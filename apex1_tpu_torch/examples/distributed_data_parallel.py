"""Minimal data parallelism (the port of
``examples/distributed_data_parallel.py``; reference
``examples/simple/distributed/distributed_data_parallel.py``, apex DDP's
hello world): a linear least-squares model, ``Amp(fused_sgd(0.1),
"O0", grad_psum_axes=("dp",))``, 10 steps. Each rank takes its rows of
the 64-row batch; the gradients' mean over the ranks makes N ranks step
as one process does on all 64.

``python -m apex1_tpu_torch.parallel.multiproc --nproc 2
apex1_tpu_torch/examples/distributed_data_parallel.py --device cpu``
(the repo root on ``PYTHONPATH``), or alone, or inside a process group
the caller opened. ``--out FILE`` writes rank 0's final weight
(``.npz``). `main` returns each step's loss and the final params.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from apex1_tpu_torch.amp import Amp
from apex1_tpu_torch.examples._common import join_ranks, leave_ranks
from apex1_tpu_torch.ops._common import resolve_device
from apex1_tpu_torch.optim.fused_sgd import fused_sgd


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA)")
    ap.add_argument("--out", default=None,
                    help="write rank 0's final params here (.npz)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    rank, world, opened = join_ranks(dev)
    try:
        rng = np.random.default_rng(0)
        X = rng.normal(size=(64, 16)).astype(np.float32)
        Y = rng.normal(size=(64, 4)).astype(np.float32)
        rows = slice(rank * 64 // world, (rank + 1) * 64 // world)
        x, y = (torch.from_numpy(a[rows]).to(dev) for a in (X, Y))
        params = {"w": torch.zeros((16, 4), dtype=torch.float32,
                                   device=dev)}
        axes = ("dp",) if torch.distributed.is_initialized() else ()
        amp = Amp(fused_sgd(0.1), opt_level="O0", grad_psum_axes=axes)
        state = amp.init(params)

        def loss_fn(p, x, y):
            return torch.mean(torch.square(x @ p["w"] - y))

        step = amp.make_train_step(loss_fn)
        losses = []
        for i in range(10):
            state, metrics = step(state, x, y)
            losses.append(float(metrics["loss"]))
            if rank == 0:
                print(f"step {i} loss {losses[-1]:.4f}")
        if rank == 0 and args.out:
            np.savez(args.out, **{k: v.detach().cpu().numpy()
                                  for k, v in state.params.items()})
        return {"losses": losses, "params": state.params}
    finally:
        leave_ranks(opened)


if __name__ == "__main__":
    main()
