"""Distributed Llama training (the port of
``examples/llama_distributed.py``; BASELINE config 4's recipe): tensor
parallelism by the model's parameter specs, optional ZeRO sharding of
the params and the optimizer state over fsdp, data parallelism, amp O2
and fused Adam with the gradient norm clipped at 1.0.

- TP specs       -> `models.llama.param_specs` (column- and
                    row-parallel weights, a vocab-split embedding and
                    head)
- ``--fsdp > 1`` -> every still-replicated large param split over fsdp
                    (`parallel.fsdp_param_specs`), the Adam moments as
                    their params (`parallel.shard_opt_state_specs`)
- placement      -> `core.mesh.place`: DTensors on the (dp, fsdp, tp)
                    mesh; the loss gathers them (`core.mesh.gather`),
                    so the model runs on plain tensors, through the
                    kernels, and the gradients come back split as the
                    params are, averaged over the data ranks

``python -m apex1_tpu_torch.parallel.multiproc --nproc 4
apex1_tpu_torch/examples/llama_distributed.py --tp 2 --fsdp 2
--device cpu`` (the repo root on ``PYTHONPATH``), or inside a process
group the caller opened; ``--dp * --fsdp * --tp`` must be the world
size (one process alone: ``--tp 1``). Rank r sits at device r's mesh
coordinate of the JAX package's ``make_mesh(dp, fsdp, tp)``; each data
rank takes its rows of every global batch of ``--batch`` sequences. The
weights come from ``init_weights(seed 0)`` (the tests pass the JAX
package's); the batches from ``np.random.default_rng(0)``, one drawn
for the init as the JAX script draws it, then one a step. `main`
returns each step's loss (the global mean), the step walls, the final
state, the full final params and the mesh's shape.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor.experimental import implicit_replication

from apex1_tpu_torch.amp import Amp
from apex1_tpu_torch.core.mesh import gather, place
from apex1_tpu_torch.core.policy import get_policy
from apex1_tpu_torch.examples._common import (StepRecord, join_ranks,
                                              leave_ranks)
from apex1_tpu_torch.models.llama import (Llama, LlamaConfig, init_weights,
                                          llama_loss_fn, param_specs)
from apex1_tpu_torch.ops._common import resolve_device
from apex1_tpu_torch.optim.fused_adam import fused_adam
from apex1_tpu_torch.parallel.distributed_optimizer import (
    fsdp_param_specs, shard_opt_state_specs)
from apex1_tpu_torch.parallel.specs import PartitionSpec as P
from apex1_tpu_torch.transformer import parallel_state
from apex1_tpu_torch.utils.observability import MetricsLogger


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--dp", type=int, default=1)
    ap.add_argument("--fsdp", type=int, default=1)
    ap.add_argument("--tp", type=int, default=2)
    ap.add_argument("--opt-level", default="O2")
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA)")
    return ap.parse_args(argv)


def sharded_state(amp: Amp, params: dict, fsdp: int, mesh):
    """``amp.init`` of ``params`` placed by the TP specs, with ``fsdp >
    1`` every replicated large one split over fsdp too, and the
    optimizer moments placed as their params."""
    specs = param_specs(params)
    if fsdp > 1:
        zero = fsdp_param_specs(params, divisor=fsdp)
        specs = {k: zero[k] if s == P() else s for k, s in specs.items()}
    state = amp.init(place(params, specs, mesh))
    opt = state.opt_state
    ospecs = shard_opt_state_specs(opt, param_specs=specs)
    opt = dataclasses.replace(opt, **{
        f: place(getattr(opt, f), getattr(ospecs, f), mesh)
        for f in ("exp_avg", "exp_avg_sq")})
    return dataclasses.replace(state, opt_state=opt)


def full_params(state) -> dict:
    """The state's params as full tensors (a DTensor's gathered)."""
    return {k: (v.full_tensor() if hasattr(v, "full_tensor") else v)
            .detach() for k, v in state.params.items()}


def main(argv=None, *, model: Llama = None) -> dict:
    """``model``: a tiny Llama (``LlamaConfig.tiny(max_seq_len=--seq)``)
    to train in place of the one drawn from seed 0."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    rank, world, opened = join_ranks(
        dev, tensor_model_parallel_size=args.tp, fsdp_size=args.fsdp)
    try:
        return _run(args, dev, rank, world, model)
    finally:
        leave_ranks(opened)


def _run(args, dev, rank, world, model) -> dict:
    n = args.dp * args.fsdp * args.tp
    if n != world:
        raise SystemExit(f"llama_distributed: dp*fsdp*tp = {n} devices, "
                         f"but {world} ranks run (one process alone: "
                         f"--dp 1 --fsdp 1 --tp 1)")
    cfg = LlamaConfig.tiny(policy=get_policy(args.opt_level),
                           max_seq_len=args.seq)
    rng = np.random.default_rng(0)
    # the JAX script's init draw: the batch flax's init traces
    rng.integers(0, cfg.vocab_size, (args.batch, args.seq))
    if model is None:
        model = init_weights(Llama(cfg, device=dev), seed=0)
    amp = Amp(fused_adam(3e-4, weight_decay=0.1), opt_level=args.opt_level,
              max_grad_norm=1.0)
    params = dict(model.named_parameters())
    mesh, n_data, data_idx = None, 1, 0
    if dist.is_initialized():
        mesh = parallel_state.get_mesh()
        n_data = mesh.size("dp") * mesh.size("fsdp")
        data_idx = mesh.index("dp") * mesh.size("fsdp") + mesh.index("fsdp")
        state = sharded_state(amp, params, args.fsdp, mesh)
    else:
        state = amp.init(params)
    base = llama_loss_fn(model)

    def loss_fn(p, tokens):
        return base(gather(p), tokens)

    step = amp.make_train_step(loss_fn)
    rows = slice(data_idx * args.batch // n_data,
                 (data_idx + 1) * args.batch // n_data)
    logger = MetricsLogger(n_devices=world)
    rec = StepRecord(dev)
    t0 = time.time()
    for i in range(args.steps):
        batch = rng.integers(0, cfg.vocab_size, (args.batch, args.seq))
        with implicit_replication():   # scalars meet placed tensors
            state, metrics = step(state,
                                  torch.from_numpy(batch[rows]).to(dev))
        if n_data > 1:
            # each data rank's loss is its rows' mean: report the global
            loss = metrics["loss"].clone()
            dist.all_reduce(loss, group=mesh.data_group)
            metrics = {**metrics, "loss": loss / n_data}
        rec(metrics)
        if rank == 0 and (i % 2 == 0 or i == args.steps - 1):
            logger.log(i, metrics, tokens=args.batch * args.seq)
    params = full_params(state)
    shape = {"dp": args.dp, "fsdp": args.fsdp, "tp": args.tp}
    if rank == 0:
        how = ("params placed by their specs, the loss on gathered "
               "tensors" if mesh is not None else "one process, unplaced")
        print(f"done in {time.time() - t0:.1f}s on mesh {shape}: {how}")
    return {**rec.result(), "state": state, "params": params,
            "mesh": shape, "cfg": cfg}


if __name__ == "__main__":
    main()
