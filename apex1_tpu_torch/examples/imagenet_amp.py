"""ResNet-50 "ImageNet" training (the port of ``examples/imagenet_amp.py``;
reference ``examples/imagenet/main_amp.py``: amp O1/O2, apex DDP, SyncBN
and the prefetching loader), on synthetic data.

- amp opt level      -> `Amp(fused_sgd(0.1, momentum=0.9), opt_level=...)`
- apex DDP allreduce -> ``grad_psum_axes=("dp",)``: the gradients'
                        mean over the data-parallel group
- convert_syncbn     -> the model built with ``bn_axis_name="dp"``
- data_prefetcher    -> `runtime.PrefetchLoader` with the native u8 -> f32
                        `normalize_images` on its worker thread and the
                        copy on a CUDA side stream

``python -m apex1_tpu_torch.examples.imagenet_amp [--steps N]
[--opt-level O2] [--batch B] [--image H] [--tiny] [--device cpu]``

One process trains alone (local batch norm, no all-reduce). Under ranks
(``python -m apex1_tpu_torch.parallel.multiproc --nproc N
apex1_tpu_torch/examples/imagenet_amp.py ...``, or inside a process
group the caller opened) each rank takes its ``--batch`` rows of every
global batch of ``--batch * world`` images, the batch statistics are
synced over the ranks and the gradients averaged, so N ranks train as
one process would on the whole batch. ``--prefetch 0`` normalizes and
copies each batch inline instead of on the prefetcher's worker. Every
step ends in a synchronize (its wall is from the previous step's end,
data included). ``--out FILE`` writes rank 0's final parameters
(``.npz``).

`main` returns the run's record: each step's loss, the step walls (ms),
the final ``(state, running statistics)`` carry, the step function and
the last batch.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch
import torch.distributed as dist

from apex1_tpu_torch import runtime
from apex1_tpu_torch.amp import Amp
from apex1_tpu_torch.core.policy import get_policy
from apex1_tpu_torch.examples._common import (StepRecord, join_ranks,
                                              leave_ranks)
from apex1_tpu_torch.models.resnet import ResNet, ResNetConfig
from apex1_tpu_torch.ops._common import resolve_device
from apex1_tpu_torch.ops.xentropy import softmax_cross_entropy_loss
from apex1_tpu_torch.optim.fused_sgd import fused_sgd
from apex1_tpu_torch.utils.observability import MetricsLogger

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=32,
                    help="images a rank per step")
    ap.add_argument("--image", type=int, default=64)
    ap.add_argument("--opt-level", default="O2")
    ap.add_argument("--tiny", action="store_true",
                    help="tiny model for smoke runs")
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA)")
    ap.add_argument("--prefetch", type=int, default=2,
                    help="batches prefetched ahead; 0 normalizes and "
                    "copies each batch inline")
    ap.add_argument("--out", default=None,
                    help="write rank 0's final params here (.npz)")
    return ap.parse_args(argv)


def synthetic_loader(batch: int, image: int, steps: int, classes: int,
                     rng: np.random.Generator):
    """``steps`` batches of uint8 NHWC images and int64 labels. (The JAX
    example draws the labels from 1000 classes whatever the head's
    width; here they lie in the model's ``classes``.)"""
    for _ in range(steps):
        yield {"images": rng.integers(0, 256, (batch, image, image, 3),
                                      dtype=np.uint8),
               "labels": rng.integers(0, classes, (batch,),
                                      dtype=np.int64)}


def transform(batch: dict) -> dict:
    return {"images": runtime.normalize_images(batch["images"], MEAN, STD),
            "labels": batch["labels"]}


def loss_fn_of(model: ResNet):
    """``loss_fn(params, images, labels, batch_stats) -> (loss, new
    stats)``: the mean fused cross-entropy with label smoothing 0.1; the
    running statistics ride out through the aux."""

    def loss_fn(params, images, labels, batch_stats):
        logits, new = torch.func.functional_call(
            model, {**params, **batch_stats}, (images,), {"train": True})
        loss = softmax_cross_entropy_loss(logits.float(), labels,
                                          smoothing=0.1).mean()
        return loss, new

    return loss_fn


def main(argv=None, *, model: ResNet = None) -> dict:
    """``model``: a ResNet to train in place of ResNet-50 (or tiny) drawn
    from seed 0 (the tests pass the JAX package's weights)."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    rank, world, opened = join_ranks(dev)
    try:
        return _run(args, dev, rank, world, model)
    finally:
        leave_ranks(opened)


def _run(args, dev, rank, world, model) -> dict:
    axes = ("dp",) if dist.is_initialized() else ()
    policy = get_policy(args.opt_level)
    bn = "dp" if axes else None
    if model is None:
        cfg = (ResNetConfig.tiny(bn_axis_name=bn, policy=policy)
               if args.tiny else
               ResNetConfig.resnet50(bn_axis_name=bn, policy=policy))
        model = ResNet(cfg, device=dev, seed=0)
    cfg = model.cfg
    amp = Amp(fused_sgd(0.1, momentum=0.9), opt_level=args.opt_level,
              grad_psum_axes=axes)
    inner = amp.make_train_step(loss_fn_of(model), has_aux=True)

    def step(carry, images, labels):
        state, stats = carry
        state, m = inner(state, images, labels, stats)
        m = dict(m)
        return (state, m.pop("aux")), m   # SyncBN's running stats advance

    carry = (amp.init(dict(model.named_parameters())),
             {k: v.clone() for k, v in model.named_buffers()})
    rows = slice(rank * args.batch, (rank + 1) * args.batch)
    source = ({k: v[rows] for k, v in b.items()} for b in synthetic_loader(
        args.batch * world, args.image, args.steps, cfg.num_classes,
        np.random.default_rng(0)))
    if args.prefetch:
        loader = runtime.PrefetchLoader(source, transform=transform,
                                        prefetch=args.prefetch, device=dev)
    else:
        loader = ({k: torch.from_numpy(v).to(dev) for k, v in
                   transform(b).items()} for b in source)
    logger = MetricsLogger(n_devices=world)
    rec = StepRecord(dev)
    t0 = time.time()
    for i, batch in enumerate(loader):
        carry, metrics = step(carry, batch["images"], batch["labels"])
        rec(metrics)
        if rank == 0 and (i % 5 == 0 or i == args.steps - 1):
            logger.log(i, metrics, tokens=args.batch * world)
    if rank == 0:
        print(f"done: {args.steps} steps, "
              f"{args.steps * args.batch * world / (time.time() - t0):.0f} "
              f"imgs/sec")
        if args.out:
            np.savez(args.out, **{k: v.detach().cpu().numpy() for k, v in
                                  carry[0].params.items()})
    return {**rec.result(), "state": carry, "step": step,
            "batch": (batch["images"], batch["labels"]),
            "images_per_step": args.batch * world, "cfg": cfg}


if __name__ == "__main__":
    main()
