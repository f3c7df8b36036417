"""GPT-2 with a tied embedding and LM head split across pipeline stages
(the port of ``examples/gpt2_pp_tied.py``; the reference's embedding
group: `parallel_state.initialize_model_parallel` builds {first,
last}-stage groups, and the schedules all-reduce the tied word
embedding's grads after each pipeline step).

One train step a rank: `schedules.pipeline_tied_apply` routes the tied
table (the embedding on stage 0, the LM head on stage P - 1, the
partial-loss convention, ``broadcast_outputs=False``) through the
transformer blocks, which are the pipeline stages;
`schedules.allreduce_embedding_grads` is the embedding-group
all-reduce; fused Adam (lr 1e-3) updates every rank's own stage and the
tied table. The loss is the sum over the stages of each stage's partial
mean. A block is the JAX script's: the port's `layer_norm`, the causal
`scaled_upper_triang_masked_softmax` over the materialized scores, the
tanh-approximated GELU (``jax.nn.gelu``'s default), and the head's
`softmax_cross_entropy_loss`, all fp32.

``python -m apex1_tpu_torch.parallel.multiproc --nproc 4
apex1_tpu_torch/examples/gpt2_pp_tied.py --pp 4 --device cpu`` (the
repo root on ``PYTHONPATH``), or inside a process group the caller
opened; ``--pp`` must be the world size (one process alone: ``--pp
1``). The weights and the one fixed batch come from
``np.random.default_rng(0)`` in the JAX script's order (each stage
keeps its layers of the full draw), so both packages train the very
same numbers. `main` returns each step's loss, the step walls, this
rank's stage and its final params.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from apex1_tpu_torch.examples._common import (StepRecord, join_ranks,
                                              leave_ranks)
from apex1_tpu_torch.ops._common import resolve_device
from apex1_tpu_torch.ops.layer_norm import layer_norm
from apex1_tpu_torch.ops.softmax import scaled_upper_triang_masked_softmax
from apex1_tpu_torch.ops.xentropy import softmax_cross_entropy_loss
from apex1_tpu_torch.optim import apply_updates
from apex1_tpu_torch.optim.fused_adam import fused_adam
from apex1_tpu_torch.transformer import parallel_state
from apex1_tpu_torch.transformer.pipeline_parallel import schedules


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pp", type=int, default=4)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--hidden", type=int, default=64)
    ap.add_argument("--heads", type=int, default=4)
    ap.add_argument("--vocab", type=int, default=256)
    ap.add_argument("--mb", type=int, default=2)
    ap.add_argument("--microbatches", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA)")
    return ap.parse_args(argv)


def draw(args) -> tuple:
    """``(chunk, tied, tokens)`` as numpy, in the JAX script's draw
    order: the chunk-major (1, P, L / P, ...) block stacks, the tied
    table and positions, then the (M, mb, S) batch."""
    P_, L, E, V, S = args.pp, args.layers, args.hidden, args.vocab, args.seq
    lps = L // P_
    rng = np.random.default_rng(0)

    def w(*shape, scale=0.02):
        return (rng.normal(size=shape) * scale).astype(np.float32)

    lead = (1, P_, lps)
    ones, zeros = (np.ones(lead + (E,), np.float32),
                   np.zeros(lead + (E,), np.float32))
    chunk = {"ln1_g": ones, "ln1_b": zeros, "wqkv": w(*lead, E, 3 * E),
             "wo": w(*lead, E, E), "ln2_g": ones.copy(),
             "ln2_b": zeros.copy(), "w1": w(*lead, E, 4 * E),
             "w2": w(*lead, 4 * E, E)}
    tied = {"wte": w(V, E), "wpe": w(S, E, scale=0.01)}
    tokens = rng.integers(0, V, (args.microbatches, args.mb, S))
    return chunk, tied, tokens


def block_fn(mb: int, S: int, H: int):
    """One transformer block on x (mb, S, E)."""

    def block(x, p):
        E = x.shape[-1]
        D = E // H
        h = layer_norm(x, p["ln1_g"], p["ln1_b"])
        qkv = (h @ p["wqkv"]).reshape(mb, S, 3, H, D)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        a = scaled_upper_triang_masked_softmax(q @ k.transpose(-1, -2),
                                               scale=1.0 / np.sqrt(D))
        o = (a @ v).transpose(1, 2).reshape(mb, S, E)
        x = x + o @ p["wo"]
        h = layer_norm(x, p["ln2_g"], p["ln2_b"])
        return x + F.gelu(h @ p["w1"], approximate="tanh") @ p["w2"]

    return block


def main(argv=None) -> dict:
    args = parse_args(argv)
    dev = resolve_device(args.device)
    rank, world, opened = join_ranks(dev,
                                     pipeline_model_parallel_size=args.pp)
    try:
        return _run(args, dev, rank, world)
    finally:
        leave_ranks(opened)


def _run(args, dev, rank, world) -> dict:
    if args.layers % args.pp:
        raise SystemExit("--layers must divide by --pp")
    if args.pp != world:
        raise SystemExit(f"gpt2_pp_tied: --pp {args.pp} but {world} ranks "
                         f"run (one process alone: --pp 1)")
    P_, M, mb, S = args.pp, args.microbatches, args.mb, args.seq
    V, lps = args.vocab, args.layers // args.pp
    group = (parallel_state.get_mesh().group("pp") if dist.is_initialized()
             else None)
    s = 0 if group is None else dist.get_rank(group)
    chunk, tied, tokens = draw(args)
    # this stage's blocks (1, lps, ...): the leading chunk axis V = 1
    params = {**{f"chunk.{k}": torch.from_numpy(
        np.ascontiguousarray(v[:, s])).to(dev) for k, v in chunk.items()},
        **{f"tied.{k}": torch.from_numpy(v).to(dev)
           for k, v in tied.items()}}
    del chunk
    tokens = torch.from_numpy(tokens).to(dev)
    block = block_fn(mb, S, args.heads)

    def stage_fn(p_stage, x):
        for j in range(lps):
            x = block(x, {k: v[j] for k, v in p_stage.items()})
        return x

    def embed_fn(t, tok):                       # (mb, S) -> (mb, S, E)
        return t["wte"][tok] + t["wpe"][None]

    def head_fn(t, outs):                       # (M, mb, S, E) -> (M,)
        logits = outs @ t["wte"].T
        ce = softmax_cross_entropy_loss(
            logits[:, :, :-1].reshape(M * mb, S - 1, V),
            tokens.reshape(M * mb, S)[:, 1:])
        return ce.reshape(M, -1).mean(dim=1)

    tx = fused_adam(1e-3)
    opt = tx.init(params)

    def step(params, opt):
        leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
        with torch.enable_grad():
            per_mb = schedules.pipeline_tied_apply(
                stage_fn,
                {k[6:]: v for k, v in leaves.items() if k[:6] == "chunk."},
                embed_fn,
                head_fn,
                {k[5:]: v for k, v in leaves.items() if k[:5] == "tied."},
                tokens, broadcast_outputs=False)
            part = per_mb.mean()                # partial over pp
            got = torch.autograd.grad(part, list(leaves.values()))
        grads = dict(zip(leaves, got))
        # the embedding-group all-reduce: the tied grads live on stage 0
        # (the embedding's use) and stage P - 1 (the head's)
        tied_g = schedules.allreduce_embedding_grads(
            {k: g for k, g in grads.items() if k[:5] == "tied."}, group)
        grads.update(tied_g)
        updates, opt = tx.update(grads, opt, params)
        loss = part.detach()
        if group is not None:
            dist.all_reduce(loss, group=group)
        return apply_updates(params, updates), opt, loss

    rec = StepRecord(dev)
    for i in range(args.steps):
        params, opt, loss = step(params, opt)
        rec({"loss": loss})
        if rank == 0 and (i % 5 == 0 or i == args.steps - 1):
            print(f"step {i:3d}  loss {loss.item():.4f}", flush=True)
    out = rec.result()
    if rank == 0:
        print(f"tied-embedding pipeline OK (embedding-group grads combined "
              f"across {P_} stages)")
    return {**out, "params": params, "stage": s}


if __name__ == "__main__":
    main()
