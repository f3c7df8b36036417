"""Llama under dp x pp x tp (+ SP) parallelism as a runnable loop (the
port of ``examples/llama_3d.py``; BASELINE config 4's composition,
`models.llama_3d`).

One train step a rank: Megatron TP + SP blocks inside the pipeline
(``--schedule scan``, or the staggered ``1f1b``; interleaved with
``--chunks 2``), the vocab-parallel embedding and fused LM-head
cross-entropy with the embedding-group grad combination, fused Adam on
fp32 masters, O2.

The layout is written out by hand (``--dp --pp --tp --cp --ep
--chunks --microbatches --schedule``). Every axis flag is checked by
`planner.check_layout` before anything is built: an illegal combination
exits 2, printing ``ILLEGAL LAYOUT`` and one line a broken rule (tp not
dividing the heads, pp above the layers, ...). ``--plan auto|PATH``
(the planner's search and a banked plan) raises NotImplementedError:
the planner's pricing waits for ROADMAP.md queue A item 11.

With ``--ckpt-dir`` the loop runs under the resilient runtime: every
checkpoint (the global state, `models.llama_3d.gather_state`) banks
the stated layout as an ``apex1-plan-v1`` document
(`resilience.reshard.plan_for_layout`), so it is self-describing and
reshardable; ``--resume auto`` continues from the newest valid one
(batch i is a pure function of (``--seed``, i), so the data position is
one int in the manifest's meta); a SIGTERM banks a final sync
checkpoint and exits 75 (``APEX1_CHAOS_SIGTERM_STEP=<n>`` sends it
after step n). ``--elastic`` resumes through
`resilience.elastic_resume`: on an unchanged device count plainly, the
checkpoint's banked plan the authority for the model and the layout; a
changed count raises its NotImplementedError (ROADMAP.md queue A item
11).

``python -m apex1_tpu_torch.examples.llama_3d --dp 1 --pp 1 --tp 1
--device cpu`` alone (a one-rank group of its own), or ``python -m
apex1_tpu_torch.parallel.multiproc --nproc 8
apex1_tpu_torch/examples/llama_3d.py --device cpu`` for the default dp
2 x pp 2 x tp 2 (the repo root on ``PYTHONPATH``); the device product
must be the world size. `main` returns each step's loss, the step
walls, the first step run and the final state.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from apex1_tpu_torch import planner
from apex1_tpu_torch.core.policy import get_policy
from apex1_tpu_torch.examples._common import (StepRecord, join_ranks,
                                              leave_ranks)
from apex1_tpu_torch.models import llama_3d as L3
from apex1_tpu_torch.models.llama import LlamaConfig
from apex1_tpu_torch.ops._common import resolve_device

_PLANNER = ("--plan searches or replays a plan with the planner's "
            "pricing, which the port has not yet: ROADMAP.md queue A "
            "item 11")


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dp", type=int, default=2)
    ap.add_argument("--pp", type=int, default=2)
    ap.add_argument("--tp", type=int, default=2)
    ap.add_argument("--chunks", type=int, default=1)
    ap.add_argument("--cp", type=int, default=1,
                    help="context parallel (ring attention seq shards)")
    ap.add_argument("--ep", type=int, default=1,
                    help="expert parallel (implies --moe)")
    ap.add_argument("--moe", action="store_true",
                    help="every FFN expert-routed (4 experts, top-2)")
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--hidden", type=int, default=64)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--vocab", type=int, default=256)
    ap.add_argument("--microbatches", type=int, default=4)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--schedule", default="scan", choices=("scan", "1f1b"),
                    help="pipeline schedule: scan (remat) or the "
                         "staggered-fwd/bwd 1F1B (interleaved with "
                         "--chunks > 1)")
    ap.add_argument("--plan", default=None, metavar="auto|PATH",
                    help="the planner's search or a banked plan "
                         "(not yet in the port: ROADMAP.md queue A "
                         "item 11)")
    ap.add_argument("--devices", type=int, default=None,
                    help="device count for --elastic (default: the "
                         "product of the axis flags)")
    ap.add_argument("--seed", type=int, default=0,
                    help="data seed: batch i is a pure function of "
                         "(seed, i), so resume is exact")
    ap.add_argument("--ckpt-dir", default=None,
                    help="enable the resilient runtime: plan-banking "
                         "checkpoints + preemption hook + resume")
    ap.add_argument("--ckpt-every", type=int, default=2)
    ap.add_argument("--resume", default="auto", choices=("auto", "never"))
    ap.add_argument("--elastic", action="store_true",
                    help="on relaunch, resume from the checkpoint's "
                         "banked plan (needs --ckpt-dir)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA)")
    return ap.parse_args(argv)


def model_shape(args) -> planner.ModelShape:
    """The planner's view of the example model: the dims of the
    `LlamaConfig.tiny` below (heads / kv fixed 4 / 2)."""
    return planner.ModelShape(
        name="llama3d-example", num_layers=args.layers,
        hidden_size=args.hidden, ffn_size=2 * args.hidden,
        num_heads=4, num_kv_heads=2, head_dim=args.hidden // 4,
        vocab_size=args.vocab, seq_len=args.seq,
        global_batch=args.microbatches * args.dp * args.ep,
        num_experts=4 if args.moe else 0, moe_top_k=2)


def stated_layout(args) -> planner.Layout:
    return planner.Layout(dp=args.dp, pp=args.pp, cp=args.cp, ep=args.ep,
                          tp=args.tp, num_microbatches=args.microbatches,
                          microbatch_size=1, num_chunks=args.chunks,
                          schedule=args.schedule)


def validate_hand_layout(args) -> None:
    """`planner.check_layout` of the axis flags: every broken rule
    named, one a line, exit 2, before anything is built."""
    violations = planner.check_layout(model_shape(args),
                                      stated_layout(args))
    if violations:
        print("ILLEGAL LAYOUT — rejected by apex1_tpu_torch.planner."
              "check_layout before building anything:",
              file=sys.stderr, flush=True)
        for v in violations:
            print(f"  [{v.rule}] {v.message}", file=sys.stderr, flush=True)
        print("(docs/planner.md has the rule catalogue)", file=sys.stderr,
              flush=True)
        sys.exit(2)


def model_config(dims: dict, moe: bool) -> LlamaConfig:
    """The example's `LlamaConfig` at ``dims`` (a plan's ``model``
    block's keys), O2."""
    kw = (dict(moe_every=1, num_experts=4, moe_top_k=2,
               moe_capacity_factor=2.0) if moe else {})
    return LlamaConfig.tiny(
        num_layers=dims["num_layers"], max_seq_len=dims["seq_len"],
        vocab_size=dims["vocab_size"], num_heads=dims["num_heads"],
        num_kv_heads=dims["num_kv_heads"], hidden_size=dims["hidden_size"],
        ffn_size=dims["ffn_size"], policy=get_policy("O2"), **kw)


def config_from_plan(plan: dict) -> L3.Llama3DConfig:
    """The `Llama3DConfig` a banked plan describes (its model, mesh and
    schedule), learning rate 3e-3."""
    m, sch, pm = plan["mesh"], plan["schedule"], plan["model"]
    moe = bool(pm.get("num_experts"))
    return L3.Llama3DConfig(
        model=model_config(pm, moe), dp=m["dp"], pp=m["pp"], tp=m["tp"],
        cp=m["cp"], ep=m["ep"], moe=moe, num_chunks=sch["num_chunks"],
        num_microbatches=sch["num_microbatches"],
        microbatch_size=sch["microbatch_size"], learning_rate=3e-3,
        schedule=sch["kind"])


def batch_at(cfg: L3.Llama3DConfig, seed: int, i: int, dev) -> tuple:
    """Batch i, a pure function of (seed, i): drawn in the canonical
    (global_batch, seq) layout and regrouped as sequence g = m·B + b ->
    tokens[m, :, b], so another (M, B) factorization trains the same
    sequences at step i. Returns (tokens, labels) (M, S, mb·dp·ep), the
    labels the tokens rolled by one along the sequence."""
    m = cfg.model
    mb_cols = cfg.microbatch_size * cfg.dp * cfg.ep
    r = np.random.default_rng([seed, i])
    canon = r.integers(0, m.vocab_size,
                       (cfg.num_microbatches * mb_cols, m.max_seq_len))
    toks = canon.reshape(cfg.num_microbatches, mb_cols,
                         m.max_seq_len).transpose(0, 2, 1)
    tokens = torch.from_numpy(np.ascontiguousarray(toks)).to(dev)
    return tokens, torch.roll(tokens, -1, dims=1)


def main(argv=None) -> dict:
    args = parse_args(argv)
    if args.ep > 1:
        args.moe = True
    if args.elastic and not args.ckpt_dir:
        print("--elastic requires --ckpt-dir", file=sys.stderr, flush=True)
        sys.exit(2)
    if args.plan:
        raise NotImplementedError(f"llama_3d --plan {args.plan}: {_PLANNER}")
    from apex1_tpu_torch.resilience import find_restorable
    elastic = args.elastic and find_restorable(args.ckpt_dir) is not None
    if not elastic:
        validate_hand_layout(args)
    dev = resolve_device(args.device)
    rank, world, opened = join_ranks(
        dev, alone=True, tensor_model_parallel_size=args.tp,
        pipeline_model_parallel_size=args.pp,
        context_parallel_size=args.cp)
    try:
        return _run(args, dev, rank, world, elastic)
    finally:
        leave_ranks(opened)


def _run(args, dev, rank, world, elastic) -> dict:
    from apex1_tpu_torch.resilience import (PreemptionHandler,
                                            ResilientCheckpointer,
                                            elastic_resume)
    from apex1_tpu_torch.resilience.reshard import plan_for_layout
    from apex1_tpu_torch.testing.chaos import sigterm_self_at
    n = args.devices or args.dp * args.pp * args.tp * args.ep * args.cp
    decision = None
    if elastic:
        # the checkpoint's banked plan is the authority for the model
        # and the layout; a changed device count raises (the re-plan
        # needs the planner)
        decision = elastic_resume(args.ckpt_dir, n_devices=n,
                                  make_template=None)
        print(f"elastic: fleet unchanged ({n} devices); plain resume from "
              f"{decision.path}", flush=True)
        cfg, bank_plan = config_from_plan(decision.plan), decision.plan
    else:
        cfg = L3.Llama3DConfig(
            model=model_config(
                {"num_layers": args.layers, "seq_len": args.seq,
                 "vocab_size": args.vocab, "num_heads": 4,
                 "num_kv_heads": 2, "hidden_size": args.hidden,
                 "ffn_size": 2 * args.hidden}, args.moe),
            dp=args.dp, pp=args.pp, tp=args.tp, cp=args.cp, ep=args.ep,
            moe=args.moe, num_chunks=args.chunks,
            num_microbatches=args.microbatches, microbatch_size=1,
            learning_rate=3e-3, schedule=args.schedule)
        bank_plan = plan_for_layout(model_shape(args), stated_layout(args))
    if n != world:
        raise SystemExit(f"llama_3d: the layout spans {n} devices, but "
                         f"{world} ranks run")
    step, state, _ = L3.make_train_step(cfg, device=dev)
    ck = pre = None
    start = 0
    if args.ckpt_dir:
        ck = ResilientCheckpointer(args.ckpt_dir, keep=3, plan=bank_plan)
        pre = PreemptionHandler()
        if decision is not None or (args.resume == "auto"
                                    and ck.latest_valid() is not None):
            g, man = ck.restore(L3.gather_state(cfg, state),
                                path=None if decision is None
                                else decision.path)
            state = L3.local_state(cfg, g)
            start = int(man.meta.get("data_step", man.step))
            print(f"resumed from step {man.step} (data step {start})",
                  flush=True)
    chaos_at = os.environ.get("APEX1_CHAOS_SIGTERM_STEP")
    chaos_at = int(chaos_at) if chaos_at else None

    def save(i, sync=False, **meta):
        g = L3.gather_state(cfg, state)       # a collective on every rank
        if rank == 0:
            (ck.save_sync if sync else ck.save)(
                int(state["step"]), g, meta={"data_step": i, **meta})

    m = cfg.model
    if rank == 0:
        print(f"mesh dp={cfg.dp} pp={cfg.pp} tp={cfg.tp} ep={cfg.ep} "
              f"cp={cfg.cp} chunks={cfg.num_chunks} moe={cfg.moe} ({n} "
              f"devices), {m.num_layers}L x {m.hidden_size}h", flush=True)
    rec = StepRecord(dev)
    t0 = time.time()
    if pre is not None:
        pre.install()
    try:
        for i in range(start, args.steps):
            state, loss = step(state, *batch_at(cfg, args.seed, i, dev))
            rec({"loss": loss})
            if rank == 0 and (i % 5 == 0 or i == args.steps - 1):
                print(f"step {i:3d}  loss {loss.item():.4f}", flush=True)
            if ck is not None:
                if (i + 1) % args.ckpt_every == 0 or i + 1 == args.steps:
                    save(i + 1)
                sigterm_self_at(i + 1, chaos_at)
                if pre.triggered:
                    ck.wait()   # let the in-flight async save commit
                    save(i + 1, sync=True, preempted=True)
                    if dist.is_initialized():
                        dist.barrier()
                    pre.exit_resumable(f"preempted at data step {i + 1}")
        if ck is not None:
            ck.wait()
            ck.close()
    finally:
        if pre is not None:
            pre.uninstall()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    if rank == 0:
        print(f"done in {time.time() - t0:.1f}s (step counter = "
              f"{int(state['step'])})")
    return {**rec.result(), "start": start, "state": state, "cfg": cfg,
            "plan": bank_plan}


if __name__ == "__main__":
    main()
