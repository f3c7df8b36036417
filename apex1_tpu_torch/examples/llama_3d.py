"""Llama under dp x pp x tp (+ SP) parallelism as a runnable loop (the
port of ``examples/llama_3d.py``; BASELINE config 4's composition,
`models.llama_3d`).

One train step a rank: Megatron TP + SP blocks inside the pipeline
(``--schedule scan``, or the staggered ``1f1b``; interleaved with
``--chunks 2``), the vocab-parallel embedding and fused LM-head
cross-entropy with the embedding-group grad combination, fused Adam on
fp32 masters, O2.

Two ways to pick the layout:

- by hand (``--dp --pp --tp --cp --ep --chunks --microbatches
  --schedule``): every axis flag is checked by `planner.check_layout`
  before anything is built; an illegal combination exits 2, printing
  ``ILLEGAL LAYOUT`` and one line a broken rule (tp not dividing the
  heads, pp above the layers, ...);
- by search: ``--plan auto`` hands the model to the planner
  (`planner.make_plan` for ``--devices``, default the world size), which
  prices the legal layouts at the card's capability row and drives this
  loop from the winner, whose partition rules are checked against the
  model's own specs before training (``plan verified``). ``--plan PATH``
  replays a banked plan (the JAX planner's too): a plan priced for other
  model dims or another device count exits 2 naming each mismatch.

With ``--ckpt-dir`` the loop runs under the resilient runtime: every
checkpoint (the global state, `models.llama_3d.gather_state`) banks
the stated layout as an ``apex1-plan-v1`` document
(`resilience.reshard.plan_for_layout`), so it is self-describing and
reshardable; ``--resume auto`` continues from the newest valid one
(batch i is a pure function of (``--seed``, i), so the data position is
one int in the manifest's meta); a SIGTERM banks a final sync
checkpoint and exits 75 (``APEX1_CHAOS_SIGTERM_STEP=<n>`` sends it
after step n). ``--elastic`` resumes through
`resilience.elastic_resume`, the checkpoint's banked plan the authority
for the model and the layout: on an unchanged device count plainly, on
a changed one (``--devices``, default the world size) re-planned by the
planner and resharded, manifest-verified.

``python -m apex1_tpu_torch.examples.llama_3d --dp 1 --pp 1 --tp 1
--device cpu`` alone (a one-rank group of its own), or ``python -m
apex1_tpu_torch.parallel.multiproc --nproc 8
apex1_tpu_torch/examples/llama_3d.py --device cpu`` for the default dp
2 x pp 2 x tp 2 (the repo root on ``PYTHONPATH``); the device product
must be the world size. ``--plan auto --device cpu`` plans and runs at
one rank. `main` returns each step's loss, the step walls, the first
step run, the final state and the plan it banks.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from apex1_tpu_torch import planner
from apex1_tpu_torch.core.policy import get_policy
from apex1_tpu_torch.examples._common import (StepRecord, install_mesh,
                                              join_ranks, leave_ranks)
from apex1_tpu_torch.models import llama_3d as L3
from apex1_tpu_torch.models.llama import LlamaConfig
from apex1_tpu_torch.ops._common import resolve_device

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
                    help="'auto': search dp x pp x cp x ep x tp with "
                         "the planner instead of the axis flags; PATH: "
                         "replay a banked plan.json")
    ap.add_argument("--devices", type=int, default=None,
                    help="device count for --plan auto / --elastic "
                         "(default: the world size)")
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
    kw = (dict(moe_every=1, num_experts=dims.get("num_experts") or 4,
               moe_top_k=dims.get("moe_top_k", 2),
               moe_capacity_factor=2.0) if moe else {})
    return LlamaConfig.tiny(
        num_layers=dims["num_layers"], max_seq_len=dims["seq_len"],
        vocab_size=dims["vocab_size"], num_heads=dims["num_heads"],
        num_kv_heads=dims["num_kv_heads"], hidden_size=dims["hidden_size"],
        ffn_size=dims["ffn_size"], policy=get_policy("O2"), **kw)


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


def _world_hint() -> int:
    """The world size before this process joins a group: the group's,
    else the launcher's ``WORLD_SIZE``, else 1."""
    if dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1"))


def apply_plan(args, plan: dict, *, dims: bool = False) -> None:
    """The plan's layout (and with ``dims`` its model dims) onto the
    axis and model flags, so every later line reads one source."""
    m, sch, pm = plan["mesh"], plan["schedule"], plan["model"]
    args.dp, args.pp, args.tp = m["dp"], m["pp"], m["tp"]
    args.cp, args.ep = m["cp"], m["ep"]
    args.microbatches = sch["num_microbatches"]
    args.chunks, args.schedule = sch["num_chunks"], sch["kind"]
    args.moe = args.moe or bool(pm.get("num_experts"))
    if dims:
        args.layers, args.hidden = pm["num_layers"], pm["hidden_size"]
        args.seq, args.vocab = pm["seq_len"], pm["vocab_size"]
        args.moe = bool(pm.get("num_experts"))


def _fail(lines: list) -> None:
    for line in lines:
        print(line, file=sys.stderr, flush=True)
    sys.exit(2)


def searched_or_replayed_plan(args) -> dict:
    """``--plan auto``: `planner.make_plan` of the example model for
    ``--devices`` (default the world size), ZeRO off (this loop runs
    the unsharded optimizer). ``--plan PATH``: the banked plan, refused
    (exit 2, each mismatch a line) unless it priced this model's dims on
    this device count."""
    n = args.devices or _world_hint()
    if args.plan == "auto":
        plan = planner.make_plan(model_shape(args), n, allow_zero=False)
    else:
        try:
            plan = planner.load_plan(args.plan)
        except ValueError as e:
            _fail([str(e)])
        bad = planner.check_plan_model(plan, model_shape(args))
        if plan.get("n_devices") != n:
            bad.append(f"n_devices: plan={plan.get('n_devices')} "
                       f"devices={n}")
        if bad:
            _fail(["plan/model mismatch — this plan was searched for a "
                   "different model or device count than the flags "
                   "describe:"] + [f"  {b}" for b in bad])
    apply_plan(args, plan)
    pr, m, sch = plan["predicted"], plan["mesh"], plan["schedule"]
    print(f"plan: mesh dp={m['dp']} pp={m['pp']} cp={m['cp']} "
          f"ep={m['ep']} tp={m['tp']} M={sch['num_microbatches']} "
          f"sp={plan['kernel_flags']['sp_boundary']} — "
          f"{pr['calibrated_step_ms']:.3f} ms/step calibrated "
          f"[{pr['calibration']['source']}], "
          f"{plan['search']['n_enumerated']} layouts searched, "
          f"{plan['search']['n_hbm_rejected']} over HBM "
          f"({plan['generation']})", flush=True)
    if plan["zero"]["enabled"]:
        print("note: plan prices ZeRO optimizer sharding; this example "
              "runs the unsharded optimizer", flush=True)
    return plan


def main(argv=None) -> dict:
    args = parse_args(argv)
    if args.ep > 1:
        args.moe = True
    if args.elastic and not args.ckpt_dir:
        print("--elastic requires --ckpt-dir", file=sys.stderr, flush=True)
        sys.exit(2)
    from apex1_tpu_torch.resilience import find_restorable
    elastic = args.elastic and find_restorable(args.ckpt_dir) is not None
    plan = None         # under --elastic the checkpoint's plan decides
    if args.plan and not elastic:
        plan = searched_or_replayed_plan(args)
    elif not elastic:
        validate_hand_layout(args)
    dev = resolve_device(args.device)
    rank, world, opened = join_ranks(dev, alone=True, mesh=False)
    try:
        decision = None
        if elastic:
            decision = _elastic(args, world)
            plan = decision["plan"]
            apply_plan(args, plan, dims=True)
        n = args.dp * args.pp * args.tp * args.ep * args.cp
        if n != world:
            raise SystemExit(f"llama_3d: the layout spans {n} devices, "
                             f"but {world} ranks run")
        install_mesh(opened, tensor_model_parallel_size=args.tp,
                     pipeline_model_parallel_size=args.pp,
                     context_parallel_size=args.cp)
        return _run(args, dev, rank, world, plan, decision)
    finally:
        leave_ranks(opened)


def _config(plan: dict) -> L3.Llama3DConfig:
    """A plan's `Llama3DConfig` (`planner.llama3d_config_from_plan` over
    `model_config` of its dims), learning rate 3e-3, the unsharded
    optimizer."""
    return planner.llama3d_config_from_plan(
        plan, model_config(plan["model"],
                           bool(plan["model"].get("num_experts"))),
        learning_rate=3e-3, ignore_zero=True)


def _elastic(args, world: int) -> dict:
    """`resilience.elastic_resume` on rank 0 (re-plan and reshard when
    the device count changed), its decision handed to every rank. A
    plan-less checkpoint or no legal layout exits 2 with the typed
    message."""
    from apex1_tpu_torch.resilience import LayoutMismatch, elastic_resume
    n = args.devices or world
    box = [None]
    if dist.get_rank() == 0:
        try:
            d = elastic_resume(
                args.ckpt_dir, n_devices=n, planner_kw={"allow_zero": False},
                make_template=lambda p: L3.global_state_template(
                    _config(p), device="meta"))
            box = [dict(path=d.path, plan=d.plan, old_plan=d.old_plan,
                        resharded=d.resharded, report=d.report)]
        except (LayoutMismatch, planner.PlanError) as e:
            box = [dict(error=str(e))]
    if world > 1:
        dist.broadcast_object_list(box, src=0)
    decision = box[0]
    if "error" in decision:
        _fail([decision["error"]])
    if decision["resharded"]:
        rep = decision["report"]
        print(f"elastic: fleet {decision['old_plan']['n_devices']} -> {n} "
              f"devices; re-planned and resharded ({rep['n_restacked']} "
              f"restacked / {rep['n_repacked']} repacked / "
              f"{rep['n_copied']} copied leaves, digest-verified) -> "
              f"{decision['path']}", flush=True)
    else:
        print(f"elastic: fleet unchanged ({n} devices); plain resume from "
              f"{decision['path']}", flush=True)
    return decision


def _bank_plan(args, plan) -> dict:
    """The plan a checkpoint banks: the run's plan as it ran (a priced
    zero plan banked with zero off: this loop runs the unsharded
    optimizer), or the stated layout's (`planner.plan_for_layout`)."""
    if plan is None:
        return planner.plan_for_layout(model_shape(args),
                                       stated_layout(args))
    if not plan["zero"]["enabled"]:
        return plan
    bank = json.loads(json.dumps(plan))
    bank["zero"]["enabled"] = False
    bank["zero"]["note"] = ("disabled at banking: the llama_3d loop ran "
                            "the unsharded optimizer (ignore_zero=True)")
    return bank


def _verify_plan_specs(plan: dict, cfg, params: dict) -> None:
    """The plan's partition rules must reproduce the model's own specs
    leaf for leaf (a plan that drifted from the model is caught here)."""
    got = planner.plan_param_specs(plan, params)
    cs, ss = L3.chunk_param_specs(cfg), L3.shared_param_specs()
    want = {k: cs[k[6:]] if k.startswith("chunk.") else ss[k[7:]]
            for k in params}
    if got != want:
        raise SystemExit(f"plan partition rules drifted from "
                         f"models.llama_3d specs:\n got {got}\nwant {want}")


def _run(args, dev, rank, world, plan, decision) -> dict:
    from apex1_tpu_torch.resilience import (PreemptionHandler,
                                            ResilientCheckpointer)
    from apex1_tpu_torch.testing.chaos import sigterm_self_at
    if plan is not None:
        cfg = _config(plan)
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
    bank_plan = _bank_plan(args, plan)
    step, state, _ = L3.make_train_step(cfg, device=dev)
    verified = False
    if plan is not None:
        _verify_plan_specs(plan, cfg, state["params"])
        verified = True
        if rank == 0:
            print("plan verified: partition rules reproduce "
                  "models.llama_3d specs", flush=True)
    ck = pre = None
    start = 0
    if args.ckpt_dir:
        ck = ResilientCheckpointer(args.ckpt_dir, keep=3, plan=bank_plan)
        pre = PreemptionHandler()
        if decision is not None or (args.resume == "auto"
                                    and ck.latest_valid() is not None):
            g, man = ck.restore(L3.gather_state(cfg, state),
                                path=None if decision is None
                                else decision["path"])
            state = L3.local_state(cfg, g)
            if decision is not None:
                start = int(man.meta.get("data_step", 0))
                print(f"elastic resume at data step {start} (checkpoint "
                      f"step {man.step}, every leaf digest-verified)",
                      flush=True)
            else:
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
              f"cp={cfg.cp} chunks={cfg.num_chunks} moe={cfg.moe} ({world} "
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
            "plan": bank_plan, "plan_verified": verified}


if __name__ == "__main__":
    main()
