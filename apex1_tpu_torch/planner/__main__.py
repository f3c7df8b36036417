"""CLI of the auto-parallel planner (the port of
``apex1_tpu/planner/__main__.py``).

    python -m apex1_tpu_torch.planner --model llama8b --devices 16 \\
        [--generation h100] [--out plan.json] [--top 5] \\
        [--no-calibration] [--no-cp] [--no-zero]

    python -m apex1_tpu_torch.planner --smoke [--device cpu]

    python -m apex1_tpu_torch.planner --measure-reserve

The generation defaults to the detected card (h100 without one).
``--smoke`` runs enumerate -> price -> emit for the tiny shape on 8
devices and pins the re-plan byte for byte, prices the banked gpt2 and
llama_longctx shapes, then drives ``examples/llama_3d.py --plan auto``
for 2 steps on ``--device`` (the card unless the CPU is named): the
search-to-training-step path end to end. ``--measure-reserve`` reads the
card's memory once the CUDA context and the kernel library are loaded
(`memory.measure_hbm_reserve`): the capability row's
``hbm_reserve_bytes``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys

from apex1_tpu_torch.planner import (BANKED_SHAPES, ModelShape, make_plan,
                                     plan_json, save_plan)

TINY = ModelShape(name="tiny", num_layers=2, hidden_size=64,
                  ffn_size=128, num_heads=4, num_kv_heads=2,
                  head_dim=16, vocab_size=256, seq_len=64,
                  global_batch=8)


def _print_plan(plan: dict) -> None:
    s = plan["search"]
    print(f"search: {s['n_enumerated']} legal layouts, "
          f"{s['n_hbm_rejected']} over HBM budget "
          f"({plan['generation']})", flush=True)
    for i, row in enumerate(s["ranked_top"]):
        tag = "-> " if i == 0 else "   "
        print(f"  {tag}{row['mesh']:44s} "
              f"calibrated {row['calibrated_step_ms']:10.3f} ms "
              f"(analytic {row['step_ms']:10.3f})", flush=True)
    p = plan["predicted"]
    print(f"pick: mesh {plan['mesh']} M="
          f"{plan['schedule']['num_microbatches']} "
          f"sp={plan['kernel_flags']['sp_boundary']} "
          f"zero={plan['zero']['enabled']}", flush=True)
    print(f"      {p['calibrated_step_ms']:.3f} ms/step calibrated "
          f"({p['calibration']['source']}); "
          f"{p['tokens_per_sec_per_chip']:,.0f} tok/s/device; "
          f"bound {p['bound']}; mem {plan['memory']['total']:.2f} / "
          f"{plan['memory']['budget']:.2f} GiB", flush=True)


def smoke(device=None) -> int:
    from apex1_tpu_torch.examples import llama_3d

    print("== planner smoke: determinism ==", flush=True)
    a = plan_json(make_plan(TINY, 8))
    b = plan_json(make_plan(TINY, 8))
    if a != b:
        print("FAIL: two identical searches emitted different plans",
              flush=True)
        return 1
    print(f"  OK   tiny/8dev plan byte-stable ({len(a)} bytes, "
          f"{json.loads(a)['generation']})", flush=True)

    print("== planner smoke: banked-shape pricing ==", flush=True)
    for name in ("gpt2", "llama_longctx"):
        plan = make_plan(BANKED_SHAPES[name], 1)
        cal = plan["predicted"]["calibration"]
        print(f"  OK   {name}: "
              f"{plan['predicted']['calibrated_step_ms']:.1f} ms/step "
              f"calibrated x{cal['slowdown']:.2f} [{cal['source']}]",
              flush=True)

    print("== planner smoke: llama_3d --plan auto ==", flush=True)
    argv = ["--plan", "auto", "--layers", "2", "--steps", "2",
            "--microbatches", "4"]
    if device is not None:
        argv += ["--device", str(device)]
    res = llama_3d.main(argv)
    if not res.get("plan_verified"):
        print("FAIL: the example did not verify the plan's partition "
              "rules", flush=True)
        return 1
    if len(res["losses"]) != 2 or not all(math.isfinite(v)
                                          for v in res["losses"]):
        print(f"FAIL: llama_3d --plan auto losses {res['losses']}",
              flush=True)
        return 1
    print("planner smoke OK", flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__.splitlines()[0],
        prog="apex1_tpu_torch.planner")
    ap.add_argument("--model", default="tiny",
                    choices=("tiny",) + tuple(sorted(BANKED_SHAPES)),
                    help="a banked shape, or the tiny smoke shape")
    ap.add_argument("--devices", type=int, default=8)
    ap.add_argument("--generation", default=None,
                    help="capability row (default: the detected card, "
                         "h100 without one)")
    ap.add_argument("--global-batch", type=int, default=None,
                    help="override the shape's sequences per step")
    ap.add_argument("--out", default=None,
                    help="write the plan JSON here (atomic)")
    ap.add_argument("--top", type=int, default=5)
    ap.add_argument("--no-calibration", action="store_true",
                    help="analytic prices only")
    ap.add_argument("--no-cp", action="store_true")
    ap.add_argument("--no-zero", action="store_true")
    ap.add_argument("--smoke", action="store_true",
                    help="enumerate, price, emit and the example (see "
                         "the module docstring)")
    ap.add_argument("--device", default=None,
                    help="--smoke's torch device (default: CUDA)")
    ap.add_argument("--measure-reserve", action="store_true",
                    help="print the card's memory held back once the "
                         "CUDA context and kernel library are loaded")
    args = ap.parse_args(argv)

    if args.smoke:
        return smoke(args.device)
    if args.measure_reserve:
        from apex1_tpu_torch.planner.memory import measure_hbm_reserve
        print(json.dumps(measure_hbm_reserve(args.device)), flush=True)
        return 0

    shape = TINY if args.model == "tiny" else BANKED_SHAPES[args.model]
    if args.global_batch:
        shape = dataclasses.replace(shape, global_batch=args.global_batch)
    plan = make_plan(shape, args.devices, generation=args.generation,
                     use_calibration=not args.no_calibration,
                     top_k=args.top, allow_cp=not args.no_cp,
                     allow_zero=not args.no_zero)
    _print_plan(plan)
    if args.out:
        save_plan(plan, args.out)
        print(f"wrote {args.out}", flush=True)
    else:
        json.dump(plan, sys.stdout, indent=1, sort_keys=True)
        print(flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
