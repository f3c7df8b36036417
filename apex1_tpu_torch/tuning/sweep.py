"""The launch-parameter sweep (the port of ``tools/tune_kernels.py``).

Times the candidates of one kernel's launch parameters on the card, in
one process: every parameter is an argument of the launch (an explicit
keyword of the op), so the candidates share one built library and one
process. For each case the sweep

1. filters the candidates through the `vmem_model` budget check of the
   kernel's `registry` spec, and logs each one it drops;
2. times each survivor on the card with CUDA events (CUDA-graph replays
   for the decode-sized kernels, whose launches are shorter than the
   wrapper's host time), forward only or forward and backward as the
   op is used;
3. holds each candidate's output against the op's plain version on the
   same inputs, within the tolerance its row's kernel check uses in
   ``chip_smoke.py`` (``TOL``), and drops a candidate that disagrees;
4. records the fastest with ``time_ms``, ``timing: "measured"``, the
   card's name and power limit (``nvidia-smi``) and the analytic
   roofline (``predicted``, which `obs.calibrate` pairs with the time),
   saves it under ``perf_results_torch/tuning/`` (``APEX1_TUNING_DIR``
   overrides) and checks that a fresh `lookup` returns it.

The cases are the JAX sweep's seven tunable specs at the shapes
``chip_smoke.py`` gives those kernels on their main paths (`CASES`).
``--device cpu`` runs the plumbing at tiny shapes on the plain versions
(host-clock times, entries marked ``timing: "cpu"``, never served on a
card). ``--validate`` checks every table strictly and sweeps nothing.

Usage:
    python -m apex1_tpu_torch.tuning.sweep --kernel int8_matmul
    python -m apex1_tpu_torch.tuning.sweep --kernel all --iters 20
    python -m apex1_tpu_torch.tuning.sweep --validate
"""

from __future__ import annotations

import argparse
import dataclasses
import subprocess
import sys
import time
from typing import Callable, Optional, Sequence

from apex1_tpu_torch import tuning

#: (rtol, atol as a share of the reference's rms) by output dtype, the
#: kernel checks' rule in ``chip_smoke.py``; ids compare exactly
TOL = {"float32": (1e-5, 1e-4), "bfloat16": (2.0 ** -7, 3e-2),
       "float16": (2.0 ** -10, 1e-2)}


@dataclasses.dataclass
class Case:
    """One sweep: the candidates (dicts of launch parameters) and a
    factory returning, for a candidate, the function to time (for None,
    the op with no explicit parameters: the table's, else today's);
    ``plain`` computes the reference; ``heuristic`` gives today's
    parameters and ``plan`` what the op resolves with no explicit ones."""

    kernel: str                   # registry name (keys the table)
    dims: dict                    # padded dims of the table key
    dtype: str                    # canonical dtype of the table key
    candidates: Sequence[dict]
    make: Callable                # params -> fn() -> output tensor
    plain: Callable               # () -> the plain version's output
    heuristic: Callable           # () -> today's params
    tol: Optional[tuple]          # None: outputs equal exactly
    grad: bool = False            # fn runs forward and backward
    graph: bool = False           # time by CUDA-graph replays
    flops: Optional[float] = None
    nbytes: Optional[float] = None
    es: int = 2                   # the budget check's element size
    check_dims: Optional[dict] = None  # the check's dims, if not dims
    plan: Optional[Callable] = None   # () -> the op's resolved params


def _gen(torch, device):
    return torch.Generator(device=device).manual_seed(1234)


def case_int8_matmul(torch, device, tiny):
    """int8_mm at a decode step's gate/up projection (8 x 5632 x 2048:
    ``chip_smoke.py``'s INT8_CASES main case)."""
    from apex1_tpu_torch.ops import quantized as q
    T, N, K = (8, 256, 256) if tiny else (8, 5632, 2048)
    g = _gen(torch, device)
    x = torch.randn(T, K, generator=g, device=device).to(torch.bfloat16)
    wq, s = q.quantize_int8(torch.randn(N, K, generator=g, device=device)
                            * 0.02)

    def heuristic():
        bm, bt = q._tile(T, N)
        splits, kc = q._split_k(T, N, K)
        return dict(bm=bm, bt=bt, splits=splits, kc=kc)
    h = heuristic()
    cands = [h, dict(h, splits=1, kc=K)]
    for sp in (2, 4, 8):
        kc = -(-(-(-K // sp)) // 64) * 64
        cands.append(dict(h, splits=-(-K // kc), kc=kc))
    cands = list({tuple(sorted(c.items())): c for c in cands}.values())
    return Case("int8_matmul", {"N": N, "K": K,
                                "Tb": tuning.token_bucket(T)}, "int8", cands,
                lambda p: lambda: q.int8_mm(x, wq, s, tile=p),
                lambda: q._int8_mm_plain(x, wq, s), heuristic,
                TOL["float32"], graph=True, es=1,
                plan=lambda: dict(zip(("bm", "bt", "splits", "kc"),
                                      q.int8_plan(T, N, K))),
                flops=2.0 * T * N * K,
                nbytes=float(N * K + 4 * N + 2 * T * K + 4 * T * N))


def case_fused_sample(torch, device, tiny):
    """The sampler at a GPT-2 decode step: 8 rows of the padded 50304
    vocab at temperature 0.7 (SAMPLE_CASES' main case); every split
    draws the same ids."""
    from apex1_tpu_torch.ops import paged_decode as pd
    R, V = (8, 1024) if tiny else (8, 50304)
    g = _gen(torch, device)
    lg = torch.randn(R, V, generator=g, device=device)
    seeds = torch.arange(R, dtype=torch.int32, device=device) * 7 + 3
    pos = torch.arange(R, dtype=torch.int32, device=device) + 64
    sms = (torch.cuda.get_device_properties(device).multi_processor_count
           if device != "cpu" else 132)

    def run(splits):
        return pd.fused_sample(lg, seeds, pos, temperature=0.7,
                               vocab_size=V - 47, splits=splits)

    def heuristic():
        return {"splits": pd.sample_splits(R, V, sms)[0]}
    h = heuristic()["splits"]
    # as `sample_plan` meets a count: a split a multiple of 4 columns
    cands = sorted({pd._split(V, c)[0] for c in (h, max(1, h // 2), 2 * h,
                                                  4 * h, 132)})
    with_plain = _plain(torch, lambda: run(None))
    return Case("fused_sample", {"Vp": tuning.padded_lanes(V), "R": R},
                "float32",
                [{"splits": c} for c in cands],
                lambda p: lambda: run(_get(p, "splits")), with_plain,
                heuristic, None, graph=True, es=4, flops=30.0 * R * V,
                plan=lambda: {"splits": pd.sample_plan(R, V, sms)[0]},
                nbytes=float(4 * R * V + 4 * R))


def case_paged_decode(torch, device, tiny):
    """Paged attention at a GPT-2 decode step: 8 rows, 12 heads, D 64,
    pages of 64 positions, 17 a row, bf16 (PAGED_CASES' decode case)."""
    from apex1_tpu_torch.ops import paged_decode as pd
    N, Hq, Hkv, D, P, T = ((2, 4, 2, 64, 16, 5) if tiny
                           else (8, 12, 12, 64, 64, 17))
    g = _gen(torch, device)
    q = torch.randn(N, Hq, 1, D, generator=g, device=device).to(
        torch.bfloat16)
    pages = 1 + N * T
    k = torch.randn(pages, Hkv, P, D, generator=g, device=device).to(
        torch.bfloat16)
    v = torch.randn(pages, Hkv, P, D, generator=g, device=device).to(
        torch.bfloat16)
    bt = torch.arange(1, pages, dtype=torch.int32,
                      device=device).reshape(N, T)
    lens = torch.tensor([T * P - 1 - 37 * i for i in range(N)],
                        dtype=torch.int32, device=device).clamp(min=0)

    def run(per):
        return pd.paged_attend(q, k, v, bt, lens, per=per)
    nkb = -(-T * P // pd.PAGED_KEYS)

    def heuristic():
        return {"per": pd.paged_geometry(N, Hq, Hkv, 1, D, P, T)[1]}
    # as `paged_plan` meets a split: per = ceil(nkb / splits)
    cands = sorted({-(-nkb // -(-nkb // min(p, nkb)))
                    for p in (heuristic()["per"], 1, 2, nkb // 2, nkb)
                    if p >= 1})
    return Case("paged_decode", {"Dp": D, "Rq": Hq // Hkv}, "bfloat16",
                [{"per": c} for c in cands],
                lambda p: lambda: run(_get(p, "per")),
                _plain(torch, lambda: run(None)), heuristic,
                TOL["bfloat16"], graph=True, es=2,
                plan=lambda: {"per": pd.paged_plan(
                    N, Hq, Hkv, 1, D, P, T, torch.bfloat16)[1]},
                flops=4.0 * N * Hq * T * P * D,
                nbytes=float(2 * N * Hkv * T * P * D * 2 + 4 * N * Hq * D))


def case_lora_epilogue(torch, device, tiny):
    """The LoRA delta at a decode step: 8 slots, rank 16, hidden 2048,
    vocab 32000, bf16 rows (LORA_CASES' main case)."""
    from apex1_tpu_torch.ops import lora_epilogue as le
    N, R, H, V = (4, 2, 128, 512) if tiny else (8, 16, 2048, 32000)
    g = _gen(torch, device)
    pages = 1 + 3 * R
    h = torch.randn(N, H, generator=g, device=device).to(torch.bfloat16)
    a = torch.randn(pages, H, generator=g, device=device) * 0.02
    b = torch.randn(pages, V, generator=g, device=device) * 0.02
    bt = (torch.arange(N * R, dtype=torch.int32, device=device)
          .reshape(N, R) % (pages - 1) + 1)
    sms = (torch.cuda.get_device_properties(device).multi_processor_count
           if device != "cpu" else 132)

    def heuristic():
        return {"rows": le.lora_rows(N, V, R, sms)}
    cands = sorted({heuristic()["rows"], 1, 2, 4, 8})
    return Case("lora_epilogue", {"Hp": tuning.padded_lanes(H),
                                  "Vp": tuning.padded_lanes(V)}, "bfloat16",
                [{"rows": c} for c in cands],
                lambda p: lambda: le.lora_delta(h, a, b, bt,
                                                rows=_get(p, "rows")),
                _plain(torch, lambda: le.lora_delta(h, a, b, bt)), heuristic,
                TOL["float32"], graph=True, es=2,
                plan=lambda: {"rows": le.lora_plan(N, H, V, R, h.dtype,
                                                   sms)},
                check_dims={"Hp": H, "Vp": V, "R": R},
                flops=2.0 * N * R * (H + V),
                nbytes=float(2 * N * H + 4 * N * R * (H + V) + 4 * N * V))


def case_fused_swiglu(torch, device, tiny):
    """The fused GLU at the Llama block's MLP (8192 x 4096 x 14336,
    bf16: GLU_CASES' main case), forward only (its backward is plain
    products)."""
    from apex1_tpu_torch.ops import fused_dense as fd
    T, H, F = (64, 128, 256) if tiny else (8192, 4096, 14336)
    g = _gen(torch, device)
    x = (torch.randn(T, H, generator=g, device=device) * 0.5).to(
        torch.bfloat16)
    wg = (torch.randn(H, F, generator=g, device=device) * H ** -0.5).to(
        torch.bfloat16)
    wu = (torch.randn(H, F, generator=g, device=device) * H ** -0.5).to(
        torch.bfloat16)

    def heuristic():
        return {"tile_n": (fd.glu_tile(T, F, torch.bfloat16)[1]
                           if device != "cpu" else 64)}

    def plan():
        return {"tile_n": fd.glu_tile_n(T, H, torch.bfloat16)
                or heuristic()["tile_n"]}
    return Case("fused_swiglu", {"Hp": tuning.padded_lanes(H),
                                 "Tb": tuning.token_bucket(T)}, "bfloat16",
                [{"tile_n": 64}, {"tile_n": 128}],
                lambda p: lambda: fd.glu_fwd(x, wg, wu,
                                             tile_n=_get(p, "tile_n")),
                lambda: fd._plain_glu(x, wg, wu, "silu"), heuristic,
                TOL["bfloat16"], es=2, flops=4.0 * T * H * F, plan=plan,
                nbytes=float(2 * (T * H + 2 * H * F + T * F)))


def case_fused_collective_matmul(torch, device, tiny):
    """The chunk product at the world-1 column product (8192 x 2048 @
    2048 x 8192, bf16 -> fp32: CHUNK_CASES' main case)."""
    from apex1_tpu_torch.ops import fused_collective as fc
    M, K, N = (128, 128, 256) if tiny else (8192, 2048, 8192)
    g = _gen(torch, device)
    a = torch.randn(M, K, generator=g, device=device).to(torch.bfloat16)
    b = (torch.randn(K, N, generator=g, device=device) * 0.02).to(
        torch.bfloat16)

    def heuristic():
        bm, bn = (fc.chunk_tile(M, N, torch.bfloat16) if device != "cpu"
                  else (128, 128))
        return {"block_m": bm, "block_n": bn}

    def plan():
        code = fc.chunk_plan(K, torch.bfloat16)
        return ({"block_m": code // 1000, "block_n": code % 1000} if code
                else heuristic())
    return Case("fused_collective_matmul", {"Kp": tuning.padded_lanes(K)},
                "bfloat16",
                [{"block_m": 128, "block_n": 128},
                 {"block_m": 128, "block_n": 256}],
                lambda p: lambda: fc.chunk_matmul(
                    a, b, tile=None if p is None else (p["block_m"],
                                                      p["block_n"])),
                lambda: fc._plain_chunk_matmul(a, b, None), heuristic,
                TOL["float32"], es=2, flops=2.0 * M * K * N, plan=plan,
                nbytes=float(2 * (M * K + K * N) + 4 * M * N))


def case_chunked_loss(torch, device, tiny):
    """The chunked log-probability at the GPT-2 head (8192 x 768 bf16
    against the padded 50304 x 768 head, 50257 classes: the DPO path),
    forward and backward; the sweep holds the log-probabilities."""
    from apex1_tpu_torch.ops import chunked_loss as cl
    T, H, V, K = (64, 128, 512, 500) if tiny else (8192, 768, 50304, 50257)
    g = _gen(torch, device)
    x = (torch.randn(T, H, generator=g, device=device) * 0.5).to(
        torch.bfloat16).requires_grad_()
    w = (torch.randn(V, H, generator=g, device=device) * 0.02).to(
        torch.bfloat16).requires_grad_()
    t = torch.randint(0, K, (T,), generator=g, device=device)

    def run(cv):
        lp = cl.chunked_logprob(x, w, t, chunk_v=cv, num_classes=K)
        lp.sum().backward()
        return lp.detach()

    def heuristic():
        return {"chunk_v": min(-(-V // 128) * 128, 8192)}
    cands = [256, 512] if tiny else [4096, 8192, 16384, 25216]
    return Case("chunked_loss", {"Hp": tuning.padded_lanes(H)}, "bfloat16",
                [{"chunk_v": c} for c in cands],
                lambda p: lambda: run(_get(p, "chunk_v")),
                _plain(torch, lambda: run(None)), heuristic,
                TOL["float32"], grad=True, es=2,
                plan=lambda: {"chunk_v": cl._auto_chunk(V, None, H,
                                                        torch.bfloat16)},
                flops=8.0 * T * H * V,
                nbytes=float(2 * (3 * V * H + 2 * T * H + V * H)))


def _get(p, key):
    return None if p is None else p[key]


def _plain(torch, fn):
    """``fn`` run on the plain versions (the reference)."""
    from apex1_tpu_torch.ops import force_impl

    def run():
        with force_impl("torch"):
            return fn()
    return run


#: kernel name -> case builder, in the JAX sweep's names
CASES = {
    "int8_matmul": case_int8_matmul,
    "fused_sample": case_fused_sample,
    "paged_decode": case_paged_decode,
    "lora_epilogue": case_lora_epilogue,
    "fused_swiglu": case_fused_swiglu,
    "fused_collective_matmul": case_fused_collective_matmul,
    "chunked_loss": case_chunked_loss,
}


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` reports them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
    except (OSError, subprocess.SubprocessError) as e:
        return f"unknown (nvidia-smi: {type(e).__name__})"
    lines = out.stdout.strip().splitlines()
    return lines[0] if out.returncode == 0 and lines else "unknown"


def compare(torch, got, want, tol) -> tuple[bool, float]:
    """(within tolerance, the worst element's error over its allowance;
    for ids the count of differing ids)."""
    if tol is None:
        bad = float((got != want).sum().item())
        return bad == 0, bad
    rtol, atol = tol
    g, w = got.double(), want.double()
    allow = rtol * w.abs() + atol * w.pow(2).mean().sqrt() + 1e-30
    worst = ((g - w).abs() / allow).max().item()
    return worst <= 1.0, worst


def time_ms(torch, fn, iters: int, graph: bool, device) -> float:
    """ms a call: CUDA events around ``iters`` calls (CUDA-graph replays
    where ``graph``) on the card, the host clock off it."""
    for _ in range(2):
        fn()
    if device == "cpu":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) * 1e3 / iters
    torch.cuda.synchronize()
    if graph:
        s = torch.cuda.Stream()
        s.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(s):
            fn()
        torch.cuda.current_stream().wait_stream(s)
        torch.cuda.synchronize()
        cg = torch.cuda.CUDAGraph()
        with torch.cuda.graph(cg):
            for _ in range(iters):
                fn()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        cg.replay()
        b.record()
        torch.cuda.synchronize()
        del cg
        return a.elapsed_time(b) / iters
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def sweep_case(case: Case, iters: int, say, *, write: bool = True,
               device="cuda", card: str = "") -> tuple:
    """Sweep one case; returns (winner params or None, problems)."""
    import torch

    from apex1_tpu_torch.core.capability import smem_budget
    from apex1_tpu_torch.obs import calibrate, spine
    from apex1_tpu_torch.tuning.registry import SPECS

    spec = SPECS[case.kernel]
    budget = smem_budget()
    say(f"== {case.kernel} dims={case.dims} dtype={case.dtype} "
        f"device={device} [{card}] ==")
    runnable, breakdown = [], []
    for p in case.candidates:
        ok, est = spec.check(p, case.check_dims or case.dims, case.es,
                             budget)
        if ok:
            runnable.append(p)
        else:
            say(f"  drop {p}: budget model {est.smem} B of shared memory "
                f"a block, {est.block_regs} registers (budget {budget} B)")
            breakdown.append({"blocks": dict(p), "status": "budget",
                              "smem_est_bytes": int(est.smem)})
    if not runnable:
        return None, [f"{case.kernel}: no candidate within the budget"]
    want = case.plain()
    results = []
    for p in runnable:
        fn = case.make(p)
        ok, err = compare(torch, fn(), want, case.tol)
        if not ok:
            say(f"  {p}: disagrees with the plain version (worst {err:.3g})")
            breakdown.append({"blocks": dict(p), "status": "wrong",
                              "worst": err})
            continue
        ms = time_ms(torch, fn, iters, case.graph, device)
        say(f"  {p}  {ms:.4f} ms {'fwd+bwd' if case.grad else 'fwd'} "
            f"(worst {err:.3g})")
        results.append((ms, p))
        breakdown.append({"blocks": dict(p), "status": "timed",
                          "time_ms": round(ms, 4)})
        spine.emit("event", "tune.candidate", kernel=case.kernel,
                   blocks=dict(p), time_ms=round(ms, 4))
    if not results:
        return None, [f"{case.kernel}: every candidate disagreed"]
    ms, best = min(results, key=lambda r: r[0])
    say(f"  WINNER {best}  {ms:.4f} ms (today's heuristic "
        f"{case.heuristic()})")
    if not write:
        return best, []
    gen = tuning.canonical_generation(None)
    extra = {"device": card, "sweep": {"iters": iters,
                                       "grad": bool(case.grad),
                                       "candidates": breakdown}}
    if case.flops is not None and case.nbytes is not None:
        extra["predicted"] = {
            "ms": round(calibrate.roofline_ms(case.flops, case.nbytes, gen),
                        6),
            "flops": case.flops, "bytes": case.nbytes, "generation": gen}
    key, _ = tuning.record(case.kernel, case.dims, case.dtype, best,
                           time_ms=ms, extra=extra)
    path = tuning.save(case.kernel)
    tuning.clear_cache()
    got = tuning.lookup(case.kernel, case.dims, case.dtype)
    if got != best:
        return best, [f"{case.kernel}: a fresh lookup returned {got}, "
                      f"expected {best}"]
    say(f"  banked {key} -> {path} (lookup verified)")
    return best, []


def sweep_one(name: str, iters: int, say, *, write: bool = True,
              device="cuda", card: str = "") -> tuple:
    """Build ``name``'s case and sweep it: (winner, problems, case)."""
    import torch
    case = CASES[name](torch, device, device == "cpu")
    best, problems = sweep_case(case, iters, say, write=write,
                                device=device, card=card)
    return best, problems, case


def validate(say) -> list:
    import os

    d = tuning.default_tuning_dir()
    problems = tuning.validate_tables(d)
    n = len([f for f in (os.listdir(d) if os.path.isdir(d) else ())
             if f.endswith(".json")])
    say(f"tuning tables: {n} file(s) under {d}")
    for p in problems:
        say(f"  INVALID {p}")
    say("tuning tables OK" if not problems
        else f"{len(problems)} invalid entries or files")
    return problems


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m apex1_tpu_torch.tuning.sweep")
    ap.add_argument("--kernel", default="all",
                    choices=sorted(CASES) + ["all"])
    ap.add_argument("--iters", type=int, default=None,
                    help="calls timed a candidate (default 20, 2 on cpu)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card) or cpu (tiny plumbing run)")
    ap.add_argument("--no-write", action="store_true",
                    help="measure only; leave the tables as they are")
    ap.add_argument("--validate", action="store_true",
                    help="check every table strictly; sweep nothing")
    args = ap.parse_args(argv)
    if args.validate:
        return 1 if validate(print) else 0
    import torch
    if args.device != "cpu" and not torch.cuda.is_available():
        print("no CUDA device: the sweep times on the card (--device cpu "
              "runs the plumbing)", file=sys.stderr)
        return 1
    card = card_line() if args.device != "cpu" else "cpu"
    names = sorted(CASES) if args.kernel == "all" else [args.kernel]
    iters = args.iters or (2 if args.device == "cpu" else 20)
    print(f"sweep device={args.device} kernels={names} iters={iters} "
          f"[{card}]")
    problems = []
    for name in names:
        problems += sweep_one(name, iters, print, write=not args.no_write,
                              device=args.device, card=card)[1]
    print("SWEEP DONE" + (f" ({len(problems)} problems: {problems})"
                          if problems else ": every winner banked"))
    return 1 if problems else 0


if __name__ == "__main__":
    sys.exit(main())
