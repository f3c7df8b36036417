#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`apex1_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the root of a checkout
    python3 chip_smoke.py --profile  # build, then profile decode steps

Phases, each printed on its own line; a failure in any exits non-zero:

1. build — compile the port's CUDA kernels from ``apex1_tpu_torch/csrc``
   (one ``nvcc`` per source, in parallel) and print the build seconds.
2. kernels — hold each kernel against its plain PyTorch version on the
   card at the serving path's shapes, with the stated tolerance; print
   errors, kernel / plain / library-yardstick times and the bound.
3. engine — serve GPT-2 124M at full width (12 layers, hidden 768,
   vocab 50257 padded to 50304) at policy O2, weights made from a seed,
   through the paged continuous-batching engine: 16 requests (prompts
   of 32-512 tokens, four sharing a prefix) over 8 slots, 64 new tokens
   each at temperature 0.7. Every request must end done with 64 tokens,
   and every kernel's launch count must be above 0 and equal the count
   the engine's forwards imply.
4. parity — the same workload at O0 (fp32), depth 2, once through the
   kernels and once through the plain versions on the card: the token
   streams must be identical.
5. the ``kernels`` JSON line, the card's name and power limit, and the
   last line ``{"ok": true, "device": {...}}``.

Times are device times of CUDA-graph replays (no host launch overhead)
unless named wall. It imports nothing of JAX. Without a CUDA device, or
run from a directory that holds no ``apex1_tpu_torch``, it exits
non-zero and prints no result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

#: published peaks of one H100 SXM (NVIDIA's data sheet, dense rates)
HBM_BYTES_PER_S = 3.35e12        # HBM3
F32_OPS_PER_S = 67e12            # fp32, outside the tensor cores
BF16_OPS_PER_S = 989e12          # bf16 / fp16 on the tensor cores
SEED = 1234


def fail(msg: str) -> int:
    print(f"FAIL: {msg}", file=sys.stderr)
    return 1


def gpu_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        else "unknown (nvidia-smi failed)"


def graph_ms(fn, iters: int = 50, reps: int = 5) -> float:
    """Device ms per call of ``fn``: ``iters`` calls captured in one
    CUDA graph, replayed ``reps`` times; the median replay over
    ``iters``."""
    import torch
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(s)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(iters):
            fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        g.replay()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / iters)
    del g
    return sorted(times)[len(times) // 2]


def bound_ms(nbytes: float, ops: float, ops_per_s: float = F32_OPS_PER_S):
    """The least time for the work: bytes over the memory rate or
    operations over ``ops_per_s`` (the peak for their operand type),
    whichever is longer."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


#: (rtol, atol) per output dtype: element i passes when
#: |got - want| <= rtol * |want_i| + atol * rms(want). rtol 2^-7 is one
#: bf16 ulp; rms(want) is the output's typical magnitude, so atol reads
#: as a share of a typical value, not of the largest one.
TOLS = {"float32": (1e-5, 1e-4), "bfloat16": (2.0 ** -7, 3e-2)}


def max_errs(got, want, rtol: float, atol: float):
    """(max |got - want|, the worst element's error over its allowance):
    within tolerance when the second is at most 1."""
    got, want = got.double(), want.double()
    diff = (got - want).abs()
    allow = rtol * want.abs() + atol * want.pow(2).mean().sqrt()
    return diff.max().item(), (diff / allow).max().item()


# ---- phase 2: kernels against their plain versions ----------------------


def check_layer_norm(torch, ops, gen):
    from apex1_tpu_torch.ops.layer_norm import layer_norm
    H = 768
    results = []
    for rows in (8, 16 * 64):
        for dt in (torch.float32, torch.bfloat16):
            x = (torch.randn(rows, H, generator=gen) * 2 + 0.5).cuda().to(dt)
            g = (1 + 0.1 * torch.randn(H, generator=gen)).cuda()
            b = (0.1 * torch.randn(H, generator=gen)).cuda()
            got = layer_norm(x, g, b)
            with ops.force_impl("torch"):
                want = layer_norm(x, g, b)
            torch.cuda.synchronize()
            tol = TOLS[str(dt)[6:]]
            abs_e, worst = max_errs(got, want, *tol)
            ms = graph_ms(lambda: layer_norm(x, g, b))
            with ops.force_impl("torch"):
                plain = graph_ms(lambda: layer_norm(x, g, b))
            gl, bl = g.to(dt), b.to(dt)
            lib = graph_ms(lambda: torch.nn.functional.layer_norm(
                x, (H,), gl, bl, 1e-5))
            eb = x.element_size()
            bnd, by = bound_ms(2 * rows * H * eb + 2 * H * 4 + 2 * rows * 4,
                               8 * rows * H)
            results.append(dict(case=f"rows={rows} H={H} {str(dt)[6:]}",
                                abs=abs_e, worst=worst, tol=tol, ms=ms,
                                plain_ms=plain, library_ms=lib,
                                bound_ms=bnd, bound_by=by,
                                main=(rows == 8 and dt == torch.bfloat16)))
    return results


def check_paged_attend(torch, ops, gen):
    from apex1_tpu_torch.ops.paged_decode import paged_attend
    N, D, P, T = 8, 64, 64, 17          # the engine's pages: 1087 / 64
    n_pages = 1 + (8 + 32) * T
    results = []
    cases = [(12, 12, 1, "float32"), (12, 12, 1, "bfloat16"),
             (12, 12, 1, "int8"), (12, 12, 64, "float32"),
             (12, 12, 64, "bfloat16"), (12, 12, 64, "int8"),
             (12, 4, 1, "bfloat16")]
    perm = torch.randperm(n_pages - 1, generator=gen)[:N * T] + 1
    bt = perm.reshape(N, T).to(torch.int32).cuda()
    for hq, hkv, S, pdt in cases:
        lens = torch.randint(32, T * P - S - 1, (N,), generator=gen)
        raw = torch.randn(2, n_pages, hkv, P, D, generator=gen)
        q = torch.randn(N, hq, S, D, generator=gen)
        if pdt == "int8":
            # K at 30x scale, q at 1/30: the scores keep unit spread, so
            # the softmax folds over many positions across pages
            kv = (raw * 30).round().clamp(-127, 127).to(torch.int8).cuda()
            q, q_dt = q / 30, torch.bfloat16
        else:
            kv = raw.to(getattr(torch, pdt)).cuda()
            q_dt = getattr(torch, pdt)
        q = q.to(q_dt).cuda()
        k, v = kv[0].contiguous(), kv[1].contiguous()
        L = lens.to(torch.int32).cuda()

        def run():
            return paged_attend(q, k, v, bt, L, total_len=T * P)

        got = run()
        with ops.force_impl("torch"):
            want = run()
        torch.cuda.synchronize()
        tol = TOLS[str(q_dt)[6:]]
        abs_e, worst = max_errs(got, want, *tol)
        ms = graph_ms(run, iters=20)
        with ops.force_impl("torch"):
            plain = graph_ms(run, iters=5)
        # bytes: q and out once, K and V up to each row's horizon
        # (len + S positions), the block table and lengths; ops: QK and
        # PV, 2 flops each per (query row, visible position, d), where
        # chunk query j sees len + j + 1 positions. The products are
        # bf16 x bf16 (int8 pages convert to bf16 exactly) on the tensor
        # cores, or fp32 x fp32 off them (TF32 is off)
        seen = (lens + S).sum().item()
        kv_bytes = 2 * seen * hkv * D * k.element_size()
        nbytes = (2 * q.numel() * q.element_size() + kv_bytes
                  + bt.numel() * 4 + N * 4)
        visible = (S * lens + S * (S + 1) // 2).sum().item()
        flops = 4 * hq * visible * D
        bnd, by = bound_ms(nbytes, flops, F32_OPS_PER_S
                           if q_dt == torch.float32 else BF16_OPS_PER_S)
        results.append(dict(
            case=f"N={N} Hq={hq} Hkv={hkv} S={S} D={D} P={P} {pdt} pages",
            abs=abs_e, worst=worst, tol=tol, ms=ms, plain_ms=plain,
            library_ms=None, bound_ms=bnd, bound_by=by,
            main=(S == 1 and pdt == "bfloat16" and hq == hkv)))
    return results


#: integer and float operations per vocab entry when sampling: a
#: 20-round threefry-2x32 block (~125), the gumbel transform (~10) and
#: two logf (~25)
SAMPLE_OPS = 160


def check_fused_sample(torch, ops, gen):
    from apex1_tpu_torch.ops.paged_decode import fused_sample
    R, V, v_eff = 8, 50304, 50257
    lg = (torch.randn(R, V, generator=gen) * 3).cuda()
    seeds = torch.randint(0, 2**31 - 1, (R,), generator=gen).to(
        torch.int32).cuda()
    pos = torch.randint(0, 1024, (R,), generator=gen).to(torch.int32).cuda()
    results = []
    for temp in (0.0, 0.7):
        def run():
            return fused_sample(lg, seeds, pos, temperature=temp,
                                vocab_size=v_eff)

        got = run()
        with ops.force_impl("torch"):
            want = run()
        torch.cuda.synchronize()
        mism = int((got != want).sum().item())
        ms = graph_ms(run)
        with ops.force_impl("torch"):
            plain = graph_ms(run, iters=10)
        lib = (graph_ms(lambda: torch.argmax(lg[:, :v_eff], dim=-1))
               if temp == 0.0 else None)
        ops_n = R * V * (1 if temp == 0.0 else SAMPLE_OPS)
        bnd, by = bound_ms(R * V * 4 + 3 * R * 4, ops_n)
        results.append(dict(case=f"R={R} V={V} vocab={v_eff} T={temp}",
                            abs=float(mism), worst=float(mism), tol=None,
                            ms=ms, plain_ms=plain, library_ms=lib,
                            bound_ms=bnd, bound_by=by, main=temp == 0.7))
    return results


# ---- phases 3 and 4: the engine -----------------------------------------


def workload(vocab: int, seed: int):
    """16 requests: prompt lengths 32-512 from the seed, the first four
    sharing a 192-token prefix; 64 new tokens each."""
    import numpy as np
    rng = np.random.default_rng(seed)
    shared = rng.integers(1, vocab, 192).astype(np.int32)
    reqs = []
    for i in range(16):
        n = int(rng.integers(32, 513))
        own = rng.integers(1, vocab, n).astype(np.int32)
        if i < 4:
            # 200-255 tokens: the chunk-aligned share point (the radix
            # cache's auto-registration length) is the shared 192
            own = np.concatenate([shared, own[:8 + n % 56]])
        reqs.append(dict(tokens=own, seed=1000 + i))
    return reqs


def serve(torch, cfg_kw, *, depth, policy, seed, device="cuda"):
    """Build GPT-2 (full width, ``depth`` layers) from ``seed`` and serve
    the workload on ``device``; returns (token streams, engine, wall s,
    decode-only step wall ms, config)."""
    from apex1_tpu_torch import (Engine, EngineConfig, GPT2Config,
                                 get_policy, gpt2_decoder,
                                 gpt2_params_from_jax)
    from apex1_tpu_torch.models.gpt2 import init_params
    cfg = GPT2Config.gpt2_125m(num_layers=depth, policy=get_policy(policy))
    model = gpt2_params_from_jax(init_params(cfg, seed), cfg, device)
    apply_fn, make_cache = gpt2_decoder(model)
    eng = Engine(apply_fn, make_cache, EngineConfig(**cfg_kw),
                 device=device)
    reqs = workload(cfg.vocab_size, seed)
    ids = [eng.submit(r["tokens"], max_new_tokens=64, seed=r["seed"])
           for r in reqs]
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    sync()
    step_ms = []
    t0 = time.perf_counter()
    while eng.scheduler.depth > 0 or any(s is not None
                                         for s in eng.slot_view()):
        chunks = eng.metrics.get_counter("prefill_chunks")
        ts = time.perf_counter()
        eng.step()
        if eng.metrics.get_counter("prefill_chunks") == chunks:
            step_ms.append((time.perf_counter() - ts) * 1e3)
    sync()
    wall = time.perf_counter() - t0
    streams = [[int(t) for t in eng.results[r].tokens] for r in ids]
    return streams, eng, wall, step_ms, cfg


ENGINE_KW = dict(paged=True, max_slots=8, max_len=1024, prefill_chunk=64,
                 vocab_size=50257, temperature=0.7)


def profile_decode(torch, steps: int = 10) -> dict:
    """``--profile``: where a full-batch decode step's time goes. Eight
    requests (256-token prompts) are admitted, then ``steps`` decode
    steps of GPT-2 124M at O2 run under torch.profiler. Returns the
    step's host wall, the device kernel time per step (the sum of the
    kernels' own device time), the device busy share, and the kernels
    with the most device time."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile
    from apex1_tpu_torch import (Engine, EngineConfig, GPT2Config,
                                 get_policy, gpt2_decoder,
                                 gpt2_params_from_jax)
    from apex1_tpu_torch.models.gpt2 import init_params
    cfg = GPT2Config.gpt2_125m(policy=get_policy("O2"))
    model = gpt2_params_from_jax(init_params(cfg, SEED), cfg)
    apply_fn, make_cache = gpt2_decoder(model)
    eng = Engine(apply_fn, make_cache, EngineConfig(**ENGINE_KW))
    rng = np.random.default_rng(SEED)
    for i in range(8):
        eng.submit(rng.integers(1, cfg.vocab_size, 256).astype(np.int32),
                   max_new_tokens=8 + steps + 4, seed=i)
    for _ in range(4):                   # admit all eight, then warm up
        eng.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / steps * 1e3
    # device-side entries only: the kernels themselves, not the CPU ops
    # that launched them (their device time would count twice) nor the
    # user annotations, whose device span is the whole step
    rows = [(e.key, e.self_device_time_total / 1e3 / steps, e.count // steps)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and not e.key.startswith("serving/")
            and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    device = sum(r[1] for r in rows)
    return {"active": eng.n_active, "step_wall_ms": wall,
            "device_ms_per_step": device, "device_busy": device / wall,
            "top": [{"name": k[:80], "ms_per_step": ms, "calls": c}
                    for k, ms, c in rows[:12]]}


def main() -> int:
    try:
        import torch
    except ImportError:
        return fail("torch is not installed")
    if not torch.cuda.is_available():
        return fail("no CUDA device: chip_smoke.py runs on the GPU")
    if not os.path.isdir(os.path.join(HERE, "apex1_tpu_torch")):
        return fail("apex1_tpu_torch/ is not beside chip_smoke.py; run it "
                    "from the root of a checkout")
    sys.stdout.reconfigure(line_buffering=True)
    sys.path.insert(0, HERE)
    import apex1_tpu_torch.ops as ops
    from apex1_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = gpu_line()
    print(f"card: {card}; torch {torch.__version__} CUDA "
          f"{torch.version.cuda}; python {sys.version.split()[0]}")

    # 1. build
    t0 = time.perf_counter()
    _build.library()
    print(f"phase build: ok, {time.perf_counter() - t0:.1f} s wall "
          f"[{card}]")
    for line in _build.build_log().splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")

    if "--profile" in sys.argv[1:]:
        prof = profile_decode(torch)
        os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
        with open(os.path.join(HERE, "chiprun_out", "profile.json"),
                  "w") as f:
            json.dump({"card": card, **prof}, f, indent=1)
        print(f"phase profile: {json.dumps(prof)} [{card}]")
        return 0

    # 2. kernels against their plain versions
    gen = torch.Generator().manual_seed(SEED)
    checks = {"layer_norm_fwd": check_layer_norm(torch, ops, gen),
              "paged_attend": check_paged_attend(torch, ops, gen),
              "fused_sample": check_fused_sample(torch, ops, gen)}
    bad = []
    for name, rows in checks.items():
        for r in rows:
            # a tolerance (rtol, atol) bounds the worst element's error
            # over its allowance by 1; sampled ids (tol None) must match
            ok = r["worst"] <= 1 if r["tol"] else r["abs"] == 0
            lib = ("-" if r["library_ms"] is None
                   else f"{r['library_ms']:.4f}")
            tol = (f"rtol={r['tol'][0]:g} atol={r['tol'][1]:g}*rms"
                   if r["tol"] else "ids exact")
            print(f"phase kernels: {name} [{r['case']}] "
                  f"max_abs={r['abs']:.3g} worst/allowed={r['worst']:.3g} "
                  f"{tol} ms={r['ms']:.4f} "
                  f"plain_ms={r['plain_ms']:.4f} library_ms={lib} "
                  f"bound_ms={r['bound_ms']:.4f} ({r['bound_by']}) "
                  f"{'ok' if ok else 'MISMATCH'} [{card}]")
            if not ok:
                bad.append(f"{name} {r['case']}")
    if bad:
        return fail(f"kernels disagree with their plain versions: {bad}")

    # 3. the engine: GPT-2 124M, O2, through the kernels
    ops.reset_launches()
    streams, eng, wall, step_ms, cfg = serve(torch, ENGINE_KW, depth=12,
                                             policy="O2", seed=SEED)
    launches = ops.launch_counts()
    summ = eng.metrics.summary()
    n_fwd = (eng.metrics.get_counter("prefill_chunks")
             + eng.metrics.get_counter("decode_steps"))
    L = cfg.num_layers
    expect = {"layer_norm_fwd": n_fwd * (2 * L + 1),
              "paged_attend": n_fwd * L, "fused_sample": n_fwd}
    n_tok = sum(len(s) for s in streams)
    statuses = {r.status for r in eng.results.values()}
    print(f"phase engine: GPT-2 124M O2 width {cfg.hidden_size} layers {L} "
          f"vocab {cfg.vocab_size}/{cfg.padded_vocab}; "
          f"{len(streams)} requests, {n_tok} tokens generated, "
          f"wall {wall:.2f} s, {n_tok / wall:.1f} tok/s, "
          f"mean decode-step wall {sum(step_ms) / len(step_ms):.2f} ms "
          f"over {len(step_ms)} steps, "
          f"prefill chunks {eng.metrics.get_counter('prefill_chunks')}, "
          f"decode steps {eng.metrics.get_counter('decode_steps')}, "
          f"prefix hit rate {summ.get('prefix_hit_rate', 0):.3f}, "
          f"ttft p50 {summ.get('ttft_p50_ms', 0):.1f} ms [{card}]")
    print(f"phase engine: launches {launches} expected {expect} "
          f"[{card}]")
    if statuses != {"done"} or any(len(s) != 64 for s in streams):
        return fail(f"engine: statuses {statuses}, lengths "
                    f"{sorted({len(s) for s in streams})}")
    for name, n in launches.items():
        if n <= 0 or n != expect[name]:
            return fail(f"engine: {name} launched {n} times, expected "
                        f"{expect[name]}")
    for s in streams:
        if min(s) < 0 or max(s) >= cfg.vocab_size:
            return fail("engine: a token outside the vocabulary")

    # 4. parity: kernels against the plain versions, O0, depth 2
    kern, _, kwall, _, _ = serve(torch, ENGINE_KW, depth=2, policy="O0",
                                 seed=SEED + 1)
    with ops.force_impl("torch"):
        plain, _, pwall, _, _ = serve(torch, ENGINE_KW, depth=2,
                                      policy="O0", seed=SEED + 1)
    diff = sum(a != b for a, b in zip(kern, plain))
    print(f"phase parity: O0 depth 2, {len(kern)} requests, kernel wall "
          f"{kwall:.2f} s, plain wall {pwall:.2f} s, streams differing "
          f"{diff} [{card}]")
    if diff:
        return fail(f"parity: {diff} token streams differ between the "
                    f"kernels and the plain versions")

    # 5. the kernels line, the card, the last line
    sources = {"layer_norm_fwd": ("apex1_tpu_torch/csrc/layer_norm.cu",
                                  "apex1_tpu/ops/layer_norm.py:110"),
               "paged_attend": ("apex1_tpu_torch/csrc/paged_attend.cu",
                                "apex1_tpu/ops/paged_decode.py:529"),
               "fused_sample": ("apex1_tpu_torch/csrc/fused_sample.cu",
                                "apex1_tpu/ops/paged_decode.py:300")}
    kernels = []
    for name, rows in checks.items():
        main_row = next(r for r in rows if r["main"])
        kernels.append({
            "name": name, "route": "cuda", "source": sources[name][0],
            "replaces": sources[name][1], "launches": launches[name],
            "max_abs_err": max(r["abs"] for r in rows),
            "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
            "bound_ms": main_row["bound_ms"],
            "bound_by": main_row["bound_by"],
            "library_ms": main_row["library_ms"]})
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "chip_smoke.json"),
              "w") as f:
        json.dump({"card": card, "checks": checks, "kernels": kernels,
                   "engine": {"wall_s": wall, "tokens": n_tok,
                              "step_ms": step_ms, "summary": summ}},
                  f, indent=1, default=str)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
