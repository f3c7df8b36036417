#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`apex1_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the root of a checkout
    python3 chip_smoke.py --profile  # build, then profile decode steps
                                     # and training steps

Phases, each printed on its own line; a failure in any exits non-zero:

1. build — compile the port's CUDA kernels from ``apex1_tpu_torch/csrc``
   (one ``nvcc`` per source, in parallel) and print the build seconds.
2. kernels — hold each kernel against its plain PyTorch version on the
   card at the shapes its main path gives it (serving's and the
   training step's), with the stated tolerance; print errors, kernel /
   plain / library-yardstick times and the bound.
3. engine — serve GPT-2 124M at full width (12 layers, hidden 768,
   vocab 50257 padded to 50304) at policy O2, weights made from a seed,
   through the paged continuous-batching engine: 16 requests (prompts
   of 32-512 tokens, four sharing a prefix) over 8 slots, 64 new tokens
   each at temperature 0.7. Every request must end done with 64 tokens,
   and every serving kernel's launch count must equal the count the
   engine's forwards imply (the training kernels 0).
4. parity — the same workload at O0 (fp32), depth 2, once through the
   kernels and once through the plain versions on the card: the token
   streams must be identical.
5. train — GPT-2 124M at full width (``use_flash=False``: materialized
   scores through the fused causal softmax; ``fuse_head=False``: fp32
   logits through the fused cross-entropy) trained at B=16 x S=1024
   under ``Amp(fused_adam(1e-4, weight_decay=0.01))``, 6 steps at O2
   and 6 at O2_fp16 (dynamic loss scale from 2^16). Every loss must be
   finite, the O2 loss must fall from step 1 to step 6, and every step
   must launch LayerNorm fwd and bwd 25 times, softmax fwd and bwd 12,
   cross-entropy fwd and bwd once.
6. train-parity — depth 2, full width, 3 steps through the kernels and
   through the plain versions: O0 losses within 1e-5 relative and grad
   norms within 1e-4; O2_fp16 with the loss multiplied by inf at step
   2 on both sides: step 2 skipped, the params it leaves equal to step
   1's bit for bit, the scale halved, skipped_steps 1.
7. the ``kernels`` JSON line (each kernel's launches: the serving and
   training runs together), the card's name and power limit, and the
   last line ``{"ok": true, "device": {...}}``.

Kernel times are device times of CUDA-graph replays (no host launch
overhead), or between CUDA events for kernels of a millisecond or more;
step and request times are host wall times ending in a synchronize.
It imports nothing of JAX. Without a CUDA device, or run from a
directory that holds no ``apex1_tpu_torch``, it exits non-zero and
prints no result.
"""

from __future__ import annotations

import json
import math
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
#: GPT-2 124M training shapes: B x S tokens, hidden, heads, vocab and
#: padded vocab
TB, TS, TH, THEADS, TV, TV_PAD = 16, 1024, 768, 12, 50257, 50304


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
TOLS = {"float32": (1e-5, 1e-4), "bfloat16": (2.0 ** -7, 3e-2),
        "float16": (2.0 ** -10, 1e-2)}


def max_errs(got, want, rtol: float, atol: float):
    """(max |got - want|, the worst element's error over its allowance):
    within tolerance when the second is at most 1."""
    got, want = got.double(), want.double()
    diff = (got - want).abs()
    allow = rtol * want.abs() + atol * want.pow(2).mean().sqrt()
    return diff.max().item(), (diff / allow).max().item()


def max_errs_all(pairs, tol):
    """`max_errs` over several (got, want) outputs: the largest of each."""
    errs = [max_errs(g, w, *tol) for g, w in pairs]
    return max(e[0] for e in errs), max(e[1] for e in errs)


def event_ms(fn, iters: int = 10) -> float:
    """Device ms per call of ``fn`` between two CUDA events around
    ``iters`` calls, after two warm-up calls: for kernels of a
    millisecond or more, whose launches the host keeps ahead of."""
    import torch
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


# ---- phase 2: kernels against their plain versions ----------------------


def check_layer_norm(torch, ops, gen):
    from apex1_tpu_torch.ops.layer_norm import layer_norm
    H = 768
    results = []
    # serving (fp32 γ/β) at decode and prefill rows; training's B*S rows
    # with half γ/β, the amp compute params
    cases = [(8, torch.float32, False), (8, torch.bfloat16, False),
             (16 * 64, torch.float32, False), (16 * 64, torch.bfloat16, False),
             (TB * TS, torch.bfloat16, True), (TB * TS, torch.float16, True)]
    for rows, dt, half_g in cases:
        x = (torch.randn(rows, H, generator=gen) * 2 + 0.5).cuda().to(dt)
        g = (1 + 0.1 * torch.randn(H, generator=gen)).cuda()
        b = (0.1 * torch.randn(H, generator=gen)).cuda()
        if half_g:
            g, b = g.to(dt), b.to(dt)
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
        bnd, by = bound_ms(2 * rows * H * eb + 2 * H * g.element_size()
                           + 2 * rows * 4, 8 * rows * H)
        results.append(dict(case=f"rows={rows} H={H} {str(dt)[6:]}"
                            + (" half γ/β" if half_g else ""),
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


def check_layer_norm_bwd(torch, ops, gen):
    """Kernel 2 at the training step's (B*S, 768) rows: half x and dy
    with half γ (the amp compute params), and f32."""
    from apex1_tpu_torch.ops.layer_norm import layer_norm_bwd, layer_norm_fwd
    R, H = TB * TS, TH
    results = []
    for dt in (torch.bfloat16, torch.float16, torch.float32):
        x = (torch.randn(R, H, generator=gen, device="cuda") * 2
             + 0.5).to(dt)
        dy = torch.randn(R, H, generator=gen, device="cuda").to(dt)
        g = (1 + 0.1 * torch.randn(H, generator=gen, device="cuda")).to(dt)
        b = (0.1 * torch.randn(H, generator=gen, device="cuda")).to(dt)
        _, mean, rstd = layer_norm_fwd(x, g, b, 1e-5, False)

        def run():
            return layer_norm_bwd(dy, x, g, mean, rstd, False, True)

        got = run()
        with ops.force_impl("torch"):
            want = run()
        torch.cuda.synchronize()
        tol = TOLS[str(dt)[6:]]
        abs_e, worst = max_errs_all(zip(got, want), tol)
        ms = graph_ms(run)
        with ops.force_impl("torch"):
            plain = graph_ms(run, iters=10)
        m2, r2 = mean[:, None], rstd[:, None]
        lib = graph_ms(lambda: torch.ops.aten.native_layer_norm_backward(
            dy, x, [H], m2, r2, g, b, [True, True, True]))
        eb, gb = x.element_size(), g.element_size()
        # x, dy read and dx written; γ read, dγ and dβ written; mean and
        # rstd read; about 12 flops per element
        bnd, by = bound_ms(3 * R * H * eb + 3 * H * gb + 2 * R * 4,
                           12 * R * H)
        results.append(dict(case=f"rows={R} H={H} {str(dt)[6:]} x, dy, γ",
                            abs=abs_e, worst=worst, tol=tol, ms=ms,
                            plain_ms=plain, library_ms=lib, bound_ms=bnd,
                            bound_by=by, main=dt == torch.bfloat16))
    return results


def check_softmax(torch, ops, gen):
    """Kernels 16 and 17 at the training step's (16, 12, 1024, 1024)
    fp32 scores: causal (the GPT-2 path) and with a broadcast
    (B, 1, 1, Sk) key-padding mask."""
    from apex1_tpu_torch.ops.softmax import softmax_bwd, softmax_fwd
    shape = (TB, THEADS, TS, TS)
    n = TB * THEADS * TS * TS
    scale = 1.0 / 8.0
    x = torch.randn(shape, generator=gen, device="cuda") * 4
    dy = torch.randn(shape, generator=gen, device="cuda")
    pad = torch.rand((TB, 1, 1, TS), generator=gen, device="cuda") < 0.1
    mask = torch.where(pad, -1e30, 0.0)
    fwd, bwd = [], []
    for causal in (True, False):
        m4 = None if causal else mask

        def run():
            return softmax_fwd(x, m4, scale, causal)

        got = run()
        with ops.force_impl("torch"):
            want = run()
        torch.cuda.synchronize()
        tol = TOLS["float32"]
        abs_e, worst = max_errs(got, want, *tol)
        ms = event_ms(run)
        with ops.force_impl("torch"):
            plain = event_ms(run, iters=3)
        if causal:
            keep = torch.ones(TS, TS, dtype=torch.bool,
                              device="cuda").tril()
            pre = torch.where(keep, x * scale, -1e30)
        else:
            pre = x * scale + mask
        lib = event_ms(lambda: torch.softmax(pre, dim=-1))
        # causal: only the lower triangle of x is needed; a mask is read
        # at its own (broadcast) size
        n_read = TB * THEADS * TS * (TS + 1) // 2 if causal else n
        mbytes = 0 if causal else mask.numel() * 4
        bnd, by = bound_ms((n_read + n) * 4 + mbytes, 5 * n)
        fwd.append(dict(case=("causal" if causal else "mask (B,1,1,Sk)")
                        + f" {shape} f32", abs=abs_e, worst=worst, tol=tol,
                        ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bnd,
                        bound_by=by, main=causal))

        def run_b():
            return softmax_bwd(want, dy, scale)

        got = run_b()
        with ops.force_impl("torch"):
            want_b = run_b()
        torch.cuda.synchronize()
        abs_e, worst = max_errs(got, want_b, *tol)
        ms = event_ms(run_b)
        with ops.force_impl("torch"):
            plain = event_ms(run_b, iters=3)
        # the library's backward lacks the scale: it computes dx / scale
        lib = event_ms(lambda: torch._softmax_backward_data(
            dy, want, -1, torch.float32))
        bnd, by = bound_ms(3 * n * 4, 4 * n)
        bwd.append(dict(case=("causal" if causal else "mask (B,1,1,Sk)")
                        + f" {shape} f32", abs=abs_e, worst=worst, tol=tol,
                        ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bnd,
                        bound_by=by, main=causal))
        del got, want, want_b
    return fwd, bwd


def check_xent(torch, ops, gen):
    """Kernels 18 and 19 at the training step's logits[:, :-1] slice of
    (16, 1024, 50304) fp32 logits, 50257 real classes: smoothing 0 (the
    GPT-2 path) and 0.1, and a padding_idx."""
    import torch.nn.functional as F
    from apex1_tpu_torch.ops.xentropy import xent_bwd, xent_fwd
    full = torch.randn((TB, TS, TV_PAD), generator=gen, device="cuda") * 2
    x = full[:, :-1]
    rows = TB * (TS - 1)
    t = torch.randint(0, TV, (rows,), generator=gen, device="cuda")
    t_pad = t.clone()
    t_pad[::5] = 0
    dloss = torch.full((rows,), 1.0 / rows, device="cuda")
    # the library call gets the real classes as one dense tensor, made
    # outside its timing
    xl = x.reshape(rows, TV_PAD)[:, :TV].contiguous()
    fwd, bwd = [], []
    for smoothing, pad in ((0.0, None), (0.1, None), (0.0, 0)):
        lab = t if pad is None else t_pad
        tol = TOLS["float32"]
        case = f"rows={rows} V={TV_PAD} K={TV} eps={smoothing} pad={pad}"
        main = smoothing == 0.0 and pad is None

        def run():
            return xent_fwd(x, lab, smoothing, pad, TV)

        got = run()
        with ops.force_impl("torch"):
            want = run()
        torch.cuda.synchronize()
        abs_e, worst = max_errs_all(zip(got, want), tol)
        ms = event_ms(run)
        with ops.force_impl("torch"):
            plain = event_ms(run, iters=3)
        lib = None
        if main:
            lib = event_ms(lambda: F.cross_entropy(xl, lab,
                                                   reduction="none"))
        # the first K columns of each row read once, the label read, loss
        # and lse written; about 6 flops per element
        bnd, by = bound_ms(rows * TV * 4 + rows * 8 + rows * 8,
                           6 * rows * TV)
        fwd.append(dict(case=case, abs=abs_e, worst=worst, tol=tol, ms=ms,
                        plain_ms=plain, library_ms=lib, bound_ms=bnd,
                        bound_by=by, main=main))
        lse = want[1]

        def run_b():
            return xent_bwd(x, lab, lse, dloss, smoothing, pad, TV)

        got_b = run_b()
        with ops.force_impl("torch"):
            want_b = run_b()
        torch.cuda.synchronize()
        abs_e, worst = max_errs(got_b, want_b, *tol)
        ms = event_ms(run_b)
        with ops.force_impl("torch"):
            plain = event_ms(run_b, iters=3)
        lib = None
        if main:
            xr = xl.detach().requires_grad_()
            loss = F.cross_entropy(xr, lab, reduction="none")
            lib = event_ms(lambda: torch.autograd.grad(
                loss, xr, dloss, retain_graph=True))
            del xr, loss
        # K columns and the label, lse, dloss read; every dx column
        # written
        bnd, by = bound_ms(rows * TV * 4 + rows * 12 + rows * TV_PAD * 4,
                           5 * rows * TV)
        bwd.append(dict(case=case, abs=abs_e, worst=worst, tol=tol, ms=ms,
                        plain_ms=plain, library_ms=lib, bound_ms=bnd,
                        bound_by=by, main=main))
        del got, want, got_b, want_b
    return fwd, bwd


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
    return {"active": eng.n_active, **kernel_split(torch, prof, steps,
                                                   wall)}


def kernel_split(torch, prof, steps: int, wall: float, top: int = 12):
    """Per step: host wall, the device kernel time (the sum of the
    kernels' own device time), the device busy share, and the kernels
    with the most device time. Device-side entries only: the kernels
    themselves, not the CPU ops that launched them (their device time
    would count twice) nor the user annotations, whose device span is
    the whole step."""
    rows = [(e.key, e.self_device_time_total / 1e3 / steps, e.count // steps)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and not e.key.startswith("serving/")
            and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    device = sum(r[1] for r in rows)
    return {"step_wall_ms": wall, "device_ms_per_step": device,
            "device_busy": device / wall,
            "top": [{"name": k[:80], "ms_per_step": ms, "calls": c}
                    for k, ms, c in rows[:top]]}


def profile_train(torch, steps: int = 2) -> dict:
    """``--profile``: where a GPT-2 124M O2 training step's time goes
    (B x S tokens, the train phase's configuration): two warm-up steps,
    then ``steps`` steps under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    _, state, step, tokens = make_trainer(torch, "O2", 12, SEED)
    for _ in range(2):
        state, _ = step(state, tokens)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            state, _ = step(state, tokens)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / steps * 1e3
    return kernel_split(torch, prof, steps, wall, top=25)


# ---- phases 5 and 6: training --------------------------------------------


def train_launches(num_layers: int) -> dict:
    """Kernel launches per GPT-2 training step: two norms a block and
    the final one, one causal softmax a block, one cross-entropy; each
    forward and backward."""
    n_norm = 2 * num_layers + 1
    return {"layer_norm_fwd": n_norm, "layer_norm_bwd": n_norm,
            "softmax_fwd": num_layers, "softmax_bwd": num_layers,
            "xent_fwd": 1, "xent_bwd": 1}


def make_trainer(torch, level: str, depth: int, seed: int, factor=False):
    """GPT-2 124M at full width (``depth`` layers, use_flash=False),
    weights from ``seed``, under ``Amp(fused_adam(1e-4,
    weight_decay=0.01), opt_level=level)``, and the B x S token batch of
    ``np.random.default_rng(0)``. With ``factor`` the step takes a third
    argument that multiplies the loss (inf forces an overflow)."""
    import numpy as np
    from apex1_tpu_torch import (Amp, GPT2Config, fused_adam, get_policy,
                                 gpt2_loss_fn, gpt2_params_from_jax)
    from apex1_tpu_torch.models.gpt2 import init_params
    cfg = GPT2Config.gpt2_125m(num_layers=depth, use_flash=False,
                               policy=get_policy(level))
    model = gpt2_params_from_jax(init_params(cfg, seed), cfg, "cuda")
    amp = Amp(fused_adam(1e-4, weight_decay=0.01), opt_level=level)
    state = amp.init(dict(model.named_parameters()))
    base = gpt2_loss_fn(model, fuse_head=False)
    loss_fn = (lambda p, t, f: base(p, t) * f) if factor else base
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (TB, TS))).cuda()
    return cfg, state, amp.make_train_step(loss_fn), tokens


def train(torch, ops, level: str, steps: int = 6):
    """``steps`` training steps of GPT-2 124M at ``level``; per step the
    loss, loss scale, skipped count, host wall (ending in a
    synchronize) and the kernel launches it made; and the peak device
    memory."""
    cfg, state, step, tokens = make_trainer(torch, level, 12, SEED)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rows, prev = [], ops.launch_counts()
    for i in range(steps):
        t0 = time.perf_counter()
        state, m = step(state, tokens)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        now = ops.launch_counts()
        rows.append(dict(step=i + 1, wall_ms=wall, loss=m["loss"].item(),
                         grad_norm=m["grad_norm"].item(),
                         loss_scale=m["loss_scale"].item(),
                         skipped=int(m["skipped_steps"].item()),
                         launches={k: now[k] - prev[k] for k in now
                                   if now[k] != prev[k]}))
        prev = now
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    return cfg, rows, peak


def train_parity(torch, ops, depth: int = 2, steps: int = 3):
    """GPT-2 at full width, ``depth`` layers, through the kernels and
    through the plain versions on the card: O0 losses and grad norms
    per step; O2_fp16 with the loss multiplied by inf at step 2 on both
    sides, with whether step 2 left every param bit for bit as step 1
    left it."""
    import contextlib
    out = {}
    for impl in ("kernel", "torch"):
        ctx = (ops.force_impl("torch") if impl == "torch"
               else contextlib.nullcontext())
        with ctx:
            _, state, step, tokens = make_trainer(torch, "O0", depth,
                                                  SEED + 1)
            o0 = []
            for _ in range(steps):
                state, m = step(state, tokens)
                o0.append((m["loss"].item(), m["grad_norm"].item()))
            del state
            _, state, step, tokens = make_trainer(torch, "O2_fp16", depth,
                                                  SEED + 1, factor=True)
            fp16, params = [], []
            for i in range(steps):
                f = torch.tensor(float("inf") if i == 1 else 1.0,
                                 device="cuda")
                state, m = step(state, tokens, f)
                params.append(state.params)
                fp16.append(dict(
                    finite=bool(m["grads_finite"].item()),
                    skipped=int(m["skipped_steps"].item()),
                    scale_used=m["loss_scale"].item(),
                    scale_after=state.loss_scale.scale.item()))
            kept = all(torch.equal(params[1][k], params[0][k])
                       for k in params[0])
            del state, params
        out[impl] = dict(o0=o0, fp16=fp16, step2_params_kept=kept)
        torch.cuda.empty_cache()
    return out


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
        if ("Compiling entry" in line or "registers" in line
                or "spill" in line):
            print(f"  ptxas: {line.strip()}")

    if "--profile" in sys.argv[1:]:
        prof = {"decode": profile_decode(torch),
                "train": profile_train(torch)}
        os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
        with open(os.path.join(HERE, "chiprun_out", "profile.json"),
                  "w") as f:
            json.dump({"card": card, **prof}, f, indent=1)
        print(f"phase profile: {json.dumps(prof)} [{card}]")
        return 0

    # 2. kernels against their plain versions
    gen = torch.Generator().manual_seed(SEED)
    cgen = torch.Generator(device="cuda").manual_seed(SEED)
    checks = {"layer_norm_fwd": check_layer_norm(torch, ops, gen),
              "paged_attend": check_paged_attend(torch, ops, gen),
              "fused_sample": check_fused_sample(torch, ops, gen),
              "layer_norm_bwd": check_layer_norm_bwd(torch, ops, cgen)}
    checks["softmax_fwd"], checks["softmax_bwd"] = check_softmax(
        torch, ops, cgen)
    checks["xent_fwd"], checks["xent_bwd"] = check_xent(torch, ops, cgen)
    torch.cuda.empty_cache()
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
    serve_launches = dict(launches)
    summ = eng.metrics.summary()
    n_fwd = (eng.metrics.get_counter("prefill_chunks")
             + eng.metrics.get_counter("decode_steps"))
    L = cfg.num_layers
    # serving launches no training kernel (it runs under inference mode)
    expect = {name: 0 for name in launches}
    expect.update({"layer_norm_fwd": n_fwd * (2 * L + 1),
                   "paged_attend": n_fwd * L, "fused_sample": n_fwd})
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
        if n != expect[name]:
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

    # 5. train: GPT-2 124M, B x S tokens, O2 and O2_fp16, six steps each
    ops.reset_launches()
    per_step = train_launches(12)
    train_out = {}
    for level in ("O2", "O2_fp16"):
        tcfg, rows, peak = train(torch, ops, level)
        walls = sorted(r["wall_ms"] for r in rows[1:])
        med = walls[len(walls) // 2]
        train_out[level] = dict(steps=rows, peak_gib=peak,
                                step_wall_ms=med, tokens_per_s=TB * TS /
                                med * 1e3)
        for r in rows:
            print(f"phase train: {level} step {r['step']} loss "
                  f"{r['loss']:.6f} grad_norm {r['grad_norm']:.4f} "
                  f"loss_scale {r['loss_scale']:g} skipped_steps "
                  f"{r['skipped']} wall {r['wall_ms']:.1f} ms launches "
                  f"{r['launches']} [{card}]")
        print(f"phase train: GPT-2 124M {level} use_flash=False "
              f"fuse_head=False B={TB} S={TS} width {tcfg.hidden_size} "
              f"layers {tcfg.num_layers} vocab "
              f"{tcfg.vocab_size}/{tcfg.padded_vocab}; step wall "
              f"{med:.2f} ms (median of steps 2-{len(rows)}), "
              f"{TB * TS / med * 1e3:.0f} tokens/s, peak memory "
              f"{peak:.2f} GiB [{card}]")
        losses = [r["loss"] for r in rows]
        if not all(math.isfinite(v) for v in losses):
            return fail(f"train {level}: a loss is not finite: {losses}")
        if level == "O2" and not losses[-1] < losses[0]:
            return fail(f"train O2: the loss did not fall: {losses}")
        for r in rows:
            if r["launches"] != per_step:
                return fail(f"train {level} step {r['step']}: launches "
                            f"{r['launches']}, expected {per_step}")
        torch.cuda.empty_cache()
    train_total = ops.launch_counts()

    # 6. train-parity: kernels against the plain versions, depth 2
    par = train_parity(torch, ops)
    k, p = par["kernel"], par["torch"]
    print(f"phase train-parity: O0 depth 2 (loss, grad_norm) per step "
          f"kernels {k['o0']} plain {p['o0']} [{card}]")
    for side in ("kernel", "torch"):
        print(f"phase train-parity: O2_fp16 inf at step 2, {side}: "
              f"{par[side]['fp16']}, step-2 params kept bit for bit "
              f"{par[side]['step2_params_kept']} [{card}]")
    for (kl, kg), (pl, pg) in zip(k["o0"], p["o0"]):
        if abs(kl - pl) > 1e-5 * abs(pl) or abs(kg - pg) > 1e-4 * abs(pg):
            return fail(f"train-parity O0: kernels {k['o0']} vs plain "
                        f"{p['o0']}")
    for side in ("kernel", "torch"):
        f = par[side]["fp16"]
        if ([r["finite"] for r in f] != [True, False, True]
                or f[1]["skipped"] != 1 or f[-1]["skipped"] != 1
                or f[1]["scale_after"] != f[1]["scale_used"] / 2
                or not par[side]["step2_params_kept"]):
            return fail(f"train-parity O2_fp16 ({side}): the forced "
                        f"overflow did not skip step 2 cleanly: {f}")

    # 7. the kernels line, the card, the last line. launches: the
    # serving run's plus the training run's (the two main paths)
    launches = {name: serve_launches[name] + train_total[name]
                for name in serve_launches}
    sources = {"layer_norm_fwd": ("apex1_tpu_torch/csrc/layer_norm.cu",
                                  "apex1_tpu/ops/layer_norm.py:110"),
               "paged_attend": ("apex1_tpu_torch/csrc/paged_attend.cu",
                                "apex1_tpu/ops/paged_decode.py:529"),
               "fused_sample": ("apex1_tpu_torch/csrc/fused_sample.cu",
                                "apex1_tpu/ops/paged_decode.py:300"),
               "layer_norm_bwd": ("apex1_tpu_torch/csrc/layer_norm_bwd.cu",
                                  "apex1_tpu/ops/layer_norm.py:135"),
               "softmax_fwd": ("apex1_tpu_torch/csrc/softmax.cu",
                               "apex1_tpu/ops/softmax.py:60"),
               "softmax_bwd": ("apex1_tpu_torch/csrc/softmax.cu",
                               "apex1_tpu/ops/softmax.py:95"),
               "xent_fwd": ("apex1_tpu_torch/csrc/xentropy.cu",
                            "apex1_tpu/ops/xentropy.py:88"),
               "xent_bwd": ("apex1_tpu_torch/csrc/xentropy.cu",
                            "apex1_tpu/ops/xentropy.py:114")}
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
                              "step_ms": step_ms, "summary": summ},
                   "train": train_out, "train_parity": par},
                  f, indent=1, default=str)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
