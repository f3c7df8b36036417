"""The analytic pricing library (the port of ``apex1_tpu/perf_model.py``):
rooflines, per-kernel cost formulas and the exposure models of the
collectives.

The planner prices thousands of candidate layouts a search through
these functions (`planner.cost`); keeping them in one module keeps one
formula for each quantity. Every number here is an UPPER bound on
throughput (no bandwidth derating, no scheduler gaps): calibration
(`obs.calibrate`) is what corrects them against banked measurements.

The peaks come from the capability row (`core.capability`): on an H100
the tensor cores' dense bf16 rate, the HBM rate, and one peer's link
rate for exposed communication. The binding side is named for the card:
``"tensor"`` (the tensor cores), ``"HBM"`` or ``"link"``.

Imports only the standard library and `core.capability`.
"""

from __future__ import annotations

from typing import Optional

from apex1_tpu_torch.core.capability import get_capability, link_gbps

# ---------------------------------------------------------------------------
# roofline
# ---------------------------------------------------------------------------


def roofline(flops, nbytes, cap, exposed_bytes=0.0):
    """Predicted seconds, binding side and model-flops utilisation of one
    program on one card.

    ``exposed_bytes``: link traffic NOT hidden behind compute; it ADDS
    to the roofline time (an overlapped transfer costs nothing here, an
    exposed one serialises), priced at the row's per-peer link rate."""
    t_tensor = flops / (cap.bf16_tflops * 1e12)
    t_hbm = nbytes / (cap.hbm_gbps * 1e9)
    t = max(t_tensor, t_hbm)
    bound = "tensor" if t_tensor >= t_hbm else "HBM"
    if exposed_bytes:
        link = cap.link_gbps
        t_link = exposed_bytes / (link * 1e9) if link else 0.0
        t = t + t_link
        if t_link > max(t_tensor, t_hbm):
            bound = "link"
    mfu = flops / (t * cap.bf16_tflops * 1e12) if t > 0 else 0.0
    return t, bound, mfu


# ---------------------------------------------------------------------------
# per-kernel analytic cases
# ---------------------------------------------------------------------------


def flash_flops_bytes(B, Hq, Hkv, S, D, causal=True, grad=False):
    """Analytic (flops, least HBM bytes) of one flash-attention call,
    the formula the kernel table and the planner's attention price
    share."""
    f = 4 * B * Hq * S * S * D * (0.5 if causal else 1.0)
    if grad:
        # the forward's 2 products plus the port's two-pass backward
        # (csrc/flash_wg.cuh): flash_dq_wg_kernel recomputes S and dP and
        # takes dq (3 products), flash_dkv_wg_kernel recomputes S and dP
        # and takes dv and dk (4): 7 backward products, (2 + 7) / 2 of
        # the forward
        f *= 4.5
    qb = B * Hq * S * D * 2
    kvb = 2 * B * Hkv * S * D * 2
    byt = qb + kvb + qb   # q, k, v in; o out
    if grad:
        byt += 2 * qb + kvb + qb   # dq out, dk/dv out, do in
    return f, byt


def elemwise_flops_bytes(n_elem, passes, itemsize, fpe):
    """Bandwidth-bound row kernels: flops a element x count, passes x
    element traffic."""
    return fpe * n_elem, passes * n_elem * itemsize


def kernel_cases():
    """ANALYTIC (flops, least HBM bytes) of each kernel at its bench
    shape.

    Formulas (a multiply-add is 2 flops; bytes: each operand and result
    crossing HBM once):
    - flash attention: 4*B*H*S^2*D product flops (QK^T + PV), x0.5
      causal; forward and backward 4.5x the forward (`flash_flops_bytes`).
      GQA K/V bytes scale by Hkv/Hq.
    - linear_xent forward and backward: 6*T*Hd*V (logits, dX, dW); bytes
      3 reads of W plus x/dx/dW.
    - LN / RMS / softmax / rope / xentropy: bandwidth-bound, flops a few
      per element (5 forward, 8 forward and backward); bytes the element
      traffic of each pass.
    - int8 GEMM: 2*M*N*K flops; bytes the int8 weight (N*K), its scales
      and the activations.
    """
    flash = flash_flops_bytes
    elemwise = elemwise_flops_bytes

    T, Hd, V = 16 * 1023, 768, 50432
    lx_f = linear_xent_flops(T, Hd, V)
    lx_b = 2 * (3 * V * Hd + 2 * T * Hd + V * Hd)  # W x3, x/dx, dW

    return [
        ("flash gpt2 (16,12,1024,64) fwd", *flash(16, 12, 12, 1024, 64)),
        ("flash gpt2 (16,12,1024,64) f+b",
         *flash(16, 12, 12, 1024, 64, grad=True)),
        ("flash longctx (1,32,16384,64) f+b",
         *flash(1, 32, 32, 16384, 64, grad=True)),
        ("flash GQA (Hq32/Hkv4,16k,64) f+b",
         *flash(1, 32, 4, 16384, 64, grad=True)),
        ("linear_xent gpt2 (16k,768,50k) f+b", lx_f, lx_b),
        ("layer_norm (16384,768) f+b",
         *elemwise(16384 * 768, 4, 2, 8)),
        ("rms_norm (16384,2048) f+b",
         *elemwise(16384 * 2048, 4, 2, 8)),
        ("causal softmax (16,12,1024,1024) f+b",
         *elemwise(16 * 12 * 1024 * 1024 // 2, 4, 4, 8)),
        ("xentropy (16368,50432) f+b",
         *elemwise(16368 * 50432, 3, 4, 8)),   # x, x, dx
        ("rope llama (1,16384,32,64) f+b",
         *elemwise(16384 * 32 * 64, 4, 2, 6)),
        ("int8 GEMM decode (8,4096)x(32000,4096)",
         2 * 8 * 32000 * 4096,
         32000 * 4096 * 1 + 32000 * 4 + 2 * 8 * (4096 + 32000) * 2),
    ]


def linear_xent_flops(T, Hd, V):
    """Fused LM-head cross-entropy forward and backward flops (logits,
    dX, dW): the chunked kernels' arithmetic is the dense one's."""
    return 6 * T * Hd * V


# ---------------------------------------------------------------------------
# exposure models of the collectives
# ---------------------------------------------------------------------------


def ring_attention_comms(generation: str, n: int, *,
                         B: int = 1, Hq: int = 32, Hkv: int = 4,
                         S: int = 16384, D: int = 64
                         ) -> Optional[dict]:
    """Exposure model of the ring-attention cp path: each ring step's K/V
    shard transfer either serialises against the attend or hides behind
    it (the double-buffered schedule). None when the row carries no link
    rate."""
    cap = get_capability(generation)
    link = link_gbps(generation)
    if not link:
        return None
    S_l = S // n
    kv_hop = 2 * B * Hkv * S_l * D * 2          # K+V bf16
    dkv_hop = 2 * B * Hkv * S_l * D * 4         # dK+dV fp32
    att = 4 * B * Hq * S_l * S_l * D * 0.5      # causal attend
    bwd = 2.5 * att
    t_hop_f = kv_hop / (link * 1e9)
    t_hop_b = (kv_hop + dkv_hop) / (link * 1e9)
    t_att = att / (cap.bf16_tflops * 1e12)
    t_bwd = bwd / (cap.bf16_tflops * 1e12)
    fwd_bytes = (n - 1) * kv_hop
    bwd_bytes = n * (kv_hop + dkv_hop)
    exp_f_overlap = (n - 1) * max(0.0, t_hop_f - t_att) * (link * 1e9)
    exp_b_overlap = n * max(0.0, t_hop_b - t_bwd) * (link * 1e9)
    return dict(
        generation=generation, cp=n, link_gbps=link,
        kv_hop=kv_hop, dkv_hop=dkv_hop,
        t_hop_f=t_hop_f, t_hop_b=t_hop_b, t_att=t_att, t_bwd=t_bwd,
        fwd_bytes=fwd_bytes, bwd_bytes=bwd_bytes,
        exp_f_overlap=exp_f_overlap, exp_b_overlap=exp_b_overlap)


def sp_boundary_comms(generation: str, n: int, *,
                      rows: int = 8192, local_k: Optional[int] = None,
                      out_width: int = 4096, ffn: int = 14336,
                      acc_bytes: int = 4,
                      hop_width: Optional[int] = None
                      ) -> Optional[dict]:
    """Exposure model of ONE sequence-parallel boundary product and its
    collective (a chunk-pipelined ring) under the three schedules:

    - ``serial``: every byte exposed;
    - ``overlap``: the per-hop residual the chunk product cannot cover
      (best case: every transfer hoisted);
    - ``fused``: the one-kernel form (`ops.fused_collective`,
      ``csrc/chunk_matmul.cu``): the prologue hop plus the same residual.

    Defaults are the Llama-8B MLP row-parallel boundary; the planner
    calls this per candidate layout with its own (rows, local_k,
    out_width).

    ``hop_width``: width of the TRAVELLING chunk; None is ``out_width``,
    right for product then reduce-scatter (the fp32 partial result
    hops). For all-gather then product the input activation travels:
    pass ``hop_width=E`` with ``acc_bytes`` its dtype's size. None when
    the row carries no link rate."""
    cap = get_capability(generation)
    link = link_gbps(generation)
    if not link:
        return None
    if local_k is None:
        local_k = ffn // n
    chunk_rows = rows // n
    if hop_width is None:
        hop_width = out_width
    hop = chunk_rows * hop_width * acc_bytes      # travelling chunk
    dot = 2 * chunk_rows * local_k * out_width    # a step's product
    t_hop = hop / (link * 1e9)
    t_dot = dot / (cap.bf16_tflops * 1e12)
    total = n * hop
    resid = n * max(0.0, t_hop - t_dot) * (link * 1e9)
    fused_exposed = hop + resid                   # prologue hop
    return dict(
        generation=generation, tp=n, link_gbps=link,
        hop=hop, dot=dot, t_hop=t_hop, t_dot=t_dot,
        total=float(total),
        exposed_serial=float(total),
        exposed_overlap=float(resid),
        exposed_fused=float(fused_exposed))


def allreduce_bytes(nbytes: float, n: int) -> float:
    """A device's ring all-reduce traffic for an ``nbytes`` buffer over
    ``n`` participants: reduce-scatter then all-gather, each moving
    (n-1)/n of the buffer. The ZeRO split (reduce-scatter the grads,
    all-gather the updated params) moves the same total."""
    if n <= 1:
        return 0.0
    return 2.0 * nbytes * (n - 1) / n


# ---------------------------------------------------------------------------
# serving-config pricing
# ---------------------------------------------------------------------------


def kv_cache_bytes(num_layers: int, num_kv_heads: int, head_dim: int,
                   positions: int, batch: int = 1,
                   bytes_per_el: int = 2) -> int:
    """Bytes of a K/V cache (K + V a layer, ``(batch, Hkv, positions,
    D)`` each): the analytic mirror of `serving.KVPool`'s pool.
    ``bytes_per_el`` 2 = bf16, 1 = the int8 tier, 4 = fp32."""
    return (2 * int(num_layers) * int(batch) * int(num_kv_heads)
            * int(positions) * int(head_dim) * int(bytes_per_el))


def serving_capacity(hbm_budget_bytes: float, num_layers: int,
                     num_kv_heads: int, head_dim: int, pool_len: int,
                     bytes_per_el: int = 2) -> int:
    """Resident batch (the engine's ``max_slots``) a KV-pool memory
    budget buys: ``budget // bytes a slot``."""
    per_slot = kv_cache_bytes(num_layers, num_kv_heads, head_dim,
                              pool_len, 1, bytes_per_el)
    if per_slot <= 0:
        raise ValueError("per-slot KV bytes must be positive")
    return int(hbm_budget_bytes // per_slot)


def speculative_speedup(accept_rate: float, num_draft: int,
                        verify_cost: float = 1.0,
                        draft_cost: float = 0.0) -> float:
    """Expected decode speedup of the engine's speculative mode: tokens
    a verify round emits over the round's relative cost.

    An independent accept probability ``r`` a position gives
    ``E[tokens/round] = 1 + r + ... + r^K`` (the accepted prefix,
    truncated at K drafts, plus the always-emitted correction token).
    ``verify_cost`` is one (K+1)-wide verify relative to one decode
    step; ``draft_cost`` is the proposal cost a draft token (0 for the
    host-side n-gram default). An UPPER bound."""
    if not 0.0 <= accept_rate <= 1.0:
        raise ValueError(f"accept_rate must be in [0, 1], "
                         f"got {accept_rate}")
    if num_draft < 1:
        raise ValueError(f"num_draft must be >= 1, got {num_draft}")
    tokens = sum(accept_rate ** j for j in range(num_draft + 1))
    cost = float(verify_cost) + num_draft * float(draft_cost)
    if cost <= 0:
        raise ValueError("round cost must be positive")
    return tokens / cost
