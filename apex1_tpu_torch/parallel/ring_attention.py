"""Ring attention (the port of ``apex1_tpu/parallel/ring_attention.py``):
context parallelism over a process group.

The sequence is sharded over the group in group order. Each ring step
attends this rank's Q shard to the visiting K/V shard with the port's
flash kernels at the shards' true global offsets (so the causal mask
and the dropout hash see global positions), and merges the partial
result into the carried fp32 ``(out, lse)``:

    lse = logaddexp(lse_a, lse_b)
    out = out_a·exp(lse_a − lse) + out_b·exp(lse_b − lse)

The forward is double-buffered as in JAX: the hop that brings shard
t + 1 (``dist.batch_isend_irecv`` to group index i + 1 from i − 1, JAX's
``ppermute``; segment ids ride along) is posted before shard t is
attended and waited on after. A causal shard wholly in the future is
skipped (``skip_masked``): no launch, a (zeros, NEG_INF) partial
merged. `ring_attention_serial` hops first and attends the shard just
received: every hop exposed, the same numbers.

The backward (``_ring_bwd``, JAX's ``_ring_bwd_loop``) is a second ring
over the inverted permutation: shards flow to i − 1, each rank visits
i + 1, i + 2, ... and evaluates each visiting shard's gradients with the
port's `flash_dq` and `flash_dkv` against the FINAL merged ``(out,
lse)`` (dlse = 0), which makes each shard's p = exp(s − lse) its true
global weight. dK/dV partials stay fp32 (``flash_dkv(...,
out_dtype=float32)``) and travel home as accumulators beside the shards
(each hop ships ``acc + pend``, the zero seed first), so they are
rounded to k's dtype once, at the end.

`ops.fused_collective.all_gather_flash_attention` runs the same rings
with the merge inside the flash forward's epilogue.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.distributed as dist
from torch.profiler import record_function

from apex1_tpu_torch.ops._common import NEG_INF
from apex1_tpu_torch.ops.attention import (_norm_segments, flash_dkv,
                                           flash_dq, flash_fwd,
                                           merge_partials)
from apex1_tpu_torch.transformer.tensor_parallel.mappings import (
    OVERLAP_SPANS, PERMUTES, Hop)


def _ring_fwd(q, k, v, qseg, group, attend, serialize: bool = False):
    """The forward ring: ``attend(k, v, kseg, q_off, k_off, out, lse) ->
    (out, lse)`` once per visiting shard, in ring order; returns the
    fp32 ``(out, lse)``. The ring is the span ``overlap.body:ring.fwd``
    of a profiler trace and each attend an ``overlap.compute`` span in
    it (`mappings.OVERLAP_SPANS`: what the overlap probe reads)."""
    with record_function(f"{OVERLAP_SPANS['body']}:ring.fwd"):
        return _ring_fwd_steps(q, k, v, qseg, group, attend, serialize)


def _ring_fwd_steps(q, k, v, qseg, group, attend, serialize):
    n, idx = dist.get_world_size(group), dist.get_rank(group)
    B, Hq, Sq, _ = q.shape
    Sk = k.shape[2]
    out = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    lse = torch.full((B, Hq, Sq), NEG_INF, dtype=torch.float32,
                     device=q.device)
    kv = [k, v] if qseg is None else [k, v, qseg]

    def step(kv, t, out, lse):
        kseg = kv[2] if len(kv) == 3 else None
        with record_function(OVERLAP_SPANS["compute"]):
            return attend(kv[0], kv[1], kseg, idx * Sq,
                          ((idx - t) % n) * Sk, out, lse)

    if n == 1:
        return step(kv, 0, out, lse)
    if serialize:
        out, lse = step(kv, 0, out, lse)
        for t in range(1, n):
            kv = Hop(kv, group).wait()
            out, lse = step(kv, t, out, lse)
        return out, lse
    hop = Hop(kv, group)
    out, lse = step(kv, 0, out, lse)
    kv = hop.wait()
    for t in range(1, n - 1):
        hop = Hop(kv, group)
        out, lse = step(kv, t, out, lse)
        kv = hop.wait()
    return step(kv, n - 1, out, lse)


def ring_attend(q, qseg, scale, causal, dropout_p, seed, skip_masked):
    """The decomposed ring's step: `flash_fwd` of the visiting shard (or
    a (zeros, NEG_INF) partial for a skipped causal shard) merged in
    torch."""
    B, Hq, Sq, _ = q.shape

    def attend(k_cur, v_cur, kseg_cur, q_off, k_off, out, lse):
        if causal and skip_masked and k_off > q_off + Sq - 1:
            out_t = torch.zeros_like(q)
            lse_t = torch.full_like(lse, NEG_INF)
        else:
            out_t, lse_t = flash_fwd(q, k_cur, v_cur, qseg, kseg_cur, scale,
                                     causal, q_off, k_off, dropout_p, seed)
        return merge_partials(out, lse, out_t, lse_t)

    return attend


def _ring_bwd(q, k, v, qseg, out, lse, do, group, causal, scale, dropout_p,
              seed, skip_masked):
    """The backward ring over the inverted permutation; fp32 (dq, dk,
    dv). The span ``overlap.body:ring.bwd``, each shard's gradients an
    ``overlap.compute`` span in it."""
    with record_function(f"{OVERLAP_SPANS['body']}:ring.bwd"):
        return _ring_bwd_steps(q, k, v, qseg, out, lse, do, group, causal,
                               scale, dropout_p, seed, skip_masked)


def _ring_bwd_steps(q, k, v, qseg, out, lse, do, group, causal, scale,
                    dropout_p, seed, skip_masked):
    n, idx = dist.get_world_size(group), dist.get_rank(group)
    B, Hq, Sq, D = q.shape
    q_off = idx * Sq
    Sk = k.shape[2]
    do = do.to(q.dtype).contiguous()
    # δ_i = Σ_d do·out, shared by every shard's backward
    delta = (do.float() * out.float()).sum(dim=-1)

    def step_grads(kv, src):
        k_off = src * Sk
        if causal and skip_masked and k_off > q_off + Sq - 1:
            return (torch.zeros(q.shape, dtype=torch.float32,
                                device=q.device),
                    torch.zeros(k.shape, dtype=torch.float32,
                                device=q.device),
                    torch.zeros(v.shape, dtype=torch.float32,
                                device=q.device))
        kseg = kv[2] if len(kv) == 3 else None
        args = (q, kv[0], kv[1], do, lse, delta, None, qseg, kseg, scale,
                causal, q_off, k_off, dropout_p, seed)
        with record_function(OVERLAP_SPANS["compute"]):
            dq_t = flash_dq(*args)
            dk_t, dv_t = flash_dkv(*args, out_dtype=torch.float32)
        return dq_t.float(), dk_t, dv_t

    kv = [k, v] if qseg is None else [k, v, qseg]
    if n == 1:
        return step_grads(kv, idx)
    hop = Hop(kv, group, shift=-1)
    dq, dk_own, dv_own = step_grads(kv, idx)
    kv = hop.wait()
    dk_acc = torch.zeros(k.shape, dtype=torch.float32, device=q.device)
    dv_acc, dk_pend, dv_pend = (torch.zeros_like(dk_acc) for _ in range(3))
    for t in range(n - 1):
        # ship the accumulators completed here last step, and prefetch
        # the next shard (none after the last)
        last = t == n - 2
        hop = Hop([dk_acc + dk_pend, dv_acc + dv_pend]
                  + ([] if last else kv), group, shift=-1)
        dq_t, dk_pend, dv_pend = step_grads(kv, (idx + 1 + t) % n)
        dq = dq + dq_t
        got = hop.wait()
        dk_acc, dv_acc = got[0], got[1]
        kv = got[2:]
    # the last hop brings each shard's sum home, where its own term adds
    dk, dv = Hop([dk_acc + dk_pend, dv_acc + dv_pend], group,
                 shift=-1).wait()
    return dq, dk + dk_own, dv + dv_own


class _Ring(torch.autograd.Function):
    """The JAX package's ``_ring`` / ``_agf`` custom VJPs: residuals
    ``(q, k, v, segment ids, out, lse)``."""

    @staticmethod
    def forward(ctx, q, k, v, qseg, group, causal, scale, dropout_p, seed,
                skip_masked, fused, serialize):
        if fused:
            from apex1_tpu_torch.ops.fused_collective import agf_attend
            attend = agf_attend(q, qseg, scale, causal)
        else:
            attend = ring_attend(q, qseg, scale, causal, dropout_p, seed,
                                 skip_masked)
        out, lse = _ring_fwd(q, k, v, qseg, group, attend, serialize)
        out = out.to(q.dtype)
        ctx.save_for_backward(q, k, v, qseg, out, lse)
        ctx.args = (group, causal, scale, dropout_p, seed, skip_masked)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, qseg, out, lse = ctx.saved_tensors
        dq, dk, dv = _ring_bwd(q, k, v, qseg, out, lse, do, *ctx.args)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None,
                None, None, None, None, None, None, None)


def _ring_apply(q, k, v, group, *, causal=False, sm_scale=None,
                segment_ids=None, dropout_p=0.0, dropout_seed=None,
                skip_masked=True, fused=False, serialize=False):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("expected (B, H, S, D) operands")
    if q.shape[1] % k.shape[1] != 0:
        raise ValueError(f"Hq={q.shape[1]} not a multiple of "
                         f"Hkv={k.shape[1]}")
    dropout_p = float(dropout_p)
    if dropout_p > 0.0 and dropout_seed is None:
        raise ValueError("dropout_p > 0 needs an explicit int32 "
                         "dropout_seed (replicated over the ring)")
    scale = (1.0 / math.sqrt(q.shape[-1]) if sm_scale is None
             else float(sm_scale))
    qseg, _ = _norm_segments(segment_ids, q.shape[2], q.shape[2], q.device)
    PERMUTES["count"] += 1
    return _Ring.apply(q, k, v, qseg, group, bool(causal), scale, dropout_p,
                       dropout_seed if dropout_p > 0.0 else None,
                       bool(skip_masked), fused, serialize)


def ring_attention(q, k, v, group, *, causal: bool = False,
                   sm_scale: Optional[float] = None, segment_ids=None,
                   block_q: Optional[int] = None,
                   block_k: Optional[int] = None, dropout_p: float = 0.0,
                   dropout_seed=None, skip_masked: bool = True):
    """Attention over a sequence sharded on ``group`` (e.g.
    `parallel_state.get_context_parallel_group()`).

    ``q`` (B, Hq, S_local, D) and ``k``/``v`` (B, Hkv, S_local, D) are
    this rank's shards (GQA when Hkv < Hq); the global sequence is the
    group size times S_local in group order. ``segment_ids``: the local
    (B, S_local) shard of the global ids (they ride the ring with K/V).
    ``dropout_p``/``dropout_seed``: the flash kernels' probability
    dropout keyed on global positions, with one int32 seed on every
    rank. ``skip_masked=False`` attends the wholly masked causal shards
    too (the same numbers). ``block_q``/``block_k`` are accepted and
    ignored. Returns the local output shard; differentiable."""
    del block_q, block_k
    return _ring_apply(q, k, v, group, causal=causal, sm_scale=sm_scale,
                       segment_ids=segment_ids, dropout_p=dropout_p,
                       dropout_seed=dropout_seed, skip_masked=skip_masked)


def ring_attention_serial(q, k, v, group, *, causal: bool = False,
                          sm_scale: Optional[float] = None,
                          segment_ids=None, block_q: Optional[int] = None,
                          block_k: Optional[int] = None,
                          dropout_p: float = 0.0, dropout_seed=None,
                          skip_masked: bool = True):
    """The serialized schedule: hop first, then attend the shard just
    received, so every one of the n − 1 hops is exposed (the A/B
    baseline). The same attends and merges in the same order as
    `ring_attention`, so the same numbers; its backward is the same
    ring."""
    del block_q, block_k
    return _ring_apply(q, k, v, group, causal=causal, sm_scale=sm_scale,
                       segment_ids=segment_ids, dropout_p=dropout_p,
                       dropout_seed=dropout_seed, skip_masked=skip_masked,
                       serialize=True)
