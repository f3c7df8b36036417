"""Ulysses all-to-all sequence parallelism (the port of
``apex1_tpu/parallel/ulysses.py``): the second context-parallel form
beside `parallel.ring_attention`.

Tokens arrive sharded over the context-parallel group. One all-to-all
re-shards q, k and v from sequence-sharded (B, H, S/n, D) to
head-sharded (B, H/n, S, D) (`mappings.all_to_all_region`, one
``all_to_all_single``); each rank runs the port's flash attention over
the whole sequence for its heads, and a second all-to-all restores the
sequence sharding. The head counts must divide by the group size (for
GQA with fewer KV heads than ranks, the KV heads are repeated up to the
group size first), or ``fallback="ring"`` routes the call through ring
attention.
"""

from __future__ import annotations

from typing import Optional

from apex1_tpu_torch.ops.attention import flash_attention
from apex1_tpu_torch.transformer.tensor_parallel import mappings as mp


def _cp_group(group):
    if group is not None:
        return group
    from apex1_tpu_torch.transformer import parallel_state
    return parallel_state.get_context_parallel_group()


def ulysses_attention(q, k, v, group=None, *, causal: bool = False,
                      sm_scale: Optional[float] = None, segment_ids=None,
                      block_q: Optional[int] = None,
                      block_k: Optional[int] = None,
                      fallback: str = "error"):
    """Attention over a sequence sharded on ``group`` (default: the
    context-parallel group) by a head-scatter / sequence-gather
    all-to-all. ``q`` (B, Hq, S_local, D), ``k``/``v`` (B, Hkv, S_local,
    D); ``segment_ids`` the local (B, S_local) shard (all-gathered here).
    Returns the local output shard; differentiable. ``fallback``:
    ``"error"`` raises when the head counts do not divide the group
    size, ``"ring"`` runs `ring_attention` instead."""
    import torch.distributed as dist
    if fallback not in ("error", "ring"):
        raise ValueError(f"fallback must be 'error' or 'ring', got "
                         f"{fallback!r}")
    group = _cp_group(group)
    n = dist.get_world_size(group)
    if n == 1:
        return flash_attention(q, k, v, causal=causal,
                               segment_ids=segment_ids, sm_scale=sm_scale,
                               block_q=block_q, block_k=block_k)
    Hq, Hkv = q.shape[1], k.shape[1]
    hkv_eff = n if (Hkv % n and n % Hkv == 0) else Hkv
    if Hq % n or hkv_eff % n:
        if fallback == "ring":
            from apex1_tpu_torch.parallel.ring_attention import (
                ring_attention)
            return ring_attention(q, k, v, group, causal=causal,
                                  sm_scale=sm_scale, segment_ids=segment_ids)
        raise ValueError(
            f"ulysses needs head counts divisible by the axis size: "
            f"Hq={Hq}, Hkv={Hkv}, n={n} (use ring_attention or "
            f"fallback='ring' otherwise)")
    if Hkv % n:
        # GQA with fewer KV heads than ranks: repeat each KV head for its
        # query group so the heads split evenly
        rep = n // Hkv
        k = k.repeat_interleave(rep, dim=1)
        v = v.repeat_interleave(rep, dim=1)

    def seq_to_heads(t):   # (B, H, S_l, D) -> (B, H/n, S, D)
        return mp.all_to_all_region(t, group, 1, 2)

    qg, kg, vg = seq_to_heads(q), seq_to_heads(k), seq_to_heads(v)
    if segment_ids is not None:
        segment_ids = mp.all_gather(segment_ids, group, 1)
    out = flash_attention(qg, kg, vg, causal=causal,
                          segment_ids=segment_ids, sm_scale=sm_scale,
                          block_q=block_q, block_k=block_k)
    return mp.all_to_all_region(out, group, 2, 1)
