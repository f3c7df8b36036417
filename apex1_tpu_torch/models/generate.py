"""KV-cached decoding plumbing (the port of the serving half of
``apex1_tpu/models/generate.py``): the cache layout, the cache-aware
attention the models call, and the ``(apply_fn, make_cache)`` decoder
pair the serving engine drives. ``generate`` comes with the flash
slice, ``beam_search`` and the speculative loop with the decode slice
(ROADMAP.md queue A items 1b and 4).
"""

from __future__ import annotations

from typing import Optional

import torch

from apex1_tpu_torch.ops._common import resolve_device
from apex1_tpu_torch.ops.paged_decode import (PagedCache, cache_attend,
                                              paged_update_attend)


def init_cache(num_layers: int, batch: int, num_kv_heads: int,
               max_len: int, head_dim: int, dtype=torch.bfloat16,
               device=None):
    """Zeroed per-layer KV cache: {"layer{i}": {"k","v": (B, Hkv, S_max,
    D)}} on ``device`` (CUDA unless named)."""
    dev = resolve_device(device)
    shape = (batch, num_kv_heads, max_len, head_dim)
    return {f"layer{i}": {"k": torch.zeros(shape, dtype=dtype, device=dev),
                          "v": torch.zeros(shape, dtype=dtype, device=dev)}
            for i in range(num_layers)}


def cached_attention(q, k_new, v_new, cache, cache_index, *,
                     sm_scale: Optional[float] = None,
                     chunk_decode: bool = False):
    """Attention through the KV cache. ``q``/``k_new``/``v_new``:
    (B, H, S, D)/(B, Hkv, S, D) for the current tokens.

    - A `PagedCache` entry writes the new K/V into its pages in place
      and attends them (`paged_update_attend`; ``cache_index`` scalar or
      per-row).
    - A dense entry {"k","v": (B, Hkv, S_max, D)} takes a scalar
      ``cache_index``: decode (S == 1) or ``chunk_decode`` (query j sees
      positions <= index + j; an empty cache at 0 is chunked prefill).
      The new entry is a fresh copy, as the JAX package's functional
      update is.

    Flash prefill (S > 1 without ``chunk_decode``) needs the causal
    flash kernel, which the flash slice ports.
    Returns (attn (B, H, S, D), new_cache_entry)."""
    if isinstance(cache, PagedCache):
        return paged_update_attend(q, k_new, v_new, cache, cache_index,
                                   sm_scale=sm_scale,
                                   chunk_decode=chunk_decode)
    S = q.shape[2]
    if S > 1 and not chunk_decode:
        raise NotImplementedError(
            "cached_attention flash prefill needs causal flash attention "
            "(TPU kernel row 3), which the flash slice ports "
            "(ROADMAP.md queue A item 1b); use chunk_decode=True")
    idx = int(cache_index)
    s_max = cache["k"].shape[2]
    # dynamic_update_slice clamps the start so the window fits
    start = min(max(idx, 0), s_max - S)
    k_all, v_all = cache["k"].clone(), cache["v"].clone()
    k_all[:, :, start:start + S] = k_new.to(k_all.dtype)
    v_all[:, :, start:start + S] = v_new.to(v_all.dtype)
    attn = cache_attend(q, k_all, v_all, idx, sm_scale=sm_scale)
    return attn, {"k": k_all, "v": v_all}


def last_real_logits(logits, lengths):
    """(B, S, V) chunk logits -> (B, V) at each row's last real token
    (index ``lengths[b] - 1``): the gather behind fixed-width prefill
    chunks, whose tail is right-padded."""
    idx = torch.as_tensor(lengths, dtype=torch.int64, device=logits.device)
    idx = (idx.reshape(-1) - 1)[:, None, None].expand(-1, 1,
                                                      logits.shape[-1])
    return torch.gather(logits, 1, idx)[:, 0]


def _decoder(model, num_kv_heads: int, head_dim: int):
    """Shared (apply_fn, make_cache) builder over a model with the
    ``positions``/``cache``/``cache_index`` cached forward."""
    cfg = model.cfg

    @torch.no_grad()
    def apply_fn(tokens, cache, cache_index, *, positions=None,
                 chunk_decode=False, return_hidden=False):
        return model(tokens, positions=positions, cache=cache,
                     cache_index=cache_index, chunk_decode=chunk_decode,
                     return_hidden=return_hidden)

    def make_cache(batch: int, max_len: int, dtype=None):
        return init_cache(cfg.num_layers, batch, num_kv_heads, max_len,
                          head_dim, dtype or cfg.policy.compute_dtype,
                          device=model.device)

    return apply_fn, make_cache


def gpt2_decoder(model):
    """(apply_fn, make_cache) for `models.gpt2.GPT2`."""
    cfg = model.cfg
    return _decoder(model, cfg.num_heads, cfg.hidden_size // cfg.num_heads)
