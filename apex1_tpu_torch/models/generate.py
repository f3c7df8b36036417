"""KV-cached decoding (the port of ``apex1_tpu/models/generate.py``):
the cache layout, the cache-aware attention the models call, the
``(apply_fn, make_cache)`` decoder pair the serving engine drives,
`generate` (the prefill + decode loop over a dense cache),
`beam_search` over the same decode step, and `t5_generate` (encode
once, then the cached T5 decoder, greedy, sampled or beam).
`counter_sample` and `speculative_generate` are not ported yet
(ROADMAP.md queue A item 4).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from apex1_tpu_torch.ops._common import NEG_INF, resolve_device
from apex1_tpu_torch.ops.attention import flash_attention
from apex1_tpu_torch.ops.paged_decode import (PagedCache, cache_attend,
                                              paged_update_attend,
                                              sample_token, split)


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
                     sm_scale: Optional[float] = None, bias=None,
                     segment_ids=None, valid_start=None,
                     chunk_decode: bool = False):
    """Attention through the KV cache. ``q``/``k_new``/``v_new``:
    (B, H, S, D)/(B, Hkv, S, D) for the current tokens.

    - A `PagedCache` entry writes the new K/V into its pages in place
      and attends them (`paged_update_attend`; ``cache_index`` scalar or
      per-row).
    - A dense entry {"k","v": (B, Hkv, S_max, D)} takes a scalar
      ``cache_index``. Prefill (S > 1 without ``chunk_decode``) must
      start from an empty cache at index 0: it runs causal flash
      attention over the current tokens (``segment_ids`` keep the
      left-pad of a ragged batch apart) and writes them into the cache.
      Decode (S == 1) or ``chunk_decode`` (query j sees positions <=
      index + j; an empty cache at 0 is chunked prefill) attend the
      cache, from each row's ``valid_start`` on when given. The new
      entry is a fresh copy, as the JAX package's functional update is.

    ``bias``: an additive logit bias, in prefill over the current tokens
    (1, H, S, S), riding flash's bias operand (causality stays the
    kernels' causal flag); in decode the query row against every cache
    slot (1, H, 1, S_max), added in fp32 before the horizon mask (T5's
    relative-position bias). A `PagedCache` takes none.
    Returns (attn (B, H, S, D), new_cache_entry)."""
    if isinstance(cache, PagedCache):
        if (bias is not None or segment_ids is not None
                or valid_start is not None):
            raise ValueError("PagedCache attention does not support "
                             "bias/segment_ids/valid_start")
        return paged_update_attend(q, k_new, v_new, cache, cache_index,
                                   sm_scale=sm_scale,
                                   chunk_decode=chunk_decode)
    S = q.shape[2]
    idx = int(cache_index)
    s_max = cache["k"].shape[2]
    # dynamic_update_slice clamps the start so the window fits
    start = min(max(idx, 0), s_max - S)
    k_all, v_all = cache["k"].clone(), cache["v"].clone()
    k_all[:, :, start:start + S] = k_new.to(k_all.dtype)
    v_all[:, :, start:start + S] = v_new.to(v_all.dtype)
    new_entry = {"k": k_all, "v": v_all}
    if S > 1 and not chunk_decode:
        if idx != 0:
            raise ValueError(
                f"cached_attention prefill (S={S} > 1) requires an empty "
                f"cache at cache_index 0, got {idx}: it attends only over "
                f"the new tokens, so a non-empty cache would be silently "
                f"ignored")
        attn = flash_attention(q, k_new, v_new, causal=True,
                               sm_scale=sm_scale, bias=bias,
                               segment_ids=segment_ids)
        return attn, new_entry
    attn = cache_attend(q, k_all, v_all, idx, sm_scale=sm_scale, bias=bias,
                        valid_start=valid_start)
    return attn, new_entry


def last_real_logits(logits, lengths):
    """(B, S, V) chunk logits -> (B, V) at each row's last real token
    (index ``lengths[b] - 1``): the gather behind fixed-width prefill
    chunks, whose tail is right-padded."""
    idx = torch.as_tensor(lengths, dtype=torch.int64, device=logits.device)
    idx = (idx.reshape(-1) - 1)[:, None, None].expand(-1, 1,
                                                      logits.shape[-1])
    return torch.gather(logits, 1, idx)[:, 0]


def generate(apply_fn: Callable, prompt_tokens, *, max_new_tokens: int,
             cache, temperature: float = 0.0, top_k: Optional[int] = None,
             rng=None, eos_id: Optional[int] = None, pad_id: int = 0,
             vocab_size: Optional[int] = None, prompt_lens=None,
             cache_start: int = 0, return_cache: bool = False):
    """Prefill + decode loop: (B, max_new_tokens) int32 generated ids;
    rows that emit ``eos_id`` are padded with ``pad_id`` afterwards.

    ``apply_fn(tokens, cache, cache_index, **kw) -> (logits, cache)`` is
    a decoder's cached forward (`gpt2_decoder`); the parameters live in
    the model it closes over (the JAX function takes them as its second
    argument). ``cache`` must hold ``cache_start + prompt +
    max_new_tokens`` positions. ``rng`` is threefry key data
    ``(k1, k2)`` (default ``key(0)``, i.e. (0, 0)), split once per token
    as ``jax.random.split`` does in JAX's default (partitionable)
    stream, so temperature sampling draws JAX's tokens.

    ``prompt_lens`` (B,): ``prompt_tokens`` are right-padded ragged
    prompts. Rows are left-aligned once so every row's last real token
    sits at the last column; the pad prefix gets segment -1 at the
    flash prefill and is masked by a per-row ``valid_start`` at decode,
    and each row's positions count from its own start.
    ``cache_start > 0`` continues from a cache already holding that
    many positions (its prefill runs the chunk-decode mode).
    ``return_cache=True`` returns ``(tokens, cache)``; the final token's
    K/V is not in it. Neither combines with ``prompt_lens``.

    The JAX function's ``lax.scan`` is a Python loop here: each step is
    one forward of the model."""
    B, S0 = prompt_tokens.shape
    key = (0, 0) if rng is None else rng
    s_max = next(iter(cache.values()))["k"].shape[2]
    if s_max < cache_start + S0 + max_new_tokens:
        raise ValueError(
            f"cache holds {s_max} positions but this call needs "
            f"cache_start + prompt + max_new_tokens = "
            f"{cache_start + S0 + max_new_tokens}")
    if return_cache and prompt_lens is not None:
        raise ValueError(
            "return_cache and prompt_lens cannot be combined: the "
            "returned cache's left-pad slots hold garbage K/V that a "
            "cache_start continuation would attend; produce "
            "continuation caches from dense (non-ragged) prompts")
    kw = {}
    lens = None
    if cache_start:
        if prompt_lens is not None:
            raise ValueError(
                "cache_start (prefix caching) and prompt_lens (ragged "
                "batches) cannot be combined: left-aligned rows would "
                "shear against the shared cached prefix")
        kw = dict(chunk_decode=True)
    elif prompt_lens is not None:
        prompt_tokens, kw, pad = _ragged_align(prompt_tokens, prompt_lens)
        lens = S0 - pad
    sample = dict(temperature=temperature, top_k=top_k,
                  vocab_size=vocab_size)
    logits, cache = apply_fn(prompt_tokens, cache, cache_start, **kw)
    key, sub = split(key)
    tok = sample_token(logits[:, -1], sub, **sample)
    done = (torch.zeros(B, dtype=torch.bool, device=tok.device)
            if eos_id is None else tok == eos_id)
    out = [tok]
    idx = cache_start + S0
    for _ in range(max_new_tokens - 1):
        dkw = {}
        if lens is not None:
            # per-row positions continue each row's own count; the
            # scalar cache index advances uniformly past S0
            dkw = dict(positions=(lens + (idx - S0))[:, None],
                       valid_start=S0 - lens)
        logits, cache = apply_fn(tok[:, None], cache, idx, **dkw)
        key, sub = split(key)
        new = sample_token(logits[:, -1], sub, **sample)
        new = torch.where(done, torch.full_like(new, pad_id), new)
        if eos_id is not None:
            done = done | (new == eos_id)
        out.append(new)
        tok = new
        idx += 1
    toks = torch.stack(out, dim=1)
    return (toks, cache) if return_cache else toks


def _ragged_align(prompt_tokens, prompt_lens):
    """Left-align a right-padded ragged batch and build the prefill
    masking kwargs (the contract is documented on `generate`). Returns
    ``(aligned_tokens, prefill_kw, pad)``, ``pad`` (B,) each row's
    left-pad width (its decode-time ``valid_start``)."""
    B, S0 = prompt_tokens.shape
    lv = np.asarray(torch.as_tensor(prompt_lens).cpu())
    if (lv < 1).any() or (lv > S0).any():
        raise ValueError(
            f"prompt_lens must lie in [1, {S0}] (the padded prompt "
            f"width), got {lv.tolist()}")
    dev = prompt_tokens.device
    lens = torch.as_tensor(lv, dtype=torch.int64, device=dev)
    pad = S0 - lens
    col = torch.arange(S0, device=dev)[None, :]
    # row b shifts right by pad_b; the wrapped-in entries land in the
    # pad region and are masked
    aligned = torch.gather(prompt_tokens, 1, (col - pad[:, None]) % S0)
    # pad slots get segment -1, the padding convention of
    # `pack_documents` and the cross-entropy's label >= 0
    kw = dict(positions=torch.clamp(col - pad[:, None], min=0),
              segment_ids=torch.where(col >= pad[:, None], 1, -1).to(
                  torch.int32),
              valid_start=pad)
    return aligned, kw, pad


def _map_cache(fn, cache: dict) -> dict:
    """``fn`` applied to every tensor of a dense {"layer{i}": {"k","v"}}
    cache."""
    return {name: {kv: fn(t) for kv, t in entry.items()}
            for name, entry in cache.items()}


def _top_k(x: torch.Tensor, k: int):
    """``jax.lax.top_k`` over the last axis: the k largest values, ties
    to the lower index (a stable descending sort)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def beam_search(apply_fn: Callable, prompt_tokens, *, max_new_tokens: int,
                cache, num_beams: int = 4, length_penalty: float = 0.0,
                eos_id: Optional[int] = None, pad_id: int = 0,
                vocab_size: Optional[int] = None):
    """Beam search over the same cached decode step as `generate`
    (``apply_fn(tokens, cache, cache_index) -> (logits, cache)``, the
    model closed over as in `generate`).

    Beams ride the batch axis: ``cache`` is built for batch ``B *
    num_beams``, lanes b-major (b·K + k), and each step's reorder is
    one gather over that axis. Prefill runs once at batch B on the
    cache's first B lanes, and the filled cache is tiled K-fold; the
    first expansion takes each row's top-K tokens from that one
    distribution.

    Scores sum token log-probs over the valid vocab (``vocab_size``
    masks the padded logits before the softmax). With ``length_penalty``
    > 0, candidates compete at every step on GNMT-normalised scores
    ``sum / length**penalty`` (a beam's length counts its tokens up to
    and including its ``eos_id``); the carried scores stay raw sums.
    Finished beams stop accumulating and pad with ``pad_id``. Ties go
    to the lower index, as ``jax.lax.top_k`` and ``argmax`` break them.
    Returns (tokens (B, max_new_tokens) int32, scores (B,)) of the best
    beam under the same normalisation."""
    B, S0 = prompt_tokens.shape
    K = num_beams

    def masked_logp(logits_row):
        lg = logits_row.float()
        if vocab_size is not None and vocab_size < lg.shape[-1]:
            col = torch.arange(lg.shape[-1], device=lg.device)
            lg = torch.where(col < vocab_size, lg, NEG_INF)
        return torch.log_softmax(lg, dim=-1)

    def norm_rank(sums, lens):
        if not length_penalty:
            return sums
        return sums / torch.clamp(lens, min=1.0) ** length_penalty

    # prefill once at batch B on the cache's first B lanes, tile K-fold
    logits, pre = apply_fn(prompt_tokens, _map_cache(lambda c: c[:B], cache),
                           0)
    cache = _map_cache(lambda c: c.repeat_interleave(K, dim=0), pre)
    logp = masked_logp(logits[:, -1])                     # (B, V)
    V = logp.shape[-1]
    dev = logp.device
    scores, nxt = _top_k(logp, K)                         # (B, K)
    nxt = nxt.to(torch.int32)
    done = (torch.zeros(B, K, dtype=torch.bool, device=dev)
            if eos_id is None else nxt == eos_id)
    lens = torch.ones(B, K, dtype=torch.float32, device=dev)
    buf = torch.full((B * K, max_new_tokens), pad_id, dtype=torch.int32,
                     device=dev)
    buf[:, 0] = nxt.reshape(-1)
    # a finished beam proposes one zero-score continuation (pad), so its
    # total never moves
    pad_row = torch.where(torch.arange(V, device=dev) == pad_id, 0.0,
                          NEG_INF)
    lane0 = torch.arange(B, device=dev)[:, None] * K
    idx = S0
    for t in range(1, max_new_tokens):
        logits, cache = apply_fn(nxt.reshape(B * K, 1), cache, idx)
        logp = masked_logp(logits[:, -1]).reshape(B, K, V)
        logp = torch.where(done[..., None], pad_row, logp)
        cand = scores[..., None] + logp
        cand_len = (lens + torch.where(done, 0.0, 1.0))[..., None]
        _, flat = _top_k(norm_rank(cand, cand_len).reshape(B, K * V), K)
        scores = torch.gather(cand.reshape(B, K * V), 1, flat)
        src = flat // V
        token = (flat % V).to(torch.int32)
        gidx = (lane0 + src).reshape(-1)
        cache = _map_cache(lambda c: c[gidx], cache)
        done = torch.gather(done, 1, src)
        lens = torch.gather(lens, 1, src)
        buf = buf[gidx]
        # the emitted token counts toward the length unless the beam had
        # finished before this step (the eos itself counts)
        lens = lens + torch.where(done, 0.0, 1.0)
        if eos_id is not None:
            done = done | (token == eos_id)
        buf[:, t] = token.reshape(-1)
        nxt = token
        idx += 1
    norm = norm_rank(scores, lens)
    best = torch.argmax(norm, dim=1)                      # (B,)
    rows = torch.arange(B, device=dev)
    return buf.reshape(B, K, -1)[rows, best], norm[rows, best]


def t5_generate(model, enc_tokens, *, max_new_tokens: int,
                dec_start_id: int = 0, enc_pad_mask=None,
                temperature: float = 0.0, top_k: Optional[int] = None,
                rng=None, eos_id: Optional[int] = None, pad_id: int = 0,
                num_beams: int = 1, length_penalty: float = 0.0):
    """Seq2seq generation for `models.t5.T5`: encode once, then the
    KV-cached decoder from ``dec_start_id`` (T5's decoder start, the
    pad token 0). Returns (B, max_new_tokens) int32 ids. The decoder's
    self-attention is cached (``1 + max_new_tokens`` slots); the
    cross-attention recomputes its K/V from the memory each step. The
    JAX function's ``params`` live in ``model``.

    ``num_beams > 1`` runs `beam_search` (the sampling arguments must
    keep their defaults; a wrong call raises before the encoder runs):
    the encoder still runs once at batch B, prefill at B against the
    untiled memory, and the memory and ``enc_pad_mask`` are tiled
    K-fold (b-major lanes) for the decode steps. Otherwise `generate`
    decodes, greedy or sampled from the threefry key data ``rng``."""
    cfg = model.cfg
    K = num_beams
    if K > 1 and (temperature != 0.0 or top_k is not None):
        raise ValueError("beam search is deterministic: temperature/top_k "
                         "require num_beams=1")
    with torch.no_grad():
        memory = model.encode(enc_tokens, enc_pad_mask)
    B = enc_tokens.shape[0]
    # lanes are b-major (b·K + k): memory[:B] of the tile would be row 0
    # repeated, so the prefill at batch B takes the untiled memory
    memory_tiled = memory.repeat_interleave(K, dim=0) if K > 1 else memory
    mask_tiled = (enc_pad_mask.repeat_interleave(K, dim=0)
                  if K > 1 and enc_pad_mask is not None else enc_pad_mask)

    @torch.no_grad()
    def apply_fn(tokens, cache, cache_index):
        pre = tokens.shape[0] == B
        return model.decode(tokens, memory if pre else memory_tiled,
                            enc_pad_mask=enc_pad_mask if pre else mask_tiled,
                            cache=cache, cache_index=cache_index)

    cache = init_cache(cfg.num_decoder_layers, B * K, cfg.num_heads,
                       1 + max_new_tokens, cfg.head_dim,
                       cfg.policy.compute_dtype, device=model.device)
    prompt = torch.full((B, 1), dec_start_id, dtype=torch.int32,
                        device=model.device)
    if K > 1:
        toks, _ = beam_search(apply_fn, prompt,
                              max_new_tokens=max_new_tokens, cache=cache,
                              num_beams=K, length_penalty=length_penalty,
                              eos_id=eos_id, pad_id=pad_id)
        return toks
    return generate(apply_fn, prompt, max_new_tokens=max_new_tokens,
                    cache=cache, temperature=temperature, top_k=top_k,
                    rng=rng, eos_id=eos_id, pad_id=pad_id)


def _decoder(model, num_kv_heads: int, head_dim: int):
    """Shared (apply_fn, make_cache) builder over a model with the
    ``positions``/``cache``/``cache_index`` cached forward; the
    keyword-only ``segment_ids``/``valid_start`` carry the ragged
    batch masking that ``generate(prompt_lens=...)`` supplies."""
    cfg = model.cfg

    @torch.no_grad()
    def apply_fn(tokens, cache, cache_index, *, positions=None,
                 segment_ids=None, valid_start=None, chunk_decode=False,
                 return_hidden=False):
        return model(tokens, positions=positions, segment_ids=segment_ids,
                     cache=cache, cache_index=cache_index,
                     valid_start=valid_start, chunk_decode=chunk_decode,
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


def llama_decoder(model):
    """(apply_fn, make_cache) for `models.llama.Llama` (GQA: the cache
    holds the KV heads)."""
    cfg = model.cfg
    return _decoder(model, cfg.num_kv_heads, cfg.head_dim)
