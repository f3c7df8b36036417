"""KV-cached decoding (the port of ``apex1_tpu/models/generate.py``):
the cache layout, the cache-aware attention the models call, the
``(apply_fn, make_cache)`` decoder pair the serving engine drives,
`generate` (the prefill + decode loop over a dense cache),
`beam_search` over the same decode step, `t5_generate` (encode once,
then the cached T5 decoder, greedy, sampled or beam), `counter_sample`
(the serving engine's per-request counter-keyed draw) and
`speculative_generate` (a draft model proposes, the target verifies a
chunk per round).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from apex1_tpu_torch.core.random import split, threefry2x32, u32
from apex1_tpu_torch.ops._common import NEG_INF, resolve_device
from apex1_tpu_torch.ops.attention import flash_attention
from apex1_tpu_torch.ops.paged_decode import (PagedCache, _gumbel_argmax,
                                              _mask_vocab,
                                              _temperature_top_k,
                                              _uniform_bits, cache_attend,
                                              fused_sample,
                                              paged_update_attend,
                                              sample_token)


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


class DenseCache:
    """One layer's dense KV cache entry that its caller owns: K/V (B,
    Hkv, S_max, D) written IN PLACE by `cached_attention` (the serving
    engine's slot pool, `speculative_generate`'s caches). A plain
    {"k","v"} dict is updated functionally instead (a fresh copy, as
    the JAX package's ``dynamic_update_slice`` returns one)."""

    def __init__(self, k, v):
        self.k = k
        self.v = v


def cached_attention(q, k_new, v_new, cache, cache_index, *,
                     sm_scale: Optional[float] = None, bias=None,
                     segment_ids=None, valid_start=None,
                     chunk_decode: bool = False):
    """Attention through the KV cache. ``q``/``k_new``/``v_new``:
    (B, H, S, D)/(B, Hkv, S, D) for the current tokens.

    - A `PagedCache` entry writes the new K/V into its pages in place
      and attends them (`paged_update_attend`; ``cache_index`` scalar or
      per-row).
    - A dense entry ({"k","v": (B, Hkv, S_max, D)}, or a `DenseCache`
      written in place) takes a scalar ``cache_index`` or a per-row (B,)
      tensor: row b writes its S new positions at its own index
      (clamped so the window fits, as ``dynamic_update_slice`` clamps
      it) and its query j sees slots <= index_b + j; a per-row index
      reads nothing back to the host. Prefill (S > 1 without
      ``chunk_decode``) must start from an empty cache at a scalar index
      0: it runs causal flash attention over the current tokens
      (``segment_ids`` keep the left-pad of a ragged batch apart) and
      writes them into the cache. Decode (S == 1) or ``chunk_decode``
      (query j sees positions <= index + j; an empty cache at 0 is
      chunked prefill) attend the cache, from each row's
      ``valid_start`` on when given.

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
    B, _, S, _ = q.shape
    inplace = isinstance(cache, DenseCache)
    k_c, v_c = (cache.k, cache.v) if inplace else (cache["k"], cache["v"])
    s_max = k_c.shape[2]
    k_all, v_all = (k_c, v_c) if inplace else (k_c.clone(), v_c.clone())
    new_entry = cache if inplace else {"k": k_all, "v": v_all}
    if torch.is_tensor(cache_index) and cache_index.dim() == 1:
        if S > 1 and not chunk_decode:
            raise ValueError("cached_attention prefill (S > 1) takes a "
                             "scalar cache_index 0; a per-row index needs "
                             "chunk_decode=True")
        idx = cache_index.to(device=q.device, dtype=torch.int64)
        start = idx.clamp(0, s_max - S)
        pos = start[:, None] + torch.arange(S, device=q.device)
        rows = torch.arange(B, device=q.device)[:, None]
        k_all[rows, :, pos] = k_new.transpose(1, 2).to(k_all.dtype)
        v_all[rows, :, pos] = v_new.transpose(1, 2).to(v_all.dtype)
        attn = cache_attend(q, k_all, v_all, idx, sm_scale=sm_scale,
                            bias=bias, valid_start=valid_start)
        return attn, new_entry
    idx = int(cache_index)
    # dynamic_update_slice clamps the start so the window fits
    start = min(max(idx, 0), s_max - S)
    k_all[:, :, start:start + S] = k_new.to(k_all.dtype)
    v_all[:, :, start:start + S] = v_new.to(v_all.dtype)
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


def counter_sample(logits, seed, positions, *, temperature: float = 0.0,
                   top_k: Optional[int] = None,
                   vocab_size: Optional[int] = None):
    """Counter-keyed sampling over an (S, V) logits chunk: the token at
    output position ``positions[j]`` is drawn with ``fold_in(key(seed),
    positions[j])``, the serving engine's per-request stream. This is
    `fused_sample` with one seed for every row (the kernel on CUDA
    logits, its plain version on the CPU)."""
    S = logits.shape[0]
    dev = logits.device
    seeds = torch.as_tensor(seed, dtype=torch.int32, device=dev)
    return fused_sample(logits, seeds.reshape(-1).expand(S).contiguous(),
                        torch.as_tensor(positions, dtype=torch.int32,
                                        device=dev),
                        temperature=temperature, top_k=top_k,
                        vocab_size=vocab_size)


def _masked_probs(logits, *, temperature: float, top_k: Optional[int],
                  vocab_size: Optional[int]):
    """The distribution `sample_token` samples from over (..., V) logits:
    fp32, the padded-vocab tail masked, then the shared temperature and
    top-k pipeline and a softmax."""
    lg = _mask_vocab(logits.float(), vocab_size)
    return torch.softmax(_temperature_top_k(lg, temperature, top_k,
                                            vocab_size), dim=-1)


def _split_rows(k1, k2, num: int) -> list:
    """`split` of per-row key data (k1, k2: (B,) int64 tensors of uint32
    values): ``num`` new (k1, k2) pairs, jax's partitionable stream."""
    zero = torch.zeros_like(k1)
    return [threefry2x32(k1, k2, zero, torch.full_like(k1, i))
            for i in range(num)]


def _uniform_rows(k1, k2, n: int):
    """``jax.random.uniform(key, (n,))`` for each row's key: the uint32
    draw's high 23 bits as the mantissa of a float in [1, 2), minus 1."""
    col = torch.arange(n, device=k1.device)[None]
    bits = _uniform_bits(k1[:, None], k2[:, None], col, n)
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return torch.clamp_min(f - 1.0, 0.0)


def _log_or_neg_inf(p):
    return torch.where(p > 0, torch.log(torch.clamp_min(p, 1e-30)),
                       torch.full_like(p, NEG_INF))


def _speculative_accept(p, q, drafts, key):
    """One round of the speculative-sampling accept/resample rule
    (Leviathan et al. 2023; Chen et al. 2023): accept draft ``x_j`` with
    probability ``min(1, p_j(x_j) / q_j(x_j))``; at the first rejection
    emit a sample of the residual ``norm(max(p_j - q_j, 0))``; if all K
    are accepted emit a bonus sample of ``p_K``.

    ``p``: ([B,] K+1, V) target probs, ``q``: ([B,] K, V) draft probs,
    ``drafts``: ([B,] K) proposed tokens, ``key``: threefry key data
    (k1, k2), ints or (B,) tensors. The uniform and categorical draws are
    jax's (``split(key)`` -> ``uniform(key_u, (K,))``,
    ``categorical(key_c, ...)``). Returns ``(a, correction)``: the
    accepted count and the token to emit at position ``a``."""
    single = drafts.dim() == 1
    if single:
        p, q, drafts = p[None], q[None], drafts[None]
    B, K = drafts.shape
    dev = p.device
    k1, k2 = (u32(k, dev).reshape(-1).expand(B) for k in key)
    (ku1, ku2), (kc1, kc2) = _split_rows(k1, k2, 2)
    d = drafts.long()[..., None]
    p_at = torch.gather(p[:, :K], 2, d)[..., 0]
    q_at = torch.clamp_min(torch.gather(q, 2, d)[..., 0], 1e-30)
    accept = _uniform_rows(ku1, ku2, K) < torch.clamp_max(p_at / q_at, 1.0)
    a = torch.cumprod(accept.to(torch.int32), dim=1).sum(1)
    rows = torch.arange(B, device=dev)
    p_row = p[rows, a]
    q_row = torch.where((a == K)[:, None], 0.0,
                        q[rows, torch.clamp_max(a, K - 1)])
    r = torch.clamp_min(p_row - q_row, 0.0)
    s = r.sum(-1, keepdim=True)
    r = torch.where(s > 0, r / torch.clamp_min(s, 1e-30), p_row)
    # jax.random.categorical, each row with its own key
    corr = _gumbel_argmax(_log_or_neg_inf(r), kc1, kc2, True)
    a = a.to(torch.int32)
    return (a[0], corr[0]) if single else (a, corr)


def speculative_generate(target_fn, draft_fn, prompt_tokens, *,
                         max_new_tokens: int, target_cache, draft_cache,
                         num_draft: int = 4, temperature: float = 0.0,
                         top_k: Optional[int] = None, rng=None,
                         eos_id: Optional[int] = None, pad_id: int = 0,
                         vocab_size: Optional[int] = None,
                         prompt_lens=None):
    """Speculative decoding: a cheap DRAFT model proposes ``num_draft``
    tokens autoregressively; the TARGET scores all of them in one
    chunk-verify forward (``chunk_decode=True``); the longest accepted
    prefix plus one correction token are emitted per round. The draft
    changes how many target forwards run, not the tokens:

    - ``temperature == 0``: greedy; accept while the draft matches the
      target's argmax. The output equals greedy `generate` of the target
      alone up to chunk-verify against step-decode numerics (the same
      logits computed as one chunk or a row at a time).
    - ``temperature > 0``: speculative sampling (`_speculative_accept`);
      the emitted sequence is distributed as ancestral sampling from the
      target's temperature/top-k distribution.

    ``target_fn``/``draft_fn`` take the `gpt2_decoder`/`llama_decoder`
    apply contract (``chunk_decode`` included; the models are closed
    over, as in `generate`), the int8 `models.quant_decode` decoders
    too. Caches must hold prompt + max_new_tokens + num_draft + 1
    positions. ``rng`` is threefry key data ``(k1, k2)`` (default
    ``key(0)``); the keys are split as the JAX function splits them, so
    the same inputs draw the same tokens. ``prompt_lens`` (B,): ragged
    right-padded prompts, left-aligned once as in `generate`, positions
    and ``valid_start`` threaded through both models.

    The JAX function runs one ``lax.while_loop`` per row under ``vmap``;
    here every round runs for all rows at once, each row at its own
    cache index (`DenseCache`, written in place after the prefill's
    copy), and a finished row keeps its state. Returns (tokens (B,
    max_new_tokens) int32, target_forwards (B,) int32): the verify
    rounds each row ran (the prefill is implied)."""
    B, S0 = prompt_tokens.shape
    K = int(num_draft)
    N = int(max_new_tokens)
    if K < 1:
        raise ValueError(f"num_draft must be >= 1, got {K}")
    for nm, c in (("target_cache", target_cache),
                  ("draft_cache", draft_cache)):
        s_max = next(iter(c.values()))["k"].shape[2]
        if s_max < S0 + N + K + 1:
            raise ValueError(
                f"{nm} holds {s_max} positions but speculative decoding "
                f"needs >= prompt + max_new_tokens + num_draft + 1 = "
                f"{S0 + N + K + 1} (rejected speculative entries briefly "
                f"occupy the tail)")
    sampled = temperature != 0.0
    key = (0, 0) if rng is None else rng
    dev = prompt_tokens.device
    i32 = torch.int32
    pre_kw = {}
    pad = torch.zeros(B, dtype=torch.int64, device=dev)
    vs = {}
    if prompt_lens is not None:
        prompt_tokens, pre_kw, pad = _ragged_align(prompt_tokens,
                                                   prompt_lens)
        vs = dict(valid_start=pad)
    logits_t, target_cache = target_fn(prompt_tokens, target_cache, 0,
                                       **pre_kw)
    _, draft_cache = draft_fn(prompt_tokens, draft_cache, 0, **pre_kw)
    key, sub = split(key)
    t0 = sample_token(logits_t[:, -1], sub, temperature=temperature,
                      top_k=top_k, vocab_size=vocab_size)
    rk = torch.tensor(split(key, B), dtype=torch.int64, device=dev)
    k1, k2 = rk[:, 0], rk[:, 1]
    # the prefill returned fresh copies: from here the rounds write them
    # in place, each row at its own index
    tc = {n: DenseCache(e["k"], e["v"]) for n, e in target_cache.items()}
    dc = {n: DenseCache(e["k"], e["v"]) for n, e in draft_cache.items()}

    def greedy(lg):
        return torch.argmax(_mask_vocab(lg.float(), vocab_size),
                            dim=-1).to(i32)

    def probs(lg):
        return _masked_probs(lg, temperature=temperature, top_k=top_k,
                             vocab_size=vocab_size)

    buf = torch.full((B, N + 1), pad_id, dtype=i32, device=dev)
    buf[:, 0] = t0
    count = torch.ones(B, dtype=torch.int64, device=dev)
    last = t0
    idx = torch.full((B,), S0, dtype=torch.int64, device=dev)
    done = (torch.zeros(B, dtype=torch.bool, device=dev) if eos_id is None
            else t0 == eos_id)
    rounds = torch.zeros(B, dtype=i32, device=dev)
    j = torch.arange(K + 1, device=dev)
    while True:
        active = (count < N) & ~done
        if not bool(active.any()):
            break
        (nk1, nk2), (kd1, kd2), (ka1, ka2) = _split_rows(k1, k2, 3)
        step_keys = _split_rows(kd1, kd2, K + 1) if sampled else None
        tok, di = last, idx
        drafts_ext, q_ext = [], []
        for s in range(K + 1):
            lg, dc = draft_fn(tok[:, None], dc, di,
                              positions=(di - pad)[:, None], **vs)
            lg = lg[:, -1]
            if sampled:
                q_row = probs(lg)
                tok = _gumbel_argmax(_log_or_neg_inf(q_row),
                                     *step_keys[s], True)
                q_ext.append(q_row)
            else:
                tok = greedy(lg)
            drafts_ext.append(tok)
            di = di + 1
        drafts = torch.stack(drafts_ext[:K], dim=1)          # (B, K)
        verify = torch.cat([last[:, None], drafts], dim=1)   # (B, K+1)
        lg_t, tc = target_fn(verify, tc, idx, chunk_decode=True,
                             positions=(idx - pad)[:, None] + j, **vs)
        ext = torch.cat([drafts, drafts[:, -1:]], dim=1)
        if sampled:
            a, corr = _speculative_accept(
                probs(lg_t), torch.stack(q_ext[:K], dim=1), drafts,
                (ka1, ka2))
            toks = torch.where(j < a[:, None].long(), ext, corr[:, None])
        else:
            tgt_next = greedy(lg_t)                           # (B, K+1)
            match = (tgt_next[:, :K] == drafts).to(i32)
            a = torch.cumprod(match, dim=1).sum(1)
            toks = torch.where(j < a[:, None], ext, tgt_next)
        a = a.long()
        keep = (j <= a[:, None]) & (count[:, None] + j < N)
        if eos_id is not None:
            hit = (toks == eos_id).to(i32)
            keep = keep & (torch.cumsum(hit, dim=1) - hit == 0)
        keep = keep & active[:, None]
        # kept lanes land at count + j; the rest go to the spare column
        col = torch.where(keep, count[:, None] + j, N)
        buf.scatter_(1, col, toks)
        count = count + keep.sum(1)
        if eos_id is not None:
            done = done | ((toks == eos_id) & keep).any(1)
        last = torch.where(active, toks.gather(1, a[:, None])[:, 0], last)
        idx = torch.where(active, idx + a + 1, idx)
        rounds = rounds + active.to(i32)
        k1 = torch.where(active, nk1, k1)
        k2 = torch.where(active, nk2, k2)
    return buf[:, :N], rounds


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
