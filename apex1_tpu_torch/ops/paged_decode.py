"""Paged ragged decode attention over KV-pool pages + fused sampling
(the port of ``apex1_tpu/ops/paged_decode.py``).

- :func:`cache_attend` — the dense decode/chunk attention composite
  (query j of a chunk sees cache slots <= index + j).
- :func:`sample_token` / :func:`_temperature_top_k` — the sampling
  pipeline, with jax's threefry-2x32 stream re-derived in integer ops
  (`_threefry2x32`, `_uniform_bits`, `_bits_to_gumbel`, `_row_keys`),
  so the port draws the same token ids as ``fold_in(key(seed), pos)`` +
  ``jax.random.categorical``. uint32 arithmetic runs in int64 tensors
  masked to 32 bits (torch's uint32 lacks some operators).
- :func:`fused_sample` — the sampling epilogue; CUDA tensors launch
  ``csrc/fused_sample.cu``.
- :class:`PagedCache` + :func:`paged_update_attend` — the per-layer
  cache entry: K/V live in a page pool ``(num_pages, Hkv, page, D)``
  addressed through a per-row block table. Unlike the JAX package the
  new tokens are written into the pool IN PLACE (`scatter_pages`), so a
  decode step never copies the pool.
- :func:`paged_attend` — ragged paged attention; CUDA tensors launch
  ``csrc/paged_attend.cu``.

Page 0 is the trash page: rows of freed slots point at it, inactive
rows scatter garbage into it, and nothing attends it.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from apex1_tpu_torch.ops import _build
from apex1_tpu_torch.ops._common import (DTYPE_CODES, NEG_INF, check_cuda,
                                         use_kernel)

_M32 = 0xFFFFFFFF
_TINY = float(np.finfo(np.float32).tiny)
_ONE_MINUS_TINY = float(np.float32(np.float32(1.0) - np.float32(_TINY)))
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


# ---- shared attention composite ---------------------------------------


def _jnp_result_type(a: torch.dtype, b: torch.dtype) -> torch.dtype:
    """jnp promotion for the P·V product: an integer (int8 cache) side
    takes the float side's type."""
    if not b.is_floating_point:
        return a
    if not a.is_floating_point:
        return b
    return torch.promote_types(a, b)


def cache_attend(q, k_all, v_all, cache_index, *,
                 sm_scale: Optional[float] = None):
    """Masked composite attention of (B, Hq, S, D) queries against a
    FULL cache (B, Hkv, S_max, D). ``cache_index`` is a scalar or a
    per-row (B,) vector; query j sees cache slots <= index + j. GQA
    groups the q heads onto the kv-head axis (no repeated cache)."""
    B, Hq, S, D = q.shape
    Hkv = k_all.shape[1]
    dev = q.device
    idx = torch.as_tensor(cache_index, dtype=torch.int64, device=dev)
    scale = (D ** -0.5) if sm_scale is None else sm_scale
    group = Hq // Hkv
    qg = q.reshape(B, Hkv, group, S, D)
    # bf16 x bf16 products are exact in f32: the same numbers as
    # preferred_element_type=f32
    scores = torch.einsum("bhgsd,bhkd->bhgsk", qg.float(),
                          k_all.float()) * scale
    pos = torch.arange(k_all.shape[2], device=dev)
    s_ar = torch.arange(S, device=dev)[None, None, None, :, None]
    if idx.dim() == 0:
        horizon = idx + s_ar
    else:
        horizon = idx.reshape(B, 1, 1, 1, 1) + s_ar
    keep = pos[None, None, None, None, :] <= horizon
    scores = torch.where(keep, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    rt = _jnp_result_type(q.dtype, v_all.dtype)
    attn = torch.einsum("bhgsk,bhkd->bhgsd", probs.to(rt), v_all.to(rt))
    return attn.reshape(B, Hq, S, D)


# ---- the threefry-2x32 stream -----------------------------------------


def _u32(x, device=None) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.int64, device=device) & _M32


def _threefry2x32(k1, k2, x0, x1):
    """The 20-round threefry-2x32 block over int64 tensors holding
    uint32 values — jax's ``threefry2x32`` op for op (key schedule,
    rotation constants, round-group injections)."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = ((x1 << r) | (x1 >> (32 - r))) & _M32
            x1 = x1 ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0, x1


def _uniform_bits(k1, k2, col, n: int, partitionable: bool = True):
    """The uint32 draw at flat position ``col`` of an n-element
    ``jax.random`` draw over key (k1, k2), in either threefry stream:

    - partitionable (the default, as the tier-1 harness runs jax): the
      position's 64-bit counter split in halves, (0, col); output
      ``y0 ^ y1``.
    - original: counts = iota(n), zero-padded to even and split in
      halves; each position recomputes its half-pair partner."""
    col = _u32(col)
    if partitionable:
        y0, y1 = _threefry2x32(k1, k2, torch.zeros_like(col), col)
        return y0 ^ y1
    odd = n % 2
    h = (n + odd) // 2
    lo = col < h
    a_idx = torch.where(lo, col, col - h)
    b_idx = a_idx + h
    if odd:
        # the last second-half lane's counter is the pad zero
        b_idx = torch.where(b_idx == n, torch.zeros_like(b_idx), b_idx)
    y0, y1 = _threefry2x32(k1, k2, a_idx, b_idx)
    return torch.where(lo, y0, y1)


def _bits_to_gumbel(bits):
    """uint32 -> standard gumbel, op for op jax's ``_uniform``/``_gumbel``
    pipeline (mantissa fill to [1, 2), minus 1, affine to [tiny, 1),
    -log(-log(u)))."""
    fb = ((bits >> 9) | 0x3F800000).to(torch.int32)
    u = fb.view(torch.float32) - 1.0
    u = u * _ONE_MINUS_TINY + _TINY
    u = torch.clamp_min(u, _TINY)
    return -torch.log(-torch.log(u))


def _row_keys(seeds, positions):
    """(R,) seeds and positions -> the key data (k1, k2) of
    ``fold_in(key(seed), pos)`` per row, each an (R,) int64 tensor of
    uint32 values. ``key(seed)`` is (0, seed); ``fold_in`` is one
    threefry block of the counter (0, pos) under that key."""
    seeds = _u32(seeds)
    positions = _u32(positions, seeds.device)
    return _threefry2x32(torch.zeros_like(seeds), seeds,
                         torch.zeros_like(positions), positions)


# ---- sampling -----------------------------------------------------------


def _mask_vocab(logits, vocab_size):
    V = logits.shape[-1]
    if vocab_size is None or vocab_size >= V:
        return logits
    keep = torch.arange(V, device=logits.device) < vocab_size
    return torch.where(keep, logits, NEG_INF)


def _temperature_top_k(logits, temperature, top_k, vocab_size):
    """Temperature + top-k masking over (..., V) fp32 logits (the
    padded-vocab tail must already be NEG_INF-masked). The divisor is a
    device tensor so the division is a true IEEE division on every
    device (a Python scalar divisor becomes a reciprocal multiply on
    CUDA)."""
    logits = logits / torch.full((), temperature, dtype=logits.dtype,
                                 device=logits.device)
    if top_k is not None:
        if top_k < 1:
            raise ValueError(f"top_k must be >= 1, got {top_k}")
        eff_v = logits.shape[-1]
        if vocab_size is not None and vocab_size < eff_v:
            eff_v = vocab_size
        k = min(int(top_k), eff_v)
        kth = torch.sort(logits, dim=-1).values[..., -k][..., None]
        logits = torch.where(logits >= kth, logits, NEG_INF)
    return logits


def _gumbel_argmax(logits, k1, k2, partitionable):
    """argmax(gumbel + logits) per row — ``jax.random.categorical``
    over the (R, V) row block, each row with its own key (k1, k2)."""
    R, V = logits.shape
    col = torch.arange(V, device=logits.device)[None]
    g = _bits_to_gumbel(_uniform_bits(k1.reshape(-1, 1), k2.reshape(-1, 1),
                                      col, V, partitionable))
    return torch.argmax(g + logits, dim=-1).to(torch.int32)


def sample_token(logits, key, *, temperature: float = 0.0,
                 top_k: Optional[int] = None,
                 vocab_size: Optional[int] = None,
                 partitionable: bool = True):
    """One sampling step from (B, V) logits with one key ``(k1, k2)``.
    ``temperature == 0`` is greedy argmax; otherwise gumbel-argmax
    sampling over the B*V flat draw, optionally truncated to the
    ``top_k`` best tokens. ``vocab_size`` masks the padded vocab."""
    logits = _mask_vocab(logits.float(), vocab_size)
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    logits = _temperature_top_k(logits, temperature, top_k, vocab_size)
    B, V = logits.shape
    k1, k2 = (_u32(k, logits.device) for k in key)
    flat = torch.arange(B * V, device=logits.device).reshape(B, V)
    g = _bits_to_gumbel(_uniform_bits(k1, k2, flat, B * V, partitionable))
    return torch.argmax(g + logits, dim=-1).to(torch.int32)


def _fused_sample_plain(logits, seeds, positions, *, temperature, top_k,
                        vocab_size, partitionable):
    """Per-row ``fold_in(key(seed), pos)`` + `sample_token` semantics,
    vectorized over the rows."""
    lg = _mask_vocab(logits.float(), vocab_size)
    if temperature == 0.0:
        return torch.argmax(lg, dim=-1).to(torch.int32)
    lg = _temperature_top_k(lg, temperature, top_k, vocab_size)
    k1, k2 = _row_keys(seeds, positions)
    return _gumbel_argmax(lg, k1, k2, partitionable)


def fused_sample(logits, seeds, positions, *, temperature: float = 0.0,
                 top_k: Optional[int] = None,
                 vocab_size: Optional[int] = None,
                 partitionable: bool = True):
    """Counter-keyed sampling over (R, V) logits rows: row r draws with
    ``fold_in(key(seeds[r]), positions[r])``. CUDA logits launch the
    fused kernel (``fused_sample.launches`` counts the launches): vocab
    mask, temperature, gumbel draw and first-index argmax in one pass,
    only the (R,) int32 token ids written. ``top_k`` keeps its sort
    outside the kernel, which then samples the pre-truncated logits."""
    R, V = logits.shape
    dev = logits.device
    seeds = torch.as_tensor(seeds, dtype=torch.int32, device=dev)
    positions = torch.as_tensor(positions, dtype=torch.int32, device=dev)
    if not use_kernel(logits):
        return _fused_sample_plain(logits, seeds, positions,
                                   temperature=temperature, top_k=top_k,
                                   vocab_size=vocab_size,
                                   partitionable=partitionable)
    if seeds.shape != (R,) or positions.shape != (R,):
        raise ValueError("fused_sample: seeds and positions must be (R,)")
    lg = logits.float().contiguous()
    v_eff = V if (vocab_size is None or vocab_size >= V) else int(
        vocab_size)
    greedy = temperature == 0.0
    scale_in_kernel = top_k is None
    if not scale_in_kernel:
        # the sort-based truncation stays outside; mask and scale go
        # with it so the kernel sees the pipeline's final logits
        lg = _mask_vocab(lg, v_eff)
        if not greedy:
            lg = _temperature_top_k(lg, temperature, top_k,
                                    vocab_size).contiguous()
    seeds, positions = seeds.contiguous(), positions.contiguous()
    check_cuda("fused_sample", lg, seeds, positions)
    out = torch.empty(R, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    _build.launch("apex1_fused_sample", lg.data_ptr(), seeds.data_ptr(),
                  positions.data_ptr(), out.data_ptr(), R, V, v_eff,
                  float(temperature), int(greedy), int(scale_in_kernel),
                  int(partitionable), stream)
    fused_sample.launches += 1
    return out


fused_sample.launches = 0


# ---- page plumbing ------------------------------------------------------


def gather_pages(pages, block_table, total_len: int):
    """Dense (N, Hkv, total_len, D) lanes from a page pool
    (num_pages, Hkv, page, D) through an (N, T) block table."""
    g = pages[block_table.long()].transpose(1, 2)    # (N, Hkv, T, P, D)
    N, Hkv, T, P, D = g.shape
    return g.reshape(N, Hkv, T * P, D)[:, :, :total_len, :]


def scatter_pages(pages, block_table, values, start):
    """Write (N, Hkv, W, D) ``values`` into the pool IN PLACE at
    positions ``[start, start + W)`` per row (windows may span pages);
    returns ``pages``. Rows whose block-table entries name the trash
    page write harmless garbage there."""
    P, T = pages.shape[2], block_table.shape[1]
    W = values.shape[2]
    dev = pages.device
    start = torch.as_tensor(start, dtype=torch.int64, device=dev)
    start = start.reshape(-1)
    pos = start[:, None] + torch.arange(W, device=dev)[None]
    pid = torch.gather(block_table.long(), 1, (pos // P).clamp(0, T - 1))
    off = pos % P
    pages[pid, :, off, :] = values.transpose(1, 2).to(pages.dtype)
    return pages


class PagedCache:
    """One layer's paged KV cache entry: K/V page pools plus the block
    table mapping (row, page slot) -> pool page. ``length`` is the
    dense-equivalent lane length (the composite's mask geometry)."""

    def __init__(self, k_pages, v_pages, block_table, length: int):
        self.k_pages = k_pages
        self.v_pages = v_pages
        self.block_table = block_table
        self.length = int(length)


def paged_update_attend(q, k_new, v_new, pc: PagedCache, cache_index, *,
                        sm_scale: Optional[float] = None,
                        chunk_decode: bool = False):
    """Scatter the new tokens' K/V into their pages (in place; the cast
    to the page dtype is the int8 tier's quantized write), then attend
    the updated pages. ``cache_index`` is a scalar or per-row (B,)
    vector. Returns (attn, pc)."""
    B, Hq, S, D = q.shape
    if S > 1 and not chunk_decode:
        raise ValueError(
            "PagedCache prefill must use chunk_decode=True (the paged "
            "pipeline has no flash-prefill mode; an empty cache at "
            "index 0 is the chunk mode's degenerate case)")
    idx = torch.as_tensor(cache_index, dtype=torch.int32, device=q.device)
    idx = idx.reshape(-1).expand(B).contiguous() if idx.numel() == 1 \
        else idx
    scatter_pages(pc.k_pages, pc.block_table, k_new, idx)
    scatter_pages(pc.v_pages, pc.block_table, v_new, idx)
    attn = paged_attend(q, pc.k_pages, pc.v_pages, pc.block_table, idx,
                        sm_scale=sm_scale, total_len=pc.length)
    return attn, pc


# ---- ragged paged attention --------------------------------------------


def _paged_attend_plain(q, k_pages, v_pages, block_table, lengths,
                        sm_scale, total_len):
    k_all = gather_pages(k_pages, block_table, total_len)
    v_all = gather_pages(v_pages, block_table, total_len)
    out = cache_attend(q, k_all, v_all, lengths, sm_scale=sm_scale)
    return out.to(q.dtype)


def paged_attend(q, k_pages, v_pages, block_table, lengths, *,
                 sm_scale: Optional[float] = None,
                 total_len: Optional[int] = None):
    """Ragged paged attention: (N, Hq, S, D) queries against
    (num_pages, Hkv, page, D) K/V pools through an (N, T) int32 block
    table, row n's query j masked to positions <= ``lengths[n] + j``.
    Output (N, Hq, S, D) in q's dtype. CUDA tensors launch the kernel
    (``paged_attend.launches`` counts the launches); CPU tensors gather
    dense lanes and run :func:`cache_attend`."""
    N, Hq, S, D = q.shape
    num_pages, Hkv, P, _ = k_pages.shape
    T = block_table.shape[1]
    if Hq % Hkv != 0:
        raise ValueError(f"Hq={Hq} must be a multiple of Hkv={Hkv}")
    lengths = torch.as_tensor(lengths, dtype=torch.int32,
                              device=q.device).reshape(-1)
    L = T * P if total_len is None else int(total_len)
    if not use_kernel(q):
        return _paged_attend_plain(q, k_pages, v_pages, block_table,
                                   lengths, sm_scale, L)
    if q.dtype not in (torch.float32, torch.bfloat16, torch.float16):
        raise ValueError(f"paged_attend: unsupported q dtype {q.dtype}")
    if k_pages.dtype not in DTYPE_CODES or v_pages.dtype != k_pages.dtype:
        raise ValueError(f"paged_attend: unsupported page dtypes "
                         f"{k_pages.dtype}/{v_pages.dtype}")
    if v_pages.shape != k_pages.shape or k_pages.shape[3] != D:
        raise ValueError("paged_attend: K/V pools must be "
                         "(num_pages, Hkv, page, D) alike")
    if block_table.dtype != torch.int32 or block_table.shape[0] != N:
        raise ValueError("paged_attend: block_table must be (N, T) int32")
    if lengths.shape != (N,):
        raise ValueError("paged_attend: lengths must be (N,)")
    q, lengths = q.contiguous(), lengths.contiguous()
    bt = block_table.contiguous()
    check_cuda("paged_attend", q, k_pages, v_pages, bt, lengths)
    scale = (D ** -0.5) if sm_scale is None else sm_scale
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    _build.launch("apex1_paged_attend", q.data_ptr(), k_pages.data_ptr(),
                  v_pages.data_ptr(), bt.data_ptr(), lengths.data_ptr(),
                  out.data_ptr(), N, Hq, Hkv, S, D, P, T, float(scale),
                  DTYPE_CODES[q.dtype], DTYPE_CODES[k_pages.dtype], stream)
    paged_attend.launches += 1
    return out


paged_attend.launches = 0
