"""Counter-based dropout masks and the fused bias-dropout-add (the port
of ``apex1_tpu/ops/stochastic.py``).

No mask tensor is ever stored: forward and backward derive the keep
mask from an int32 seed and the element's position counters,

    bits = hash_bits_u32(seed, salt, row, col)   one uint32 word
    keep = bits >= threshold_u32(p)              p·2^32, rounded

with ``row``/``col`` GLOBAL positions (the attention kernels fold their
q/k offsets in, and salt is ``b·H + h``; the row kernels use salt 0).
The hash is the reference's: its XLA composites and its Pallas kernels
in interpret mode draw these very masks, bit for bit. (Its compiled
TPU path draws from the TPU's hardware PRNG instead, which no GPU
reproduces; the hash is the port's mask on every device.)

Seeds are plain int32 values: Python ints or 0-d int32 tensors. Derive
one per call site with `fold_seed`: two sites sharing a seed draw
identical masks. The reference's ``seed_from_key`` derives a seed from
a ``jax.random`` key; the port has no such keys, so it has no
counterpart: callers pass int seeds (the models take a base seed and
fold per-layer seeds from it, see `models.bert`).

On the CPU there are no uint32 shifts, adds or compares in PyTorch, so
the hash runs on int64 tensors holding uint32 values, each step masked
with ``& 0xFFFFFFFF`` and each product split in 16-bit halves so that
no int64 product overflows.

Kernels (``csrc/bias_dropout_add.cu``, TPU rows 14-15), each beside its
plain PyTorch version: `bda_fwd` (y = residual + keep·(x + bias)/(1 -
p)) and `bda_bwd` (dx = keep·dy/(1 - p) and dbias = Σ_rows dx in
fp32). `fused_bias_dropout_add` is differentiable through one
``torch.autograd.Function`` that saves only the seed, p and the dtypes.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from apex1_tpu_torch.ops import _build
from apex1_tpu_torch.ops._common import DTYPE_CODES, check_cuda, use_kernel
from apex1_tpu_torch.ops.layer_norm import layer_norm, rms_norm

SEED_MAX = 0x7FFFFFFF  # the largest seed `fold_seed` returns

_GOLDEN = 0x9E3779B9   # 2^32/φ — Weyl increment for salting
_C_ROW = 0x85EBCA6B    # odd multipliers: murmur3 finalizer constants
_C_COL = 0xC2B2AE35
_M32 = 0xFFFFFFFF

_DTYPES = (torch.float32, torch.bfloat16, torch.float16)

#: widest row the backward with bias takes: its per-column fp32 sums
#: fill at most the 48 KB of shared memory a block gets without opting in
MAX_DBIAS_H = 12288

#: row blocks of the backward's first pass with bias (each writes one
#: fp32 row of dbias partials)
_BWD_GROUPS = 512


def _u32(v):
    """A uint32 word as a Python int, or an int64 tensor of them."""
    if isinstance(v, torch.Tensor):
        return v.to(torch.int64) & _M32
    return int(v) & _M32


def _mul32(x, c: int):
    """``(x * c) mod 2^32`` for uint32 words ``x`` (ints or int64
    tensors) and a uint32 constant ``c``: ``c`` split at 16 bits, so no
    partial product passes 2^48."""
    hi, lo = c >> 16, c & 0xFFFF
    return ((((x * hi) & 0xFFFF) << 16) + x * lo) & _M32


def _mix32(x):
    """'lowbias32' avalanche finalizer on uint32 words (bijective)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def hash_bits_u32(seed, salt, row, col):
    """Counter-based uint32 stream: one word per (seed, salt, row, col),
    returned as int64 (values in [0, 2^32)). Arguments are ints or int
    tensors, broadcast together; the reference's chained bijective
    mixes (the salt gets its own avalanche before the row enters)."""
    s = _mix32((_u32(seed) + _GOLDEN) & _M32)
    s = _mix32(s ^ _mul32(_u32(salt), _C_ROW))
    h = _mix32(s ^ _mul32(_u32(row), _C_ROW))
    return _mix32(h ^ _mul32(_u32(col), _C_COL))


def threshold_u32(p: float) -> int:
    """Drop threshold: keep iff bits >= round(p·2^32)."""
    if not 0.0 < p < 1.0:
        raise ValueError(f"dropout p must be in (0, 1), got {p}")
    return min(int(round(p * 4294967296.0)), _M32)


def inv_keep(p: float) -> float:
    """``1 / (1 - p)`` as the fp32 value the reference multiplies by
    (a Python float is rounded to fp32 against an fp32 array)."""
    return float(np.float32(1.0 / (1.0 - p)))


def attn_keep_mask(seed, num_batch: int, num_heads: int, rows, cols, p):
    """Attention-probability keep mask at GLOBAL positions: bool
    (num_batch, num_heads, Sq, Sk) for int tensors ``rows``/``cols``
    broadcastable to (Sq, Sk) (the caller folds in its q/k offsets);
    salt ``b·num_heads + h`` per (batch, head)."""
    dev = rows.device
    salt = (torch.arange(num_batch, device=dev)[:, None] * num_heads
            + torch.arange(num_heads, device=dev)[None, :])
    bits = hash_bits_u32(_seed_on(seed, dev), salt[:, :, None, None],
                         rows[None, None], cols[None, None])
    return bits >= threshold_u32(p)


def fold_seed(seed, salt: int):
    """Per-site stream from one base seed (≙ ``fold_in`` for int32
    seeds); a Python int for an int seed, else an int32 tensor. Call
    sites that share a base seed must fold distinct salts."""
    s = _mix32((_u32(seed) + ((_GOLDEN * (salt + 1)) & _M32)) & _M32)
    s = s & SEED_MAX
    return s.to(torch.int32) if isinstance(s, torch.Tensor) else s


def _seed_on(seed, device):
    return seed.to(device) if isinstance(seed, torch.Tensor) else seed


def _seed_word(seed) -> int:
    """The seed as the kernels' uint32 word (a CUDA tensor seed costs
    one host sync)."""
    return int(seed) & _M32


def _row_keep(seed, rows: int, h: int, p: float, device):
    """(rows, h) bool: the row kernels' mask (salt 0, global rows)."""
    r = torch.arange(rows, device=device)[:, None]
    c = torch.arange(h, device=device)[None, :]
    return hash_bits_u32(_seed_on(seed, device), 0, r, c) >= threshold_u32(p)


# ---- plain versions ------------------------------------------------------


def _bda_plain_fwd(x2, r2, bias, seed, p):
    """The reference's ``_bda_xla`` on (rows, h) views: fp32 math,
    rounded to x's dtype."""
    xb = x2.float()
    if bias is not None:
        xb = xb + bias.float()
    keep = _row_keep(seed, x2.shape[0], x2.shape[1], p, x2.device)
    y = torch.where(keep, xb * inv_keep(p), 0.0) + r2.float()
    return y.to(x2.dtype)


def _bda_plain_bwd(dy2, seed, p, with_bias):
    """dx in dy's dtype and, with a bias, dbias = Σ_rows of the fp32 dx
    (before its rounding), as ``_bda_bwd_kernel`` sums it."""
    keep = _row_keep(seed, dy2.shape[0], dy2.shape[1], p, dy2.device)
    dx = torch.where(keep, dy2.float() * inv_keep(p), 0.0)
    return dx.to(dy2.dtype), (dx.sum(dim=0) if with_bias else None)


# ---- kernel wrappers -----------------------------------------------------


def _vec(h: int, *tensors) -> int:
    """16-byte accesses: every row a whole number of 16-byte packs of
    each operand and every operand 16-byte aligned."""
    return int(all(h * t.element_size() % 16 == 0 and t.data_ptr() % 16 == 0
                   for t in tensors))


def bda_fwd(x2: torch.Tensor, r2: torch.Tensor, bias: Optional[torch.Tensor],
            seed, p: float) -> torch.Tensor:
    """``residual + keep·(x + bias)/(1 - p)`` over (rows, h) views, in
    x's dtype; ``bias`` (h,) or None. CUDA tensors launch the kernel
    (``bda_fwd.launches``); CPU tensors take the plain version."""
    if not use_kernel(x2):
        return _bda_plain_fwd(x2, r2, bias, seed, p)
    if (x2.dim() != 2 or r2.shape != x2.shape or x2.dtype not in _DTYPES
            or r2.dtype not in _DTYPES):
        raise ValueError(f"bda_fwd: x {tuple(x2.shape)} {x2.dtype} and "
                         f"residual {tuple(r2.shape)} {r2.dtype}")
    rows, h = x2.shape
    x2, r2 = x2.contiguous(), r2.contiguous()
    b = None if bias is None else bias.float().reshape(h).contiguous()
    check_cuda("bda_fwd", x2, r2, b)
    y = torch.empty_like(x2)
    stream = torch.cuda.current_stream(x2.device).cuda_stream
    _build.launch("apex1_bda_fwd", x2.data_ptr(), r2.data_ptr(),
                  None if b is None else b.data_ptr(), y.data_ptr(), rows, h,
                  _seed_word(seed), threshold_u32(p), inv_keep(p),
                  _vec(h, x2, r2, y), DTYPE_CODES[x2.dtype],
                  DTYPE_CODES[r2.dtype], stream)
    bda_fwd.launches += 1
    return y


bda_fwd.launches = 0


def bda_bwd(dy2: torch.Tensor, seed, p: float, with_bias: bool):
    """``(dx, dbias)``: dx = keep·dy/(1 - p) in dy's dtype over (rows,
    h), dbias (h,) fp32 (None without a bias), summed over rows in a
    fixed order. CUDA tensors launch the kernel (``bda_bwd.launches``);
    CPU tensors take the plain version."""
    if not use_kernel(dy2):
        return _bda_plain_bwd(dy2, seed, p, with_bias)
    if dy2.dim() != 2 or dy2.dtype not in _DTYPES:
        raise ValueError(f"bda_bwd: dy {tuple(dy2.shape)} {dy2.dtype}")
    rows, h = dy2.shape
    if with_bias and h > MAX_DBIAS_H:
        raise ValueError(f"bda_bwd: h={h} is wider than the dbias pass's "
                         f"{MAX_DBIAS_H}")
    dy2 = dy2.contiguous()
    check_cuda("bda_bwd", dy2)
    dev = dy2.device
    dx = torch.empty_like(dy2)
    rows_per_block = max(1, -(-rows // _BWD_GROUPS))
    groups = -(-rows // rows_per_block) if rows else 0
    part = db = None
    if with_bias:
        part = torch.empty(groups, h, dtype=torch.float32, device=dev)
        db = torch.empty(h, dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    _build.launch("apex1_bda_bwd", dy2.data_ptr(), dx.data_ptr(),
                  None if part is None else part.data_ptr(),
                  None if db is None else db.data_ptr(), rows, h,
                  rows_per_block, groups, _seed_word(seed), threshold_u32(p),
                  inv_keep(p), _vec(h, dy2, dx), DTYPE_CODES[dy2.dtype],
                  stream)
    bda_bwd.launches += 1
    return dx, db


bda_bwd.launches = 0


class _BiasDropoutAdd(torch.autograd.Function):
    """The reference's ``_bda`` custom VJP: the residuals are the seed,
    p and the dtypes, never a mask or an activation."""

    @staticmethod
    def forward(ctx, x, residual, bias, seed, p):
        h = x.shape[-1]
        y = bda_fwd(x.reshape(-1, h), residual.reshape(-1, h), bias, seed,
                    p)
        ctx.seed, ctx.p = seed, p
        ctx.res_dtype = residual.dtype
        ctx.bias_dtype = None if bias is None else bias.dtype
        return y.reshape(x.shape)

    @staticmethod
    def backward(ctx, dy):
        h = dy.shape[-1]
        dx, db = bda_bwd(dy.reshape(-1, h), ctx.seed, ctx.p,
                         ctx.bias_dtype is not None)
        if db is not None:
            db = db.to(ctx.bias_dtype)
        return (dx.reshape(dy.shape), dy.to(ctx.res_dtype), db, None, None)


def fused_bias_dropout_add(x: torch.Tensor, residual: torch.Tensor, *,
                           p: float, seed=None,
                           bias: Optional[torch.Tensor] = None,
                           block_rows: Optional[int] = None) -> torch.Tensor:
    """``dropout(x + bias)/(1-p) + residual`` in one row-kernel pass,
    the mask recomputed from ``seed`` in the backward (the Megatron
    ``bias_dropout_add`` epilogue). ``p == 0`` is the plain add, bit
    for bit. ``seed``: an int32 seed (required when p > 0). ``bias``:
    optional (H,) vector, differentiable. ``block_rows`` is the TPU
    kernel's row block: accepted and ignored."""
    del block_rows
    if residual.shape != x.shape:
        raise ValueError(f"residual shape {tuple(residual.shape)} != x "
                         f"shape {tuple(x.shape)}")
    if bias is not None and tuple(bias.shape) != (x.shape[-1],):
        raise ValueError(f"bias must be ({x.shape[-1]},), got "
                         f"{tuple(bias.shape)}")
    p = float(p)
    if p == 0.0:
        y = x if bias is None else x + bias.to(x.dtype)
        return y + residual.to(x.dtype)
    if seed is None:
        raise ValueError("dropout p > 0 needs an explicit int32 seed "
                         "(fold_seed at the call site)")
    return _BiasDropoutAdd.apply(x, residual, bias, seed, p)


def fused_dropout_add_layer_norm(x, residual, gamma, beta, *, p: float,
                                 seed=None, bias=None, eps: float = 1e-5,
                                 rms: bool = False, prenorm: bool = False,
                                 block_rows: Optional[int] = None):
    """``LN(dropout(x + bias)/(1-p) + residual)``: `fused_bias_dropout_add`
    then the norm kernels (`layer_norm`, or `rms_norm` with ``rms``,
    which ignores ``beta``). ``prenorm=True`` also returns the pre-norm
    sum z: ``(y, z)``."""
    z = fused_bias_dropout_add(x, residual, p=p, seed=seed, bias=bias,
                               block_rows=block_rows)
    if rms:
        y = rms_norm(z, gamma, eps=eps)
    else:
        y = layer_norm(z, gamma, beta, eps=eps)
    return (y, z) if prenorm else y


def layer_seeds(dropout_rng, num_layers: int) -> list:
    """The per-layer int32 seeds of a model's dropout, as Python ints.
    ``dropout_rng`` is a (num_layers,) int tensor (or sequence) of
    per-layer seeds, used as given; or one int base seed (an int or a
    0-d tensor), and then layer i's seed is ``fold_seed(base, i)``. The
    port's counterpart of flax's per-module ``make_rng("dropout")``,
    whose keys it has no way to draw. (Read once to the host here, so
    the kernels take plain ints.)"""
    if isinstance(dropout_rng, torch.Tensor) and dropout_rng.dim() == 0:
        dropout_rng = int(dropout_rng)
    if isinstance(dropout_rng, int):
        return [fold_seed(dropout_rng, i) for i in range(num_layers)]
    seeds = [int(s) for s in (dropout_rng.tolist()
                              if isinstance(dropout_rng, torch.Tensor)
                              else dropout_rng)]
    if len(seeds) != num_layers:
        raise ValueError(f"dropout_rng holds {len(seeds)} seeds for "
                         f"{num_layers} layers")
    return seeds
