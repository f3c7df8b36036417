"""Weight-only int8 quantized matmul (the port of
``apex1_tpu/ops/quantized.py``).

Decode streams every weight once per token step for a few rows of
work, so its time is the weight bytes over the memory rate; int8
storage with per-output-channel fp32 scales halves them against bf16.

- :func:`quantize_int8` — symmetric per-output-channel quantization of
  a 2-D weight (max-abs / 127), equal to the JAX function bit for bit.
- :func:`int8_matmul` — ``y = (bf16(x) @ bf16(wq)ᵀ) * scale``, summed
  in fp32, the scale applied once after the whole K sum; fp32 output,
  leading dimensions of ``x`` kept; differentiable in ``x`` only.
- :func:`int8_mm` — the 2-D product: CUDA tensors launch
  ``csrc/int8_matmul.cu`` (TPU row 20), a wgmma product whose threads
  convert the int8 weight to bf16 in their own registers, so the bf16
  weight matrix never exists in device memory; one launch a call, a K
  split summed inside it (`int8_plan`: an explicit ``tile``, else the
  tuning table's ``int8_matmul`` entry, else `_tile` and `_split_k`);
  CPU tensors take the plain version, the JAX package's composite
  ``_dequant_matmul_xla``.

The JAX package sends shapes that are not multiples of 128, or more
than 1024 rows, to its composite (a TPU tiling rule). The CUDA kernel
takes every shape and masks its ragged tiles; the numbers are defined
the same way either side (bf16 activations, fp32 sums, fp32 scale
last).
"""

from __future__ import annotations

import math

import torch

from apex1_tpu_torch import tuning
from apex1_tpu_torch.ops import _build
from apex1_tpu_torch.ops._common import check_cuda, use_kernel

#: the kernel's K step and the card's SMs (``csrc/int8_matmul.cu``)
_KT, _SMS = 64, 132
#: the most output tiles a K-split grid may have (the counters the
#: wrapper allocates once per device), the most fp32 partial-sum bytes a
#: split may write (they stay in the 50 MB L2), the most slices, and the
#: most partial-sum bytes a tile's last block adds
_MAX_TILES, _PART_BYTES, _MAX_SPLITS = 1024, 16 << 20, 16
_TILE_PART_BYTES = 32 << 10
#: a two-warpgroup tile's step has fixed work (the weight tile's
#: conversion, the barrier) that takes about as long as the products of
#: this many token columns (fitted to prefill tiles of 128 and 256
#: tokens on an H100)
_STEP_COLUMNS = 183
_COUNTERS: dict = {}


def _tile(T: int, N: int) -> tuple[int, int]:
    """(weight rows, tokens) of the kernel's output tile. Two warpgroups'
    128 weight rows where 128 x 128 tiles fill the 132 SMs, by the 128,
    192 or 256 tokens whose waves of tiles take least (`_wide_cost`);
    else one warpgroup's 64 rows (several blocks an SM) by the smallest
    of 8, 16, 32, 64, 128 tokens that holds T (128 past it, or 64 where
    even 64 x 128 tiles leave SMs idle: a short grid splits K, and
    smaller tiles leave less to sum)."""
    def tiles(bm, bt):
        return math.ceil(N / bm) * math.ceil(T / bt)
    if T > 128 and tiles(128, 128) >= _SMS:
        return 128, min((256, 192, 128), key=lambda bt: _wide_cost(
            tiles(128, bt), bt))
    bt = next((b for b in (8, 16, 32, 64) if T <= b), 128)
    if bt == 128 and tiles(64, 128) < _SMS:
        bt = 64
    return 64, bt


def _wide_cost(tiles: int, bt: int) -> int:
    """A two-warpgroup grid's time in token columns: its waves on the 132
    SMs, each as long as a tile's step, a fixed part (the weight tile's
    conversion and the step's barriers, `_STEP_COLUMNS`) and a part that
    grows with the tokens."""
    return math.ceil(tiles / _SMS) * (_STEP_COLUMNS + bt)


def _split_k(T: int, N: int, K: int) -> tuple[int, int]:
    """(splits, K per split, a multiple of the kernel's K step). A grid
    under 2 blocks an SM splits every tile's K into as many slices as
    keep it within 2 blocks an SM (a third block on some SMs would hold
    the rest back), at most `_MAX_SPLITS`, their fp32 partial sums within
    `_PART_BYTES` and a tile's within `_TILE_PART_BYTES` (the last block
    of the tile adds them); the slices are summed inside the launch."""
    bm, bt = _tile(T, N)
    tiles = math.ceil(N / bm) * math.ceil(T / bt)
    splits = 1
    if tiles < 2 * _SMS:
        splits = min(2 * _SMS // tiles, math.ceil(K / _KT),
                     max(1, _PART_BYTES // (4 * T * N)), _MAX_SPLITS,
                     max(1, _TILE_PART_BYTES // (4 * bm * bt)))
    kc = math.ceil(math.ceil(K / splits) / _KT) * _KT
    return math.ceil(K / kc), kc


def int8_plan(T: int, N: int, K: int, tile=None) -> tuple:
    """The launch's (bm, bt, splits, kc): ``tile`` (a dict of the four,
    what the sweep passes) > the tuning table's ``int8_matmul`` entry
    for (N, K, the token bucket) > `_tile` and `_split_k`. A table entry
    whose K split needs more ticket counters than the device holds at
    this T is a miss."""
    def heuristic():
        bm, bt = _tile(T, N)
        splits, kc = _split_k(T, N, K)
        return dict(bm=bm, bt=bt, splits=splits, kc=kc)
    got, src = tuning.resolve(
        "int8_matmul", tile,
        lambda: {"N": N, "K": K, "Tb": tuning.token_bucket(T)}, "int8",
        heuristic)
    tiles = math.ceil(N / got["bm"]) * math.ceil(T / got["bt"])
    if src == "table" and got["splits"] > 1 and tiles > _MAX_TILES:
        got = heuristic()
    return got["bm"], got["bt"], got["splits"], got["kc"]


def _counters(device: torch.device) -> torch.Tensor:
    """The K-split grid's ticket counters on ``device``: zeros, allocated
    once (the kernel leaves them zero). One launch at a time may use
    them: the port runs the kernel on one stream a device."""
    c = _COUNTERS.get(device)
    if c is None:
        c = _COUNTERS[device] = torch.zeros(_MAX_TILES, dtype=torch.int32,
                                            device=device)
    return c


def quantize_int8(w: torch.Tensor, *, axis: int = -1):
    """Symmetric per-channel int8 quantization of a 2-D weight.

    ``w``: (N, K) with ``axis`` the contraction (K) axis; each of the N
    output channels gets one fp32 scale = max|w| / 127 (at least 1e-12,
    so an all-zero channel stays zero) over its K entries. Returns
    ``(wq int8 (N, K), scale fp32 (N,))`` with
    ``w ≈ wq * scale[:, None]``; ``round`` is half to even, as
    ``jnp.round``. Plain tensor ops, run once per weight; the divisors
    are tensors so the divisions are IEEE divisions on every device."""
    if w.dim() != 2:
        raise ValueError(f"quantize_int8 expects a 2-D weight, got "
                         f"{tuple(w.shape)}")
    if axis not in (0, 1, -1, -2):
        raise ValueError(f"axis must name one of the 2 dims, got {axis}")
    if axis in (0, -2):
        w = w.t()
    wf = w.float()
    f32 = dict(dtype=torch.float32, device=wf.device)
    scale = wf.abs().amax(dim=1) / torch.full((), 127.0, **f32)
    scale = torch.maximum(scale, torch.full((), 1e-12, **f32))
    wq = torch.clamp(torch.round(wf / scale[:, None]), -127, 127)
    return wq.to(torch.int8).contiguous(), scale


def _int8_mm_plain(x2, wq, scale):
    """The JAX composite: bf16 activations against the int8 values
    (exact in any float width), fp32 sums, the fp32 scale last."""
    return (x2.to(torch.bfloat16).float() @ wq.float().t()) * scale


def int8_mm(x2: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor, *,
            tile=None) -> torch.Tensor:
    """(T, K) ``x2`` against (N, K) int8 ``wq`` and (N,) fp32 ``scale``:
    (T, N) fp32. CUDA tensors launch the kernel (``int8_mm.launches``
    counts the calls) with `int8_plan`'s parameters (``tile``: the
    sweep's explicit ones), CPU tensors take the plain version."""
    if not use_kernel(x2):
        return _int8_mm_plain(x2, wq, scale)
    if wq.dtype != torch.int8 or scale.dtype != torch.float32:
        raise ValueError(f"int8_mm: weights must be int8 with fp32 scales, "
                         f"got {wq.dtype}, {scale.dtype}")
    if x2.dim() != 2 or wq.dim() != 2 or wq.shape[1] != x2.shape[1] \
            or scale.shape != (wq.shape[0],):
        raise ValueError(f"int8_mm: x {tuple(x2.shape)}, wq "
                         f"{tuple(wq.shape)} and scale {tuple(scale.shape)} "
                         f"do not fit")
    xb = x2.to(torch.bfloat16).contiguous()
    wq, scale = wq.contiguous(), scale.contiguous()
    check_cuda("int8_mm", xb, wq, scale)
    (T, K), N = xb.shape, wq.shape[0]
    out = torch.empty(T, N, dtype=torch.float32, device=xb.device)
    bm, bt, splits, kc = int8_plan(T, N, K, tile)
    tiles = math.ceil(N / bm) * math.ceil(T / bt)
    part = (torch.empty(tiles * splits * bm * bt, dtype=torch.float32,
                        device=xb.device) if splits > 1 else None)
    vec = K % 16 == 0 and xb.data_ptr() % 16 == 0 and wq.data_ptr() % 16 == 0
    stream = torch.cuda.current_stream(xb.device).cuda_stream
    _build.launch("apex1_int8_mm", xb.data_ptr(), wq.data_ptr(),
                  scale.data_ptr(), out.data_ptr(),
                  None if part is None else part.data_ptr(),
                  _counters(xb.device).data_ptr(), T, N, K, splits, kc, bm,
                  bt, int(vec), stream)
    int8_mm.launches += 1
    return out


int8_mm.launches = 0


class _Int8Matmul(torch.autograd.Function):
    """The JAX package's custom VJP: ``dx = ((dy * s) @ wq) `` in fp32,
    rounded to x's dtype (a plain product, outside any TPU kernel there
    too); ``wq`` and ``scale`` get no gradient."""

    @staticmethod
    def forward(ctx, x2, wq, scale):
        ctx.save_for_backward(wq, scale)
        ctx.x_dtype = x2.dtype
        return int8_mm(x2, wq, scale)

    @staticmethod
    def backward(ctx, dy):
        wq, scale = ctx.saved_tensors
        dx = (dy.float() * scale.float()) @ wq.float()
        return dx.to(ctx.x_dtype), None, None


def int8_matmul(x: torch.Tensor, wq: torch.Tensor,
                scale: torch.Tensor) -> torch.Tensor:
    """``y = x @ (wq * scale[:, None]).T``: (..., K) against (N, K) int8
    and (N,) fp32 scales from :func:`quantize_int8`; (..., N) fp32
    (cast at the call site). Differentiable in ``x`` only."""
    lead, K = x.shape[:-1], x.shape[-1]
    y = _Int8Matmul.apply(x.reshape(-1, K), wq, scale)
    return y.reshape(*lead, wq.shape[0])
