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
  ``csrc/int8_matmul.cu`` (TPU row 20), which converts the int8 tile to
  bf16 in registers, so the bf16 weight matrix never exists in device
  memory; CPU tensors take the plain version, the JAX package's
  composite ``_dequant_matmul_xla``.

The JAX package sends shapes that are not multiples of 128, or more
than 1024 rows, to its composite (a TPU tiling rule). The CUDA kernel
takes every shape and masks its ragged tiles; the numbers are defined
the same way either side (bf16 activations, fp32 sums, fp32 scale
last).
"""

from __future__ import annotations

import math

import torch

from apex1_tpu_torch.ops import _build
from apex1_tpu_torch.ops._common import check_cuda, use_kernel

#: the kernel's tiles (``csrc/int8_matmul.cu``): weight rows and K depth a
#: block step, and the blocks wanted in flight on the 132 SMs
_BN, _KT, _SMS = 64, 64, 132


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


def _split_k(T: int, N: int, K: int) -> tuple[int, int]:
    """(splits, K per split, a multiple of the kernel's K step). A grid
    under 2 blocks an SM splits K until about 4 an SM are in flight."""
    tiles = math.ceil(N / _BN) * math.ceil(T / (8 if T <= 8 else 64))
    splits = 1
    if tiles < 2 * _SMS:
        splits = min(math.ceil(4 * _SMS / tiles), math.ceil(K / _KT))
    kc = math.ceil(math.ceil(K / splits) / _KT) * _KT
    return math.ceil(K / kc), kc


def int8_mm(x2: torch.Tensor, wq: torch.Tensor,
            scale: torch.Tensor) -> torch.Tensor:
    """(T, K) ``x2`` against (N, K) int8 ``wq`` and (N,) fp32 ``scale``:
    (T, N) fp32. CUDA tensors launch the kernel (``int8_mm.launches``
    counts the calls), CPU tensors take the plain version."""
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
    splits, kc = _split_k(T, N, K)
    part = (torch.empty(splits, T, N, dtype=torch.float32, device=xb.device)
            if splits > 1 else None)
    vec = K % 16 == 0 and xb.data_ptr() % 16 == 0 and wq.data_ptr() % 16 == 0
    stream = torch.cuda.current_stream(xb.device).cuda_stream
    _build.launch("apex1_int8_mm", xb.data_ptr(), wq.data_ptr(),
                  scale.data_ptr(), out.data_ptr(),
                  None if part is None else part.data_ptr(), T, N, K, splits,
                  kc, int(T > 8), int(vec), stream)
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
