"""Fused scale + mask + softmax (the port of ``apex1_tpu/ops/softmax.py``).

    y  = softmax(scale * x + mask)      mask additive, broadcastable
    causal ("upper_triang"): columns past the row's query index -> NEG_INF
    dx = scale * y * (dy - sum(dy * y))  (saved: y only)

Kernels ``csrc/softmax.cu`` (one warp per row, forward and backward),
each beside its plain PyTorch version. ``scaled_masked_softmax`` and
``scaled_upper_triang_masked_softmax`` are differentiable through one
``torch.autograd.Function``. The output keeps ``x.dtype``; statistics
are fp32. ``FusedScaleMaskSoftmax`` comes with the BERT slice.
"""

from __future__ import annotations

from typing import Optional

import torch

from apex1_tpu_torch.ops import _build
from apex1_tpu_torch.ops._common import (DTYPE_CODES, NEG_INF, check_cuda,
                                         use_kernel)

_DTYPES = (torch.float32, torch.bfloat16, torch.float16)


def _as4d(x: torch.Tensor) -> torch.Tensor:
    """(..., sq, sk) -> (B, H, sq, sk), leading dims folded into B."""
    if x.dim() == 2:
        return x.reshape(1, 1, *x.shape)
    if x.dim() == 3:
        return x.reshape(x.shape[0], 1, x.shape[1], x.shape[2])
    return x.reshape(-1, *x.shape[-3:])


def _mask4d(mask: torch.Tensor, x_shape4) -> torch.Tensor:
    """A broadcastable mask as 4-D with every dim 1 or full."""
    m = (mask.reshape((1,) * (4 - mask.dim()) + tuple(mask.shape))
         if mask.dim() < 4 else mask.reshape(-1, *mask.shape[-3:]))
    for ax, full in enumerate(x_shape4):
        if m.shape[ax] not in (1, full):
            raise ValueError(f"mask shape {tuple(mask.shape)} not "
                             f"broadcastable to {tuple(x_shape4)}")
    return m


def _plain_fwd(x4, m4, scale, causal):
    """The JAX package's ``_fwd_kernel`` in plain PyTorch."""
    v = x4.float() * scale
    if m4 is not None:
        v = v + m4.float()
    if causal:
        sq, sk = x4.shape[-2:]
        q = torch.arange(sq, device=x4.device)[:, None]
        col = torch.arange(sk, device=x4.device)[None, :]
        v = torch.where(col > q, NEG_INF, v)
    m = v.amax(dim=-1, keepdim=True)
    e = torch.exp(v - m)
    return (e / e.sum(dim=-1, keepdim=True)).to(x4.dtype)


def _plain_bwd(y, dy, scale):
    """The JAX package's ``_bwd_kernel`` in plain PyTorch."""
    y32, dy32 = y.float(), dy.float()
    dot = (y32 * dy32).sum(dim=-1, keepdim=True)
    return (scale * y32 * (dy32 - dot)).to(y.dtype)


def softmax_fwd(x4: torch.Tensor, m4: Optional[torch.Tensor], scale: float,
                causal: bool) -> torch.Tensor:
    """Row softmax of (B, H, Sq, Sk) scores with an optional 4-D additive
    mask whose dims are 1 or full. CUDA tensors launch the kernel
    (``softmax_fwd.launches``); CPU tensors take the plain version."""
    if not use_kernel(x4):
        return _plain_fwd(x4, m4, scale, causal)
    if x4.dim() != 4 or x4.dtype not in _DTYPES:
        raise ValueError(f"softmax_fwd takes 4-D f32/bf16/f16 scores, got "
                         f"{tuple(x4.shape)} {x4.dtype}")
    x4 = x4.contiguous()
    b, nh, sq, sk = x4.shape
    if m4 is not None:
        # fp32, dense over its own (broadcast) shape; a size-1 dim reads
        # with stride 0
        m4 = m4.float().contiguous()
        strides = [0 if m4.shape[i] == 1 else m4.stride(i)
                   for i in range(4)]
    else:
        strides = [0, 0, 0, 0]
    check_cuda("softmax_fwd", x4, m4)
    y = torch.empty_like(x4)
    stream = torch.cuda.current_stream(x4.device).cuda_stream
    _build.launch("apex1_softmax_fwd", x4.data_ptr(),
                  None if m4 is None else m4.data_ptr(), y.data_ptr(),
                  b, nh, sq, sk, float(scale), int(causal), *strides,
                  DTYPE_CODES[x4.dtype], stream)
    softmax_fwd.launches += 1
    return y


softmax_fwd.launches = 0


def softmax_bwd(y: torch.Tensor, dy: torch.Tensor,
                scale: float) -> torch.Tensor:
    """dx of the softmax over the last axis from its output ``y``, in
    ``y.dtype``. CUDA tensors launch the kernel
    (``softmax_bwd.launches``); CPU tensors take the plain version."""
    if not use_kernel(y):
        return _plain_bwd(y, dy, scale)
    if y.dtype not in _DTYPES or dy.shape != y.shape:
        raise ValueError(f"softmax_bwd: y {tuple(y.shape)} {y.dtype} and "
                         f"dy {tuple(dy.shape)}")
    y = y.contiguous()
    dy = dy.to(y.dtype).contiguous()
    check_cuda("softmax_bwd", y, dy)
    dx = torch.empty_like(y)
    sk = y.shape[-1]
    stream = torch.cuda.current_stream(y.device).cuda_stream
    _build.launch("apex1_softmax_bwd", y.data_ptr(), dy.data_ptr(),
                  dx.data_ptr(), y.numel() // sk, sk, float(scale),
                  DTYPE_CODES[y.dtype], stream)
    softmax_bwd.launches += 1
    return dx


softmax_bwd.launches = 0


class _FusedSoftmax(torch.autograd.Function):
    """The JAX package's ``_fused_softmax`` custom VJP; the mask gets
    no gradient."""

    @staticmethod
    def forward(ctx, x, mask, scale, causal):
        x4 = _as4d(x)
        m4 = None if mask is None else _mask4d(mask, x4.shape)
        y = softmax_fwd(x4, m4, scale, causal).reshape(x.shape)
        ctx.save_for_backward(y)
        ctx.scale = scale
        return y

    @staticmethod
    def backward(ctx, dy):
        (y,) = ctx.saved_tensors
        return softmax_bwd(y, dy, ctx.scale), None, None, None


def scaled_masked_softmax(x: torch.Tensor,
                          mask: Optional[torch.Tensor] = None, *,
                          scale: float = 1.0) -> torch.Tensor:
    """``scaled_masked_softmax_cuda``: ``x`` (..., sq, sk) scores,
    ``mask`` additive and broadcastable to ``x`` (use large negative
    values such as ``NEG_INF`` for masked positions)."""
    return _FusedSoftmax.apply(x, mask, float(scale), False)


def scaled_upper_triang_masked_softmax(x: torch.Tensor, *,
                                       scale: float = 1.0) -> torch.Tensor:
    """``scaled_upper_triang_masked_softmax_cuda`` (causal)."""
    return _FusedSoftmax.apply(x, None, float(scale), True)
