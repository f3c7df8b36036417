"""Softmax cross-entropy with label smoothing (the port of
``apex1_tpu/ops/xentropy.py``, apex's ``contrib.xentropy``).

Loss (label smoothing ε, K real classes):
    loss_i = (1-ε) (lse_i - x_i[t_i]) + ε (lse_i - Σ_{k<K} x_ik / K)
    dx_i   = softmax(x_i) - (1-ε) onehot(t_i) - ε/K     (0 for k >= K)
``padding_idx`` rows give loss 0 and a zero gradient.

Kernels ``csrc/xentropy.cu`` (a block a row, the row streamed in
16-byte vectors), each beside its plain PyTorch version. The forward
keeps only the per-row lse for the backward, which recomputes
``exp(x - lse)`` from the logits, as the reference does: no (tokens x
vocab) probabilities are stored.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.distributed.tensor import DTensor

from apex1_tpu_torch.ops import _build
from apex1_tpu_torch.ops._common import (DTYPE_CODES, NEG_INF, check_cuda,
                                         use_kernel)

_DTYPES = (torch.float32, torch.bfloat16, torch.float16)


def _as3d(logits: torch.Tensor) -> torch.Tensor:
    """(..., T, V) -> (A, T, V) without a copy where the strides allow
    it (a ``logits[:, :-1]`` slice keeps its strides)."""
    if logits.dim() == 1:
        return logits.reshape(1, 1, -1)
    if logits.dim() == 2:
        return logits.reshape(1, *logits.shape)
    return logits.reshape(-1, *logits.shape[-2:])


def _plain_fwd(x3, labels, smoothing, padding_idx, true_k):
    """The JAX package's ``_fwd_kernel`` in plain PyTorch: (loss, lse)
    per row, fp32."""
    x = x3.reshape(-1, x3.shape[-1]).float()
    t = labels.reshape(-1, 1).long()
    col = torch.arange(x.shape[1], device=x.device)[None, :]
    valid = col < true_k
    xm = torch.where(valid, x, NEG_INF)
    m = xm.amax(dim=1, keepdim=True)
    e = torch.where(valid, torch.exp(xm - m), 0.0)
    lse = m + torch.log(e.sum(dim=1, keepdim=True))
    tgt = torch.where(col == t, x, 0.0).sum(dim=1, keepdim=True)
    sum_x = torch.where(valid, x, 0.0).sum(dim=1, keepdim=True)
    loss = ((1.0 - smoothing) * (lse - tgt)
            + smoothing * (lse - sum_x / true_k))
    if padding_idx is not None:
        loss = torch.where(t == padding_idx, 0.0, loss)
    return loss[:, 0], lse[:, 0]


def _plain_bwd(x3, labels, lse, dloss, smoothing, padding_idx, true_k):
    """The JAX package's ``_bwd_kernel`` in plain PyTorch: dx (rows, V)
    in the logits' dtype."""
    x = x3.reshape(-1, x3.shape[-1]).float()
    t = labels.reshape(-1, 1).long()
    col = torch.arange(x.shape[1], device=x.device)[None, :]
    valid = col < true_k
    p = torch.where(valid, torch.exp(x - lse.reshape(-1, 1)), 0.0)
    grad = p - (1.0 - smoothing) * (col == t).float() - smoothing / true_k
    grad = torch.where(valid, grad, 0.0)
    d = dloss.reshape(-1, 1).float()
    if padding_idx is not None:
        d = torch.where(t == padding_idx, 0.0, d)
    return (grad * d).to(x3.dtype)


def _check(x3, labels, name):
    """The logits may be strided over their leading axes (the kernels
    take those strides), so they are checked here, not by
    `check_cuda`."""
    if isinstance(x3, DTensor) or isinstance(labels, DTensor):
        raise TypeError(f"{name}: got a DTensor; the kernel takes plain "
                        f"tensors (gather it with core.mesh.gathered)")
    if x3.dtype not in _DTYPES or x3.stride(2) != 1:
        raise ValueError(f"{name}: logits must be f32/bf16/f16 with a "
                         f"dense last axis, got {x3.dtype} strides "
                         f"{x3.stride()}")
    if labels.device != x3.device:
        raise ValueError(f"{name}: logits on {x3.device}, labels on "
                         f"{labels.device}")
    if labels.numel() != x3.shape[0] * x3.shape[1]:
        raise ValueError(f"{name}: {labels.numel()} labels for "
                         f"{x3.shape[0] * x3.shape[1]} rows")


def xent_fwd(x3: torch.Tensor, labels: torch.Tensor, smoothing: float,
             padding_idx: Optional[int], true_k: int):
    """(loss, lse), fp32 (rows,), for (A, T, V) logits (any strides
    over A and T) and (A*T,) int32 labels. CUDA tensors launch the
    kernel (``xent_fwd.launches``); CPU tensors take the plain
    version."""
    if not use_kernel(x3):
        return _plain_fwd(x3, labels, smoothing, padding_idx, true_k)
    _check(x3, labels, "xent_fwd")
    A, T, V = x3.shape
    rows = A * T
    labels = labels.reshape(-1).to(torch.int32).contiguous()
    loss = torch.empty(rows, dtype=torch.float32, device=x3.device)
    lse = torch.empty(rows, dtype=torch.float32, device=x3.device)
    stream = torch.cuda.current_stream(x3.device).cuda_stream
    _build.launch("apex1_xent_fwd", x3.data_ptr(), labels.data_ptr(),
                  loss.data_ptr(), lse.data_ptr(), rows, T, x3.stride(0),
                  x3.stride(1), V, true_k, float(smoothing),
                  1.0 - smoothing, int(padding_idx is not None),
                  -1 if padding_idx is None else int(padding_idx),
                  DTYPE_CODES[x3.dtype], stream)
    xent_fwd.launches += 1
    return loss, lse


xent_fwd.launches = 0


def xent_bwd(x3: torch.Tensor, labels: torch.Tensor, lse: torch.Tensor,
             dloss: torch.Tensor, smoothing: float,
             padding_idx: Optional[int], true_k: int) -> torch.Tensor:
    """dx (A*T, V), dense, in the logits' dtype. CUDA tensors launch the
    kernel (``xent_bwd.launches``); CPU tensors take the plain
    version."""
    if not use_kernel(x3):
        return _plain_bwd(x3, labels, lse, dloss, smoothing, padding_idx,
                          true_k)
    _check(x3, labels, "xent_bwd")
    A, T, V = x3.shape
    rows = A * T
    labels = labels.reshape(-1).to(torch.int32).contiguous()
    lse = lse.contiguous()
    dloss = dloss.reshape(-1).float().contiguous()
    check_cuda("xent_bwd", labels, lse, dloss)
    dx = torch.empty(rows, V, dtype=x3.dtype, device=x3.device)
    stream = torch.cuda.current_stream(x3.device).cuda_stream
    _build.launch("apex1_xent_bwd", x3.data_ptr(), labels.data_ptr(),
                  lse.data_ptr(), dloss.data_ptr(), dx.data_ptr(), rows, T,
                  x3.stride(0), x3.stride(1), V, true_k, 1.0 - smoothing,
                  smoothing / true_k, int(padding_idx is not None),
                  -1 if padding_idx is None else int(padding_idx),
                  DTYPE_CODES[x3.dtype], stream)
    xent_bwd.launches += 1
    return dx


xent_bwd.launches = 0


class _Xent(torch.autograd.Function):
    """The JAX package's ``_fused_xent`` custom VJP: residuals are the
    logits, the labels and the per-row lse."""

    @staticmethod
    def forward(ctx, logits, labels, smoothing, padding_idx, true_k):
        x3 = _as3d(logits)
        loss, lse = xent_fwd(x3, labels, smoothing, padding_idx, true_k)
        ctx.save_for_backward(logits, labels, lse)
        ctx.args = (smoothing, padding_idx, true_k)
        return loss.reshape(logits.shape[:-1])

    @staticmethod
    def backward(ctx, dloss):
        logits, labels, lse = ctx.saved_tensors
        dx = xent_bwd(_as3d(logits), labels, lse, dloss, *ctx.args)
        return dx.reshape(logits.shape), None, None, None, None


def softmax_cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                               *, smoothing: float = 0.0,
                               padding_idx: Optional[int] = None,
                               num_classes: Optional[int] = None
                               ) -> torch.Tensor:
    """``apex.contrib.xentropy.SoftmaxCrossEntropyLoss.apply(logits,
    labels, smoothing, padding_idx)``: per-token loss (fp32), reduce it
    yourself. ``num_classes``: only the first N logit columns are real
    classes (lane-padded vocab logits; the rest are masked in the
    kernel and get zero gradient)."""
    width = logits.shape[-1]
    if num_classes is not None and not 0 < num_classes <= width:
        raise ValueError(f"num_classes {num_classes} must be in "
                         f"(0, {width}]")
    k = width if num_classes is None else int(num_classes)
    return _Xent.apply(logits, labels, float(smoothing), padding_idx, k)


def masked_next_token_mean(losses: torch.Tensor,
                           segment_ids: torch.Tensor) -> torch.Tensor:
    """Mean of next-token losses over VALID targets in a packed batch:
    a target in another segment than its input token (a document
    boundary), or in the padding segment (< 0), is not a target.
    ``losses``: (B, S-1); ``segment_ids``: (B, S)."""
    valid = ((segment_ids[:, :-1] == segment_ids[:, 1:])
             & (segment_ids[:, :-1] >= 0)).to(losses.dtype)
    return (losses * valid).sum() / torch.clamp(valid.sum(), min=1.0)
