"""Fused LayerNorm / RMSNorm forward (the port of
``apex1_tpu/ops/layer_norm.py``).

The kernel is ``csrc/layer_norm.cu`` (one block per row, fp32
statistics, variance as E[x^2] - mean^2); `_plain_norm` beside it is
the same function in plain PyTorch. bf16/fp16 ``x`` with fp32 ``γ/β``
is the "MixedFused" path; the output keeps ``x.dtype``. Forward only:
the backward kernel belongs to the training slice.
"""

from __future__ import annotations

from typing import Optional

import torch

from apex1_tpu_torch.ops import _build
from apex1_tpu_torch.ops._common import DTYPE_CODES, check_cuda, use_kernel

_NORM_DTYPES = (torch.float32, torch.bfloat16, torch.float16)


def _plain_norm(x2, gamma, beta, eps, rms):
    """(R, H) rows -> (y, mean (R,), rstd (R,)), op for op the JAX
    package's ``_xla_norm``."""
    x32 = x2.float()
    if rms:
        mean = torch.zeros(x32.shape[0], 1, dtype=torch.float32,
                           device=x2.device)
    else:
        mean = x32.mean(dim=-1, keepdim=True)
    xc = x32 - mean
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    if not rms:
        var = var - mean * mean
    rstd = torch.rsqrt(var + eps)
    y = xc * rstd * gamma.float()
    if beta is not None:
        y = y + beta.float()
    return y.to(x2.dtype), mean[:, 0], rstd[:, 0]


def layer_norm_fwd(x2: torch.Tensor, gamma: torch.Tensor,
                   beta: Optional[torch.Tensor], eps: float, rms: bool):
    """Normalize the rows of ``x2`` (R, H): returns (y, mean, rstd).
    CUDA tensors launch the kernel (``layer_norm_fwd.launches`` counts
    the launches); CPU tensors take the plain version."""
    if not use_kernel(x2):
        return _plain_norm(x2, gamma, beta, eps, rms)
    if x2.dim() != 2:
        raise ValueError(f"layer_norm_fwd takes (R, H) rows, got "
                         f"{tuple(x2.shape)}")
    if x2.dtype not in _NORM_DTYPES:
        raise ValueError(f"layer_norm_fwd: unsupported dtype {x2.dtype}")
    R, H = x2.shape
    gamma = gamma.float().contiguous()
    beta = None if beta is None else beta.float().contiguous()
    if gamma.shape != (H,) or (beta is not None and beta.shape != (H,)):
        raise ValueError("layer_norm_fwd: gamma/beta must be (H,)")
    x2 = x2.contiguous()
    check_cuda("layer_norm_fwd", x2, gamma, beta)
    y = torch.empty_like(x2)
    mean = torch.empty(R, dtype=torch.float32, device=x2.device)
    rstd = torch.empty(R, dtype=torch.float32, device=x2.device)
    stream = torch.cuda.current_stream(x2.device).cuda_stream
    _build.launch("apex1_layer_norm_fwd", x2.data_ptr(), gamma.data_ptr(),
                  None if beta is None else beta.data_ptr(), y.data_ptr(),
                  mean.data_ptr(), rstd.data_ptr(), R, H, float(eps),
                  int(rms), DTYPE_CODES[x2.dtype], stream)
    layer_norm_fwd.launches += 1
    return y, mean, rstd


layer_norm_fwd.launches = 0


def layer_norm(x: torch.Tensor, gamma: torch.Tensor,
               beta: torch.Tensor, *, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis; output keeps ``x.dtype``."""
    shape = x.shape
    y, _, _ = layer_norm_fwd(x.reshape(-1, shape[-1]), gamma, beta, eps,
                             False)
    return y.reshape(shape)


def rms_norm(x: torch.Tensor, gamma: torch.Tensor, *,
             eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last axis (no mean subtraction, no β)."""
    shape = x.shape
    y, _, _ = layer_norm_fwd(x.reshape(-1, shape[-1]), gamma, None, eps,
                             True)
    return y.reshape(shape)
