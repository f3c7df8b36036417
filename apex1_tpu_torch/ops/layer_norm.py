"""Fused LayerNorm / RMSNorm (the port of ``apex1_tpu/ops/layer_norm.py``).

Two kernels, each beside its plain PyTorch version:

- forward, ``csrc/layer_norm.cu``: one block per row, fp32 statistics,
  variance as E[x^2] - mean^2; saves the row mean and rstd;
- backward, ``csrc/layer_norm_bwd.cu``: dx per row from the saved
  statistics, dγ/dβ as per-block partial sums reduced in a fixed order
  by a second pass (no atomics: the same result on every run).

`layer_norm` and `rms_norm` are differentiable through a
``torch.autograd.Function`` over the two. bf16/fp16 ``x`` with fp32
``γ/β`` is the "MixedFused" path; the output and dx keep ``x.dtype``,
dγ/dβ come back in γ's dtype (half under the amp policies, whose
compute params are all half), as in the JAX package.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch
import torch.nn as nn
import torch.utils.checkpoint

from apex1_tpu_torch.ops import _build
from apex1_tpu_torch.ops._common import DTYPE_CODES, check_cuda, use_kernel

_NORM_DTYPES = (torch.float32, torch.bfloat16, torch.float16)

#: widest row the backward kernel takes: its dγ/dβ partials (8 bytes a
#: column) and its reduction scratch fit the 48 KB of shared memory a
#: block gets without opting in
MAX_BWD_H = 6016

#: row blocks of the backward's first pass (each writes one fp32 row of
#: dγ/dβ partials to the workspace the second pass sums)
_BWD_GROUPS = 512


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


def _plain_norm_bwd(dy2, x2, gamma, mean, rstd, rms, with_beta):
    """dx, dγ, dβ (fp32) op for op the JAX package's ``_bwd_kernel``."""
    x = x2.float()
    dy = dy2.float()
    xhat = (x - mean[:, None]) * rstd[:, None]
    wdy = dy * gamma.float()
    inv_h = 1.0 / x.shape[1]
    c1 = (xhat * wdy).sum(dim=1, keepdim=True) * inv_h
    if rms:
        dx = (wdy - xhat * c1) * rstd[:, None]
    else:
        c2 = wdy.sum(dim=1, keepdim=True) * inv_h
        dx = (wdy - c2 - xhat * c1) * rstd[:, None]
    dg = (dy * xhat).sum(dim=0)
    db = dy.sum(dim=0) if with_beta else None
    return dx.to(x2.dtype), dg, db


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


def layer_norm_bwd(dy2: torch.Tensor, x2: torch.Tensor, gamma: torch.Tensor,
                   mean: torch.Tensor, rstd: torch.Tensor, rms: bool,
                   with_beta: bool):
    """Backward of `layer_norm_fwd` over (R, H) rows: returns (dx in
    x's dtype, dγ and dβ in γ's dtype; dβ None without β). CUDA tensors
    launch the kernel (``layer_norm_bwd.launches``); CPU tensors take
    the plain version."""
    if not use_kernel(x2):
        dx, dg, db = _plain_norm_bwd(dy2, x2, gamma, mean, rstd, rms,
                                     with_beta)
        return dx, dg.to(gamma.dtype), (None if db is None
                                        else db.to(gamma.dtype))
    if x2.dim() != 2 or dy2.shape != x2.shape:
        raise ValueError(f"layer_norm_bwd takes matching (R, H) x and dy, "
                         f"got {tuple(x2.shape)} and {tuple(dy2.shape)}")
    if x2.dtype not in _NORM_DTYPES or gamma.dtype not in _NORM_DTYPES:
        raise ValueError(f"layer_norm_bwd: unsupported dtypes {x2.dtype}, "
                         f"{gamma.dtype}")
    R, H = x2.shape
    if H > MAX_BWD_H:
        raise ValueError(f"layer_norm_bwd: H={H} is wider than the "
                         f"kernel's {MAX_BWD_H}")
    x2 = x2.contiguous()
    dy2 = dy2.to(x2.dtype).contiguous()
    g32 = gamma.float().contiguous()
    mean, rstd = mean.contiguous(), rstd.contiguous()
    check_cuda("layer_norm_bwd", x2, dy2, g32, mean, rstd)
    rows_per_block = max(1, -(-R // _BWD_GROUPS))
    groups = -(-R // rows_per_block)
    dev = x2.device
    dx = torch.empty_like(x2)
    part = torch.empty(2, groups, H, dtype=torch.float32, device=dev)
    dg = torch.empty(H, dtype=gamma.dtype, device=dev)
    db = torch.empty(H, dtype=gamma.dtype, device=dev) if with_beta else None
    stream = torch.cuda.current_stream(dev).cuda_stream
    _build.launch("apex1_layer_norm_bwd", x2.data_ptr(), g32.data_ptr(),
                  mean.data_ptr(), rstd.data_ptr(), dy2.data_ptr(),
                  dx.data_ptr(), part.data_ptr(), dg.data_ptr(),
                  None if db is None else db.data_ptr(), R, H,
                  rows_per_block, groups, int(rms), int(with_beta),
                  DTYPE_CODES[x2.dtype], DTYPE_CODES[gamma.dtype], stream)
    layer_norm_bwd.launches += 1
    return dx, dg, db


layer_norm_bwd.launches = 0


class _FusedNorm(torch.autograd.Function):
    """The JAX package's ``_fused_norm`` custom VJP: forward saves x, γ
    and the row statistics; backward runs `layer_norm_bwd`."""

    @staticmethod
    def forward(ctx, x2, gamma, beta, eps, rms):
        y, mean, rstd = layer_norm_fwd(x2, gamma, beta, eps, rms)
        ctx.save_for_backward(x2, gamma, mean, rstd)
        ctx.rms = rms
        ctx.beta_dtype = None if beta is None else beta.dtype
        return y

    @staticmethod
    def backward(ctx, dy):
        x2, gamma, mean, rstd = ctx.saved_tensors
        dx, dg, db = layer_norm_bwd(dy, x2, gamma, mean, rstd, ctx.rms,
                                    ctx.beta_dtype is not None)
        if db is not None:
            db = db.to(ctx.beta_dtype)
        return dx, dg, db, None, None


def _norm(x, gamma, beta, eps, rms):
    shape = x.shape
    y = _FusedNorm.apply(x.reshape(-1, shape[-1]), gamma, beta, eps, rms)
    return y.reshape(shape)


def layer_norm(x: torch.Tensor, gamma: torch.Tensor,
               beta: torch.Tensor, *, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis; output keeps ``x.dtype``."""
    return _norm(x, gamma, beta, eps, False)


def rms_norm(x: torch.Tensor, gamma: torch.Tensor, *,
             eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last axis (no mean subtraction, no β)."""
    return _norm(x, gamma, None, eps, True)


# ---- module API: apex.normalization's FusedLayerNorm / FusedRMSNorm ----


def _flat_h(normalized_shape) -> int:
    if isinstance(normalized_shape, int):
        return normalized_shape
    h = 1
    for s in normalized_shape:
        h *= s
    return h


class _FusedNormModule(nn.Module):
    """Shared body: the trailing ``normalized_shape`` dims are flattened
    into the kernel's row axis, as the reference wrapper does; γ (and
    β) are fp32 parameters ``scale`` (and ``bias``);
    ``memory_efficient`` recomputes the forward in the backward."""

    _rms = False

    def __init__(self, normalized_shape: Union[int, Sequence[int]],
                 eps: float, elementwise_affine: bool,
                 memory_efficient: bool, device=None):
        super().__init__()
        self.normalized_shape = normalized_shape
        self.eps = eps
        self.memory_efficient = memory_efficient
        h = _flat_h(normalized_shape)
        kw = dict(device=device, dtype=torch.float32)
        if elementwise_affine:
            self.scale = nn.Parameter(torch.ones(h, **kw))
            self.bias = (None if self._rms
                         else nn.Parameter(torch.zeros(h, **kw)))
        else:
            self.register_buffer("scale", torch.ones(h, **kw))
            self.bias = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n = (1 if isinstance(self.normalized_shape, int)
             else len(self.normalized_shape))
        orig = x.shape
        x = x.reshape(*orig[:x.dim() - n], -1)
        args = (x, self.scale, self.bias, self.eps, self._rms)
        if self.memory_efficient:
            y = torch.utils.checkpoint.checkpoint(_norm, *args,
                                                  use_reentrant=False)
        else:
            y = _norm(*args)
        return y.reshape(orig)


class FusedLayerNorm(_FusedNormModule):
    """``apex.normalization.FusedLayerNorm(normalized_shape, eps,
    elementwise_affine, memory_efficient)``."""

    def __init__(self, normalized_shape, eps: float = 1e-5,
                 elementwise_affine: bool = True,
                 memory_efficient: bool = False, device=None):
        super().__init__(normalized_shape, eps, elementwise_affine,
                         memory_efficient, device)


class FusedRMSNorm(_FusedNormModule):
    """``apex.normalization.FusedRMSNorm``: no mean, no β."""

    _rms = True

    def __init__(self, normalized_shape, eps: float = 1e-6,
                 elementwise_affine: bool = True,
                 memory_efficient: bool = False, device=None):
        super().__init__(normalized_shape, eps, elementwise_affine,
                         memory_efficient, device)
