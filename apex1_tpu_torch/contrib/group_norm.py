"""Channel-last GroupNorm with an optional fused SiLU (the port of
``apex1_tpu/contrib/group_norm.py``; reference
``apex/contrib/group_norm``, tuned for diffusion models).

Statistics in fp32 over (spatial..., C / G) per sample and group: the
mean, then the two-pass variance mean((x - mean)^2); the affine and
SiLU in fp32, the result rounded to x's dtype once. A plain composite,
as in the JAX package (no TPU kernel).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from apex1_tpu_torch.ops._common import resolve_device


def group_norm(x: torch.Tensor, num_groups: int,
               gamma: Optional[torch.Tensor] = None,
               beta: Optional[torch.Tensor] = None, *, eps: float = 1e-5,
               act: Optional[str] = None) -> torch.Tensor:
    """``x`` (N, ..., C) channel-last; ``act`` None, "none" or "silu"."""
    C = x.shape[-1]
    if C % num_groups:
        raise ValueError(f"channels {C} not divisible by groups "
                         f"{num_groups}")
    xf = x.float()
    xg = xf.reshape(x.shape[0], -1, num_groups, C // num_groups)
    mean = xg.mean(dim=(1, 3), keepdim=True)
    var = (xg - mean).square().mean(dim=(1, 3), keepdim=True)
    y = ((xg - mean) * torch.rsqrt(var + eps)).reshape(xf.shape)
    if gamma is not None:
        y = y * gamma.float()
    if beta is not None:
        y = y + beta.float()
    if act == "silu":
        y = y * torch.sigmoid(y)
    elif act not in (None, "none"):
        raise ValueError(f"unsupported act {act!r}")
    return y.to(x.dtype)


class GroupNorm(nn.Module):
    """``apex.contrib.group_norm.GroupNorm(num_groups, num_channels, eps,
    affine, act)``: fp32 ``weight`` (ones) and ``bias`` (zeros) on
    ``device`` (CUDA unless the caller names another)."""

    def __init__(self, num_groups: int, num_channels: int,
                 eps: float = 1e-5, affine: bool = True,
                 act: Optional[str] = None, device=None):
        super().__init__()
        self.num_groups, self.eps, self.act = num_groups, eps, act
        dev = resolve_device(device)
        self.weight = (nn.Parameter(torch.ones(num_channels, device=dev))
                       if affine else None)
        self.bias = (nn.Parameter(torch.zeros(num_channels, device=dev))
                     if affine else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return group_norm(x, self.num_groups, self.weight, self.bias,
                          eps=self.eps, act=self.act)
