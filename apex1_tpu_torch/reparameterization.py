"""Weight normalisation (the port of ``apex1_tpu/reparameterization.py``;
reference ``apex/reparameterization``): w = g · v / ||v||, the norm in
fp32 whatever the parameter's dtype (an fp16 ||v||² overflows at a
large fan-in), as a function (`weight_norm`), a dense layer
(`WeightNormDense`) and the collapse back to one kernel
(`remove_weight_norm`).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from apex1_tpu_torch.ops._common import resolve_device
from apex1_tpu_torch.ops.fused_dense import lecun_normal_


def weight_norm(v: torch.Tensor, g: torch.Tensor, *, dim: Optional[int] = 0,
                eps: float = 1e-12) -> torch.Tensor:
    """``g * v / ||v||`` in v's dtype, the norm in fp32 over every axis
    but ``dim`` (the output-channel axis, kept; the reference's ``dim=0``
    by default), or over all of v with ``dim=None``."""
    v32 = v.float()
    if dim is None:
        norm = torch.sqrt(v32.square().sum() + eps)
    else:
        axes = tuple(a for a in range(v.dim()) if a != dim % v.dim())
        norm = torch.sqrt(v32.square().sum(dim=axes, keepdim=True) + eps)
    g32 = g.float()
    if dim is not None and g32.dim() == 1:
        shape = [1] * v.dim()
        shape[dim % v.dim()] = g32.shape[0]
        g32 = g32.reshape(shape)
    return (g32 * v32 / norm).to(v.dtype)


class WeightNormDense(nn.Module):
    """A dense layer under weight norm (the reference's
    ``apply_weight_norm`` on a Linear): fp32 ``v`` (in, features), ``g``
    (features,) and ``bias``, on ``device`` (CUDA unless the caller
    names another). The JAX module reads ``in_features`` from its first
    input; here it is given."""

    def __init__(self, in_features: int, features: int,
                 use_bias: bool = True, dim: int = 1, device=None):
        super().__init__()
        dev = resolve_device(device)
        self.dim = dim
        self.v = nn.Parameter(lecun_normal_(
            torch.empty(in_features, features, device=dev), in_features))
        self.g = nn.Parameter(torch.ones(features, device=dev))
        self.bias = (nn.Parameter(torch.zeros(features, device=dev))
                     if use_bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x @ weight_norm(self.v, self.g, dim=self.dim).to(x.dtype)
        return y if self.bias is None else y + self.bias.to(x.dtype)


def remove_weight_norm(params: dict, *, dim: int = 1) -> dict:
    """``{v, g, ...}`` with v and g collapsed into ``kernel`` (the
    reference's ``remove_weight_norm(module)``)."""
    out = dict(params)
    if "v" in out and "g" in out:
        out["kernel"] = weight_norm(out.pop("v"), out.pop("g"), dim=dim)
    return out
