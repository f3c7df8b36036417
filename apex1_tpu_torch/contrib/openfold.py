"""OpenFold's fused pieces (the port of ``apex1_tpu/contrib/openfold.py``;
reference ``apex/contrib/openfold_triton``): the layer norm, the
Evoformer attention core with its pair biases and gating, SiLU and
SwiGLU.

- `layer_norm` is `ops.layer_norm.layer_norm` (the norm kernels, TPU
  rows 1-2);
- `attention_core` folds ``bias1``, ``bias2`` and the boolean mask into
  one additive fp32 mask and runs the scores through
  `ops.softmax.scaled_masked_softmax` (the softmax kernels, TPU rows
  16-17), the mask's size-1 dims broadcast inside the kernel; the two
  products are ``torch.einsum`` (fp32 scores, as in the JAX package);
- `swish` and `swiglu` are plain composites, as in the JAX package.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from apex1_tpu_torch.ops._common import NEG_INF
from apex1_tpu_torch.ops.layer_norm import layer_norm as _layer_norm_op
from apex1_tpu_torch.ops.softmax import scaled_masked_softmax

__all__ = ["layer_norm", "attention_core", "swiglu", "swish"]


def layer_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               *, eps: float = 1e-5) -> torch.Tensor:
    """``openfold_triton``'s LayerNorm: the norm kernels."""
    return _layer_norm_op(x, gamma, beta, eps=eps)


def attention_core(q, k, v, *, bias1=None, bias2=None, mask=None,
                   gate=None, sm_scale: Optional[float] = None):
    """The Evoformer attention (``openfold_triton/mha.py ::
    _attention_core``):

        out = softmax(scale·q·kᵀ [+ bias1] [+ bias2] [+ mask·NEG_INF])·v
        [out = out * sigmoid(gate)]

    ``q``/``k``/``v`` (..., H, S, D); ``bias1`` broadcastable to (..., 1,
    1, S) (the MSA row mask bias), ``bias2`` to (..., 1, S, S) (the pair
    bias); ``mask`` boolean, True = attend. The scores and the softmax
    are fp32. The folded mask must broadcast to the scores with its
    leading dims folded into one, as the JAX package requires: a 5-D
    mask whose two leading dims are neither 1 nor the scores' raises
    ValueError."""
    scale = (1.0 / math.sqrt(q.shape[-1]) if sm_scale is None
             else float(sm_scale))
    s = torch.einsum("...qd,...kd->...qk", q.float(), k.float())
    add = None
    for b in (bias1, bias2):
        if b is not None:
            b = b.float()
            add = b if add is None else add + b
    if mask is not None:
        neg = torch.where(mask, 0.0, NEG_INF).float()
        add = neg if add is None else add + neg
    p = scaled_masked_softmax(s, add, scale=scale)
    out = torch.einsum("...qk,...kd->...qd", p.to(v.dtype), v)
    if gate is not None:
        out = out * torch.sigmoid(gate.to(out.dtype))
    return out


def swish(x: torch.Tensor) -> torch.Tensor:
    """SiLU (``openfold_triton/swish.py``)."""
    return F.silu(x)


def swiglu(x, w_gate, w_up, w_down) -> torch.Tensor:
    """The gated-SiLU MLP ``(silu(x·Wg) ⊙ (x·Wu))·Wd``."""
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down
