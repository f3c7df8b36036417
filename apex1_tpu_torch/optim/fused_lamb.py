"""Fused LAMB (the port of ``apex1_tpu/optim/fused_lamb.py``; reference
``apex/optimizers/fused_lamb.py :: FusedLAMB``, kernels
``csrc/multi_tensor_lamb.cu :: LAMBStage1Functor/LAMBStage2Functor``).

The reference's three passes, op for op as the JAX package's:
  pass 1 - the GLOBAL grad norm; clip = max(1, norm / max_grad_norm);
  stage 1 - g / clip into the fp32 moments (bias-corrected), the update
            u = m_hat / (sqrt(v_hat) + eps) + wd * p;
  stage 2 - the trust ratio ||p|| / ||u|| (1 where either norm is 0),
            applied only with weight decay or ``use_nvlamb``; p -= lr *
            ratio * u.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Union

import torch

from apex1_tpu_torch.core.pytree import global_norm
from apex1_tpu_torch.optim.fused_adam import (GradientTransformation,
                                              bias_corrections, step0,
                                              zeros_f32)


@dataclasses.dataclass(frozen=True)
class FusedLAMBState:
    """``step`` int32 0-d; ``exp_avg`` (m) and ``exp_avg_sq`` (v): fp32
    dicts keyed like the params."""

    step: torch.Tensor
    exp_avg: dict
    exp_avg_sq: dict


def fused_lamb(learning_rate: Union[float, Callable] = 1e-3,
               b1: float = 0.9, b2: float = 0.999, eps: float = 1e-6,
               weight_decay: float = 0.01, bias_correction: bool = True,
               max_grad_norm: float = 1.0,
               use_nvlamb: bool = False) -> GradientTransformation:
    """``FusedLAMB(lr, betas=(b1, b2), eps, weight_decay,
    bias_correction, max_grad_norm, use_nvlamb)`` as an init/update
    pair over ``{name: tensor}`` params."""

    def init(params: dict) -> FusedLAMBState:
        return FusedLAMBState(step=step0(params), exp_avg=zeros_f32(params),
                              exp_avg_sq=zeros_f32(params))

    def update(grads: dict, state: FusedLAMBState, params: dict = None):
        if params is None:
            raise ValueError("fused_lamb requires params")
        step = state.step + 1
        lr = learning_rate(step) if callable(learning_rate) else learning_rate
        clip = torch.clamp(global_norm(grads) / max_grad_norm, min=1.0)
        bc1, bc2 = bias_corrections(b1, b2, step, bias_correction)
        updates, new_m, new_v = {}, {}, {}
        for k, g in grads.items():
            p = params[k]
            g32, p32 = g.float() / clip, p.float()
            m = b1 * state.exp_avg[k] + (1.0 - b1) * g32
            v = b2 * state.exp_avg_sq[k] + (1.0 - b2) * g32.square()
            u = (m / bc1) / (torch.sqrt(v / bc2) + eps)
            if weight_decay:
                u = u + weight_decay * p32
            if weight_decay or use_nvlamb:
                w_norm = p32.square().sum().sqrt()
                u_norm = u.square().sum().sqrt()
                ratio = torch.where((w_norm > 0) & (u_norm > 0),
                                    w_norm / u_norm, 1.0)
            else:
                ratio = 1.0
            updates[k] = (-lr * ratio * u).to(p.dtype)
            new_m[k], new_v[k] = m, v
        return updates, FusedLAMBState(step=step, exp_avg=new_m,
                                       exp_avg_sq=new_v)

    return GradientTransformation(init, update)
