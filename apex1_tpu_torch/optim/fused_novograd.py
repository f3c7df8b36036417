"""Fused NovoGrad (the port of ``apex1_tpu/optim/fused_novograd.py``;
reference ``apex/optimizers/fused_novograd.py :: FusedNovoGrad``, kernel
``csrc/multi_tensor_novograd.cu``).

Adam with a PER-TENSOR second moment, op for op as the JAX package's:

    v_t = b2 * v + (1-b2) * ||g||^2     (one fp32 0-d tensor a param;
                                         ||g||^2 on the first step, or 0
                                         with ``init_zero``)
    g'  = g / (sqrt(v_t / bc2) + eps) + wd * p
    m_t = b1 * m + c * g'               (c = 1-b1 with grad_averaging,
                                         else 1)
    p  -= lr * m_t / bc1

``norm_type`` 2 (L2) or inf (``||g||^2`` is then max|g| squared).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Union

import torch

from apex1_tpu_torch.optim.fused_adam import (GradientTransformation,
                                              bias_corrections, step0,
                                              zeros_f32)


@dataclasses.dataclass(frozen=True)
class FusedNovoGradState:
    """``step`` int32 0-d; ``exp_avg`` (m): fp32 dict keyed like the
    params; ``exp_avg_sq`` (v): ONE fp32 0-d tensor a param."""

    step: torch.Tensor
    exp_avg: dict
    exp_avg_sq: dict


def fused_novograd(learning_rate: Union[float, Callable] = 1e-3,
                   b1: float = 0.95, b2: float = 0.98, eps: float = 1e-8,
                   weight_decay: float = 0.0, grad_averaging: bool = True,
                   init_zero: bool = False, norm_type=2,
                   bias_correction: bool = True) -> GradientTransformation:
    """``FusedNovoGrad(lr, betas=(b1, b2), eps, weight_decay,
    grad_averaging, init_zero, norm_type, bias_correction)`` as an
    init/update pair over ``{name: tensor}`` params."""
    if norm_type not in (2, float("inf")):
        raise ValueError("norm_type must be 2 or inf")

    def norm_sq(g32):
        if norm_type == 2:
            return g32.square().sum()
        return g32.abs().amax().square()

    def init(params: dict) -> FusedNovoGradState:
        return FusedNovoGradState(
            step=step0(params), exp_avg=zeros_f32(params),
            exp_avg_sq={k: torch.zeros((), dtype=torch.float32,
                                       device=p.device)
                        for k, p in params.items()})

    def update(grads: dict, state: FusedNovoGradState, params: dict = None):
        if params is None:
            raise ValueError("fused_novograd requires params")
        step = state.step + 1
        lr = learning_rate(step) if callable(learning_rate) else learning_rate
        first = state.step == 0
        bc1, bc2 = bias_corrections(b1, b2, step, bias_correction)
        c = (1.0 - b1) if grad_averaging else 1.0
        updates, new_m, new_v = {}, {}, {}
        for k, g in grads.items():
            p = params[k]
            g32, p32 = g.float(), p.float()
            nsq = norm_sq(g32)
            v_init = torch.zeros_like(nsq) if init_zero else nsq
            v = torch.where(first, v_init,
                            b2 * state.exp_avg_sq[k] + (1.0 - b2) * nsq)
            gp = g32 / (torch.sqrt(v / bc2) + eps)
            if weight_decay:
                gp = gp + weight_decay * p32
            m = b1 * state.exp_avg[k] + c * gp
            updates[k] = (-lr * (m / bc1)).to(p.dtype)
            new_m[k], new_v[k] = m, v
        return updates, FusedNovoGradState(step=step, exp_avg=new_m,
                                           exp_avg_sq=new_v)

    return GradientTransformation(init, update)
