"""Fused momentum SGD (the port of ``apex1_tpu/optim/fused_sgd.py``;
reference ``apex/optimizers/fused_sgd.py :: FusedSGD``, kernel
``csrc/multi_tensor_sgd_kernel.cu :: SGDFunctor``).

torch-SGD semantics, op for op as the JAX package's:

    g = g + wd * p
    buf = momentum * buf + (1 - dampening) * g     (buf := g on the first
                                                     step, state.step == 0)
    g = g + momentum * buf   if nesterov else buf
    p -= lr * g

``wd_after_momentum`` adds the weight decay to the post-momentum
update instead. The momentum buffers are fp32; the update is cast to
the param dtype. Plain PyTorch per tensor, as the JAX package leaves it
to XLA (no TPU kernel).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Union

import torch

from apex1_tpu_torch.optim.fused_adam import (GradientTransformation, step0,
                                              zeros_f32)


@dataclasses.dataclass(frozen=True)
class FusedSGDState:
    """``step`` int32 0-d; ``momentum_buf``: fp32 dict keyed like the
    params."""

    step: torch.Tensor
    momentum_buf: dict


def fused_sgd(learning_rate: Union[float, Callable] = 1e-3,
              momentum: float = 0.0, dampening: float = 0.0,
              weight_decay: float = 0.0, nesterov: bool = False,
              wd_after_momentum: bool = False) -> GradientTransformation:
    """``FusedSGD(lr, momentum, dampening, weight_decay, nesterov,
    wd_after_momentum)`` as an init/update pair over ``{name: tensor}``
    params. ``learning_rate`` may be a schedule ``f(step) -> lr``."""
    if nesterov and (momentum <= 0 or dampening != 0):
        raise ValueError("nesterov requires momentum > 0 and dampening == 0")

    def init(params: dict) -> FusedSGDState:
        return FusedSGDState(step=step0(params),
                             momentum_buf=zeros_f32(params))

    def update(grads: dict, state: FusedSGDState, params: dict = None):
        if params is None:
            raise ValueError("fused_sgd requires params")
        step = state.step + 1
        lr = learning_rate(step) if callable(learning_rate) else learning_rate
        first = state.step == 0
        updates, bufs = {}, {}
        for k, g in grads.items():
            p, buf = params[k], state.momentum_buf[k]
            g32, p32 = g.float(), p.float()
            if weight_decay and not wd_after_momentum:
                g32 = g32 + weight_decay * p32
            if momentum:
                new_buf = torch.where(
                    first, g32, momentum * buf + (1.0 - dampening) * g32)
                d = g32 + momentum * new_buf if nesterov else new_buf
            else:
                new_buf, d = buf, g32
            if weight_decay and wd_after_momentum:
                d = d + weight_decay * p32
            updates[k] = (-lr * d).to(p.dtype)
            bufs[k] = new_buf
        return updates, FusedSGDState(step=step, momentum_buf=bufs)

    return GradientTransformation(init, update)
