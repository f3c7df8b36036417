"""Fused Adagrad (the port of ``apex1_tpu/optim/fused_adagrad.py``;
reference ``apex/optimizers/fused_adagrad.py :: FusedAdagrad``, kernel
``csrc/multi_tensor_adagrad.cu``).

    h += g^2                     (fp32)
    p -= lr * g / (sqrt(h) + eps)

``adagrad_w_mode``: decoupled weight decay (the update gains wd * p)
instead of L2 (g += wd * p), as the reference's flag.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Union

import torch

from apex1_tpu_torch.optim.fused_adam import (GradientTransformation, step0,
                                              zeros_f32)


@dataclasses.dataclass(frozen=True)
class FusedAdagradState:
    """``step`` int32 0-d; ``sum_sq`` (h): fp32 dict keyed like the
    params."""

    step: torch.Tensor
    sum_sq: dict


def fused_adagrad(learning_rate: Union[float, Callable] = 1e-2,
                  eps: float = 1e-10, weight_decay: float = 0.0,
                  adagrad_w_mode: bool = False) -> GradientTransformation:
    """``FusedAdagrad(lr, eps, weight_decay, adagrad_w_mode)`` as an
    init/update pair over ``{name: tensor}`` params."""

    def init(params: dict) -> FusedAdagradState:
        return FusedAdagradState(step=step0(params),
                                 sum_sq=zeros_f32(params))

    def update(grads: dict, state: FusedAdagradState, params: dict = None):
        if params is None:
            raise ValueError("fused_adagrad requires params")
        step = state.step + 1
        lr = learning_rate(step) if callable(learning_rate) else learning_rate
        updates, new_h = {}, {}
        for k, g in grads.items():
            p = params[k]
            g32, p32 = g.float(), p.float()
            if weight_decay and not adagrad_w_mode:
                g32 = g32 + weight_decay * p32
            h = state.sum_sq[k] + g32.square()
            upd = g32 / (torch.sqrt(h) + eps)
            if weight_decay and adagrad_w_mode:
                upd = upd + weight_decay * p32
            updates[k] = (-lr * upd).to(p.dtype)
            new_h[k] = h
        return updates, FusedAdagradState(step=step, sum_sq=new_h)

    return GradientTransformation(init, update)
