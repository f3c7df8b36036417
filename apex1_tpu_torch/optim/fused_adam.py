"""Fused Adam/AdamW (the port of ``apex1_tpu/optim/fused_adam.py``;
reference ``apex/optimizers/fused_adam.py :: FusedAdam``, kernel
``csrc/multi_tensor_adam.cu :: AdamFunctor``).

The math is the contract, op for op as the JAX package's:

    adam_w_mode=True (ADAM_MODE_0): decoupled weight decay
        p -= lr * (m_hat / (sqrt(v_hat) + eps) + wd * p)
    adam_w_mode=False (ADAM_MODE_1): L2, g = g + wd * p before the moments

with bias correction m_hat = m / (1 - b1^t), moments in fp32. It is not
``torch.optim.AdamW``, which decays the weights before the update and
applies the bias correction in another order. The update is functional
(``update`` returns new tensors) and plain PyTorch per tensor; the JAX
package leaves it to XLA too (no TPU kernel). One multi-tensor kernel
for the whole update is later work.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Union

import torch


@dataclasses.dataclass(frozen=True)
class FusedAdamState:
    """``step`` int32 0-d; ``exp_avg`` (m) and ``exp_avg_sq`` (v): fp32
    dicts keyed like the params."""

    step: torch.Tensor
    exp_avg: dict
    exp_avg_sq: dict


@dataclasses.dataclass(frozen=True)
class GradientTransformation:
    """``init(params) -> state``; ``update(grads, state, params) ->
    (updates, new_state)``; apply with ``p + u``."""

    init: Callable
    update: Callable


def zeros_f32(params: dict) -> dict:
    """fp32 zeros shaped like each param: a moment's initial value."""
    return {k: torch.zeros_like(p, dtype=torch.float32)
            for k, p in params.items()}


def step0(params: dict) -> torch.Tensor:
    """The step count's initial value, an int32 0-d tensor on the
    params' device."""
    dev = next(iter(params.values())).device if params else None
    return torch.zeros((), dtype=torch.int32, device=dev)


def bias_corrections(b1: float, b2: float, step: torch.Tensor, on: bool):
    """(1 - b1^t, 1 - b2^t) as fp32 0-d tensors, or (1.0, 1.0)."""
    if not on:
        return 1.0, 1.0
    t = step.to(torch.float32)

    def bc(b):
        return 1.0 - torch.pow(torch.tensor(b, dtype=torch.float32,
                                            device=t.device), t)

    return bc(b1), bc(b2)


def fused_adam(learning_rate: Union[float, Callable] = 1e-3,
               b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
               weight_decay: float = 0.0, adam_w_mode: bool = True,
               bias_correction: bool = True) -> GradientTransformation:
    """``FusedAdam(lr, betas=(b1, b2), eps, weight_decay, adam_w_mode,
    bias_correction)`` as an init/update pair over ``{name: tensor}``
    params. ``learning_rate`` may be a schedule ``f(step) -> lr``."""

    def init(params: dict) -> FusedAdamState:
        return FusedAdamState(step=step0(params), exp_avg=zeros_f32(params),
                              exp_avg_sq=zeros_f32(params))

    def update(grads: dict, state: FusedAdamState, params: dict = None):
        if params is None:
            raise ValueError("fused_adam requires params")
        step = state.step + 1
        lr = learning_rate(step) if callable(learning_rate) else learning_rate
        bc1, bc2 = bias_corrections(b1, b2, step, bias_correction)
        updates, new_m, new_v = {}, {}, {}
        for k, g in grads.items():
            p = params[k]
            g32, p32 = g.float(), p.float()
            if not adam_w_mode and weight_decay:
                g32 = g32 + weight_decay * p32
            m = b1 * state.exp_avg[k] + (1.0 - b1) * g32
            v = b2 * state.exp_avg_sq[k] + (1.0 - b2) * g32.square()
            upd = (m / bc1) / (torch.sqrt(v / bc2) + eps)
            if adam_w_mode and weight_decay:
                upd = upd + weight_decay * p32
            updates[k] = (-lr * upd).to(p.dtype)
            new_m[k], new_v[k] = m, v
        return updates, FusedAdamState(step=step, exp_avg=new_m,
                                       exp_avg_sq=new_v)

    return GradientTransformation(init, update)
