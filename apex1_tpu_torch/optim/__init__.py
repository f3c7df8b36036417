"""Fused optimizers (the port of ``apex1_tpu/optim``; reference
``apex/optimizers``, ``apex/contrib/clip_grad`` and
``apex/parallel/LARC.py``).

Each optimizer is a `GradientTransformation` (``init(params)``,
``update(grads, state, params) -> (updates, state)``) over flat
``{name: tensor}`` dicts whose math is the JAX package's op for op
(moments in fp32, the same weight-decay modes and flags). `chain`
threads the updates through several transformations (LARC before its
optimizer) and `apply_updates` adds them to the params.

`Optimizer` is the torch-shaped facade: ``opt = FusedAdam(lr=1e-3);
state = opt.init(params); params, state = opt.step(grads, state,
params)``; the constructors take the reference's signatures.
"""

from __future__ import annotations

from typing import Any

from apex1_tpu_torch.optim.clip_grad import clip_grad_norm
from apex1_tpu_torch.optim.fused_adagrad import (FusedAdagradState,
                                                 fused_adagrad)
from apex1_tpu_torch.optim.fused_adam import (FusedAdamState,
                                              GradientTransformation,
                                              fused_adam)
from apex1_tpu_torch.optim.fused_lamb import FusedLAMBState, fused_lamb
from apex1_tpu_torch.optim.fused_novograd import (FusedNovoGradState,
                                                  fused_novograd)
from apex1_tpu_torch.optim.fused_sgd import FusedSGDState, fused_sgd
from apex1_tpu_torch.optim.larc import LARC, larc

clip_grad_norm_ = clip_grad_norm


def apply_updates(params: dict, updates: dict) -> dict:
    """``p + u`` for each param, in the param's dtype (optax's
    ``apply_updates``)."""
    return {k: (p + updates[k]).to(p.dtype) for k, p in params.items()}


def chain(*txs: GradientTransformation) -> GradientTransformation:
    """The transformations applied in order, each to the previous one's
    updates (optax's ``chain``); the state is a tuple of theirs."""

    def init(params: dict) -> tuple:
        return tuple(tx.init(params) for tx in txs)

    def update(grads: dict, state: tuple, params: dict = None):
        new_state = []
        for tx, s in zip(txs, state):
            grads, s = tx.update(grads, s, params)
            new_state.append(s)
        return grads, tuple(new_state)

    return GradientTransformation(init, update)


class Optimizer:
    """Torch-shaped facade over a `GradientTransformation`."""

    def __init__(self, tx: GradientTransformation):
        self.tx = tx

    def init(self, params: dict):
        return self.tx.init(params)

    def update(self, grads: dict, state, params: dict):
        return self.tx.update(grads, state, params)

    def step(self, grads: dict, state, params: dict):
        """``(new_params, new_state)``."""
        updates, new_state = self.tx.update(grads, state, params)
        return apply_updates(params, updates), new_state


def FusedAdam(lr=1e-3, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0,
              adam_w_mode=True, bias_correction=True, **_ignored: Any):
    """The reference's ``FusedAdam`` signature."""
    return Optimizer(fused_adam(lr, betas[0], betas[1], eps, weight_decay,
                                adam_w_mode, bias_correction))


def FusedLAMB(lr=1e-3, betas=(0.9, 0.999), eps=1e-6, weight_decay=0.01,
              bias_correction=True, max_grad_norm=1.0, use_nvlamb=False,
              **_ignored: Any):
    """The reference's ``FusedLAMB`` signature."""
    return Optimizer(fused_lamb(lr, betas[0], betas[1], eps, weight_decay,
                                bias_correction, max_grad_norm, use_nvlamb))


def FusedSGD(lr=1e-3, momentum=0.0, dampening=0.0, weight_decay=0.0,
             nesterov=False, wd_after_momentum=False, **_ignored: Any):
    """The reference's ``FusedSGD`` signature."""
    return Optimizer(fused_sgd(lr, momentum, dampening, weight_decay,
                               nesterov, wd_after_momentum))


def FusedNovoGrad(lr=1e-3, betas=(0.95, 0.98), eps=1e-8, weight_decay=0.0,
                  grad_averaging=True, init_zero=False, norm_type=2,
                  bias_correction=True, **_ignored: Any):
    """The reference's ``FusedNovoGrad`` signature."""
    return Optimizer(fused_novograd(lr, betas[0], betas[1], eps,
                                    weight_decay, grad_averaging, init_zero,
                                    norm_type, bias_correction))


def FusedAdagrad(lr=1e-2, eps=1e-10, weight_decay=0.0, adagrad_w_mode=False,
                 **_ignored: Any):
    """The reference's ``FusedAdagrad`` signature."""
    return Optimizer(fused_adagrad(lr, eps, weight_decay, adagrad_w_mode))


__all__ = ["apply_updates", "chain", "clip_grad_norm", "clip_grad_norm_",
           "FusedAdagrad", "FusedAdagradState", "FusedAdam",
           "FusedAdamState", "FusedLAMB", "FusedLAMBState", "FusedNovoGrad",
           "FusedNovoGradState", "FusedSGD", "FusedSGDState",
           "GradientTransformation", "LARC", "Optimizer", "fused_adagrad",
           "fused_adam", "fused_lamb", "fused_novograd", "fused_sgd",
           "larc"]
