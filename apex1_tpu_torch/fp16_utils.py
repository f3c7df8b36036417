"""The legacy manual mixed-precision API (the port of
``apex1_tpu/fp16_utils.py``; reference ``apex/fp16_utils/
{fp16_optimizer,loss_scaler,fp16util}.py``): ``FP16_Optimizer``,
``DynamicLossScaler``, ``network_to_half``,
``master_params_to_model_params`` and the rest, over the same
machinery as `amp` (`core.loss_scale`).

"The model" is a flat ``{name: tensor}`` dict (``dict(model.
named_parameters())``), so the module-mutating helpers of the
reference are casts of such dicts; a norm parameter is one whose name
has a norm segment (``bn1``, ``ln_f``, ``attn_norm``, ``stem_bn``...),
not every ``bias`` or ``scale``.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Callable

import torch

from apex1_tpu_torch.core.loss_scale import (DynamicLossScale,
                                             LossScaleState, all_finite,
                                             make_loss_scale, select_tree)
from apex1_tpu_torch.ops._common import resolve_device
from apex1_tpu_torch.optim import GradientTransformation, apply_updates

__all__ = [
    "tofp16", "network_to_half", "BN_convert_float", "prep_param_lists",
    "master_params_to_model_params", "model_grads_to_master_grads",
    "DynamicLossScaler", "LossScaler", "FP16_Optimizer",
]

# norm-ish name segments only: a Dense bias must go half, or the fp32
# add would promote the rest of the network
_NORM = re.compile(r"(^|[\[\]'/_.])((layer|batch|group|sync|rms)?"
                   r"norm|bn|ln)\d*([\[\]'/_.]|$)")


def _cast(tree: dict, dtype, keep_norms_fp32: bool = False) -> dict:
    def cast(name, t):
        if not torch.is_floating_point(t):
            return t
        if keep_norms_fp32 and _NORM.search(name.lower()):
            return t.float()
        return t.to(dtype)

    return {k: cast(k, v) for k, v in tree.items()}


def tofp16(tree: dict) -> dict:
    """``fp16util.tofp16``: float tensors to fp16."""
    return network_to_half(tree, dtype=torch.float16)


def network_to_half(tree: dict, *, dtype=torch.float16,
                    keep_norms_fp32: bool = False) -> dict:
    """``fp16util.network_to_half``: float tensors to ``dtype``; with
    ``keep_norms_fp32`` the norm parameters stay fp32."""
    return _cast(tree, dtype, keep_norms_fp32)


def BN_convert_float(tree: dict) -> dict:
    """``fp16util.BN_convert_float``: the norm parameters back to fp32
    after a wholesale half cast (the rest fp16)."""
    return network_to_half(tree, dtype=torch.float16, keep_norms_fp32=True)


def prep_param_lists(params: dict):
    """``fp16util.prep_param_lists(model)``: ``(model_params,
    master_params)``, the fp16 view and the fp32 masters."""
    return network_to_half(params), _cast(params, torch.float32)


def master_params_to_model_params(master_params: dict, *,
                                  dtype=torch.float16) -> dict:
    """``fp16util.master_params_to_model_params`` (master -> model; a
    new dict)."""
    return network_to_half(master_params, dtype=dtype)


def model_grads_to_master_grads(model_grads: dict) -> dict:
    """``fp16util.model_grads_to_master_grads``: to fp32."""
    return _cast(model_grads, torch.float32)


class DynamicLossScaler:
    """``fp16_utils.loss_scaler.DynamicLossScaler``: a stateful facade
    over `LossScaleState` (2^16 at first, x scale_factor every
    ``scale_window`` clean steps, halved on an overflow). The state
    lives on ``device``: CUDA unless the caller names another (asking
    for CUDA without a card raises)."""

    def __init__(self, init_scale: float = 2.0 ** 16,
                 scale_factor: float = 2.0, scale_window: int = 2000,
                 device=None):
        self._impl = make_loss_scale(DynamicLossScale(
            init_scale=init_scale, growth_factor=scale_factor,
            growth_interval=scale_window))
        self.state: LossScaleState = self._impl.init(
            resolve_device(device))

    @property
    def loss_scale(self) -> float:
        return float(self.state.scale)

    def scale_loss(self, loss: torch.Tensor) -> torch.Tensor:
        return self._impl.scale(loss, self.state)

    def unscale(self, grads: dict) -> dict:
        return self._impl.unscale(grads, self.state)

    def has_overflow(self, grads: dict) -> bool:
        return not bool(all_finite(grads))

    def update_scale(self, overflow: bool) -> None:
        self.state = self._impl.adjust(self.state,
                                       torch.tensor(not overflow))


class LossScaler(DynamicLossScaler):
    """The static ``fp16_utils.loss_scaler.LossScaler``."""

    def __init__(self, scale: float = 1.0, device=None):
        self._impl = make_loss_scale(scale)
        self.state = self._impl.init(resolve_device(device))

    def update_scale(self, overflow: bool) -> None:
        pass  # static


@dataclasses.dataclass
class FP16_Optimizer:
    """``fp16_utils.fp16_optimizer.FP16_Optimizer``: any
    `GradientTransformation` with fp32 master weights and loss scaling,
    driven by hand:

        opt = FP16_Optimizer(fused_sgd(0.1), dynamic_loss_scale=True)
        state = opt.init(half_params)
        loss, half_params, state = opt.step(loss_fn, state, *batch)

    ``loss_fn(model_params, *batch)`` sees the masters cast to
    ``compute_dtype``; a step with a non-finite gradient keeps the
    masters and the optimizer state (the reference's skip)."""

    optimizer: GradientTransformation
    static_loss_scale: float = 1.0
    dynamic_loss_scale: bool = False
    compute_dtype: Any = torch.float16

    def __post_init__(self):
        self._scaler = make_loss_scale(
            "dynamic" if self.dynamic_loss_scale else self.static_loss_scale)

    def init(self, params: dict) -> dict:
        master = _cast({k: v.detach() for k, v in params.items()},
                       torch.float32)
        dev = next(iter(master.values())).device
        return {"master": master, "opt": self.optimizer.init(master),
                "scale": self._scaler.init(dev)}

    def step(self, loss_fn: Callable, state: dict, *batch):
        """``(loss, model_params, new_state)``."""
        scaler, ls = self._scaler, state["scale"]
        master = {k: v.detach().requires_grad_()
                  for k, v in state["master"].items()}
        with torch.enable_grad():
            model = master_params_to_model_params(master,
                                                  dtype=self.compute_dtype)
            loss = loss_fn(model, *batch)
            got = torch.autograd.grad(scaler.scale(loss.float(), ls),
                                      list(master.values()),
                                      allow_unused=True)
        grads = {k: torch.zeros_like(p) if g is None else g
                 for (k, p), g in zip(master.items(), got)}
        grads = scaler.unscale(model_grads_to_master_grads(grads), ls)
        finite = all_finite(grads)
        updates, new_opt = self.optimizer.update(grads, state["opt"],
                                                 state["master"])
        new_master = apply_updates(state["master"], updates)
        new_state = {
            "master": select_tree(finite, new_master, state["master"]),
            "opt": select_tree(finite, new_opt, state["opt"]),
            "scale": scaler.adjust(ls, finite)}
        model = master_params_to_model_params(new_state["master"],
                                              dtype=self.compute_dtype)
        return loss.detach(), model, new_state
