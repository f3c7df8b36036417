"""Mixed-precision training (the port of ``apex1_tpu/amp``; reference
``apex/amp``).

    amp = Amp(fused_adam(1e-4), opt_level="O2")
    state = amp.init(dict(model.named_parameters()))
    step = amp.make_train_step(gpt2_loss_fn(model, fuse_head=False))
    state, metrics = step(state, tokens)

As in the JAX package, the step is a function of explicit state:
- fp32 master weights: ``state.params`` are the fp32 parameters; the
  loss function sees ``policy.cast_to_compute(params)``, so the grads
  land on the masters through the cast;
- ``scale_loss`` and the overflow skip: the loss-scale state rides in
  ``state.loss_scale``; non-finite grads keep the old params and
  optimizer state through `select_tree` (device-side, no host sync)
  and halve the scale.

Data parallelism (``grad_psum_axes``, JAX's shard_map DDP): the scaled
gradients and the reported loss are averaged over the named groups
(mesh axis names resolved through `parallel_state`'s mesh, or
``ProcessGroup``s) before the unscale, and the finite flag is a MIN
all-reduce over them, so every replica skips the same steps.

Ported for one loss and no gradient accumulation; ``accum_steps > 1``
and ``num_losses > 1`` raise.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from apex1_tpu_torch.core.loss_scale import (LossScaleState, all_finite,
                                             make_loss_scale, select_tree)
from apex1_tpu_torch.core.policy import PrecisionPolicy, get_policy
from apex1_tpu_torch.core.pytree import global_norm
from apex1_tpu_torch.optim.clip_grad import clip_grad_norm
from apex1_tpu_torch.optim.fused_adam import GradientTransformation


@dataclasses.dataclass
class AmpState:
    """fp32 master params, optimizer state and loss-scale state (the
    (model, optimizer, ``amp.state_dict()``) triple the reference
    checkpoints); ``step`` int32 0-d."""

    step: torch.Tensor
    params: dict
    opt_state: Any
    loss_scale: LossScaleState


class Amp:
    """Precision policy + optimizer. ``opt_level`` and overrides mirror
    ``amp.initialize``: ``Amp(tx, opt_level="O2", loss_scale=128.0)``."""

    def __init__(self, tx: GradientTransformation,
                 opt_level="O1", max_grad_norm: float = None,
                 grad_psum_axes: tuple = (), num_losses: int = 1,
                 **policy_overrides):
        if num_losses != 1:
            raise NotImplementedError(
                "num_losses > 1 (one loss scaler per loss) is not ported "
                "yet: ROADMAP.md queue A item 5")
        self.tx = tx
        self.policy: PrecisionPolicy = get_policy(opt_level,
                                                  **policy_overrides)
        self.scaler = make_loss_scale(self.policy.loss_scale)
        self.max_grad_norm = max_grad_norm
        #: the groups the gradients are averaged over (data parallelism)
        self.grad_psum_axes = tuple(grad_psum_axes)

    def init(self, params: dict) -> AmpState:
        """``params``: ``{name: tensor}``, e.g. a model's
        ``dict(named_parameters())``; stored detached in the policy's
        param dtype."""
        params = self.policy.cast_to_param(
            {k: v.detach() for k, v in params.items()})
        dev = next(iter(params.values())).device
        return AmpState(step=torch.zeros((), dtype=torch.int32, device=dev),
                        params=params, opt_state=self.tx.init(params),
                        loss_scale=self.scaler.init(dev))

    def make_train_step(self, loss_fn: Callable, *,
                        accum_steps: int = 1) -> Callable:
        """``loss_fn(compute_params, *batch) -> loss`` (a 0-d tensor).
        Returns ``step(state, *batch) -> (new_state, metrics)`` with
        metrics ``loss``, ``grad_norm``, ``loss_scale``,
        ``grads_finite`` and ``skipped_steps``, all device tensors."""
        if accum_steps != 1:
            raise NotImplementedError(
                "accum_steps > 1 (gradient accumulation) is not ported "
                "yet: ROADMAP.md queue A item 5")
        policy, scaler = self.policy, self.scaler

        def train_step(state: AmpState, *batch):
            ls, params = state.loss_scale, state.params
            masters = {k: p.detach().requires_grad_()
                       for k, p in params.items()}
            with torch.enable_grad():
                loss = loss_fn(policy.cast_to_compute(masters), *batch)
                got = torch.autograd.grad(scaler.scale(loss.float(), ls),
                                          list(masters.values()),
                                          allow_unused=True)
            grads = {k: (torch.zeros_like(p) if g is None else g)
                     for (k, p), g in zip(params.items(), got)}
            loss = loss.detach().float()
            if self.grad_psum_axes:
                from apex1_tpu_torch.parallel.ddp import mean_over
                grads = mean_over(grads, self.grad_psum_axes)
                # report the global mean
                loss = mean_over({"loss": loss}, self.grad_psum_axes)["loss"]
            grads = scaler.unscale(grads, ls)
            finite = all_finite(grads)
            if self.grad_psum_axes:
                finite = _all_groups_finite(finite, self.grad_psum_axes)
            gnorm = global_norm(grads)
            if self.max_grad_norm is not None:
                grads, _ = clip_grad_norm(grads, self.max_grad_norm)
            updates, new_opt = self.tx.update(grads, state.opt_state, params)
            new_params = {k: p + updates[k] for k, p in params.items()}
            # skip-on-overflow: keep the old params and optimizer state
            new_params = select_tree(finite, new_params, params)
            new_opt = select_tree(finite, new_opt, state.opt_state)
            new_ls = scaler.adjust(ls, finite)
            new_state = AmpState(step=state.step + 1, params=new_params,
                                 opt_state=new_opt, loss_scale=new_ls)
            metrics = {"loss": loss, "grad_norm": gnorm,
                       "loss_scale": ls.scale, "grads_finite": finite,
                       "skipped_steps": new_ls.overflow_count}
            return new_state, metrics

        return train_step

    def master_params(self, state: AmpState) -> dict:
        """``amp.master_params(optimizer)``: the fp32 weights."""
        return state.params

    def model_params(self, state: AmpState) -> dict:
        """The compute-dtype view the model consumes."""
        return self.policy.cast_to_compute(state.params)


def _all_groups_finite(finite: torch.Tensor, groups) -> torch.Tensor:
    """``finite`` on every rank of ``groups`` (a MIN all-reduce of the
    flag, JAX's ``pmin``)."""
    import torch.distributed as dist

    from apex1_tpu_torch.parallel.ddp import resolve_groups
    from apex1_tpu_torch.transformer.tensor_parallel.mappings import (
        all_reduce)
    flag = finite.to(torch.int32)
    for g in resolve_groups(groups):
        flag = all_reduce(flag, g, dist.ReduceOp.MIN)
    return flag.bool()
