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

The rest of ``amp.initialize``: ``has_aux`` (``loss_fn`` returns
``(loss, aux)``; ``metrics["aux"]`` holds the new aux, also on a
skipped step), ``num_losses`` with a step per ``loss_id`` (one scaler
state each), ``accum_steps`` (every batch leaf leads with the
accumulation axis; one optimizer step on the mean gradient),
``min_loss_scale``/``max_loss_scale`` (on a copy of the scaler) and
``cast_model_outputs`` (`Amp.make_forward`); `Amp.state_dict`,
`initialize`, `scale_loss` and the function wrappers.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any, Callable

import torch

from apex1_tpu_torch.core.loss_scale import (DynamicLossScale,
                                             LossScaleState, all_finite,
                                             make_loss_scale, select_tree)
from apex1_tpu_torch.core.policy import (PrecisionPolicy, map_tensors,
                                         get_policy)
from apex1_tpu_torch.core.pytree import global_norm
from apex1_tpu_torch.optim.clip_grad import clip_grad_norm
from apex1_tpu_torch.optim import GradientTransformation, apply_updates


@dataclasses.dataclass
class AmpState:
    """fp32 master params, optimizer state and loss-scale state (the
    (model, optimizer, ``amp.state_dict()``) triple the reference
    checkpoints); ``step`` int32 0-d; ``loss_scale`` a tuple of states
    when ``num_losses > 1``."""

    step: torch.Tensor
    params: dict
    opt_state: Any
    loss_scale: Any

    #: key paths visit the fields sorted, as the JAX package's chex
    #: dataclass flattens (`core.pytree.tree_flatten_with_path`)
    _tree_sorted_fields = True


class Amp:
    """Precision policy + optimizer. ``opt_level`` and overrides mirror
    ``amp.initialize``: ``Amp(tx, opt_level="O2", loss_scale=128.0)``."""

    def __init__(self, tx: GradientTransformation,
                 opt_level="O1", max_grad_norm: float = None,
                 grad_psum_axes: tuple = (), num_losses: int = 1,
                 cast_model_outputs=None, min_loss_scale: float = None,
                 max_loss_scale: float = None, **policy_overrides):
        self.tx = tx
        self.policy: PrecisionPolicy = get_policy(opt_level,
                                                  **policy_overrides)
        self.scaler = make_loss_scale(self.policy.loss_scale)
        # amp.initialize(min_loss_scale=, max_loss_scale=): clamps on a
        # copy, never on a scaler the caller passed in
        if min_loss_scale is not None or max_loss_scale is not None:
            if not isinstance(self.scaler, DynamicLossScale):
                raise ValueError("min/max_loss_scale require a dynamic "
                                 "loss scale")
            self.scaler = copy.copy(self.scaler)
            if min_loss_scale is not None:
                self.scaler.min_loss_scale = float(min_loss_scale)
            if max_loss_scale is not None:
                self.scaler.max_loss_scale = float(max_loss_scale)
        self.max_grad_norm = max_grad_norm
        #: the groups the gradients are averaged over (data parallelism)
        self.grad_psum_axes = tuple(grad_psum_axes)
        if num_losses < 1:
            raise ValueError("num_losses must be >= 1")
        #: one scaler state a loss (GAN D/G, multi-task); a step picks
        #: one through ``loss_id``
        self.num_losses = int(num_losses)
        #: the dtype `make_forward` casts the outputs to (None: as is)
        self.cast_model_outputs = cast_model_outputs

    def init(self, params: dict) -> AmpState:
        """``params``: ``{name: tensor}``, e.g. a model's
        ``dict(named_parameters())``; stored detached in the policy's
        param dtype."""
        params = self.policy.cast_to_param(
            {k: v.detach() for k, v in params.items()})
        dev = next(iter(params.values())).device
        ls = (self.scaler.init(dev) if self.num_losses == 1
              else tuple(self.scaler.init(dev)
                         for _ in range(self.num_losses)))
        return AmpState(step=torch.zeros((), dtype=torch.int32, device=dev),
                        params=params, opt_state=self.tx.init(params),
                        loss_scale=ls)

    def _get_ls(self, state: AmpState, loss_id: int) -> LossScaleState:
        if self.num_losses == 1:
            return state.loss_scale
        return state.loss_scale[loss_id]

    def _set_ls(self, state_ls, loss_id: int, new: LossScaleState):
        if self.num_losses == 1:
            return new
        return tuple(new if i == loss_id else s
                     for i, s in enumerate(state_ls))

    def make_train_step(self, loss_fn: Callable, *, has_aux: bool = False,
                        loss_id: int = 0, accum_steps: int = 1) -> Callable:
        """``loss_fn(compute_params, *batch) -> loss`` (a 0-d tensor), or
        ``(loss, aux)`` with ``has_aux``. Returns ``step(state, *batch)
        -> (new_state, metrics)`` with metrics ``loss``, ``grad_norm``,
        ``loss_scale``, ``grads_finite`` and ``skipped_steps`` (device
        tensors) and ``aux`` (detached). ``loss_id`` picks the scaler
        when ``num_losses > 1``.

        ``accum_steps > 1``: every tensor of the batch leads with the
        accumulation axis; the micro-batches' scaled gradients are
        summed in fp32, times 1/n, cast to the param dtype, and the
        optimizer steps once. The loss is the micro-batches' mean; a
        float aux tensor their mean, any other the last one's."""
        if not 0 <= loss_id < self.num_losses:
            raise ValueError(f"loss_id {loss_id} outside num_losses="
                             f"{self.num_losses}")
        if accum_steps < 1:
            raise ValueError("accum_steps must be >= 1")
        policy, scaler = self.policy, self.scaler

        def grads_of(params: dict, ls: LossScaleState, batch):
            masters = {k: p.detach().requires_grad_()
                       for k, p in params.items()}
            with torch.enable_grad():
                out = loss_fn(policy.cast_to_compute(masters), *batch)
                loss, aux = out if has_aux else (out, None)
                got = torch.autograd.grad(scaler.scale(loss.float(), ls),
                                          list(masters.values()),
                                          allow_unused=True)
            grads = {k: (torch.zeros_like(p) if g is None else g)
                     for (k, p), g in zip(params.items(), got)}
            return grads, loss.detach(), map_tensors(aux, torch.Tensor.detach)

        def train_step(state: AmpState, *batch):
            ls, params = self._get_ls(state, loss_id), state.params
            if accum_steps == 1:
                grads, loss, aux = grads_of(params, ls, batch)
            else:
                grads = {k: torch.zeros_like(p, dtype=torch.float32)
                         for k, p in params.items()}
                loss, auxes = 0.0, []
                for i in range(accum_steps):
                    mb = map_tensors(batch, lambda t, i=i: t[i])
                    g, l_mb, aux_mb = grads_of(params, ls, mb)
                    grads = {k: grads[k] + g[k] for k in grads}
                    loss = loss + l_mb.float()
                    auxes.append(aux_mb)
                inv = 1.0 / accum_steps
                grads = {k: (g * inv).to(params[k].dtype)
                         for k, g in grads.items()}
                loss = loss * inv
                aux = _mean_aux(auxes) if has_aux else None
            loss = loss.float()
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
            new_params = apply_updates(params, updates)
            # skip-on-overflow: keep the old params and optimizer state
            new_params = select_tree(finite, new_params, params)
            new_opt = select_tree(finite, new_opt, state.opt_state)
            new_ls = scaler.adjust(ls, finite)
            new_state = AmpState(
                step=state.step + 1, params=new_params, opt_state=new_opt,
                loss_scale=self._set_ls(state.loss_scale, loss_id, new_ls))
            metrics = {"loss": loss, "grad_norm": gnorm,
                       "loss_scale": ls.scale, "grads_finite": finite,
                       "skipped_steps": new_ls.overflow_count}
            if has_aux:
                metrics["aux"] = aux
            return new_state, metrics

        return train_step

    def master_params(self, state: AmpState) -> dict:
        """``amp.master_params(optimizer)``: the fp32 weights."""
        return state.params

    def model_params(self, state: AmpState) -> dict:
        """The compute-dtype view the model consumes."""
        return self.policy.cast_to_compute(state.params)

    def make_forward(self, forward_fn: Callable) -> Callable:
        """The reference's patched forward for evaluation:
        ``fwd(state_or_params, *inputs)`` runs ``forward_fn`` on the
        params and the float inputs cast to the compute dtype, and casts
        every output tensor to ``cast_model_outputs`` when it is set."""
        policy = self.policy

        def fwd(state_or_params, *inputs):
            params = (state_or_params.params
                      if isinstance(state_or_params, AmpState)
                      else state_or_params)
            out = forward_fn(policy.cast_to_compute(params),
                             *policy.cast_to_compute(inputs))
            if self.cast_model_outputs is not None:
                out = map_tensors(
                    out, lambda t: t.to(self.cast_model_outputs))
            return out

        return fwd

    # amp.half_function / float_function / promote_function bound to this
    # Amp's policy (the module-level forms take the policy)
    def half_function(self, fn):
        return self.policy.half_function(fn)

    def float_function(self, fn):
        return self.policy.float_function(fn)

    def promote_function(self, fn):
        return self.policy.promote_function(fn)

    @staticmethod
    def _one_sd(ls: LossScaleState) -> dict:
        return {"loss_scale": ls.scale, "growth_count": ls.growth_count,
                "overflow_count": ls.overflow_count,
                "hysteresis_left": ls.hysteresis_left}

    def _one_ls(self, sd: dict, device) -> LossScaleState:
        def t(x, dtype):
            return torch.as_tensor(x, dtype=dtype, device=device).reshape(())

        return LossScaleState(
            scale=t(sd["loss_scale"], torch.float32),
            growth_count=t(sd["growth_count"], torch.int32),
            overflow_count=t(sd["overflow_count"], torch.int32),
            hysteresis_left=t(sd.get("hysteresis_left",
                                     getattr(self.scaler, "hysteresis", 1)),
                              torch.int32))

    def state_dict(self, state: AmpState) -> dict:
        """``amp.state_dict()``: the loss-scaler state for a checkpoint
        (``loss_scaler{i}`` entries when ``num_losses > 1``, as the
        reference's per-loss scalers)."""
        if self.num_losses == 1:
            return self._one_sd(state.loss_scale)
        return {f"loss_scaler{i}": self._one_sd(s)
                for i, s in enumerate(state.loss_scale)}

    def load_state_dict(self, state: AmpState, sd: dict) -> AmpState:
        """``state`` with the loss-scaler state of ``sd`` (tensors or
        numbers), on the params' device."""
        dev = state.step.device
        if self.num_losses == 1:
            return dataclasses.replace(state,
                                       loss_scale=self._one_ls(sd, dev))
        return dataclasses.replace(state, loss_scale=tuple(
            self._one_ls(sd[f"loss_scaler{i}"], dev)
            for i in range(self.num_losses)))


def _mean_aux(auxes: list):
    """The micro-batches' aux as one: float tensors averaged, other
    tensors the last micro-batch's (counters, flags)."""
    def merge(*leaves):
        if not isinstance(leaves[0], torch.Tensor):
            return leaves[-1]
        if torch.is_floating_point(leaves[0]):
            return torch.stack(leaves).mean(0)
        return leaves[-1]

    def walk(items):
        first = items[0]
        if isinstance(first, dict):
            return {k: walk([a[k] for a in items]) for k in first}
        if isinstance(first, (list, tuple)) and not hasattr(first, "_fields"):
            return type(first)(walk(list(col)) for col in zip(*items))
        return merge(*items)

    return walk(auxes)


def initialize(params: dict, tx: GradientTransformation, opt_level="O1",
               **overrides):
    """``amp.initialize(model, optimizer, opt_level)`` in one call:
    returns ``(amp, state)``."""
    amp = Amp(tx, opt_level=opt_level, **overrides)
    return amp, amp.init(params)


def half_function(fn, policy):
    """``amp.half_function``: ``fn`` with float inputs cast to
    ``policy``'s compute dtype (pass the policy or opt level you train
    with, or use `Amp.half_function`)."""
    return get_policy(policy).half_function(fn)


def float_function(fn, policy="O0"):
    """``amp.float_function``: float inputs cast to fp32 (the same under
    every policy)."""
    return get_policy(policy).float_function(fn)


def promote_function(fn, policy="O0"):
    """``amp.promote_function``: float inputs promoted to the widest
    among them (the same under every policy)."""
    return get_policy(policy).promote_function(fn)


def scale_loss(loss: torch.Tensor, loss_scale_state: LossScaleState):
    """``with amp.scale_loss(loss, opt) as scaled:`` for a hand-written
    step: the loss times the current scale."""
    return loss * loss_scale_state.scale.to(loss.dtype)


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
