"""Functional loss scaling (the port of ``apex1_tpu/core/loss_scale.py``;
reference ``apex/amp/scaler.py :: LossScaler``).

The scale and its counters are 0-d tensors on the device, threaded
through the train step; the finite check is a device reduction and the
skip a per-tensor ``torch.where``, so a step never waits on the host
(the role of apex's device-side ``noop_flag``).

Semantics, as the reference's:
  - dynamic: init 2**16, double every ``growth_interval`` (2000)
    consecutive clean steps, halve on inf/nan (after ``hysteresis``
    overflows), skip the optimizer step on overflow;
  - ``min_loss_scale`` / ``max_loss_scale`` clamps.
"""

from __future__ import annotations

import dataclasses

import torch

from apex1_tpu_torch.core.pytree import whole


@dataclasses.dataclass(frozen=True)
class LossScaleState:
    """0-d tensors on the device: ``scale`` f32; ``growth_count``
    (consecutive clean steps), ``overflow_count`` (total skipped steps)
    and ``hysteresis_left`` (overflows left before the scale halves)
    int32."""

    scale: torch.Tensor
    growth_count: torch.Tensor
    overflow_count: torch.Tensor
    hysteresis_left: torch.Tensor

    #: key paths visit the fields sorted, as the JAX package's chex
    #: dataclass flattens (`core.pytree.tree_flatten_with_path`)
    _tree_sorted_fields = True


def _state(scale: float, hysteresis: int, device) -> LossScaleState:
    i32 = dict(dtype=torch.int32, device=device)
    return LossScaleState(
        scale=torch.tensor(scale, dtype=torch.float32, device=device),
        growth_count=torch.zeros((), **i32),
        overflow_count=torch.zeros((), **i32),
        hysteresis_left=torch.tensor(hysteresis, **i32))


def all_finite(tree: dict) -> torch.Tensor:
    """One bool 0-d tensor: every float tensor of ``tree`` is free of
    inf and nan (the reference's in-kernel overflow check). A DTensor's
    flag covers its every shard (`core.pytree.whole`)."""
    flags = [whole(torch.isfinite(v).all()) for v in tree.values()
             if torch.is_floating_point(v)]
    if not flags:
        return torch.ones((), dtype=torch.bool)
    return torch.stack(flags).all()


def _where(pred, on_true, on_false):
    if isinstance(on_true, torch.Tensor):
        return torch.where(pred, on_true, on_false)
    if isinstance(on_true, dict):
        return {k: _where(pred, v, on_false[k]) for k, v in on_true.items()}
    if isinstance(on_true, (list, tuple)):
        return type(on_true)(_where(pred, a, b)
                             for a, b in zip(on_true, on_false))
    if dataclasses.is_dataclass(on_true):
        return dataclasses.replace(on_true, **{
            f.name: _where(pred, getattr(on_true, f.name),
                           getattr(on_false, f.name))
            for f in dataclasses.fields(on_true)})
    raise TypeError(f"select_tree: unsupported leaf {type(on_true)}")


def select_tree(pred: torch.Tensor, on_true, on_false):
    """Per-tensor ``torch.where(pred, a, b)`` over matching dicts, lists
    and tuples (or dataclasses of tensors and dicts; a chained
    optimizer's state is a tuple): keeps the old params and
    optimizer state on an overflowed step, with no host sync."""
    return _where(pred, on_true, on_false)


class _LossScaleBase:
    def init(self, device=None) -> LossScaleState:
        raise NotImplementedError

    def scale(self, loss: torch.Tensor, state: LossScaleState):
        return loss * state.scale.to(loss.dtype)

    def unscale(self, grads: dict, state: LossScaleState) -> dict:
        inv = 1.0 / state.scale
        return {k: ((g.float() * inv).to(g.dtype)
                    if torch.is_floating_point(g) else g)
                for k, g in grads.items()}

    def adjust(self, state: LossScaleState, grads_finite) -> LossScaleState:
        raise NotImplementedError


class NoOpLossScale(_LossScaleBase):
    """scale == 1; O0 and the bf16 paths (bf16 has fp32's range)."""

    def init(self, device=None) -> LossScaleState:
        return _state(1.0, 1, device)

    def scale(self, loss, state):
        return loss

    def unscale(self, grads, state):
        return grads

    def adjust(self, state, grads_finite):
        return state


class StaticLossScale(_LossScaleBase):
    """``loss_scale=<float>`` in ``amp.initialize``; never adjusts."""

    def __init__(self, scale: float):
        self._scale = float(scale)

    def init(self, device=None) -> LossScaleState:
        return _state(self._scale, 1, device)

    def adjust(self, state, grads_finite):
        skipped = (~torch.as_tensor(grads_finite)).to(torch.int32)
        return dataclasses.replace(
            state, overflow_count=state.overflow_count + skipped)


class DynamicLossScale(_LossScaleBase):
    """The reference's dynamic scaling state machine (``scaler.py ::
    LossScaler`` and the device-side hysteresis of
    ``csrc/update_scale_hysteresis.cu``)."""

    def __init__(self, init_scale: float = 2.0 ** 16,
                 growth_factor: float = 2.0, backoff_factor: float = 0.5,
                 growth_interval: int = 2000, min_loss_scale: float = 1.0,
                 max_loss_scale: float = 2.0 ** 24, hysteresis: int = 1):
        self.init_scale = float(init_scale)
        self.growth_factor = float(growth_factor)
        self.backoff_factor = float(backoff_factor)
        self.growth_interval = int(growth_interval)
        self.min_loss_scale = float(min_loss_scale)
        self.max_loss_scale = float(max_loss_scale)
        self.hysteresis = int(hysteresis)

    def init(self, device=None) -> LossScaleState:
        return _state(self.init_scale, self.hysteresis, device)

    def adjust(self, state: LossScaleState, grads_finite) -> LossScaleState:
        """A clean step advances the growth count (x growth_factor every
        ``growth_interval``, which also refills the hysteresis budget);
        an overflow zeroes the count and spends one unit of budget: the
        scale halves once the budget is spent, and on every further
        overflow until growth refills it. ``hysteresis=1`` is the
        classic halve-on-every-overflow."""
        finite = torch.as_tensor(grads_finite, device=state.scale.device)
        grew = state.growth_count + 1 >= self.growth_interval
        clean_scale = torch.where(grew, state.scale * self.growth_factor,
                                  state.scale)
        clean_count = torch.where(grew, 0, state.growth_count + 1)
        hys_spent = torch.clamp(state.hysteresis_left - 1, min=0)
        backoff = (~finite) & (hys_spent <= 0)
        new_scale = torch.where(
            finite, clean_scale,
            torch.where(backoff, state.scale * self.backoff_factor,
                        state.scale))
        new_scale = torch.clamp(new_scale, self.min_loss_scale,
                                self.max_loss_scale)
        new_hys = torch.where(
            finite,
            torch.where(grew, self.hysteresis, state.hysteresis_left),
            hys_spent)
        return LossScaleState(
            scale=new_scale.to(torch.float32),
            growth_count=torch.where(finite, clean_count, 0).to(torch.int32),
            overflow_count=(state.overflow_count
                            + (~finite).to(torch.int32)).to(torch.int32),
            hysteresis_left=new_hys.to(torch.int32))


def make_loss_scale(spec) -> _LossScaleBase:
    """Resolve the policy's ``loss_scale``: None -> no-op, "dynamic" ->
    `DynamicLossScale`, a number -> `StaticLossScale`."""
    if spec is None:
        return NoOpLossScale()
    if isinstance(spec, _LossScaleBase):
        return spec
    if spec == "dynamic":
        return DynamicLossScale()
    return StaticLossScale(float(spec))
