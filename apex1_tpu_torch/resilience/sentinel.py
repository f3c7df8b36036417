"""Divergence sentinel (the port of ``apex1_tpu/resilience/sentinel.py``):
a finite and divergence guard for every dtype, with a skip, rollback,
abort escalation.

1. Skip (on the device, every step): `guard_train_step` wraps any
   ``(state, *batch) -> (state, metrics)`` step, derives one health
   flag from the step's own metrics (``isfinite(loss) &
   isfinite(grad_norm) [& grads_finite] [& grad_norm < threshold]``)
   and keeps the old state on an unhealthy step through
   `core.loss_scale.select_tree`, the fp16 overflow skip's machinery.
   The flag and the counters are 0-d tensors carried in a
   `SentinelState`: the guarded step reads nothing back to the host
   (no ``.item()``, ``bool(t)`` or ``int(t)``; pinned by test).
2. Rollback (on the host, every ``check_every`` steps): `Sentinel.poll`
   reads the counters (the one sync, amortized) and once
   ``consecutive_bad >= rollback_after`` directs the loop to restore the
   last good checkpoint through the `ResilientCheckpointer` and to
   re-fold its random stream (`refold_key`, `refold_seed`).
3. Abort: ``consecutive_bad >= abort_after``, the rollback budget spent
   or no checkpoint to roll back to raises a `DivergenceError` carrying
   the banked diagnostic record (JSON on disk).
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Callable, Optional, Tuple

import torch

from apex1_tpu_torch.core.loss_scale import select_tree
from apex1_tpu_torch.resilience.manifest import atomic_write_json
from apex1_tpu_torch.resilience.retry import _mix32


@dataclasses.dataclass(frozen=True)
class SentinelState:
    """Device-carried counters, 0-d tensors (checkpoint them with the
    rest of the train state so a resume keeps the escalation context)."""

    steps_seen: torch.Tensor       # i32: wrapped steps executed
    consecutive_bad: torch.Tensor  # i32: current unhealthy streak
    total_bad: torch.Tensor        # i32: lifetime unhealthy steps
    last_bad_step: torch.Tensor    # i32: steps_seen index, -1 = never
    last_loss: torch.Tensor        # f32: most recent loss (diagnostics)
    last_grad_norm: torch.Tensor   # f32

    #: key paths visit the fields sorted, as the JAX package's chex
    #: dataclass flattens (`core.pytree.tree_flatten_with_path`)
    _tree_sorted_fields = True


def sentinel_init(device=None) -> SentinelState:
    """Fresh counters on ``device`` (CUDA unless named)."""
    from apex1_tpu_torch.ops._common import resolve_device
    dev = resolve_device(device)
    i32 = dict(dtype=torch.int32, device=dev)
    f32 = dict(dtype=torch.float32, device=dev)
    return SentinelState(steps_seen=torch.zeros((), **i32),
                         consecutive_bad=torch.zeros((), **i32),
                         total_bad=torch.zeros((), **i32),
                         last_bad_step=torch.full((), -1, **i32),
                         last_loss=torch.zeros((), **f32),
                         last_grad_norm=torch.zeros((), **f32))


def health_flag(metrics: dict, *, gnorm_threshold: Optional[float] = None,
                axis_names: Tuple = ()) -> torch.Tensor:
    """One bool 0-d tensor from a train step's metrics: loss and
    grad_norm finite, ``grads_finite`` honored when present, and an
    optional hard grad-norm ceiling (divergence is not only NaN). With
    ``axis_names`` (mesh axis names or process groups) the ranks agree:
    a MIN all-reduce of the flag over each, JAX's ``pmin``."""
    flags = []
    for key in ("loss", "grad_norm"):
        if key in metrics:
            v = torch.as_tensor(metrics[key])
            if torch.is_floating_point(v):
                flags.append(torch.isfinite(v).all())
    if "grads_finite" in metrics:
        flags.append(torch.as_tensor(metrics["grads_finite"]).bool())
    if gnorm_threshold is not None and "grad_norm" in metrics:
        flags.append(torch.as_tensor(metrics["grad_norm"])
                     < float(gnorm_threshold))
    if not flags:
        return torch.ones((), dtype=torch.bool)
    healthy = flags[0]
    for f in flags[1:]:
        healthy = torch.logical_and(healthy, f.to(healthy.device))
    if axis_names:
        from apex1_tpu_torch.amp import _all_groups_finite
        healthy = _all_groups_finite(healthy, tuple(axis_names))
    return healthy


def guard_train_step(train_step: Callable, *,
                     gnorm_threshold: Optional[float] = None,
                     axis_names: Tuple = ()) -> Callable:
    """Wrap ``train_step(state, *batch) -> (new_state, metrics)`` into
    ``guarded((state, sentinel_state), *batch) -> ((state', sentinel'),
    metrics)``. An unhealthy step keeps the old state (a ``step`` field
    of a dataclass state still advances, as the fp16 overflow skip's
    does, so data progress is not replayed); no host sync."""

    def guarded(carry, *batch):
        state, s = carry
        new_state, metrics = train_step(state, *batch)
        healthy = health_flag(metrics, gnorm_threshold=gnorm_threshold,
                              axis_names=axis_names)
        healthy = healthy.to(s.steps_seen.device)
        kept = select_tree(healthy, new_state, state)
        if dataclasses.is_dataclass(kept) and hasattr(kept, "step"):
            kept = dataclasses.replace(kept, step=new_state.step)
        bad = torch.logical_not(healthy)
        zero = torch.zeros((), dtype=torch.float32,
                           device=s.last_loss.device)
        loss = torch.as_tensor(metrics.get("loss", zero))
        gnorm = torch.as_tensor(metrics.get("grad_norm", zero))
        new_s = SentinelState(
            steps_seen=s.steps_seen + 1,
            consecutive_bad=torch.where(
                bad, s.consecutive_bad + 1,
                torch.zeros_like(s.consecutive_bad)),
            total_bad=s.total_bad + bad.to(torch.int32),
            last_bad_step=torch.where(bad, s.steps_seen, s.last_bad_step),
            last_loss=loss.detach().float().reshape(()).to(zero.device),
            last_grad_norm=gnorm.detach().float().reshape(())
            .to(zero.device))
        metrics = dict(metrics)
        metrics["sentinel_healthy"] = healthy
        return (kept, new_s), metrics

    return guarded


def refold_key(key, attempt: int) -> tuple:
    """Re-fold a threefry key (`core.random`'s ``(k1, k2)``) for a
    post-rollback retry: attempt 1, 2, … draw distinct streams, so the
    retry does not replay the stochastic trajectory that diverged. JAX's
    ``fold_in(key, 0x5EED0000 + attempt)`` to the bit."""
    from apex1_tpu_torch.core.random import fold_in
    return fold_in(key, 0x5EED0000 + int(attempt))


def refold_seed(seed: int, attempt: int) -> int:
    """Integer-seed analog of `refold_key` (the counter-based kernels,
    `ops.stochastic`): a deterministic avalanche of (seed, attempt)."""
    return _mix32(int(seed) ^ _mix32(0x5EED0000 + int(attempt)))


class DivergenceError(RuntimeError):
    """Escalation exhausted; ``record`` is the banked diagnostic."""

    def __init__(self, msg: str, record: dict):
        super().__init__(msg)
        self.record = record


class Sentinel:
    """Host-side escalation policy around the device-carried counters.

    Typical loop::

        sent = Sentinel(ckptr, check_every=10)
        guarded = sent.guard(amp.make_train_step(loss_fn))
        carry = (state, sentinel_init())
        while step < total:
            carry, metrics = guarded(carry, batch_at(step))
            action = sent.poll(carry[1])          # syncs every Nth call
            if action == "rollback":
                state, manifest, s0 = sent.rollback(template=carry[0])
                step = manifest.step              # rewind data position
                carry = (state, s0)               # + refold_key(...)
                continue
            step += 1

    ``poll`` raises `DivergenceError` on the abort rung; every rollback
    and abort banks a JSON diagnostic record under ``diagnostics_dir``
    (default ``<checkpoint dir>/diagnostics``).
    """

    def __init__(self, checkpointer=None, *, check_every: int = 10,
                 rollback_after: int = 2, abort_after: int = 4,
                 max_rollbacks: int = 2,
                 gnorm_threshold: Optional[float] = None,
                 diagnostics_dir: Optional[str] = None):
        if check_every < 1:
            raise ValueError("check_every must be >= 1")
        if not 1 <= rollback_after <= abort_after:
            raise ValueError("need 1 <= rollback_after <= abort_after")
        self.checkpointer = checkpointer
        self.check_every = int(check_every)
        self.rollback_after = int(rollback_after)
        self.abort_after = int(abort_after)
        self.max_rollbacks = int(max_rollbacks)
        self.gnorm_threshold = gnorm_threshold
        self.diagnostics_dir = diagnostics_dir
        self.records: list = []         # banked this process, in order
        self.rollbacks_done = 0
        self._polls = 0

    def guard(self, train_step: Callable,
              axis_names: Tuple = ()) -> Callable:
        return guard_train_step(train_step,
                                gnorm_threshold=self.gnorm_threshold,
                                axis_names=axis_names)

    def init_state(self, device=None) -> SentinelState:
        return sentinel_init(device)

    # -- host control plane (the int() reads below are the amortized
    # every-Nth-step sync, never inside the guarded step) ---------------

    def _diagnostic(self, s: SentinelState, action: str) -> dict:
        return {"action": action,
                "time": time.time(),
                "steps_seen": int(s.steps_seen),
                "consecutive_bad": int(s.consecutive_bad),
                "total_bad": int(s.total_bad),
                "last_bad_step": int(s.last_bad_step),
                "last_loss": float(s.last_loss),
                "last_grad_norm": float(s.last_grad_norm),
                "rollbacks_done": self.rollbacks_done}

    def _bank_dir(self) -> Optional[str]:
        """Resolved lazily: the checkpointer may be attached after
        construction."""
        if self.diagnostics_dir is not None:
            return self.diagnostics_dir
        if self.checkpointer is not None:
            return os.path.join(self.checkpointer.directory,
                                "diagnostics")
        return None

    def _bank(self, record: dict) -> dict:
        self.records.append(record)
        ddir = self._bank_dir()
        if ddir:
            os.makedirs(ddir, exist_ok=True)
            name = (f"divergence_{len(self.records):04d}_"
                    f"{record['action']}.json")
            atomic_write_json(os.path.join(ddir, name), record)
            record["path"] = os.path.join(ddir, name)
        # mirrored into the telemetry spine (APEX1_OBS_DIR), beside the
        # loop's metrics
        from apex1_tpu_torch.obs import spine
        spine.emit("event", "sentinel.diagnostic", **record)
        return record

    def poll(self, s: SentinelState, *, force: bool = False
             ) -> Optional[str]:
        """Check the carried counters every ``check_every``-th call (one
        device sync). Returns None (healthy or not checked), ``"skip"``
        (bad steps skipped on the device, below the rollback rung) or
        ``"rollback"``; raises `DivergenceError` on the abort rung."""
        self._polls += 1
        if not force and self._polls % self.check_every:
            return None
        consecutive = int(s.consecutive_bad)
        if consecutive == 0:
            return None
        can_rollback = (self.checkpointer is not None
                        and self.rollbacks_done < self.max_rollbacks
                        and self.checkpointer.latest_valid() is not None)
        if consecutive >= self.abort_after or (
                consecutive >= self.rollback_after and not can_rollback):
            record = self._bank(self._diagnostic(s, "abort"))
            raise DivergenceError(
                f"diverged: {consecutive} consecutive unhealthy steps "
                f"(total {int(s.total_bad)}), escalation exhausted — "
                f"diagnostic banked at {record.get('path', '<memory>')}",
                record)
        if consecutive >= self.rollback_after:
            self._bank(self._diagnostic(s, "rollback"))
            return "rollback"
        self._bank(self._diagnostic(s, "skip"))
        return "skip"

    def rollback(self, template: Any):
        """Restore the last good checkpoint. Returns ``(state, manifest,
        fresh_sentinel_state)`` (the counters on the template's device);
        the caller rewinds its data position to ``manifest.step`` and
        re-folds its random stream with `refold_key(key,
        sentinel.rollbacks_done)`."""
        if self.checkpointer is None:
            raise DivergenceError("rollback requested without a "
                                  "checkpointer", {})
        state, manifest = self.checkpointer.restore(template)
        self.rollbacks_done += 1
        return state, manifest, sentinel_init(_first_device(state))


def _first_device(state) -> Optional[torch.device]:
    from apex1_tpu_torch.core.pytree import tree_flatten_with_path
    for _, x in tree_flatten_with_path(state):
        if isinstance(x, torch.Tensor):
            return x.device
    return None
