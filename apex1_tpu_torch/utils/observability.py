"""Tracing, profiling and metrics (the port of
``apex1_tpu/utils/observability.py``).

Reference: ``apex.pyprof`` (nvtx ranges on every call, per-kernel FLOP
counts from the profile) and ``apex/transformer``'s ``timers``.

- `annotate` names a region in ``torch.profiler`` traces
  (``record_function``).
- `trace` records a ``torch.profiler`` session of the enclosed block
  (CPU, and CUDA where there is a card) and writes its Chrome trace
  under ``logdir``.
- `cost_analysis` / `flops_per_step` count the model FLOPs of a call:
  its matrix products through ``torch.utils.flop_counter
  .FlopCounterMode``. The port's kernels are launched through ctypes,
  outside PyTorch's dispatcher, so the counter would see none of their
  work: the call is counted on its PLAIN path instead, on ``meta``
  copies of its tensors (no memory, no device work). The kernels
  compute the same functions. Flash attention's and the fused linear
  cross-entropy's backward form their forward products again (the
  scores, the logits), in the kernels and in their plain versions;
  ``ops.force_impl("autodiff")`` differentiates their plain forward
  with autograd instead, so each product counts once forward and twice
  backward, as a model FLOP count (6 a weight and token, 12·L·S·H a
  token for attention) assumes. The recomputation is not counted.
- `Timers` — named cumulative timers on the spine's `StopWatch`, the
  ``apex/transformer`` ``timers`` contract.
- `MetricsLogger` writes per-step structured metrics as JSON lines and
  mirrors every record into the telemetry spine when ``APEX1_OBS_DIR``
  is set.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Callable, Optional

import numpy as np
import torch

from apex1_tpu_torch.obs import spine


def annotate(name: str):
    """Name a region for profiler timelines."""
    return torch.profiler.record_function(name)


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the enclosed block with ``torch.profiler`` (CUDA
    activity too where a card is present) and write its Chrome trace to
    ``<logdir>/trace_<pid>_<n>.json``. The profile object is yielded;
    its ``trace_path`` attribute names the file once the block ends."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    n = len([f for f in os.listdir(logdir) if f.startswith("trace_")])
    with profile(activities=acts) as prof:
        yield prof
    prof.trace_path = os.path.join(logdir, f"trace_{os.getpid()}_{n}.json")
    prof.export_chrome_trace(prof.trace_path)


def _to_meta(tree):
    from apex1_tpu_torch.core.pytree import tree_map_with_path
    return tree_map_with_path(
        lambda _, x: (torch.empty_like(x, device="meta")
                      if isinstance(x, torch.Tensor) else x), tree)


def cost_analysis(fn: Callable, *args, **kwargs) -> dict:
    """``{"flops": n}``: the floating-point operations of the matrix
    products (mm, bmm, addmm, convolutions, attention) that
    ``fn(*args, **kwargs)`` runs on its plain path without recomputation
    (module docstring), on meta copies of
    its tensors, so nothing is computed and no state is changed (``fn``
    must not read tensor values on the host). XLA's cost model also
    reports bytes accessed and transcendentals; PyTorch's counter has no
    twin of those."""
    from torch.utils.flop_counter import FlopCounterMode

    from apex1_tpu_torch.ops import force_impl
    a, k = _to_meta(args), _to_meta(kwargs)
    with force_impl("autodiff"), FlopCounterMode(display=False) as counter:
        fn(*a, **k)
    return {"flops": float(counter.get_total_flops())}


def flops_per_step(fn: Callable, *args, **kwargs) -> float:
    """`cost_analysis`'s FLOP count of one call (a train step)."""
    return float(cost_analysis(fn, *args, **kwargs)["flops"])


class Timers:
    """Named cumulative timers (``timers("fwd").start()/.stop()``), the
    calling convention of ``apex/transformer``'s schedules. ``stop``
    takes ``sync=tree`` to wait for the tree's devices first. Each timer
    is a spine `StopWatch`, and ``log`` mirrors the read-out as spine
    counters when ``APEX1_OBS_DIR`` is set."""

    #: the spine primitive, under the JAX package's name
    _Timer = spine.StopWatch

    def __init__(self):
        self._timers: dict[str, spine.StopWatch] = {}

    def __call__(self, name: str) -> spine.StopWatch:
        return self._timers.setdefault(name, spine.StopWatch())

    def log(self, names=None, *, reset: bool = True) -> dict[str, float]:
        names = list(self._timers) if names is None else names
        out = {}
        for n in names:
            if n not in self._timers:
                continue
            t = self._timers[n]
            count = t.count
            out[n] = t.elapsed(reset=reset)
            spine.emit("counter", f"timer.{n}", value=round(out[n], 6),
                       count=count)
        return out


class MetricsLogger:
    """Structured per-step metrics with tokens/sec/device derivation.

    ``log(step, metrics, tokens=...)`` turns tensors into host scalars
    (one small transfer each) and emits a JSON line via ``print`` or a
    supplied writer."""

    def __init__(self, writer: Optional[Callable[[str], None]] = None,
                 n_devices: int = 1):
        self.writer = writer or print
        self.n_devices = n_devices
        self._last_t: Optional[float] = None
        self._last_step: Optional[int] = None

    def log(self, step: int, metrics: dict, *,
            tokens: Optional[int] = None,
            _obs_name: Optional[str] = "metrics") -> dict:
        # _obs_name: spine event name for the mirror; None = the caller
        # already emitted a structured spine event for this record
        now = time.perf_counter()
        rec = {"step": int(step)}
        for k, v in metrics.items():
            if isinstance(v, (str, bool)):
                rec[k] = v
                continue
            if isinstance(v, torch.Tensor):
                v = v.detach().cpu().numpy()
            try:
                arr = np.asarray(v)
                if arr.size == 1 and arr.dtype != object:
                    rec[k] = float(arr)
                elif arr.dtype != object:
                    rec[k] = arr.tolist()
                else:
                    raise TypeError("non-array metric")
            except (TypeError, ValueError):
                rec[k] = repr(v)[:500]
        if tokens is not None and self._last_t is not None:
            dt = now - self._last_t
            steps = step - (self._last_step or 0)
            if dt > 0 and steps > 0:
                rec["tokens_per_sec_per_device"] = (
                    tokens * steps / dt / self.n_devices)
        self._last_t, self._last_step = now, step
        self.writer(json.dumps(rec))
        if _obs_name:
            spine.emit("event", _obs_name, **rec)
        return rec
