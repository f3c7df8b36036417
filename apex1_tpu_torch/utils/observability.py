"""Tracing and metrics (the serving half of
``apex1_tpu/utils/observability.py``).

- `annotate` names a region in ``torch.profiler`` traces
  (``record_function``; the JAX package used a named scope plus a
  profiler trace annotation).
- `MetricsLogger` writes per-step structured metrics as JSON lines and
  mirrors every record into the telemetry spine when ``APEX1_OBS_DIR``
  is set.
"""

from __future__ import annotations

import json
import time
from typing import Callable, Optional

import numpy as np
import torch

from apex1_tpu_torch.obs import spine


def annotate(name: str):
    """Name a region for profiler timelines."""
    return torch.profiler.record_function(name)


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
