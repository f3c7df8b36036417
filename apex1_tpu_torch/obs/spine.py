"""Telemetry spine (the part of ``apex1_tpu/obs/spine.py`` that the
serving metrics use): the one clock, `monotonic`, and `emit`, which
appends one JSON event line to the run file under ``APEX1_OBS_DIR``
and is a no-op when that variable is unset.

The file is ``<dir>/<component>_<pid>_<t0>.jsonl``; line 1 is the run
header ``{"schema": "apex1-obs-v1", "kind": "run", ...}`` and every
later line is ``{"kind", "name", "t", **fields}`` with ``t`` in seconds
since the run opened — the same schema as the JAX package, so both
packages' runs read alike.
"""

from __future__ import annotations

import json
import os
import re
import sys
import threading
import time
from typing import Optional

SCHEMA = "apex1-obs-v1"
KINDS = ("span", "counter", "gauge", "event")

monotonic = time.monotonic


def obs_dir() -> Optional[str]:
    d = os.environ.get("APEX1_OBS_DIR", "").strip()
    return d or None


class _Run:
    """One run's append-only event file, flushed per line."""

    def __init__(self, d: str):
        base = os.path.basename(sys.argv[0] or "") or "python"
        comp = re.sub(r"[^A-Za-z0-9_.-]", "_",
                      re.sub(r"\.py$", "", base)) or "python"
        t0_unix = time.time()
        run_id = f"{comp}_{os.getpid()}_{int(t0_unix)}"
        os.makedirs(d, exist_ok=True)
        self._t0 = time.monotonic()
        self._lock = threading.Lock()
        self._f = open(os.path.join(d, run_id + ".jsonl"), "a",
                       encoding="utf-8")
        self._write({"schema": SCHEMA, "kind": "run", "run": run_id,
                     "component": comp, "pid": os.getpid(),
                     "t0_unix": round(t0_unix, 3), "meta": {}})

    def _write(self, rec: dict) -> None:
        line = json.dumps(rec)
        with self._lock:
            self._f.write(line + "\n")
            self._f.flush()

    def emit(self, kind: str, name: str, **fields) -> None:
        if kind not in KINDS:
            raise ValueError(f"unknown event kind {kind!r}; one of {KINDS}")
        t = time.monotonic() - self._t0
        self._write({"kind": kind, "name": str(name), "t": round(t, 6),
                     **fields})


_DEFAULT: dict = {"run": None, "key": None}
_DEFAULT_LOCK = threading.Lock()


def _default_run() -> Optional[_Run]:
    d = obs_dir()
    key = (os.getpid(), d)
    with _DEFAULT_LOCK:
        if _DEFAULT["key"] != key:
            run = None
            if d is not None:
                try:
                    run = _Run(d)
                except OSError:
                    run = None
            _DEFAULT.update(run=run, key=key)
        return _DEFAULT["run"]


def emit(kind: str, name: str, **fields) -> None:
    """Fire-and-forget emission; a no-op when the spine is off, and I/O
    errors are swallowed: instrumentation never costs the instrumented
    path its result."""
    run = _default_run()
    if run is None:
        return
    try:
        run.emit(kind, name, **fields)
    except (OSError, TypeError, ValueError):
        pass
