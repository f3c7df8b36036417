"""Telemetry spine (the port of ``apex1_tpu/obs/spine.py``): one
run-scoped event schema for every subsystem, the same as the JAX
package's, so each package's `read_events` reads the other's files.

- A **run** is one process-level measurement context. Its events land
  in one JSONL file ``<dir>/<component>_<pid>_<t0>_<seq>.jsonl``.
- Line 1 is the run header::

    {"schema": "apex1-obs-v1", "kind": "run", "run": "<id>",
     "component": "<argv0>", "pid": 1234, "t0_unix": 1759...,
     "meta": {...}}

- Every following line is one event::

    {"kind": "span",    "name": ..., "t": <s since t0>, "dur_s": ...}
    {"kind": "counter", "name": ..., "t": ..., "value": <cumulative>}
    {"kind": "gauge",   "name": ..., "t": ..., "value": <sample>}
    {"kind": "event",   "name": ..., "t": ..., **fields}

  Extra keyword fields ride along verbatim (JSON-safe scalars: callers
  hand host values, the emitter reads no tensor).

Durability: events are appended and flushed a line at a time, so a
crash keeps every line written and at most the last can be torn
(`read_events` skips it).

Activation: `emit` and `default_run` are inert (no file, one getenv)
until ``APEX1_OBS_DIR`` is set. `StopWatch` is the one host-side
wall-clock timer: `utils.observability.Timers` and the spans sit on it.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import re
import sys
import threading
import time
from typing import Any, Optional

SCHEMA = "apex1-obs-v1"

#: event kinds the schema admits (plus the "run" header line)
KINDS = ("span", "counter", "gauge", "event")

monotonic = time.monotonic   # the one clock (see ObsRun)


def obs_dir() -> Optional[str]:
    """``APEX1_OBS_DIR`` when set and non-empty, else None (spine off)."""
    d = os.environ.get("APEX1_OBS_DIR", "").strip()
    return d or None


def sync_tree(tree: Any) -> None:
    """Wait for the devices that hold the CUDA tensors of ``tree`` (one
    synchronize a device); CPU tensors and other leaves need none."""
    import torch

    from apex1_tpu_torch.core.pytree import tree_flatten_with_path
    devices = {x.device for _, x in tree_flatten_with_path(tree)
               if isinstance(x, torch.Tensor) and x.is_cuda}
    for d in devices:
        torch.cuda.synchronize(d)


class StopWatch:
    """Cumulative named-timer primitive: ``start()`` / ``stop(sync=...)``.

    ``stop(sync=tree)`` first waits for the devices of the tree's CUDA
    tensors, so device work is attributed to the timed region (the
    ``apex/transformer`` ``timers`` contract). ``elapsed_``, ``count``
    and ``last_s`` are public; ``elapsed(reset=True)`` reads and
    clears."""

    def __init__(self):
        self.elapsed_ = 0.0
        self.count = 0
        self.last_s: Optional[float] = None
        self._t0: Optional[float] = None

    def start(self) -> "StopWatch":
        self._t0 = time.perf_counter()
        return self

    def stop(self, sync: Any = None) -> float:
        if sync is not None:
            sync_tree(sync)
        dt = time.perf_counter() - self._t0
        self.elapsed_ += dt
        self.count += 1
        self.last_s = dt
        self._t0 = None
        return dt

    def elapsed(self, reset: bool = False) -> float:
        e = self.elapsed_
        if reset:
            self.elapsed_, self.count = 0.0, 0
        return e


def _component() -> str:
    base = os.path.basename(sys.argv[0] or "") or "python"
    base = re.sub(r"\.py$", "", base)
    return re.sub(r"[^A-Za-z0-9_.-]", "_", base) or "python"


#: per-process sequence folded into run ids: two runs opened in the same
#: second must not append into one file
_RUN_SEQ = itertools.count()


class ObsRun:
    """One run's event sink. Thread-safe; every write is flushed so the
    file tails live. Use it as a context manager or `close()` it (the
    file stays readable after the process dies mid-run)."""

    def __init__(self, dir: Optional[str] = None, *,
                 run_id: Optional[str] = None,
                 component: Optional[str] = None,
                 meta: Optional[dict] = None,
                 path: Optional[str] = None):
        self.component = component or _component()
        t0_unix = time.time()
        self.run_id = run_id or (f"{self.component}_{os.getpid()}_"
                                 f"{int(t0_unix)}_{next(_RUN_SEQ)}")
        if path is None:
            d = dir or obs_dir()
            if d is None:
                raise ValueError("ObsRun needs dir=, path=, or "
                                 "APEX1_OBS_DIR")
            os.makedirs(d, exist_ok=True)
            path = os.path.join(d, self.run_id + ".jsonl")
        self.path = path
        self._t0 = time.monotonic()
        self._lock = threading.Lock()
        self._f = open(path, "a", encoding="utf-8")
        self._write({"schema": SCHEMA, "kind": "run", "run": self.run_id,
                     "component": self.component, "pid": os.getpid(),
                     "t0_unix": round(t0_unix, 3),
                     "meta": dict(meta or {})})

    def _write(self, rec: dict) -> None:
        line = json.dumps(rec)
        with self._lock:
            if self._f.closed:
                return
            self._f.write(line + "\n")
            self._f.flush()

    def emit(self, kind: str, name: str, *, t: Optional[float] = None,
             **fields) -> None:
        if kind not in KINDS:
            raise ValueError(f"unknown event kind {kind!r}; one of {KINDS}")
        t = (time.monotonic() - self._t0) if t is None else t
        self._write({"kind": kind, "name": str(name),
                     "t": round(float(t), 6), **fields})

    def counter(self, name: str, value, **fields) -> None:
        self.emit("counter", name, value=value, **fields)

    def gauge(self, name: str, value, **fields) -> None:
        self.emit("gauge", name, value=value, **fields)

    def event(self, name: str, **fields) -> None:
        self.emit("event", name, **fields)

    @contextlib.contextmanager
    def span(self, name: str, *, sync: Any = None, **attrs):
        """Time the enclosed block as one span event. ``sync=tree``
        waits for the tree's devices before the clock stops (as
        `StopWatch.stop`)."""
        t_rel = time.monotonic() - self._t0
        sw = StopWatch().start()
        try:
            yield sw
        finally:
            dur = sw.stop(sync=sync)
            self.emit("span", name, t=t_rel, dur_s=round(dur, 6), **attrs)

    def close(self) -> None:
        with self._lock:
            if not self._f.closed:
                self._f.flush()
                try:
                    os.fsync(self._f.fileno())
                except OSError:
                    pass
                self._f.close()

    def __enter__(self) -> "ObsRun":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# -- the process-wide default run ------------------------------------------
#
# Subsystems call `emit(...)` unconditionally: with APEX1_OBS_DIR unset it
# does nothing, with it set the process opens ONE run lazily, keyed on
# (pid, dir) so a forked child and a changed dir get fresh files.

_DEFAULT: dict = {"run": None, "key": None}
_DEFAULT_LOCK = threading.Lock()


def default_run() -> Optional[ObsRun]:
    """The process-wide run (created at first use iff ``APEX1_OBS_DIR``
    is set), or None. Never raises: a broken obs dir must not take down
    the instrumented subsystem."""
    d = obs_dir()
    key = (os.getpid(), d)
    if _DEFAULT["key"] == key:
        return _DEFAULT["run"]
    with _DEFAULT_LOCK:
        if _DEFAULT["key"] == key:
            return _DEFAULT["run"]
        old = _DEFAULT["run"]
        run = None
        if d is not None:
            try:
                run = ObsRun(dir=d)
            except OSError:
                run = None
        _DEFAULT.update(run=run, key=key)
    if old is not None:
        try:
            old.close()
        except OSError:
            pass
    return _DEFAULT["run"]


def set_default_run(run: Optional[ObsRun]) -> None:
    """Install an explicit run as the process default (tests, tools
    that own their run). Pass None to clear."""
    with _DEFAULT_LOCK:
        _DEFAULT.update(run=run,
                        key=(os.getpid(), obs_dir()) if run else None)


def emit(kind: str, name: str, **fields) -> None:
    """Fire-and-forget emission through the default run; a no-op when
    the spine is off, and I/O errors are swallowed: instrumentation
    never costs the instrumented path its result."""
    run = default_run()
    if run is None:
        return
    try:
        run.emit(kind, name, **fields)
    except (OSError, TypeError, ValueError):
        pass


def read_events(path: str, *, kinds: Optional[tuple] = None) -> list[dict]:
    """One run file back as a list of dicts (the header included).
    Unparseable lines (the torn tail a crash can leave) are skipped:
    the durability contract is per line."""
    out = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue
            if not isinstance(rec, dict):
                continue
            if kinds is not None and rec.get("kind") not in kinds:
                continue
            out.append(rec)
    return out
