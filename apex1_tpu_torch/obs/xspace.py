"""Per-op attribution of the port's profiler traces (the port of
``apex1_tpu/obs/xspace.py``).

The JAX package reads the ``*.xplane.pb`` protobufs ``jax.profiler``
writes; the port reads the Chrome-trace JSON ``torch.profiler`` exports
(``utils.observability.trace`` writes ``trace_<pid>_<n>.json``), plain
or gzipped. The module keeps its counterpart's name, public names and
report schema, so a report from either package reads the same.

Attribution model:

- **device rows** — with a card, the per-op events are the CUDA
  stream's ``cat: "kernel"`` events (and the copies and fills,
  ``gpu_memcpy``/``gpu_memset``, which ``torch.profiler``'s own device
  totals count too); ``plane_class`` is ``"device"``. With no card the
  host's ATen ops (``cat: "cpu_op"``) stand in, outermost ops of each
  thread only (a nested op is inside its parent's time), labelled
  ``"host-proxy"``: op *shares* are meaningful there, absolute times are
  host wall-clock.
- **buckets** — each op lands in exactly one of ``collective`` (NCCL
  kernels and gloo or c10d collectives: the JAX package's ICI bucket),
  ``kernel`` (the port's own ``csrc/`` kernels, matched by the names of
  the ``__global__`` functions the library's sources define: the
  counterpart of the JAX package's ``pallas`` bucket) or ``library``
  (ATen's, cuBLAS's and cuDNN's kernels and everything else: the
  counterpart of ``xla``). Name-based, best-effort: `bucket_of`.

Every malformed input (truncated JSON, a bad gzip, an empty directory,
a trace with no op events) raises the typed `TraceError`, never a
traceback from the middle of the reader and never an empty report.
"""

from __future__ import annotations

import glob
import gzip
import json
import os
import re
import zlib
from pathlib import Path
from typing import Optional

REPORT_SCHEMA = "apex1-trace-report-v1"
REPORT_NAME = "trace_report.json"

BUCKETS = ("kernel", "collective", "library")

#: the device event categories that hold the card's time
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")

_COLLECTIVE_RE = re.compile(r"(nccl|gloo|c10d::|record_param_comms)",
                            re.I)
_IDENT_RE = re.compile(r"[A-Za-z_]\w*")
_GLOBAL_RE = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)"
                        r"\s*)?(\w+)\s*\(", re.S)

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_KERNELS: dict = {}


class TraceError(RuntimeError):
    """Typed failure for unreadable, corrupt or empty traces: callers get
    ``.path`` and ``.reason``."""

    def __init__(self, path, reason: str):
        self.path = os.fspath(path)
        self.reason = reason
        super().__init__(f"unreadable trace at {self.path}: {reason}")


def kernel_names() -> frozenset:
    """The names of the ``__global__`` functions in the port's
    ``csrc/`` sources: the `kernel` bucket (read once)."""
    if "names" not in _KERNELS:
        names = set()
        for p in sorted(_CSRC.glob("*.cu*")):
            names.update(_GLOBAL_RE.findall(p.read_text()))
        _KERNELS["names"] = frozenset(names)
    return _KERNELS["names"]


def parse_trace(path) -> list:
    """The ``traceEvents`` of one Chrome trace (``.gz`` transparently).
    Raises `TraceError` on any unreadable or corrupt input."""
    path = os.fspath(path)
    try:
        with open(path, "rb") as f:
            data = f.read()
        if path.endswith(".gz"):
            data = gzip.decompress(data)
        doc = json.loads(data.decode("utf-8"))
    # zlib.error: a valid gzip header over a corrupt deflate body
    except (OSError, EOFError, zlib.error, UnicodeDecodeError) as e:
        raise TraceError(path, f"cannot read: {e}") from e
    except json.JSONDecodeError as e:
        raise TraceError(path, f"corrupt JSON: {e}") from e
    events = doc.get("traceEvents") if isinstance(doc, dict) else doc
    if not isinstance(events, list):
        raise TraceError(path, "no traceEvents list (a foreign file)")
    return [e for e in events if isinstance(e, dict)]


def find_trace_files(trace_dir) -> list:
    """Every Chrome trace under ``trace_dir``: ``*.json`` and
    ``*.json.gz``, the report itself excepted."""
    trace_dir = os.fspath(trace_dir)
    out = []
    for pat in ("*.json", "*.json.gz"):
        out += glob.glob(os.path.join(trace_dir, "**", pat), recursive=True)
    return sorted(p for p in out if os.path.basename(p) != REPORT_NAME)


def bucket_of(op_name: str) -> str:
    """``collective`` | ``kernel`` | ``library`` for one op name:
    collectives first (an NCCL kernel is communication time whatever
    launched it), then the port's own kernels, then everything else."""
    if _COLLECTIVE_RE.search(op_name):
        return "collective"
    if kernel_names().intersection(_IDENT_RE.findall(op_name)):
        return "kernel"
    return "library"


def _outermost(ops: list) -> list:
    """The host ops no other op of the same thread encloses."""
    out = []
    by_tid: dict = {}
    for e in ops:
        by_tid.setdefault((e.get("pid"), e.get("tid")), []).append(e)
    for evs in by_tid.values():
        evs.sort(key=lambda e: (float(e["ts"]), -float(e.get("dur", 0))))
        end = float("-inf")
        for e in evs:
            ts, dur = float(e["ts"]), float(e.get("dur", 0))
            if ts >= end:
                out.append(e)
                end = ts + dur
    return out


def op_totals(events: list) -> tuple:
    """Aggregate per-op ``{name: [total_us, count]}``. Returns
    ``(totals, plane_class)``: ``"device"`` from the card's events, else
    ``"host-proxy"`` from the outermost host ops, else ``"none"``."""
    timed = [e for e in events if e.get("ph") == "X" and "dur" in e
             and "ts" in e and isinstance(e.get("name"), str)]
    device = [e for e in timed if e.get("cat") in DEVICE_CATS]
    if device:
        rows, plane = device, "device"
    else:
        rows, plane = _outermost(
            [e for e in timed if e.get("cat") == "cpu_op"]), "host-proxy"
    totals: dict = {}
    for e in rows:
        a = totals.setdefault(e["name"], [0.0, 0])
        a[0] += float(e["dur"])
        a[1] += 1
    return totals, (plane if totals else "none")


def build_report(trace_dir, *, steps: Optional[int] = None,
                 top: int = 200) -> dict:
    """Per-op time breakdown of the traces in one directory.

    Raises `TraceError` when the directory holds no trace, a trace does
    not parse, or no op event is found (an empty report would read as
    "nothing ran" when the truth is "nothing was attributable")."""
    trace_dir = os.fspath(trace_dir)
    paths = find_trace_files(trace_dir)
    if not paths:
        raise TraceError(trace_dir, "no *.json or *.json.gz trace under dir")
    events = []
    for p in paths:
        events += parse_trace(p)
    totals, plane_class = op_totals(events)
    if not totals:
        cats = sorted({str(e.get("cat")) for e in events})
        raise TraceError(trace_dir, f"no op events in {len(events)} trace "
                         f"events; categories seen: {cats[:12]}")
    total_us = sum(us for us, _n in totals.values())
    buckets = {b: 0.0 for b in BUCKETS}
    ops = []
    for name, (us, n) in sorted(totals.items(), key=lambda kv: -kv[1][0]):
        b = bucket_of(name)
        buckets[b] += us
        ops.append({"name": name, "bucket": b, "ms": round(us / 1e3, 6),
                    "count": int(n),
                    "share": round(us / total_us, 4) if total_us else 0.0})
    report = {
        "schema": REPORT_SCHEMA,
        "trace_dir": trace_dir,
        "plane_class": plane_class,
        "total_op_ms": round(total_us / 1e3, 6),
        "buckets": {b: {"ms": round(buckets[b] / 1e3, 6),
                        "share": (round(buckets[b] / total_us, 4)
                                  if total_us else 0.0)}
                    for b in BUCKETS},
        "n_ops": len(ops),
        "ops": ops[:top],
    }
    if steps:
        report["steps"] = int(steps)
        report["per_step_ms"] = round(total_us / 1e3 / steps, 6)
    return report


def write_report(trace_dir, *, report: Optional[dict] = None,
                 steps: Optional[int] = None,
                 path: Optional[str] = None) -> str:
    """Build (unless given) and atomically persist the report next to
    the trace it describes (``<trace_dir>/trace_report.json``)."""
    from apex1_tpu_torch.resilience.manifest import atomic_write_json

    if report is None:
        report = build_report(trace_dir, steps=steps)
    if path is None:
        path = os.path.join(os.fspath(trace_dir), REPORT_NAME)
    atomic_write_json(path, report)
    return path


def format_report(report: dict, top: int = 25) -> str:
    """Human-readable rendering."""
    lines = [f"plane class: {report['plane_class']}   "
             f"total op time: {report['total_op_ms']:.3f} ms"
             + (f"   ({report['per_step_ms']:.3f} ms/step x "
                f"{report['steps']})" if report.get("steps") else "")]
    bk = report["buckets"]
    lines.append("buckets: " + "  ".join(
        f"{b}={bk[b]['ms']:.3f}ms ({bk[b]['share'] * 100:.1f}%)"
        for b in BUCKETS))
    for op in report["ops"][:top]:
        lines.append(f"{op['ms']:10.3f} ms {op['count']:6d}x "
                     f"{op['share'] * 100:5.1f}%  [{op['bucket']:10s}] "
                     f"{op['name'][:100]}")
    return "\n".join(lines)
