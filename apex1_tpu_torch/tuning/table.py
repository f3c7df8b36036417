"""Shape-keyed tables of measured launch parameters (the port of
``apex1_tpu/tuning/table.py``).

``python -m apex1_tpu_torch.tuning.sweep`` times the candidates of a
kernel's launch parameters on the card in one process, writes the winner
here, and every tunable launcher consults the table before its
heuristic: an explicit parameter (what the sweep passes) > the table >
today's heuristic. Entries are keyed on

    kernel x GPU generation (``core.capability``) x operand dtype
    x the kernel's padded dims (``registry.KernelSpec.dims``)

as ``<generation>|<dtype>|<k=v,...>``, the JAX package's grammar, so a
winner swept for a bf16 GLU at hidden 4096 on an H100 never leaks to
fp32, to another hidden size or to another card. On disk each kernel
owns one JSON file under ``perf_results_torch/tuning/`` (override with
``APEX1_TUNING_DIR``), in the JAX package's format:

    {"schema": 1, "kernel": "fused_swiglu",
     "entries": {"h100|bfloat16|Hp=4096,Tb=8192":
                 {"blocks": {"tile_n": 128}, "time_ms": 4.27,
                  "backend": "cuda", "timing": "measured",
                  "device": "NVIDIA H100 80GB HBM3, 700.00 W"}}}

Lookup never fails loudly: a missing directory, a corrupt file, an
unknown generation (a TPU table's ``v5e``/``v5p`` among them), a
misaligned entry, an entry over the recorded row's budget under the
`vmem_model` check, and on the card an entry whose ``timing`` is not
``"measured"`` are all misses, and the launcher's heuristic takes over.
``validate_tables`` re-checks every file strictly and names a table of
another accelerator foreign, not corrupt.
"""

from __future__ import annotations

import json
import os
from typing import Any, Mapping

from apex1_tpu_torch.core.capability import (detect_generation,
                                             known_generation, smem_budget)
from apex1_tpu_torch.tuning.registry import SPECS

_SCHEMA = 1

#: dtype names a table key may carry, with their element sizes
_ITEMSIZE = {"float64": 8, "float32": 4, "bfloat16": 2, "float16": 2,
             "int32": 4, "int8": 1, "uint8": 1}

# process-wide cache: {"dir": str|None, "tables": {kernel: {key: entry}},
# "problems": [str]}, loaded on the first lookup and dropped by
# clear_cache() (tests, a changed APEX1_TUNING_DIR, after a sweep)
_STATE: dict[str, Any] = {"dir": None, "tables": None, "problems": None}


def _on_card() -> bool:
    """True with a card the capability table knows attached: there only
    ``"measured"`` entries are served."""
    try:
        return detect_generation() is not None
    except ValueError:
        return True


#: ``<repo>/perf_results_torch/tuning`` (the package's parent directory
#: is the repo root): the port's own, never the JAX package's
#: ``perf_results/tuning``
_DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "perf_results_torch", "tuning")


def default_tuning_dir() -> str:
    """``APEX1_TUNING_DIR`` if set, else the repo's
    ``perf_results_torch/tuning``."""
    return os.environ.get("APEX1_TUNING_DIR", "").strip() or _DEFAULT_DIR


def clear_cache() -> None:
    """Drop the in-memory tables (the next lookup reloads from disk)."""
    _STATE.update(dir=None, tables=None, problems=None)


def canonical_dtype(dtype) -> str:
    """Canonical dtype name for table keys ('bfloat16', 'float32',
    'int8', ...), the JAX package's names: accepts strings, torch dtypes
    and numpy dtypes or scalar types."""
    if isinstance(dtype, str):
        name = dtype
    elif hasattr(dtype, "is_floating_point") and str(dtype).startswith(
            "torch."):
        name = str(dtype)[len("torch."):]
    else:
        import numpy as np
        name = np.dtype(dtype).name
    if name not in _ITEMSIZE:
        raise ValueError(f"no table dtype for {dtype!r}")
    return name


def itemsize(dtype) -> int:
    """Element bytes of a table dtype."""
    return _ITEMSIZE[canonical_dtype(dtype)]


def canonical_generation(generation: str | None = None) -> str:
    """Table-key generation: explicit > the attached card's row > 'h100'
    (the row the port plans for with no card, as
    `core.capability.get_capability` does)."""
    return generation or detect_generation() or "h100"


def make_key(dims: Mapping[str, int], dtype,
             generation: str | None = None) -> str:
    """Canonical entry key: ``<gen>|<dtype>|<k=v,...>`` with dims sorted
    by name. ``dims`` are the kernel's PADDED dims, per
    ``registry.KernelSpec.dims``."""
    gen = canonical_generation(generation)
    dt = canonical_dtype(dtype)
    body = ",".join(k + "=" + str(int(v)) for k, v in sorted(dims.items()))
    return gen + "|" + dt + "|" + body


def parse_key(key: str) -> tuple[str, str, dict[str, int]]:
    """Inverse of :func:`make_key`; raises ValueError on malformed keys."""
    parts = key.split("|")
    if len(parts) != 3:
        raise ValueError(f"malformed tuning key {key!r}")
    gen, dt, body = parts
    dims: dict[str, int] = {}
    for item in body.split(","):
        name, _, val = item.partition("=")
        if not name or not val:
            raise ValueError(f"malformed dims in tuning key {key!r}")
        dims[name] = int(val)
    return gen, dt, dims


def _load_file(path: str, kernel: str) -> dict[str, dict]:
    with open(path) as f:
        doc = json.load(f)
    if not isinstance(doc, dict):
        raise ValueError("a table is a JSON object")
    if doc.get("schema") != _SCHEMA:
        raise ValueError(f"unsupported schema {doc.get('schema')!r}")
    if doc.get("kernel") != kernel:
        raise ValueError(f"kernel field {doc.get('kernel')!r} != filename")
    entries = doc.get("entries")
    if not isinstance(entries, dict):
        raise ValueError("entries must be an object")
    return entries


def _tables() -> dict[str, dict[str, dict]]:
    """Every ``<kernel>.json`` in the tuning dir, loaded once. Unreadable
    files become recorded problems (`load_problems`), never exceptions:
    a corrupt table must not take down a training run."""
    d = default_tuning_dir()
    if _STATE["tables"] is not None and _STATE["dir"] == d:
        return _STATE["tables"]
    tables: dict[str, dict[str, dict]] = {}
    problems: list[str] = []
    if os.path.isdir(d):
        for name in sorted(os.listdir(d)):
            if not name.endswith(".json"):
                continue
            kernel = name[:-5]
            path = os.path.join(d, name)
            try:
                tables[kernel] = _load_file(path, kernel)
            except (OSError, ValueError) as e:  # a miss, not a crash
                problems.append(f"{path}: {type(e).__name__}: {e}")
    _STATE.update(dir=d, tables=tables, problems=problems)
    return tables


def has_table(kernel: str) -> bool:
    """True when ``kernel`` has entries in the tuning directory."""
    return bool(_tables().get(kernel))


def load_problems() -> list[str]:
    """Parse problems the lazy loader swallowed (for diagnostics)."""
    _tables()
    return list(_STATE["problems"])


def _entry_blocks(kernel: str, entry: Mapping, dims: Mapping[str, int],
                  dtype_name: str, generation: str, *,
                  serving: bool = True) -> dict[str, int] | None:
    """Validated parameters of one entry, or None where it is unusable:
    a fixed-tile kernel, wrong or missing params, misaligned values, an
    unknown generation, or a frame over the recorded row's budget.
    ``serving`` also refuses, on the card, an entry not timed there
    (lookup); ``validate_tables`` checks the structure only."""
    spec = SPECS.get(kernel)
    if spec is None or spec.fixed or not known_generation(generation):
        return None
    blocks = entry.get("blocks") if isinstance(entry, Mapping) else None
    if not isinstance(blocks, Mapping):
        return None
    out: dict[str, int] = {}
    for p in spec.params:
        v = blocks.get(p)
        if not isinstance(v, int) or isinstance(v, bool) or v <= 0 \
                or v % spec.align:
            return None
        out[p] = v
    try:
        ok, _est = spec.check(out, dims, _ITEMSIZE[dtype_name],
                              smem_budget(generation))
    except (KeyError, ValueError):
        return None
    if not ok:
        return None
    # a CPU-timed entry orders nothing on the card: served only off it
    if serving and entry.get("timing") != "measured" and _on_card():
        return None
    return out


def lookup(kernel: str, dims: Mapping[str, int], dtype,
           generation: str | None = None) -> dict[str, int] | None:
    """Validated parameters for (kernel, generation, dtype, padded dims),
    or None on a miss: the caller then takes its heuristic. Cheap where
    the kernel has no table (the launchers call it on every launch)."""
    table = _tables().get(kernel)
    if not table:
        return None
    try:
        gen = canonical_generation(generation)
        key = make_key(dims, dtype, gen)
    except ValueError:
        return None
    entry = table.get(key)
    if entry is None:
        return None
    return _entry_blocks(kernel, entry, dims, canonical_dtype(dtype), gen)


def record(kernel: str, dims: Mapping[str, int], dtype,
           blocks: Mapping[str, int], *, time_ms: float | None = None,
           generation: str | None = None,
           extra: Mapping[str, Any] | None = None) -> tuple[str, dict]:
    """Install a winner in the in-memory table (seen by the next
    ``lookup`` at once); ``save`` persists it. The entry says where it
    was timed: ``"measured"`` on the card, ``"cpu"`` off it."""
    spec = SPECS.get(kernel)
    if spec is None:
        raise ValueError(f"unknown tunable kernel {kernel!r}; "
                         f"known: {sorted(SPECS)}")
    if spec.fixed:
        raise ValueError(f"{kernel}: the CUDA kernel's tiles are fixed; "
                         f"it takes no table entry")
    missing = [p for p in spec.params if p not in blocks]
    if missing:
        raise ValueError(f"{kernel} entry missing params {missing}")
    key = make_key(dims, dtype, generation)
    card = _on_card()
    entry: dict[str, Any] = {
        "blocks": {p: int(blocks[p]) for p in spec.params},
        "time_ms": None if time_ms is None else round(float(time_ms), 4),
        "backend": "cuda" if card else "cpu",
        "timing": "measured" if card else "cpu",
    }
    if extra:
        entry.update(extra)
    _tables().setdefault(kernel, {})[key] = entry
    return key, entry


def save(kernel: str, dir: str | None = None) -> str:
    """Write ``kernel``'s table to ``<dir>/<kernel>.json``, merged over
    the entries already on disk that this process never loaded (two
    sweeps of other shapes compose). Returns the path."""
    d = dir or default_tuning_dir()
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, kernel + ".json")
    entries: dict[str, dict] = {}
    if os.path.exists(path):
        try:
            entries = _load_file(path, kernel)
        except (OSError, ValueError):
            entries = {}  # an unreadable file: the fresh write repairs it
    entries.update(_tables().get(kernel, {}))
    doc = {"schema": _SCHEMA, "kernel": kernel,
           "entries": {k: entries[k] for k in sorted(entries)}}
    tmp = path + f".{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
        f.write("\n")
    os.replace(tmp, path)
    return path


def validate_tables(dir: str | None = None) -> list[str]:
    """Strict validation of every ``*.json`` table in ``dir``: the file
    parses, schema and kernel fields match, every key parses, names a
    generation this port has a row for (another accelerator's table is
    reported foreign) and carries the spec's dims, and every entry's
    params pass the spec's alignment and budget check for its recorded
    row. Returns the problems (empty = clean)."""
    d = dir or default_tuning_dir()
    problems: list[str] = []
    if not os.path.isdir(d):
        return problems  # no tables yet is a valid state
    for name in sorted(os.listdir(d)):
        if not name.endswith(".json"):
            continue
        path = os.path.join(d, name)
        kernel = name[:-5]
        if kernel not in SPECS:
            problems.append(f"{path}: not a known tunable kernel "
                            f"(known: {sorted(SPECS)})")
            continue
        try:
            entries = _load_file(path, kernel)
        except (OSError, ValueError) as e:
            problems.append(f"{path}: corrupt: {type(e).__name__}: {e}")
            continue
        for key, entry in entries.items():
            try:
                gen, dt, dims = parse_key(key)
            except ValueError as e:
                problems.append(f"{path}: corrupt: {e}")
                continue
            if not known_generation(gen):
                problems.append(
                    f"{path}: {key}: foreign generation {gen!r} (another "
                    f"accelerator's table; this port has rows for h100 "
                    f"only): never served")
                continue
            if SPECS[kernel].fixed:
                problems.append(f"{path}: {key}: {kernel}'s CUDA tiles "
                                f"are fixed; it takes no table entry")
                continue
            missing = [k for k in SPECS[kernel].dims if k not in dims]
            if missing:
                problems.append(f"{path}: {key}: missing dims {missing}")
                continue
            if dt not in _ITEMSIZE or _entry_blocks(
                    kernel, entry, dims, dt, gen, serving=False) is None:
                problems.append(
                    f"{path}: {key}: entry invalid (params "
                    f"{entry.get('blocks')!r} misaligned, or over the "
                    f"{gen} row's shared-memory or register budget)")
    return problems
