"""Per-checkpoint integrity manifest (the port of
``apex1_tpu/resilience/manifest.py``): the evidence that a checkpoint
is the one that was written.

Two layers of evidence in one ``manifest.json`` beside the payload:

- file digests: relative path, byte size and sha256 of every payload
  file. Re-checked without restoring (a directory walk), which is what
  lets `find_restorable` scan backward past truncated or bit-flipped
  checkpoints;
- leaf digests: key path (`core.pytree.keystr`), shape, dtype name and
  sha256 of each leaf's C-contiguous little-endian bytes at save time,
  re-checked after a restore, so a wrong but readable restore is a
  typed error.

The manifest also carries ``step``, the program ``fingerprint``
(`utils.debug.program_fingerprint`) and a free-form JSON ``meta``
dict. It is written temp file + ``os.replace`` and is the commit
marker: no manifest, no committed checkpoint.

The JSON is the JAX package's, format tag and all, and the digests
depend only on the bytes, so each package's `read_manifest`,
`verify_files` and `verify_tree` read the other's step directories.
dtype names are numpy's (``bfloat16``, ``float32``, ``bool``); a
bfloat16 tensor is digested through its 2-byte view, a threefry key
(`core.random`'s tuple) as its uint32 key data, as the JAX package
digests ``jax.random.key_data``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import json
import os
import threading
from typing import Any, Optional

import numpy as np
import torch

from apex1_tpu_torch.core.pytree import (is_key_data, keystr,
                                         tree_flatten_with_path)

MANIFEST_NAME = "manifest.json"
_FORMAT = "apex1-resilient-ckpt-v1"


def atomic_write_text(path: str | os.PathLike, text: str) -> None:
    """Temp file + flush + fsync + ``os.replace``: the one torn-write-
    proof file commit of the resilience layer (manifests, the ``latest``
    pointer, diagnostic records)."""
    path = os.fspath(path)
    tmp = os.path.join(os.path.dirname(path),
                       f".{os.path.basename(path)}.tmp.{os.getpid()}")
    with open(tmp, "w") as f:
        f.write(text)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def atomic_write_json(path: str | os.PathLike, doc: Any) -> None:
    atomic_write_text(path, json.dumps(doc, indent=1, sort_keys=True))


class IntegrityError(RuntimeError):
    """Manifest mismatch: the checkpoint's content does not match what
    was recorded at save time (corruption, truncation, wrong restore)."""

    def __init__(self, path: str | os.PathLike, reason: str):
        self.path = os.fspath(path)
        self.reason = reason
        super().__init__(f"integrity check failed at {self.path}: {reason}")


_pool = threading.local()


@contextlib.contextmanager
def parallel_cap(workers: Optional[int]):
    """The `parallel_map` calls this thread makes inside the block run on
    at most ``workers`` threads (None: the host's pool). A save in
    flight beside a training step leaves the step's host thread its core
    and the interpreter lock."""
    prev = getattr(_pool, "cap", None)
    _pool.cap = workers
    try:
        yield
    finally:
        _pool.cap = prev


def parallel_map(fn, items) -> list:
    """``[fn(x) for x in items]`` on a pool of threads (as many as the
    host's cores, at most 8, or `parallel_cap`'s): hashing, file reads
    and writes release the interpreter lock, so a multi-GB checkpoint's
    leaves go through the host's cores side by side. Results in
    ``items``' order; the first exception raises."""
    items = list(items)
    workers = min(getattr(_pool, "cap", None) or 8, os.cpu_count() or 1,
                  len(items))
    if workers <= 1:
        return [fn(x) for x in items]
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(workers) as ex:
        return list(ex.map(fn, items))


def _sha256_file(path: str, chunk: int = 1 << 24) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            b = f.read(chunk)
            if not b:
                break
            h.update(b)
    return h.hexdigest()


#: the numpy (ml_dtypes) name of each torch dtype a leaf may hold
TORCH_DTYPES = {"bool": torch.bool, "uint8": torch.uint8,
                "int8": torch.int8, "int16": torch.int16,
                "int32": torch.int32, "int64": torch.int64,
                "float16": torch.float16, "float32": torch.float32,
                "float64": torch.float64, "bfloat16": torch.bfloat16,
                "complex64": torch.complex64}
#: the names numpy has no type for, and the same-width integer view
#: (torch's, numpy's) their bytes cross the host as
_VIEWS = {"bfloat16": (torch.int16, np.int16)}
for _name in ("float8_e4m3fn", "float8_e5m2"):
    if hasattr(torch, _name):
        TORCH_DTYPES[_name] = getattr(torch, _name)
        _VIEWS[_name] = (torch.uint8, np.uint8)


def dtype_name(dtype: torch.dtype) -> str:
    """A torch dtype's numpy name (``bfloat16``, not
    ``torch.bfloat16``)."""
    for name, dt in TORCH_DTYPES.items():
        if dt == dtype:
            return name
    raise TypeError(f"no numpy name for {dtype}")


def host_dtype(name: str) -> np.dtype:
    """The numpy dtype a leaf of dtype ``name`` is held in on the host
    (its integer view where numpy has no such type), little-endian."""
    return np.dtype(_VIEWS[name][1] if name in _VIEWS else name
                    ).newbyteorder("<")


def to_tensor(a: np.ndarray, name: str) -> torch.Tensor:
    """`host_array`'s inverse for a tensor: the host bytes ``a`` as a CPU
    tensor of dtype ``name`` (sharing ``a``'s memory)."""
    t = torch.from_numpy(a)
    return t.view(TORCH_DTYPES[name]) if name in _VIEWS else t


def host_array(x) -> tuple:
    """``(array, dtype name)``: a leaf's host bytes as a numpy array
    (C-contiguous, little-endian; a bfloat16 tensor as its int16 view,
    named ``bfloat16``), and its numpy dtype name. A DTensor contributes
    its full tensor (a collective call), a CUDA tensor a host copy."""
    if isinstance(x, torch.Tensor):
        if hasattr(x, "full_tensor"):
            x = x.full_tensor()
        t = x.detach().contiguous().cpu()
        name = dtype_name(t.dtype)
        return (t.view(_VIEWS[name][0]) if name in _VIEWS else t
                ).numpy(), name
    if is_key_data(x):
        a = np.asarray(x, np.uint32)
    else:
        a = np.asarray(x)
    if not a.flags.c_contiguous:
        a = np.ascontiguousarray(a)     # (which makes a 0-d array 1-d)
    if a.dtype.byteorder == ">":
        a = a.astype(a.dtype.newbyteorder("<"))
    return a, a.dtype.name


def _digest(a: np.ndarray) -> str:
    """sha256 over the array's bytes (layout-independent: a restore onto
    another placement still matches)."""
    return hashlib.sha256(
        np.ascontiguousarray(a).reshape(-1).view(np.uint8)).hexdigest()


def host_leaves(tree: Any) -> list:
    """``[(key path string, array, dtype name)]`` for every leaf
    (`host_array`), in the JAX package's leaf order."""
    out = []
    for path, leaf in tree_flatten_with_path(tree):
        a, name = host_array(leaf)
        out.append((keystr(path), a, name))
    return out


@dataclasses.dataclass
class Manifest:
    """Parsed manifest — `write_manifest`/`read_manifest` round-trip."""

    step: int
    fingerprint: Optional[str]          # hex string or None
    meta: dict                          # resume extras (JSON-safe)
    tree: list                          # [{path, shape, dtype, sha256}]
    files: list                         # [{path, bytes, sha256}]

    def to_json(self) -> dict:
        return {"format": _FORMAT, "step": self.step,
                "fingerprint": self.fingerprint, "meta": self.meta,
                "tree": self.tree, "files": self.files}


def tree_entries(state: Any) -> list:
    """Per-leaf manifest entries of a (host or device) tree: the JAX
    package's ``tree_entries`` of the same arrays, entry for entry."""
    leaves = host_leaves(state)
    digests = parallel_map(lambda e: _digest(e[1]), leaves)
    return [{"path": p, "shape": list(a.shape), "dtype": name,
             "sha256": d} for (p, a, name), d in zip(leaves, digests)]


def _walk_files(ckpt_dir: str) -> list:
    out = []
    for root, _dirs, files in os.walk(ckpt_dir):
        for name in sorted(files):
            if name == MANIFEST_NAME:
                continue
            full = os.path.join(root, name)
            out.append(os.path.relpath(full, ckpt_dir))
    return sorted(out)


def write_manifest(ckpt_dir: str | os.PathLike, *, step: int,
                   state: Any = None, tree: Optional[list] = None,
                   fingerprint: Optional[int] = None,
                   meta: Optional[dict] = None,
                   file_digests: Optional[dict] = None) -> Manifest:
    """Digest every payload file under ``ckpt_dir`` (and the leaf digests
    of ``state``, or precomputed ``tree`` entries) and atomically write
    ``manifest.json``. Call after the payload is written.
    ``file_digests`` (``{relative path: sha256}``) names files whose
    digest is known already (a raw leaf file's is its leaf digest):
    those are not read again."""
    ckpt_dir = os.fspath(ckpt_dir)
    if tree is None:
        tree = tree_entries(state) if state is not None else []
    known = file_digests or {}

    def entry(rel):
        full = os.path.join(ckpt_dir, rel)
        return {"path": rel, "bytes": os.path.getsize(full),
                "sha256": known.get(rel) or _sha256_file(full)}

    files = parallel_map(entry, _walk_files(ckpt_dir))
    m = Manifest(step=int(step),
                 fingerprint=(None if fingerprint is None
                              else f"{int(fingerprint):#x}"),
                 meta=dict(meta or {}), tree=tree, files=files)
    atomic_write_json(os.path.join(ckpt_dir, MANIFEST_NAME), m.to_json())
    return m


def read_manifest(ckpt_dir: str | os.PathLike) -> Manifest:
    """Parse ``manifest.json``; raises `IntegrityError` when missing or
    unparseable (no manifest: the save never committed)."""
    ckpt_dir = os.fspath(ckpt_dir)
    path = os.path.join(ckpt_dir, MANIFEST_NAME)
    try:
        with open(path) as f:
            doc = json.load(f)
    except OSError as e:
        raise IntegrityError(ckpt_dir, f"manifest missing ({e})") from e
    except json.JSONDecodeError as e:
        raise IntegrityError(ckpt_dir, f"manifest unparseable ({e})") from e
    if doc.get("format") != _FORMAT:
        raise IntegrityError(
            ckpt_dir, f"unknown manifest format {doc.get('format')!r}")
    try:
        return Manifest(step=int(doc["step"]),
                        fingerprint=doc.get("fingerprint"),
                        meta=doc.get("meta", {}), tree=doc["tree"],
                        files=doc["files"])
    except (KeyError, TypeError, ValueError) as e:
        raise IntegrityError(ckpt_dir, f"manifest malformed ({e})") from e


def verify_files(ckpt_dir: str | os.PathLike,
                 manifest: Optional[Manifest] = None) -> Manifest:
    """Re-digest the payload files against the manifest: truncation
    (size mismatch, missing file) and bit flips (sha256), without
    restoring. Returns the manifest."""
    ckpt_dir = os.fspath(ckpt_dir)
    m = manifest if manifest is not None else read_manifest(ckpt_dir)
    recorded = {e["path"]: e for e in m.files}
    on_disk = set(_walk_files(ckpt_dir))
    missing = set(recorded) - on_disk
    if missing:
        raise IntegrityError(ckpt_dir,
                             f"missing files: {sorted(missing)[:4]}")
    extra = on_disk - set(recorded)
    if extra:
        raise IntegrityError(ckpt_dir,
                             f"unrecorded files: {sorted(extra)[:4]}")
    for rel, e in recorded.items():
        size = os.path.getsize(os.path.join(ckpt_dir, rel))
        if size != e["bytes"]:
            raise IntegrityError(
                ckpt_dir, f"{rel}: {size} bytes, manifest says "
                f"{e['bytes']} (truncated?)")
    got = parallel_map(lambda rel: _sha256_file(os.path.join(ckpt_dir, rel)),
                       recorded)
    for (rel, e), g in zip(recorded.items(), got):
        if g != e["sha256"]:
            raise IntegrityError(
                ckpt_dir, f"{rel}: content digest mismatch (bit flip?)")
    return m


def verify_tree(ckpt_dir: str | os.PathLike, state: Any,
                manifest: Optional[Manifest] = None) -> None:
    """Verify a restored tree against the manifest's leaf digests:
    structure, shapes, dtypes and content, each mismatch a typed
    error."""
    ckpt_dir = os.fspath(ckpt_dir)
    m = manifest if manifest is not None else read_manifest(ckpt_dir)
    got = {e["path"]: e for e in tree_entries(state)}
    want = {e["path"]: e for e in m.tree}
    if set(got) != set(want):
        raise IntegrityError(
            ckpt_dir, "tree structure mismatch: "
            f"missing {sorted(set(want) - set(got))[:4]}, "
            f"unexpected {sorted(set(got) - set(want))[:4]}")
    for p, w in want.items():
        g = got[p]
        for field in ("shape", "dtype", "sha256"):
            if g[field] != w[field]:
                raise IntegrityError(
                    ckpt_dir, f"leaf {p}: {field} mismatch "
                    f"({g[field]!r} != recorded {w[field]!r})")
