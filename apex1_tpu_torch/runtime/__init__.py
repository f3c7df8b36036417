"""Host-side data plumbing (the port of ``apex1_tpu/runtime``): ctypes
bindings over ``_runtime.cpp`` (the JAX package's, copied), the data
loaders, the prefetcher and the serving engine's request feeder.

Reference: ``csrc/flatten_unflatten.cpp :: flatten/unflatten`` (the
``apex_C`` extension) and ``examples/imagenet/main_amp.py ::
data_prefetcher`` (a side-stream copy of the next batch).

- `flatten` / `unflatten`, `normalize_images`, `f32_to_bf16_bits` /
  `bf16_bits_to_f32`: numpy in, numpy out, on native host threads.
- `TokenDataset` / `ShardedTokenDataset`: ``batch_at(step)`` is a pure
  function of (file, seed, step) over memory-mapped token files;
  `write_token_file` writes one.
- `pack_documents`: first-fit packing of documents into rows.
- `PrefetchLoader`: a worker thread runs the source and its transform,
  stages each batch in pinned host memory and copies it to the card on
  a CUDA side stream; the consumer's stream waits on the copy's event
  (Apex's ``data_prefetcher``).
- `RequestFeeder`: the serving engine's background ingest thread
  (tokenize off the engine's critical path, submit under bounded
  backoff), on `resilience.retry.backoff_delays` (re-exported here).

The native library is built with ``g++ -O3 -march=native`` at FIRST USE
(never at import) under ``apex1_tpu_torch/build/``, named by a hash of
the source, the flags and the host's native target, through a
per-process temporary file and an atomic rename (several processes may
import and build at once). Where ``g++`` fails, every function takes
its NumPy fallback, which gives the same arrays (`normalize_images`
within float rounding, 1e-6), and `native_available` says so;
`build_log` holds the compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import queue
import subprocess
import threading
import time as _time
from pathlib import Path
from typing import Callable, Iterable, Iterator, Optional, Sequence

import numpy as np
import torch

from apex1_tpu_torch.resilience.retry import backoff_delays

_SRC = Path(__file__).resolve().parent / "_runtime.cpp"
_BUILD = Path(__file__).resolve().parent.parent / "build"
#: the JAX package's flags (`apex1_tpu/runtime/__init__.py`)
GXX_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
             "-pthread"]
#: the C side's version; a library that reports another is not used
ABI_VERSION = 4
_N_THREADS = max(1, (os.cpu_count() or 4) // 2)
#: below this many output bytes a native call runs on the calling thread:
#: the C side starts its threads on every call, which costs more than
#: the copy (a 16 x 1025 token batch, 66 KB)
_SERIAL_BYTES = 4 << 20
_UNSET = object()
_LOCK = threading.Lock()
_STATE: dict = {"lib": _UNSET, "log": ""}


def _threads(nbytes: int) -> int:
    """Host threads for a native call writing ``nbytes``."""
    return 1 if nbytes < _SERIAL_BYTES else _N_THREADS


def _native_arch() -> str:
    """What ``-march=native`` means to g++ on this host (a library built
    for another CPU may use instructions this one lacks)."""
    try:
        out = subprocess.run(["g++", "-march=native", "-Q", "--help=target"],
                             capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"
    return " ".join(line.split()[-1] for line in out.stdout.splitlines()
                    if line.strip().startswith(("-march=", "-mtune=")))


def _library_path() -> Path:
    """Named by a hash of the flags, the host's native target and the
    source."""
    h = hashlib.sha256(" ".join(GXX_FLAGS + [_native_arch()]).encode())
    h.update(_SRC.read_bytes())
    return _BUILD / f"libapex1_runtime_{h.hexdigest()[:16]}.so"


def _build() -> Optional[Path]:
    """The library's path, compiled first if no build with this digest
    exists; None (and the compiler's output in `build_log`) if g++
    fails."""
    lib = _library_path()
    if lib.exists():
        return lib
    _BUILD.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    try:
        out = subprocess.run(["g++", *GXX_FLAGS, str(_SRC), "-o", str(tmp)],
                             capture_output=True, text=True, timeout=120)
    except (OSError, subprocess.TimeoutExpired) as e:
        _STATE["log"] = f"g++ did not run: {e!r}"
        return None
    _STATE["log"] = out.stdout + out.stderr
    if out.returncode != 0:
        tmp.unlink(missing_ok=True)
        return None
    os.replace(tmp, lib)
    return lib


def _load(path: Path) -> Optional[ctypes.CDLL]:
    try:
        lib = ctypes.CDLL(str(path))
        # the ABI gate comes BEFORE any other symbol: a library from
        # another source must fall back to NumPy, and ctypes raises
        # AttributeError (not OSError) for a missing symbol
        lib.apex1_runtime_abi_version.restype = ctypes.c_int
        if lib.apex1_runtime_abi_version() != ABI_VERSION:
            _STATE["log"] += f"\n{path.name}: ABI version is not {ABI_VERSION}"
            return None
        i64, vp = ctypes.c_int64, ctypes.c_void_p
        lib.apex1_flatten.argtypes = [ctypes.POINTER(vp),
                                      ctypes.POINTER(i64), i64, vp,
                                      ctypes.c_int]
        lib.apex1_flatten.restype = None
        lib.apex1_unflatten.argtypes = [vp, ctypes.POINTER(i64), i64,
                                        ctypes.POINTER(vp), ctypes.c_int]
        lib.apex1_unflatten.restype = None
        lib.apex1_normalize_u8_f32.argtypes = [
            vp, vp, i64, ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float), i64, ctypes.c_int]
        lib.apex1_normalize_u8_f32.restype = None
        lib.apex1_f32_to_bf16.argtypes = [vp, vp, i64, ctypes.c_int]
        lib.apex1_f32_to_bf16.restype = None
        lib.apex1_bf16_to_f32.argtypes = [vp, vp, i64, ctypes.c_int]
        lib.apex1_bf16_to_f32.restype = None
        lib.apex1_loader_open.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                          i64, i64, ctypes.c_uint64,
                                          ctypes.c_int]
        lib.apex1_loader_open.restype = vp
        lib.apex1_loader_num_sequences.argtypes = [vp]
        lib.apex1_loader_num_sequences.restype = i64
        lib.apex1_loader_next.argtypes = [vp, i64, vp, ctypes.c_int]
        lib.apex1_loader_next.restype = ctypes.c_int
        lib.apex1_loader_fetch.argtypes = [vp, i64, vp]
        lib.apex1_loader_fetch.restype = ctypes.c_int
        lib.apex1_loader_close.argtypes = [vp]
        lib.apex1_loader_close.restype = None
        lib.apex1_pack_fill.argtypes = [
            vp, vp, vp, vp, vp, vp, vp, i64, vp, vp, vp, i64, i64,
            ctypes.c_int32, ctypes.c_int]
        lib.apex1_pack_fill.restype = None
        lib.apex1_pack_plan.argtypes = [
            vp, vp, i64, i64, ctypes.c_int, vp, vp, vp, vp, vp, vp]
        lib.apex1_pack_plan.restype = i64
        return lib
    except (OSError, AttributeError) as e:
        _STATE["log"] += f"\n{path.name}: {e!r}"
        return None


def _lib() -> Optional[ctypes.CDLL]:
    """The native library, built and loaded at first use; None when
    g++ or the load failed (the NumPy fallback)."""
    if _STATE["lib"] is _UNSET:
        with _LOCK:
            if _STATE["lib"] is _UNSET:
                path = _build()
                _STATE["lib"] = None if path is None else _load(path)
    return _STATE["lib"]


def native_available() -> bool:
    """True when the native library built and loaded (building it on
    the first call)."""
    return _lib() is not None


def build_log() -> str:
    """g++'s output, or why the library could not load, from this
    process; empty when an earlier build was reused."""
    return _STATE["log"]


def _as_contig(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a)


def flatten(arrays: Sequence[np.ndarray]) -> np.ndarray:
    """Pack arrays into one contiguous byte buffer (``apex_C.flatten``).
    Returns a uint8 array; pair with `unflatten` and the original
    specs."""
    arrays = [_as_contig(np.asarray(a)) for a in arrays]
    sizes = [a.nbytes for a in arrays]
    out = np.empty(sum(sizes), np.uint8)
    lib = _lib()
    if lib is not None and arrays:
        n = len(arrays)
        srcs = (ctypes.c_void_p * n)(*[a.ctypes.data for a in arrays])
        csizes = (ctypes.c_int64 * n)(*sizes)
        lib.apex1_flatten(srcs, csizes, n, out.ctypes.data,
                          _threads(out.nbytes))
    else:
        off = 0
        for a, s in zip(arrays, sizes):
            # reshape first: a 0-d array cannot change its dtype
            out[off:off + s] = a.reshape(-1).view(np.uint8)
            off += s
    return out


def unflatten(flat: np.ndarray,
              specs: Sequence[tuple[tuple[int, ...], np.dtype]]
              ) -> list[np.ndarray]:
    """Inverse of `flatten`: ``specs`` is [(shape, dtype), ...]
    (``apex_C.unflatten``)."""
    flat = _as_contig(np.asarray(flat)).view(np.uint8)
    outs = [np.empty(shape, dtype) for shape, dtype in specs]
    sizes = [o.nbytes for o in outs]
    if sum(sizes) != flat.nbytes:
        raise ValueError(f"flat buffer holds {flat.nbytes} bytes, specs "
                         f"need {sum(sizes)}")
    lib = _lib()
    if lib is not None and outs:
        n = len(outs)
        dsts = (ctypes.c_void_p * n)(*[o.ctypes.data for o in outs])
        csizes = (ctypes.c_int64 * n)(*sizes)
        lib.apex1_unflatten(flat.ctypes.data, csizes, n, dsts,
                            _threads(flat.nbytes))
    else:
        off = 0
        for o, s in zip(outs, sizes):
            o.reshape(-1).view(np.uint8)[:] = flat[off:off + s]
            off += s
    return outs


def normalize_images(batch_u8: np.ndarray, mean: Sequence[float],
                     std: Sequence[float]) -> np.ndarray:
    """uint8 NHWC -> fp32 ``(x/255 - mean) / std`` per channel (the
    reference prefetcher's normalize, on host threads). The native path
    computes ``x * (1 / (255 std)) - mean / std``, within 1e-6 of the
    NumPy fallback's form."""
    batch_u8 = _as_contig(np.asarray(batch_u8, np.uint8))
    c = batch_u8.shape[-1]
    if len(mean) != c or len(std) != c:
        raise ValueError(f"mean/std length must equal channels ({c})")
    out = np.empty(batch_u8.shape, np.float32)
    lib = _lib()
    if lib is not None:
        fmean = (ctypes.c_float * c)(*[float(m) for m in mean])
        fstd = (ctypes.c_float * c)(*[float(s) for s in std])
        lib.apex1_normalize_u8_f32(batch_u8.ctypes.data, out.ctypes.data,
                                   batch_u8.size, fmean, fstd, c,
                                   _threads(out.nbytes))
    else:
        out[:] = (batch_u8.astype(np.float32) / 255.0
                  - np.asarray(mean, np.float32)) / np.asarray(
                      std, np.float32)
    return out


def f32_to_bf16_bits(x: np.ndarray) -> np.ndarray:
    """fp32 -> bf16 bit patterns (uint16), round to nearest even; a NaN
    is quieted (its top payload bits kept), never rounded into ±0 or
    ±inf. Host staging for bf16 buffers."""
    x = _as_contig(np.asarray(x, np.float32))
    out = np.empty(x.shape, np.uint16)
    lib = _lib()
    if lib is not None:
        lib.apex1_f32_to_bf16(x.ctypes.data, out.ctypes.data, x.size,
                              _threads(x.nbytes))
    else:
        bits = x.view(np.uint32)
        rounding = 0x7FFF + ((bits >> 16) & 1)
        rounded = ((bits + rounding) >> 16).astype(np.uint16)
        nan = (bits & 0x7FFFFFFF) > 0x7F800000
        out[:] = np.where(nan, ((bits >> 16) | 0x0040).astype(np.uint16),
                          rounded)
    return out


def bf16_bits_to_f32(bits: np.ndarray) -> np.ndarray:
    """bf16 bit patterns (uint16) -> fp32, exactly."""
    bits = _as_contig(np.asarray(bits, np.uint16))
    out = np.empty(bits.shape, np.float32)
    lib = _lib()
    if lib is not None:
        lib.apex1_bf16_to_f32(bits.ctypes.data, out.ctypes.data,
                              bits.size, _threads(out.nbytes))
    else:
        out.view(np.uint32)[:] = bits.astype(np.uint32) << 16
    return out


def _mix64(x: np.ndarray) -> np.ndarray:
    """splitmix64 over uint64; must match ``mix64`` in `_runtime.cpp`."""
    with np.errstate(over="ignore"):
        x = (x + np.uint64(0x9E3779B97F4A7C15)).astype(np.uint64)
        x = ((x ^ (x >> np.uint64(30)))
             * np.uint64(0xBF58476D1CE4E5B9)).astype(np.uint64)
        x = ((x ^ (x >> np.uint64(27)))
             * np.uint64(0x94D049BB133111EB)).astype(np.uint64)
        return x ^ (x >> np.uint64(31))


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


def _epoch_perm(epoch: np.ndarray, i: np.ndarray, *, seed: int, n: int,
                pow2: int) -> np.ndarray:
    """Exact permutation of [0, n) per epoch (a cycle-walked affine map
    over the pow2 ring): the math of ``TokenLoader::perm``, vectorized."""
    seed = np.uint64(seed)
    a = (_mix64(seed ^ _mix64(epoch)) | np.uint64(1))
    c = _mix64(seed ^ _mix64(epoch ^ np.uint64(0xD1B54A32D192ED03)))
    m = np.uint64(pow2 - 1)
    x = i.astype(np.uint64)
    with np.errstate(over="ignore"):
        x = (a * x + c) & m
        todo = x >= np.uint64(n)
        while np.any(todo):
            x[todo] = (a[todo] * x[todo] + c[todo]) & m
            todo = x >= np.uint64(n)
    return x.astype(np.int64)


class TokenDataset:
    """Deterministic LM-pretraining batches from a flat binary token file.

    ``batch_at(step)`` is a pure function of (file, seed, step): a
    checkpoint stores only the step counter, and a prefetch worker can
    fetch any step. Shuffling is an exact per-epoch permutation (an
    affine map over the next power of two with cycle-walking: O(1)
    memory for any corpus). Backed by the memory-mapped native loader;
    the NumPy fallback gives the same batches bit for bit.

    The file is raw little-endian tokens, uint16 (vocab < 65536) or
    int32/uint32. For next-token training use ``seq_len = S + 1`` and
    shift in the loss.
    """

    def __init__(self, path: str, *, seq_len: int, batch_size: int,
                 dtype=np.uint16, seed: int = 0, shuffle: bool = True):
        self.path = str(path)
        self.seq_len = int(seq_len)
        self.batch_size = int(batch_size)
        self.dtype = np.dtype(dtype)
        if self.dtype.itemsize not in (2, 4):
            raise ValueError("token dtype must be 2 or 4 bytes")
        # wrapped to uint64 so the native (C cast) and NumPy paths agree
        # for negative or oversized seeds
        self.seed = int(seed) & ((1 << 64) - 1)
        self.shuffle = bool(shuffle)
        self._closed = False
        self._handle = None
        self._finalizer = None
        lib = _lib()
        if lib is not None:
            self._handle = lib.apex1_loader_open(
                self.path.encode(), self.dtype.itemsize, self.seq_len,
                self.batch_size, ctypes.c_uint64(self.seed),
                int(self.shuffle))
            if self._handle:
                import weakref
                self._lib = lib
                self._finalizer = weakref.finalize(
                    self, lib.apex1_loader_close, self._handle)
        if self._handle:
            self.num_sequences = int(
                lib.apex1_loader_num_sequences(self._handle))
            self._tokens = None
        else:
            self._tokens = np.memmap(self.path, dtype=self.dtype, mode="r")
            self.num_sequences = len(self._tokens) // self.seq_len
        if self.num_sequences < 1:
            raise ValueError(
                f"{path}: fewer than one {seq_len}-token sequence")
        self._pow2 = _next_pow2(self.num_sequences)

    @property
    def native(self) -> bool:
        return self._handle is not None

    def steps_per_epoch(self) -> int:
        return self.num_sequences // self.batch_size

    def _perm(self, epoch: np.ndarray, i: np.ndarray) -> np.ndarray:
        if not self.shuffle:
            return i.astype(np.int64)
        return _epoch_perm(epoch, i, seed=self.seed, n=self.num_sequences,
                           pow2=self._pow2)

    def fetch(self, seq_index: int, out=None) -> np.ndarray:
        """One raw sequence by index (no permutation): the building
        block `ShardedTokenDataset` routes its global shuffle through.
        ``out``: an optional int32 (seq_len,) buffer filled in place."""
        if self._closed:
            raise RuntimeError("TokenDataset is closed")
        if not 0 <= seq_index < self.num_sequences:
            raise IndexError(seq_index)
        if out is None:
            out = np.empty((self.seq_len,), np.int32)
        if self._handle:
            rc = self._lib.apex1_loader_fetch(self._handle, seq_index,
                                              out.ctypes.data)
            if rc != 0:
                raise RuntimeError(f"loader_fetch failed ({seq_index})")
            return out
        lo = seq_index * self.seq_len
        out[:] = self._tokens[lo:lo + self.seq_len]
        return out

    def batch_at(self, step: int) -> np.ndarray:
        """(batch_size, seq_len) int32 tokens of global step ``step``."""
        if self._closed:
            raise RuntimeError("TokenDataset is closed")
        if step < 0:
            raise ValueError("step must be >= 0")
        out = np.empty((self.batch_size, self.seq_len), np.int32)
        if self._handle:
            rc = self._lib.apex1_loader_next(self._handle, step,
                                             out.ctypes.data,
                                             _threads(out.nbytes))
            if rc != 0:
                raise RuntimeError(f"loader_next failed (step={step})")
            return out
        g = np.uint64(step) * np.uint64(self.batch_size) + np.arange(
            self.batch_size, dtype=np.uint64)
        epoch = g // np.uint64(self.num_sequences)
        s = self._perm(epoch, g % np.uint64(self.num_sequences))
        for r in range(self.batch_size):
            lo = int(s[r]) * self.seq_len
            out[r] = self._tokens[lo:lo + self.seq_len]
        return out

    def iter_from(self, step: int = 0) -> Iterator[np.ndarray]:
        """Endless step-indexed batch stream (wrap it in a
        `PrefetchLoader` to overlap host work with device compute)."""
        while True:
            yield self.batch_at(step)
            step += 1

    def close(self):
        self._closed = True
        if self._finalizer is not None:
            self._finalizer()  # idempotent: detaches and closes the handle
            self._finalizer = None
        self._handle = None
        self._tokens = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class ShardedTokenDataset:
    """`TokenDataset` over a sharded corpus (many flat token files). Same
    contract: a pure ``batch_at(step)`` and one exact shuffle over the
    CONCATENATED sequence pool (epoch boundaries and resume are
    corpus-global); rows route to their shard by the cumulative sequence
    counts. Shard order is the caller's (pass a sorted list for a
    canonical corpus)."""

    def __init__(self, paths: Sequence[str], *, seq_len: int,
                 batch_size: int, dtype=np.uint16, seed: int = 0,
                 shuffle: bool = True):
        if not paths:
            raise ValueError("need at least one shard path")
        self.seq_len = int(seq_len)
        self.batch_size = int(batch_size)
        self.seed = int(seed) & ((1 << 64) - 1)
        self.shuffle = bool(shuffle)
        self._shards = [TokenDataset(str(p), seq_len=seq_len,
                                     batch_size=1, dtype=dtype, seed=0,
                                     shuffle=False) for p in paths]
        counts = [s.num_sequences for s in self._shards]
        self._starts = np.concatenate([[0], np.cumsum(counts)])
        self.num_sequences = int(self._starts[-1])
        self._pow2 = _next_pow2(self.num_sequences)

    @property
    def native(self) -> bool:
        return all(s.native for s in self._shards)

    def steps_per_epoch(self) -> int:
        return self.num_sequences // self.batch_size

    def batch_at(self, step: int) -> np.ndarray:
        if step < 0:
            raise ValueError("step must be >= 0")
        g = np.uint64(step) * np.uint64(self.batch_size) + np.arange(
            self.batch_size, dtype=np.uint64)
        epoch = g // np.uint64(self.num_sequences)
        i = g % np.uint64(self.num_sequences)
        s = (_epoch_perm(epoch, i, seed=self.seed, n=self.num_sequences,
                         pow2=self._pow2)
             if self.shuffle else i.astype(np.int64))
        out = np.empty((self.batch_size, self.seq_len), np.int32)
        shard_of = np.searchsorted(self._starts, s, side="right") - 1
        for r in range(self.batch_size):
            sh = int(shard_of[r])
            self._shards[sh].fetch(int(s[r] - self._starts[sh]),
                                   out=out[r])
        return out

    def iter_from(self, step: int = 0) -> Iterator[np.ndarray]:
        while True:
            yield self.batch_at(step)
            step += 1

    def close(self):
        for s in self._shards:
            s.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def pack_documents(docs: Sequence[np.ndarray], seq_len: int,
                   *, pad_id: int = 0,
                   restart_chunk_positions: bool = False):
    """Greedy first-fit packing of variable-length documents into fixed
    (rows, seq_len) batches.

    Returns ``(tokens, segment_ids, positions)``, each (rows, seq_len)
    int32. ``segment_ids`` are unique per document within a row and -1
    on padding; ``positions`` restart at 0 per document. A document
    longer than ``seq_len`` is split into ``seq_len`` chunks, each its
    own segment, whose positions continue within the document unless
    ``restart_chunk_positions`` is set (required for learned-position
    models like GPT-2, whose table would otherwise be indexed past its
    end). First fit looks at the 256 most recently opened rows that
    still have room. The native plan and fill and the Python fallback
    give the same arrays."""
    if seq_len <= 0:
        # before the native branch: apex1_pack_plan's chunk loop cannot
        # advance at seq_len <= 0
        raise ValueError(f"seq_len must be positive, got {seq_len}")
    docs = [np.ascontiguousarray(np.asarray(d).ravel(), np.int32)
            for d in docs]
    doc_lens = np.asarray([len(d) for d in docs], np.int64)
    doc_starts = np.zeros(len(docs) + 1, np.int64)
    np.cumsum(doc_lens, out=doc_starts[1:])
    flat = (np.concatenate(docs) if docs else np.zeros(0, np.int32))
    n_chunks = int(np.sum(-(-doc_lens // seq_len)))

    lib = _lib()
    if lib is not None:
        # the native plan (first-fit placement), then a threaded fill
        starts = np.empty(n_chunks, np.int64)
        lens64 = np.empty(n_chunks, np.int64)
        rows64 = np.empty(n_chunks, np.int64)
        cols64 = np.empty(n_chunks, np.int64)
        segs32 = np.empty(n_chunks, np.int32)
        pos032 = np.empty(n_chunks, np.int32)
        n = lib.apex1_pack_plan(
            doc_lens.ctypes.data, doc_starts.ctypes.data, len(docs),
            seq_len, int(restart_chunk_positions), starts.ctypes.data,
            lens64.ctypes.data, rows64.ctypes.data, cols64.ctypes.data,
            segs32.ctypes.data, pos032.ctypes.data)
        tokens = np.empty((n, seq_len), np.int32)
        segs = np.empty((n, seq_len), np.int32)
        pos = np.empty((n, seq_len), np.int32)
        lib.apex1_pack_fill(
            flat.ctypes.data, starts.ctypes.data, lens64.ctypes.data,
            rows64.ctypes.data, cols64.ctypes.data, segs32.ctypes.data,
            pos032.ctypes.data, n_chunks, tokens.ctypes.data,
            segs.ctypes.data, pos.ctypes.data, n, seq_len, pad_id,
            _threads(3 * tokens.nbytes))
        return tokens, segs, pos

    space: list[int] = []
    fill: list[int] = []       # next free column per row
    nseg: list[int] = []       # segments placed per row
    open_rows: list[int] = []  # bounded first-fit window
    max_open = 256
    plan: list[tuple[int, int, int, int, int, int]] = []
    for di, doc in enumerate(docs):
        for lo in range(0, len(doc), seq_len):
            ln = min(seq_len, len(doc) - lo)
            for r in open_rows:
                if space[r] >= ln:
                    break
            else:
                r = len(space)
                space.append(seq_len)
                fill.append(0)
                nseg.append(0)
                if ln < seq_len:   # full rows never enter the window
                    open_rows.append(r)
                    if len(open_rows) > max_open:
                        open_rows.pop(0)  # evict by age
            plan.append((int(doc_starts[di]) + lo, ln, r, fill[r],
                         nseg[r], 0 if restart_chunk_positions else lo))
            space[r] -= ln
            fill[r] += ln
            nseg[r] += 1
            if space[r] == 0 and r in open_rows:
                open_rows.remove(r)
    n = len(space)
    tokens = np.full((n, seq_len), pad_id, np.int32)
    segs = np.full((n, seq_len), -1, np.int32)
    pos = np.zeros((n, seq_len), np.int32)
    for start, ln, r, c, sid, pos0 in plan:
        tokens[r, c:c + ln] = flat[start:start + ln]
        segs[r, c:c + ln] = sid
        pos[r, c:c + ln] = np.arange(pos0, pos0 + ln)
    return tokens, segs, pos


def write_token_file(path: str, tokens: np.ndarray) -> None:
    """Write a flat token file `TokenDataset` can read (little-endian)."""
    arr = np.asarray(tokens)
    if arr.dtype.itemsize not in (2, 4):
        raise ValueError("token dtype must be 2 or 4 bytes")
    arr.astype(arr.dtype.newbyteorder("<")).tofile(path)


class PrefetchLoader:
    """Apex's ``data_prefetcher``: a worker thread pulls batches from
    ``source``, runs ``transform`` (e.g. `normalize_images`) off the
    training loop's thread, and with ``device_put`` puts each batch on
    ``device`` ahead of its step.

    A batch is a tree (a dict, a list or tuple, or a bare array); its
    numpy arrays become tensors, everything else passes through. On a
    CUDA device each array is staged in its own pinned host buffer (the
    caching host allocator does not reuse a buffer before the copy that
    reads it has finished) and copied with ``non_blocking=True`` on a
    dedicated side stream; an event recorded after the batch's copies is
    waited on by the consumer's current stream before the batch is
    yielded, and every yielded tensor is marked used on that stream
    (``record_stream``), so the caching allocator does not hand its
    block out again while the step still reads it. ``device="cpu"``
    yields CPU tensors (``torch.from_numpy``); ``device_put=False``
    yields the transformed numpy trees. ``device=None`` is CUDA, raising
    where there is none.

    Stopping early (``break``, an exception, ``close()``) waits up to
    60 s for the worker to stop, since the caller may then tear down
    what the worker reads (a memory map); a worker still blocked in the
    source after that is reported with a RuntimeWarning."""

    _DONE = object()

    def __init__(self, source: Iterable, *,
                 transform: Optional[Callable] = None,
                 device_put: bool = True, prefetch: int = 2, device=None):
        from apex1_tpu_torch.ops._common import resolve_device
        self.source = source
        self.transform = transform
        self.device_put = device_put
        self.prefetch = max(1, prefetch)
        self.device = resolve_device(device) if device_put else None

    def _put_on_device(self, batch, dev, stream):
        """(tree of tensors, event or None) of one host batch."""
        from apex1_tpu_torch.core.pytree import tree_map_with_path

        def move(_, x):
            if not isinstance(x, np.ndarray):
                return x
            t = torch.from_numpy(x if x.flags.writeable else x.copy())
            if stream is None:
                return t.to(dev)
            t = t.pin_memory()
            with torch.cuda.stream(stream):
                return t.to(dev, non_blocking=True)

        out = tree_map_with_path(move, batch)
        if stream is None:
            return out, None
        ev = torch.cuda.Event()
        ev.record(stream)
        return out, ev

    def __iter__(self) -> Iterator:
        from apex1_tpu_torch.core.pytree import tree_flatten_with_path
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        err: list[BaseException] = []
        stop = threading.Event()
        cuda = self.device_put and self.device.type == "cuda"
        dev = self.device
        if cuda and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        stream = torch.cuda.Stream(dev) if cuda else None

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def work():
            try:
                if cuda:
                    torch.cuda.set_device(dev)
                for batch in self.source:
                    if stop.is_set():
                        return
                    if self.transform is not None:
                        batch = self.transform(batch)
                    item = (self._put_on_device(batch, dev, stream)
                            if self.device_put else (batch, None))
                    if not put(item):
                        return
            except BaseException as e:  # propagated to the consumer
                err.append(e)
            finally:
                put(self._DONE)

        t = threading.Thread(target=work, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is self._DONE:
                    if err:
                        raise err[0]
                    return
                batch, ev = item
                if ev is not None:
                    cur = torch.cuda.current_stream(dev)
                    cur.wait_event(ev)
                    for _, x in tree_flatten_with_path(batch):
                        if isinstance(x, torch.Tensor):
                            x.record_stream(cur)
                yield batch
        finally:
            # the consumer stopped (exhausted, break or exception):
            # unblock the worker and wait until it is DEAD: a caller may
            # tear down what the worker reads (an mmap) right after
            stop.set()
            deadline = _time.monotonic() + 60.0
            while t.is_alive() and _time.monotonic() < deadline:
                while not q.empty():
                    try:
                        q.get_nowait()
                    except queue.Empty:
                        break
                t.join(timeout=0.1)
            if t.is_alive():
                # a source blocked in next() never sees `stop`
                import warnings
                warnings.warn(
                    "PrefetchLoader worker did not stop within 60s (source "
                    "blocked?); resources it reads must outlive it",
                    RuntimeWarning, stacklevel=2)


__all__ = ["ABI_VERSION", "GXX_FLAGS", "native_available", "build_log",
           "flatten", "unflatten", "normalize_images", "f32_to_bf16_bits",
           "bf16_bits_to_f32", "TokenDataset", "ShardedTokenDataset",
           "pack_documents", "write_token_file", "PrefetchLoader",
           "backoff_delays", "RequestFeeder"]


class RequestFeeder:
    """Background request-ingest thread for the serving engine: pulls
    raw prompts from ``source`` (an iterable of anything — text lines,
    token lists), tokenizes them OFF the engine's critical path, and
    pushes them through ``submit`` (the engine/scheduler entry point),
    absorbing `Backpressure` with the scheduler docstring's promised
    429/retry contract: BOUNDED EXPONENTIAL BACKOFF with deterministic
    jitter (`backoff_delays` — base ``retry_wait_s``,
    doubling, capped at ``retry_cap_s``, jittered so a burst of rejected
    feeders doesn't re-slam the queue in lockstep) and a
    drop-after-deadline rule: once an item has spent ``deadline_s``
    total in retries it is shed (``dropped``), because an overloaded
    engine must shed load, not stretch tail latency unboundedly.

    A structured rejection's ``retry_after_s`` is the server's backoff
    hint and is honored as a FLOOR on the next sleep: the exponential
    schedule may wait longer, never shorter — a thousand feeders
    retrying "soon" against a server that said "50 ms" is exactly the
    re-slam the hint exists to prevent. The floored delay still counts
    against ``deadline_s``.

    ``tokenize(item) -> (tokens, kwargs)`` where kwargs go straight to
    ``submit(tokens, **kwargs)`` (``max_new_tokens`` etc.). Rejections
    that outlive ``retries``/``deadline_s`` land in ``dropped`` with the
    reason. ``counters`` tracks the aggregate: ``submitted``,
    ``retries`` (backoff sleeps taken), ``dropped_backpressure``,
    ``dropped_error`` — the feed-side metrics record.

    The worker only SUBMITS; stepping the engine stays with the caller
    (the engine is not thread-safe by design — one loop owns the
    device). Typical shape::

        feeder = RequestFeeder(prompts, tokenize, engine.submit)
        feeder.start()
        while not feeder.idle or engine.n_active or engine.scheduler.depth:
            engine.step()
        feeder.join()
    """

    def __init__(self, source: Iterable, tokenize: Callable,
                 submit: Callable, *, retries: int = 100,
                 retry_wait_s: float = 0.005,
                 retry_cap_s: float = 0.25,
                 deadline_s: Optional[float] = None,
                 jitter: float = 0.5, seed: int = 0):
        self.source = source
        self.tokenize = tokenize
        self.submit = submit
        self.retries = int(retries)
        self.retry_wait_s = float(retry_wait_s)
        self.retry_cap_s = float(retry_cap_s)
        self.deadline_s = deadline_s
        self.jitter = float(jitter)
        self.seed = int(seed)
        self.submitted: list = []
        self.dropped: list = []          # (item, reason)
        self.errors: list = []
        self.counters = {"submitted": 0, "retries": 0,
                         "dropped_backpressure": 0, "dropped_error": 0}
        self._thread: Optional[threading.Thread] = None
        self._done = threading.Event()

    @property
    def idle(self) -> bool:
        """True once the source is drained and every item dispatched."""
        return self._done.is_set()

    def start(self) -> "RequestFeeder":
        from apex1_tpu_torch.serving.scheduler import (Backpressure,
                                                       new_request_id)

        def work():
            try:
                for n_item, item in enumerate(self.source):
                    # a PER-ITEM failure (tokenizer bug, contract
                    # ValueError from submit) drops THAT item and keeps
                    # feeding — one malformed request must not silently
                    # starve the rest of the stream
                    try:
                        tokens, kw = self.tokenize(item)
                    except Exception as e:
                        self.dropped.append((item, f"tokenize: {e!r}"))
                        self.counters["dropped_error"] += 1
                        self.errors.append(e)
                        continue
                    # one id across every retry attempt: transient
                    # backpressure rejections then update ONE metrics
                    # record instead of minting a phantom rejected
                    # record per attempt
                    kw.setdefault("req_id", new_request_id())
                    delays = backoff_delays(
                        self.retries, base_s=self.retry_wait_s,
                        cap_s=self.retry_cap_s, jitter=self.jitter,
                        seed=self.seed ^ n_item)
                    t0 = _time.monotonic()
                    while True:
                        try:
                            self.submitted.append(
                                self.submit(tokens, **kw))
                            self.counters["submitted"] += 1
                            break
                        except Backpressure as e:
                            d = next(delays, None)
                            if d is not None:
                                # server hint = the floor, not the value:
                                # back off MORE than asked, never less
                                floor = getattr(e, "retry_after_s", None)
                                if floor:
                                    d = max(d, float(floor))
                            waited = _time.monotonic() - t0
                            if d is None:
                                reason = f"{e.reason} (retries exhausted)"
                            elif (self.deadline_s is not None
                                  and waited + d > self.deadline_s):
                                reason = (f"{e.reason} (deadline "
                                          f"{self.deadline_s}s after "
                                          f"{waited:.3f}s)")
                            else:
                                self.counters["retries"] += 1
                                _time.sleep(d)
                                continue
                            self.dropped.append((item, reason))
                            self.counters["dropped_backpressure"] += 1
                            break
                        except Exception as e:
                            self.dropped.append((item, repr(e)))
                            self.counters["dropped_error"] += 1
                            self.errors.append(e)
                            break
            except BaseException as e:   # source iteration died —
                self.errors.append(e)    # surfaced via join()
            finally:
                self._done.set()

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()
        return self

    def join(self, timeout: Optional[float] = None) -> None:
        if self._thread is not None:
            self._thread.join(timeout)
        if self.errors:
            raise self.errors[0]
