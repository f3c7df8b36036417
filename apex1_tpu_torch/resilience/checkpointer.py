"""Async, integrity-checked, ring-kept checkpoints over
`checkpoint.save_checkpoint` (the port of
``apex1_tpu/resilience/checkpointer.py``).

- Async double buffering: ``save(step, state)`` takes a device-side
  snapshot (the tensors copied into one buffer a device by one ``cat``
  on the caller's current stream, and a CUDA event recorded after it),
  so the next step's updates cannot touch what is being saved, and
  hands it to one background worker. The worker enters the snapshot's
  device (a new thread's current device is device 0), copies the
  buffer to pinned host memory on a side stream that waits on the
  event (a copy on the legacy default stream would serialize with the
  training step), and writes on a pool of `ASYNC_THREADS` threads. The
  save still costs the steps beside it host time: a step with a save
  in flight is measured in PERF.md §6. At most two snapshots exist (one
  writing, one queued: the slot is taken before the copy is made); a
  third ``save`` blocks until the writer drains one.
- Atomic commit and integrity manifest: the payload lands in
  ``step_XXXXXXXX.tmp-<pid>/state`` through the atomic
  `checkpoint.save_checkpoint`, `manifest.write_manifest` records every
  file and leaf digest (`write_step_dir`: each leaf hashed once), the
  temp dir is renamed to ``step_XXXXXXXX`` and only then is the
  ``latest`` pointer promoted. A crash at any point leaves a complete
  checkpoint or ignorable debris.
- Ring keep policy: the last ``keep`` checkpoints survive; saves with
  ``milestone=True`` are pinned outside the ring.
- Backward scan: `find_restorable` walks newest to oldest past
  truncated, bit-flipped or uncommitted checkpoints to the newest
  valid one.
- Exact resume: the manifest carries ``step``, a JSON ``meta`` dict
  (data position, seeds) and a program ``fingerprint`` that refuses a
  silent resume onto a changed program; with ``plan=`` the producing
  layout is banked in every save and a restore under another layout is
  a typed `LayoutMismatch`.

Scope: one process's own state (each rank of a multi-process job its
own directory); the collective save of a sharded state is
`checkpoint.save_checkpoint`'s. `timings` keeps, per committed save,
the seconds of its host copy, payload write and digests.
"""

from __future__ import annotations

import os
import queue
import re
import shutil
import threading
import time
from typing import Any, Optional, Tuple

import torch

from apex1_tpu_torch.checkpoint import (CheckpointError, commit_dir,
                                        read_index, restore_checkpoint,
                                        save_checkpoint)
from apex1_tpu_torch.core.pytree import tree_map_with_path
from apex1_tpu_torch.resilience.manifest import (IntegrityError, Manifest,
                                                 atomic_write_text,
                                                 parallel_cap,
                                                 read_manifest,
                                                 tree_entries, verify_files,
                                                 write_manifest)
from apex1_tpu_torch.resilience.reshard import (PLAN_SCHEMA, LayoutMismatch,
                                                mesh_str, plan_spec)

_STEP_RE = re.compile(r"^step_(\d{8})$")
_LATEST = "latest"
_STATE_SUBDIR = "state"


def step_dir_name(step: int) -> str:
    if step < 0:
        raise ValueError("step must be >= 0")
    return f"step_{int(step):08d}"


def _list_step_dirs(directory: str) -> list:
    """[(step, absolute path)] sorted ascending; ignores temp debris."""
    out = []
    try:
        names = os.listdir(directory)
    except OSError:
        return out
    for name in names:
        m = _STEP_RE.match(name)
        if m:
            out.append((int(m.group(1)), os.path.join(directory, name)))
    return sorted(out)


def is_valid_checkpoint(path: str | os.PathLike) -> bool:
    """Committed and passes the file-level integrity manifest."""
    try:
        verify_files(path)
        return True
    except IntegrityError:
        return False


def find_restorable(directory: str | os.PathLike) -> Optional[str]:
    """Newest valid checkpoint dir under ``directory``, or None. Every
    ``step_*`` dir is verified newest to oldest; the ``latest`` pointer
    is not trusted (a kill between the commit rename and the pointer
    promote leaves a newer valid checkpoint it does not name)."""
    directory = os.fspath(directory)
    for _step, path in reversed(_list_step_dirs(directory)):
        if is_valid_checkpoint(path):
            return path
    return None


def write_step_dir(final: str, host: Any, *, step: int,
                   fingerprint: Optional[int] = None,
                   meta: Optional[dict] = None) -> dict:
    """Commit the host tree ``host`` as the step directory ``final``:
    leaf digests, the payload under ``state/``, the manifest, then the
    rename (`checkpoint.commit_dir`). Each leaf is hashed once: a leaf
    file holds its leaf's raw bytes, so its file digest is the leaf
    digest. Returns the seconds of the digests and of the write."""
    tmp = f"{final}.tmp-{os.getpid()}"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    try:
        t0 = time.perf_counter()
        tree = tree_entries(host)
        t1 = time.perf_counter()
        state_dir = os.path.join(tmp, _STATE_SUBDIR)
        save_checkpoint(state_dir, host)
        leaf_sha = {e["path"]: e["sha256"] for e in tree}
        files = {f"{_STATE_SUBDIR}/{e['file']}": leaf_sha[e["path"]]
                 for e in read_index(state_dir)}
        write_manifest(tmp, step=step, tree=tree, fingerprint=fingerprint,
                       meta=meta, file_digests=files)
        commit_dir(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return {"digest_s": t1 - t0, "write_s": time.perf_counter() - t1}


def check_payload(path: str, manifest: Manifest) -> None:
    """The payload's index against the manifest's leaf entries: the same
    leaves, shapes and dtypes, and each leaf file's digest equal to its
    leaf digest. After `verify_files` this proves the restored leaves
    are the recorded ones (a leaf restores as its file's bytes) without
    hashing them again; each mismatch a typed `IntegrityError`."""
    try:
        index = read_index(os.path.join(path, _STATE_SUBDIR))
    except CheckpointError as e:
        raise IntegrityError(path, e.reason) from e
    files = {e["path"]: e["sha256"] for e in manifest.files}
    got = {e["path"]: dict(e, sha256=files.get(
        f"{_STATE_SUBDIR}/{e['file']}")) for e in index}
    want = {e["path"]: e for e in manifest.tree}
    if set(got) != set(want):
        raise IntegrityError(
            path, "tree structure mismatch: "
            f"missing {sorted(set(want) - set(got))[:4]}, "
            f"unexpected {sorted(set(got) - set(want))[:4]}")
    for p, w in want.items():
        for field in ("shape", "dtype", "sha256"):
            if got[p][field] != w[field]:
                raise IntegrityError(
                    path, f"leaf {p}: {field} mismatch "
                    f"({got[p][field]!r} != recorded {w[field]!r})")


#: byte alignment of each leaf in a packed snapshot (the host views'
#: dtypes need it)
_ALIGN = 16


class _Slot:
    """A snapshot leaf: its place in its device's packed buffer."""

    def __init__(self, t: torch.Tensor, index: int):
        self.device, self.index = t.device, index
        self.dtype, self.shape = t.dtype, tuple(t.shape)
        self.nbytes = t.numel() * t.element_size()


def _pack(parts: list) -> tuple:
    """One device's tensors copied into one byte buffer (one ``cat`` on
    the caller's current stream), each at a multiple of `_ALIGN`: the
    buffer, the event recorded after the copy (None on the CPU) and the
    offsets."""
    pieces, offsets, off = [], [], 0
    pad = torch.zeros(_ALIGN, dtype=torch.uint8, device=parts[0].device)
    for t in parts:
        offsets.append(off)
        pieces.append(t.reshape(-1).view(torch.uint8))
        off += pieces[-1].numel()
        if off % _ALIGN:
            pieces.append(pad[:-off % _ALIGN])
            off += pieces[-1].numel()
    buf = torch.cat(pieces)
    if not buf.is_cuda:
        return buf, None, offsets
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(buf.device))
    return buf, ev, offsets


class ResilientCheckpointer:
    """Train-loop API: ``save(step, state)`` (async) / ``save_sync`` /
    ``restore(template)`` / ``latest_valid()``. See module docstring."""

    #: the threads an async save hashes and writes on, beside the
    #: caller's training steps: one interfered least with GPT-2 124M's
    #: host-bound step (PERF.md §6)
    ASYNC_THREADS = 1

    def __init__(self, directory: str | os.PathLike, *, keep: int = 3,
                 fingerprint: Optional[int] = None,
                 plan: Optional[dict] = None):
        self.directory = os.fspath(os.path.abspath(directory))
        os.makedirs(self.directory, exist_ok=True)
        if keep < 1:
            raise ValueError("keep must be >= 1")
        self.keep = int(keep)
        self.fingerprint = fingerprint
        if plan is not None and (not isinstance(plan, dict)
                                 or plan.get("schema") != PLAN_SCHEMA):
            raise ValueError(
                f"plan= must be an {PLAN_SCHEMA} document")
        self.plan = plan
        self._q: queue.Queue = queue.Queue()
        # the memory bound: a slot is taken before the snapshot is built
        # and released after the worker dropped it, so at most two
        # snapshots coexist (a queue maxsize cannot give this: the third
        # save() would build its snapshot before put() blocks)
        self._slots = threading.Semaphore(2)
        self._errors: list = []
        self._lock = threading.Lock()
        #: per committed save: {"step", "copy_s", "write_s", "digest_s"}
        self.timings: list = []
        self._worker = threading.Thread(target=self._work, daemon=True)
        self._worker.start()

    # -- save path ---------------------------------------------------------

    def _snapshot(self, state):
        """A copy of every tensor (a DTensor's full tensor), each
        device's packed into one buffer (`_pack`), a CUDA one with an
        event recorded on the caller's current stream after it: the
        live tensors may be updated by the very next step. Returns the
        tree with a `_Slot` for each tensor, and the buffers."""
        parts: dict = {}

        def leaf(_p, x):
            if not isinstance(x, torch.Tensor):
                return x
            if hasattr(x, "full_tensor"):
                x = x.full_tensor()
            group = parts.setdefault(x.device, [])
            group.append(x.detach())
            return _Slot(x, len(group) - 1)

        tree = tree_map_with_path(leaf, state)
        return tree, {dev: _pack(group) for dev, group in parts.items()}

    def save(self, step: int, state: Any, *, meta: Optional[dict] = None,
             milestone: bool = False) -> None:
        """Queue an async snapshot of ``state`` at ``step``. Blocks only
        while two snapshots are outstanding. Background failures surface
        on the next save, wait or close. The write runs on at most
        `ASYNC_THREADS` threads beside the caller's steps."""
        self._enqueue(step, state, meta, milestone, self.ASYNC_THREADS)

    def _enqueue(self, step, state, meta, milestone, threads):
        self._raise_pending()
        self._slots.acquire()
        try:
            snap = self._snapshot(state)
            m = dict(meta or {})
            if milestone:
                m["milestone"] = True
            if self.plan is not None and "plan" not in m:
                m["plan"] = self.plan
            self._q.put((int(step), snap, m, threads))
        except BaseException:
            self._slots.release()
            raise

    def save_sync(self, step: int, state: Any, *,
                  meta: Optional[dict] = None,
                  milestone: bool = False) -> str:
        """Synchronous save (the preemption-grace path; the caller
        waits, so the write takes every thread `manifest.parallel_map`
        has): returns the committed checkpoint dir."""
        self._enqueue(step, state, meta, milestone, None)
        self.wait()
        return os.path.join(self.directory, step_dir_name(step))

    def wait(self) -> None:
        """Block until every queued save committed (or failed)."""
        self._q.join()
        self._raise_pending()

    def _raise_pending(self):
        with self._lock:
            if self._errors:
                err = self._errors[:]
                self._errors.clear()
                raise CheckpointError(
                    self.directory,
                    f"background save failed: {err[0]!r}") from err[0]

    def _work(self):
        while True:
            item = self._q.get()
            if item is None:
                self._q.task_done()
                return
            step, snap, meta, threads = item
            try:
                with parallel_cap(threads):
                    self._write_one(step, snap, meta)
            except BaseException as e:
                with self._lock:
                    self._errors.append(e)
            finally:
                del item, snap
                self._slots.release()
                self._q.task_done()

    @staticmethod
    def _to_host(snap):
        """The snapshot on the host, each leaf a view of its device's
        buffer. A CUDA buffer is copied into pinned memory on a side
        stream of its device that waits on the buffer's event (inside
        ``torch.cuda.device``: a new thread's current device is device
        0): one copy, which does not queue behind (or hold up) the
        training step's kernels on the caller's stream."""
        tree, bufs = snap
        host = {}
        for dev, (buf, event, offsets) in bufs.items():
            if event is not None:
                with torch.cuda.device(dev):
                    stream = torch.cuda.Stream(dev)
                    with torch.cuda.stream(stream):
                        stream.wait_event(event)
                        pinned = torch.empty(buf.numel(), dtype=torch.uint8,
                                             pin_memory=True)
                        pinned.copy_(buf, non_blocking=True)
                    stream.synchronize()
                buf = pinned
            host[dev] = (buf, offsets)

        def leaf(_p, x):
            if not isinstance(x, _Slot):
                return x
            buf, offsets = host[x.device]
            off = offsets[x.index]
            return buf[off:off + x.nbytes].view(x.dtype).view(x.shape)

        return tree_map_with_path(leaf, tree)

    def _write_one(self, step: int, snap, meta: dict):
        t0 = time.perf_counter()
        host = self._to_host(snap)
        copy_s = time.perf_counter() - t0
        split = write_step_dir(
            os.path.join(self.directory, step_dir_name(step)), host,
            step=step, fingerprint=self.fingerprint, meta=meta)
        self._promote_latest(step)
        self._gc()
        self.timings.append({"step": int(step), "copy_s": copy_s, **split})

    def _promote_latest(self, step: int):
        atomic_write_text(os.path.join(self.directory, _LATEST),
                          step_dir_name(step) + "\n")

    def _gc(self):
        dirs = _list_step_dirs(self.directory)
        if len(dirs) <= self.keep:
            return
        for _step, path in dirs[:-self.keep]:
            try:
                if read_manifest(path).meta.get("milestone"):
                    continue            # pinned outside the ring
            except IntegrityError:
                pass                    # corrupt/uncommitted: collectable
            shutil.rmtree(path, ignore_errors=True)

    # -- restore path ------------------------------------------------------

    def latest_valid(self) -> Optional[str]:
        return find_restorable(self.directory)

    def restore(self, template: Any, *, path: Optional[str] = None,
                expect_fingerprint: Optional[int] = None,
                allow_fingerprint_mismatch: bool = False
                ) -> Tuple[Any, Manifest]:
        """Restore the newest valid checkpoint (or ``path``) onto
        ``template``'s types and devices: verify the file manifest,
        enforce the layout and the program fingerprint, check the
        payload's leaves against the recorded leaf digests
        (`check_payload`), restore.
        Returns ``(state, manifest)``; ``manifest.step`` and
        ``manifest.meta`` carry the resume position."""
        if path is None:
            path = self.latest_valid()
            if path is None:
                raise CheckpointError(self.directory,
                                      "no valid checkpoint to restore")
        manifest = verify_files(path)
        if self.plan is not None:
            # the layout check first: a topology change flips the
            # fingerprint too, and "go through elastic resume" is the
            # actionable diagnosis
            ckpt_plan = manifest.meta.get("plan")
            if not isinstance(ckpt_plan, dict):
                raise LayoutMismatch(
                    path, "no plan meta: this checkpoint predates "
                    "plan-aware saves and cannot be layout-checked "
                    "against the current plan; restore it with a "
                    "plan-less checkpointer, or reshard it via "
                    "resilience.reshard_checkpoint")
            if plan_spec(ckpt_plan) != plan_spec(self.plan):
                raise LayoutMismatch(
                    path, f"checkpoint layout [{mesh_str(ckpt_plan)}] "
                    f"!= current plan [{mesh_str(self.plan)}] — the "
                    "mesh/schedule changed; resume through "
                    "resilience.elastic_resume (re-plan + "
                    "manifest-verified reshard), not an in-place "
                    "restore")
        want_fp = (expect_fingerprint if expect_fingerprint is not None
                   else self.fingerprint)
        if (want_fp is not None and manifest.fingerprint is not None
                and not allow_fingerprint_mismatch
                and int(manifest.fingerprint, 16) != int(want_fp)):
            raise CheckpointError(
                path, f"program fingerprint mismatch: checkpoint "
                f"{manifest.fingerprint}, current {int(want_fp):#x} — "
                "the program changed since this checkpoint was written; "
                "pass allow_fingerprint_mismatch=True to resume anyway")
        check_payload(path, manifest)
        state = restore_checkpoint(os.path.join(path, _STATE_SUBDIR),
                                   template=template)
        return state, manifest

    # -- lifecycle ---------------------------------------------------------

    def close(self) -> None:
        self.wait()
        self._q.put(None)
        self._worker.join(timeout=60.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
