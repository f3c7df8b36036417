"""Process launcher (the port of ``apex1_tpu/parallel/multiproc.py``;
reference ``apex/parallel/multiproc.py``).

- `init_distributed` joins this process to the default process group:
  from the ``torchrun`` environment (``RANK``, ``WORLD_SIZE``,
  ``MASTER_ADDR``/``MASTER_PORT``, ``LOCAL_RANK``) or from an explicit
  ``init_method`` such as a ``file://`` rendezvous. NCCL is the
  default; with no CUDA device that raises unless the caller names
  gloo. The backend never changes on its own.
- `launch(fn, nprocs, *args, backend=...)` spawns ``nprocs`` local
  ranks that meet through a ``FileStore`` in a temporary directory (no
  TCP port, so concurrent launches never collide), runs ``fn(*args)``
  in each and returns the ranks' results to the parent, in rank order.
- `launch_script(script, args, num_processes=N)` runs N copies of a
  script, each with the ``torchrun`` environment (``RANK``,
  ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and a free
  ``MASTER_PORT``); the script calls `init_from_env`. ``python -m
  apex1_tpu_torch.parallel.multiproc --nproc N script.py [args]`` is
  its command line (the reference's ``apex.parallel.multiproc``).

Every wait is bounded: the process group's ``timeout`` bounds each
collective, and the parent stops waiting ``timeout`` seconds after the
last rank reported, terminates the ranks and raises, so a broken rank
fails its caller instead of hanging it.

A spawned rank re-imports the module that defines ``fn``: keep rank
bodies in a module that imports what the ranks need and no more.
"""

from __future__ import annotations

import datetime
import inspect
import multiprocessing
import os
import pickle
import queue
import shutil
import socket
import subprocess
import sys
import tempfile
import time
import traceback
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist

#: seconds a collective or a rendezvous may wait before it fails
DEFAULT_TIMEOUT = 60.0


def init_distributed(backend: Optional[str] = None, *,
                     init_method: Optional[str] = None,
                     rank: Optional[int] = None,
                     world_size: Optional[int] = None,
                     timeout: float = DEFAULT_TIMEOUT) -> None:
    """``torch.distributed.init_process_group`` for this process.

    Without ``init_method`` the ``torchrun`` environment names the rank,
    the world size and the rendezvous (``env://``). ``backend`` defaults
    to NCCL, which needs a CUDA device: this rank's is ``LOCAL_RANK``
    (else ``rank`` modulo the device count), made current. Pass
    ``backend="gloo"`` to run on the CPU."""
    backend = backend or "nccl"
    if init_method is None:
        init_method = "env://"
        rank = int(os.environ["RANK"]) if rank is None else rank
        world_size = (int(os.environ["WORLD_SIZE"]) if world_size is None
                      else world_size)
    if rank is None or world_size is None:
        raise ValueError("init_distributed: an explicit init_method needs "
                         "rank and world_size")
    kw = dict(backend=backend, init_method=init_method, rank=rank,
              world_size=world_size,
              timeout=datetime.timedelta(seconds=timeout))
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "init_distributed: NCCL needs a CUDA device and none is "
                "available; pass backend='gloo' to run on the CPU")
        local = int(os.environ.get("LOCAL_RANK",
                                   rank % torch.cuda.device_count()))
        torch.cuda.set_device(local)
        if "device_id" in inspect.signature(
                dist.init_process_group).parameters:
            # binds the group to the device (eager NCCL communicators)
            kw["device_id"] = torch.device("cuda", local)
    dist.init_process_group(**kw)


def _rank_main(rank, nprocs, store, backend, timeout, fn, args, out):
    """A spawned rank: join the group, run ``fn(*args)``, report
    ``(rank, ok, pickled result or traceback)``."""
    try:
        init_distributed(backend, init_method=f"file://{store}", rank=rank,
                         world_size=nprocs, timeout=timeout)
        try:
            result = fn(*args)
        finally:
            dist.destroy_process_group()
        out.put((rank, True, pickle.dumps(result)))
    except BaseException:
        out.put((rank, False, traceback.format_exc()))
        raise


def launch(fn: Callable, nprocs: int, *args, backend: str = "nccl",
           timeout: float = DEFAULT_TIMEOUT) -> list:
    """Run ``fn(*args)`` in ``nprocs`` spawned ranks of one process group
    and return their results in rank order (``fn`` and ``args`` are
    pickled by import path and value; so is each result). A rank that
    raises, dies or stays silent for ``timeout`` seconds after the last
    report fails the launch with a ``RuntimeError`` that carries the
    ranks' tracebacks; every rank is ended before it returns."""
    if nprocs < 1:
        raise ValueError(f"nprocs must be >= 1, got {nprocs}")
    ctx = multiprocessing.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="apex1_launch_")
    out = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, nprocs, os.path.join(tmp, "store"),
                               backend, timeout, fn, args, out))
             for r in range(nprocs)]
    results, errors = {}, {}
    try:
        for p in procs:
            p.start()
        deadline, grace = time.monotonic() + timeout, None
        while len(results) + len(errors) < nprocs:
            now = time.monotonic()
            if now > deadline or (grace is not None and now > grace):
                break
            try:
                rank, ok, payload = out.get(timeout=0.2)
            except queue.Empty:
                for r, p in enumerate(procs):
                    if (p.exitcode not in (None, 0) and r not in results
                            and r not in errors):
                        errors[r] = (f"rank {r} exited with code "
                                     f"{p.exitcode} and no report")
            else:
                (results if ok else errors)[rank] = payload
                deadline = time.monotonic() + timeout
            if errors and grace is None:
                # the other ranks may wait on the failed one in a
                # collective: collect what reports come, then stop
                grace = time.monotonic() + 2.0
    finally:
        for p in procs:
            p.join(timeout=5 if not errors else 1)
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=5)
        out.close()
        shutil.rmtree(tmp, ignore_errors=True)
    if len(results) < nprocs:
        missing = [r for r in range(nprocs) if r not in results]
        detail = "\n".join(f"-- rank {r}:\n{errors.get(r, 'no report')}"
                           for r in missing)
        raise RuntimeError(f"launch: ranks {missing} of {nprocs} failed:\n"
                           f"{detail}")
    return [pickle.loads(results[r]) for r in range(nprocs)]


def init_from_env(backend: Optional[str] = None, *,
                  timeout: float = DEFAULT_TIMEOUT) -> None:
    """A script's side of `launch_script` (or of ``torchrun``):
    `init_distributed` on the ``RANK``/``WORLD_SIZE``/``MASTER_ADDR``/
    ``MASTER_PORT`` environment; ``backend`` as there (NCCL by
    default)."""
    init_distributed(backend, timeout=timeout)


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


#: seconds `launch_script` leaves the other ranks once one has failed
FAILURE_GRACE_S = 10.0


def launch_script(script: str, args: Sequence[str] = (), *,
                  num_processes: int = 2) -> int:
    """Run ``num_processes`` copies of ``python script *args``, rank r
    with ``RANK=r``, ``LOCAL_RANK=r``, ``WORLD_SIZE``, ``MASTER_ADDR``
    (127.0.0.1) and a free ``MASTER_PORT``. Returns the first non-zero
    exit code, or 0: once a rank fails, the others get
    `FAILURE_GRACE_S` seconds (they may be failing with it) and are then
    terminated, since a survivor may wait on the dead rank in a
    collective forever."""
    if num_processes < 1:
        raise ValueError(f"num_processes must be >= 1, got {num_processes}")
    port = str(_free_port())
    procs = []
    for rank in range(num_processes):
        child = dict(os.environ)
        child.update(RANK=str(rank), LOCAL_RANK=str(rank),
                     WORLD_SIZE=str(num_processes), MASTER_ADDR="127.0.0.1",
                     MASTER_PORT=port)
        procs.append(subprocess.Popen([sys.executable, script, *args],
                                      env=child))
    first_bad = 0
    try:
        while procs:
            alive = []
            for p in procs:
                code = p.poll()
                if code is None:
                    alive.append(p)
                elif code and not first_bad:
                    first_bad = code
            procs = alive
            if first_bad and procs:
                deadline = time.monotonic() + FAILURE_GRACE_S
                while procs and time.monotonic() < deadline:
                    procs = [p for p in procs if p.poll() is None]
                    time.sleep(0.1)
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            p.terminate()
        for p in procs:
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
    return first_bad


def main(argv: Optional[Sequence[str]] = None) -> int:
    """``python -m apex1_tpu_torch.parallel.multiproc [--nproc N]
    script.py [args...]``: `launch_script` (2 processes by default)."""
    argv = list(sys.argv[1:] if argv is None else argv)
    nproc = 2
    if argv[:1] == ["--nproc"]:
        nproc, argv = int(argv[1]), argv[2:]
    if not argv:
        print("usage: python -m apex1_tpu_torch.parallel.multiproc "
              "[--nproc N] script.py [args...]", file=sys.stderr)
        return 2
    return launch_script(argv[0], argv[1:], num_processes=nproc)


if __name__ == "__main__":
    sys.exit(main())
