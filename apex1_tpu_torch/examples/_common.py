"""What the examples share: joining the ranks an example runs under, and
the per-step record of a training loop."""

from __future__ import annotations

import os
import shutil
import tempfile
import time

import torch
import torch.distributed as dist

from apex1_tpu_torch.parallel.multiproc import init_from_env
from apex1_tpu_torch.transformer import parallel_state


def join_ranks(device: torch.device, *, alone: bool = False,
               mesh: bool = True, **degrees):
    """``(rank, world, opened)``: join the ranks `multiproc` launched
    (``WORLD_SIZE`` set) unless a group exists, and install
    `parallel_state`'s mesh over it (``degrees``: the keywords of
    `parallel_state.initialize_model_parallel`, data parallel over the
    rest) unless one is installed or ``mesh`` is False (`install_mesh`
    later, once the degrees are known). One process alone is rank 0 of
    1, in no group, or with ``alone`` in a one-rank group of its own (a
    file rendezvous in a temporary directory) for code that needs a
    mesh."""
    backend = "nccl" if device.type == "cuda" else "gloo"
    opened = []
    if not dist.is_initialized() and "WORLD_SIZE" in os.environ:
        init_from_env(backend)
        opened.append("group")
    elif not dist.is_initialized() and alone:
        from apex1_tpu_torch.parallel import init_distributed
        tmp = tempfile.mkdtemp(prefix="apex1_rank_")
        init_distributed(backend, init_method=f"file://{tmp}/store", rank=0,
                         world_size=1)
        opened += ["group", ("store", tmp)]
    if not dist.is_initialized():
        return 0, 1, opened
    if mesh:
        install_mesh(opened, **degrees)
    return dist.get_rank(), dist.get_world_size(), opened


def install_mesh(opened: list, **degrees) -> None:
    """`parallel_state`'s mesh at ``degrees`` unless one is installed;
    noted in ``opened`` for `leave_ranks`."""
    if not parallel_state.model_parallel_is_initialized():
        parallel_state.initialize_model_parallel(**degrees)
        opened.append("mesh")


def leave_ranks(opened: list) -> None:
    if "mesh" in opened:
        parallel_state.destroy_model_parallel()
    if "group" in opened:
        dist.destroy_process_group()
    for entry in opened:
        if isinstance(entry, tuple):        # ("store", its directory)
            shutil.rmtree(entry[1], ignore_errors=True)


class StepRecord:
    """Each step's loss (kept on the device until the end) and the time
    its step ended, after a synchronize of the device."""

    def __init__(self, device: torch.device):
        self.device = device
        self.losses: list = []
        self.ends: list = [time.perf_counter()]

    def __call__(self, metrics: dict) -> None:
        self.losses.append(metrics["loss"].detach())
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.ends.append(time.perf_counter())

    def result(self) -> dict:
        """``{"losses": [float], "step_ms": [ms from the previous
        step's end (or the record's start) to this step's end]}``."""
        return {"losses": [float(x) for x in self.losses],
                "step_ms": [(b - a) * 1e3
                            for a, b in zip(self.ends, self.ends[1:])]}
