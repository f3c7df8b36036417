"""What the examples share: joining the ranks an example runs under, and
the per-step record of a training loop."""

from __future__ import annotations

import os
import time

import torch
import torch.distributed as dist

from apex1_tpu_torch.parallel.multiproc import init_from_env
from apex1_tpu_torch.transformer import parallel_state


def join_ranks(device: torch.device):
    """``(rank, world, opened)``: join the ranks `multiproc` launched
    (``WORLD_SIZE`` set) unless a group exists, and install
    `parallel_state`'s mesh over it; one process alone is rank 0 of 1."""
    opened = []
    if not dist.is_initialized() and "WORLD_SIZE" in os.environ:
        init_from_env("nccl" if device.type == "cuda" else "gloo")
        opened.append("group")
    if not dist.is_initialized():
        return 0, 1, opened
    if not parallel_state.model_parallel_is_initialized():
        parallel_state.initialize_model_parallel(1)
        opened.append("mesh")
    return dist.get_rank(), dist.get_world_size(), opened


def leave_ranks(opened: list) -> None:
    if "mesh" in opened:
        parallel_state.destroy_model_parallel()
    if "group" in opened:
        dist.destroy_process_group()


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
