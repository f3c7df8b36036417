"""Elastic resume (the port of ``apex1_tpu/resilience/elastic.py``):
find the newest restorable checkpoint, read its banked producing plan,
and hand the training loop the path and plan it resumes from, every
decision banked as an obs-spine event (`obs.spine.emit`, inert without
``APEX1_OBS_DIR``): ``elastic.detect`` (the device count, the
checkpoint, its step and data step, its banked layout) and
``elastic.resume`` (the path to restore, whether a reshard happened).

At the device count the checkpoint was written for, the resume is
plain (the source path, ``resharded=False``), the JAX package's branch
whole. Another count needs a fresh legal plan from the planner
(``planner.make_plan``), which the port has not yet: that branch and
the drill (`drill`) raise `NotImplementedError` naming ROADMAP.md queue
A item 11. A caller that has the target plan reshards with
`resilience.reshard_checkpoint` directly.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Callable, Optional

from apex1_tpu_torch.checkpoint import CheckpointError
from apex1_tpu_torch.resilience.checkpointer import find_restorable
from apex1_tpu_torch.resilience.manifest import Manifest, verify_files
from apex1_tpu_torch.resilience.reshard import mesh_str, plan_meta

_REPLAN = ("re-planning onto another device count needs the planner "
           "(planner.make_plan), which the port has not yet: ROADMAP.md "
           "queue A item 11")


@dataclasses.dataclass
class ElasticDecision:
    """What `elastic_resume` decided, with the evidence attached.
    ``path`` is the directory the loop should restore."""

    ckpt_dir: str
    source: str                 # the checkpoint that was found
    path: str                   # what to restore from
    old_plan: dict
    plan: dict                  # the plan the resumed loop should run
    resharded: bool
    step: int
    data_step: Optional[int]
    manifest: Manifest          # manifest of `path`
    report: Optional[dict]      # reshard report (None when not resharded)


def _device_count() -> int:
    """The surviving fleet: the process group's world size, else the
    visible CUDA devices (one at least)."""
    import torch
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return max(1, torch.cuda.device_count())


def elastic_resume(ckpt_dir: str | os.PathLike, *,
                   n_devices: Optional[int] = None,
                   make_template: Callable[[dict], Any],
                   generation: Optional[str] = None,
                   results_dir: Optional[str] = None,
                   out_root: Optional[str] = None,
                   planner_kw: Optional[dict] = None
                   ) -> ElasticDecision:
    """Find the newest restorable checkpoint under ``ckpt_dir`` and read
    its banked plan (a typed `LayoutMismatch` when absent). At the
    plan's own device count: a plain resume (``resharded=False``, the
    source path). At another: `NotImplementedError` naming ROADMAP.md
    queue A item 11 (the planner). ``n_devices`` defaults to the world
    size (`_device_count`); ``make_template``, ``generation``,
    ``results_dir``, ``out_root`` and ``planner_kw`` are the JAX
    signature's, read by the re-plan branch."""
    from apex1_tpu_torch.obs import spine

    ckpt_dir = os.fspath(ckpt_dir)
    if n_devices is None:
        n_devices = _device_count()
    src = find_restorable(ckpt_dir)
    if src is None:
        raise CheckpointError(ckpt_dir,
                              "no valid checkpoint to resume from")
    man = verify_files(src)
    old_plan = plan_meta(man, src)
    data_step = man.meta.get("data_step")
    spine.emit("event", "elastic.detect", n_devices=int(n_devices),
               ckpt=src, step=int(man.step), data_step=data_step,
               mesh=mesh_str(old_plan),
               banked_devices=old_plan.get("n_devices"))
    if int(old_plan.get("n_devices", -1)) != int(n_devices):
        raise NotImplementedError(
            f"elastic_resume: the checkpoint's plan [{mesh_str(old_plan)}]"
            f" ran on {old_plan.get('n_devices')} devices, this fleet has "
            f"{n_devices}; {_REPLAN}")
    spine.emit("event", "elastic.resume", resharded=False,
               path=src, mesh=mesh_str(old_plan),
               step=int(man.step), data_step=data_step)
    return ElasticDecision(
        ckpt_dir=ckpt_dir, source=src, path=src,
        old_plan=old_plan, plan=old_plan, resharded=False,
        step=int(man.step), data_step=data_step, manifest=man,
        report=None)


def drill(n_from: int = 8, n_to: Optional[int] = None, *,
          seed: int = 20260804, steps_total: int = 6,
          work_dir: Optional[str] = None, verbose: bool = True,
          subprocess_resume: bool = True) -> dict:
    """The JAX package's shrink drill (train, kill mid-run, re-plan onto
    fewer devices, reshard, resume against a control) re-plans through
    the planner: not yet in the port."""
    raise NotImplementedError(f"elastic.drill: {_REPLAN}")
