"""Elastic resume (the port of ``apex1_tpu/resilience/elastic.py``):
survive a changed device count by re-planning on purpose. Detect the
surviving device count, ask the planner (`planner.make_plan`) for a
fresh legal layout, reshard the newest restorable checkpoint onto it
(`resilience.reshard`, manifest-verified end to end), and hand the
training loop the plan and the path it resumes from.

Every decision is banked as an obs-spine event (`obs.spine.emit`, inert
without ``APEX1_OBS_DIR``), so an episode is reconstructable from the
events alone:

- ``elastic.detect``: the device count, the checkpoint, its step and
  data step, its banked layout;
- ``elastic.replan``: the old and new layout specs (`planner.plan_spec`),
  the search size, the calibrated price of the pick, and the generation
  it was priced at with where that came from (the checkpoint's plan
  when it names a row of the port's table, else the detected card: a
  checkpoint the JAX package wrote banks a TPU's generation);
- ``elastic.reshard``: leaf counts by remap class, the output path;
- ``elastic.verify``: the digest and conservation verdicts;
- ``elastic.resume``: the path to restore, whether a reshard happened.

THE DRILL (`drill`, ``python -m apex1_tpu_torch.resilience.elastic
--drill``): train a tiny `models.llama_3d` on ``n_from`` gloo ranks of
the CPU (`parallel.launch`), kill it after a seed-keyed number of
committed checkpoints (`testing.chaos.shrink_schedule`), then resume in
FRESH processes that make up ``n_to`` devices (gloo ranks of the CPU, or
one process on the card when one is present and ``n_to`` is 1) through
`elastic_resume`, and run a CONTROL there: a second reshard of the same
checkpoint (the same leaf digests: the determinism pin) restored and
trained on the same data. The elastic leg's losses and final params must
equal the control's bit for bit, and the episode is rebuilt in the
parent from the five spine events alone.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Callable, Optional

from apex1_tpu_torch.checkpoint import CheckpointError
from apex1_tpu_torch.resilience.checkpointer import (find_restorable,
                                                     step_dir_name)
from apex1_tpu_torch.resilience.manifest import Manifest, verify_files
from apex1_tpu_torch.resilience.reshard import (mesh_str, plan_meta,
                                                reshard_checkpoint)

#: the spine events one resharded episode banks, in order
EPISODE_EVENTS = ("elastic.detect", "elastic.replan", "elastic.reshard",
                  "elastic.verify", "elastic.resume")


@dataclasses.dataclass
class ElasticDecision:
    """What `elastic_resume` decided, with the evidence attached.
    ``path`` is the directory the loop should restore (the resharded
    checkpoint, or the source itself when no reshard was needed)."""

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


def _replan_generation(old_plan: dict, generation: Optional[str]):
    """(generation, where it came from) for a re-plan."""
    from apex1_tpu_torch.core.capability import (default_generation,
                                                 known_generation)
    if generation:
        return generation, "stated by the caller"
    banked = old_plan.get("generation")
    if known_generation(banked):
        return banked, "the checkpoint's plan"
    return default_generation(), (f"the detected card (the checkpoint's "
                                  f"plan banks {banked!r}, no row of the "
                                  f"port's table)")


def elastic_resume(ckpt_dir: str | os.PathLike, *,
                   n_devices: Optional[int] = None,
                   make_template: Callable[[dict], Any],
                   generation: Optional[str] = None,
                   results_dir: Optional[str] = None,
                   out_root: Optional[str] = None,
                   planner_kw: Optional[dict] = None
                   ) -> ElasticDecision:
    """Find the newest restorable checkpoint under ``ckpt_dir``, read its
    banked plan (a typed `LayoutMismatch` when absent), and:

    - at the plan's own device count: a plain resume
      (``resharded=False``, the source path);
    - at another: ``planner.make_plan(shape, n_devices)`` for a fresh
      legal plan, then a manifest-verified reshard onto it.

    ``make_template(plan)`` builds the SOURCE plan's global state
    template (`models.llama_3d.global_state_template` of the plan's
    config: mesh-free, so it works on the shrunken fleet).
    ``n_devices`` defaults to the world size (`_device_count`).
    ``planner_kw`` forwards to ``make_plan``; ``require_zero`` defaults
    to the source plan's zero setting, because flipping it changes the
    optimizer state's structure, which the reshard refuses.
    ``generation`` defaults as `_replan_generation` says."""
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

    if int(old_plan.get("n_devices", -1)) == int(n_devices):
        spine.emit("event", "elastic.resume", resharded=False,
                   path=src, mesh=mesh_str(old_plan),
                   step=int(man.step), data_step=data_step)
        return ElasticDecision(
            ckpt_dir=ckpt_dir, source=src, path=src,
            old_plan=old_plan, plan=old_plan, resharded=False,
            step=int(man.step), data_step=data_step, manifest=man,
            report=None)

    from apex1_tpu_torch import planner

    shape = planner.model_shape_from_plan(old_plan)
    kw = dict(planner_kw or {})
    kw.setdefault("require_zero",
                  bool(old_plan.get("zero", {}).get("enabled")))
    gen, gen_source = _replan_generation(old_plan, generation)
    new_plan = planner.make_plan(shape, int(n_devices), generation=gen,
                                 results_dir=results_dir, **kw)
    spine.emit("event", "elastic.replan",
               old_mesh=mesh_str(old_plan), new_mesh=mesh_str(new_plan),
               old_spec=planner.plan_spec(old_plan),
               new_spec=planner.plan_spec(new_plan),
               n_enumerated=new_plan["search"]["n_enumerated"],
               calibrated_step_ms=new_plan["predicted"]
               ["calibrated_step_ms"],
               generation=gen, generation_source=gen_source)

    root = out_root or os.path.join(ckpt_dir, "elastic")
    out_dir = os.path.join(
        root, f"{step_dir_name(man.step)}_to{int(n_devices)}dev")
    out_path, new_man, report = reshard_checkpoint(
        src, make_template(old_plan), new_plan, out_dir, manifest=man)
    spine.emit("event", "elastic.reshard", src=src, out=out_path,
               n_leaves=report["n_leaves"],
               n_restacked=report["n_restacked"],
               n_repacked=report["n_repacked"],
               n_copied=report["n_copied"],
               stack_from=report["stack_from"],
               stack_to=report["stack_to"])
    spine.emit("event", "elastic.verify", path=out_path,
               source_verified=True, files_verified=True,
               conserved=report["conserved"],
               n_conservation_checks=report["n_checks"],
               n_tree_digests=len(new_man.tree))
    spine.emit("event", "elastic.resume", resharded=True,
               path=out_path, mesh=mesh_str(new_plan),
               step=int(new_man.step), data_step=data_step)
    return ElasticDecision(
        ckpt_dir=ckpt_dir, source=src, path=out_path,
        old_plan=old_plan, plan=new_plan, resharded=True,
        step=int(new_man.step), data_step=data_step, manifest=new_man,
        report=report)


# -- the acceptance drill ----------------------------------------------------

#: the drill model's dims (the JAX package's drill's)
DRILL_DIMS = dict(num_layers=4, hidden_size=64, ffn_size=128, num_heads=4,
                  num_kv_heads=2, vocab_size=128, seq_len=32)


def _drill_fixture(seed: int, level: str = "O2"):
    """The drill's model and config constants, shared by every side of
    the process boundaries, so they provably describe the same job.
    Returns ``(shape, cfg_of, make_template, batch_at)``."""
    import numpy as np
    import torch

    from apex1_tpu_torch import planner
    from apex1_tpu_torch.core.policy import get_policy
    from apex1_tpu_torch.models import llama_3d as L3
    from apex1_tpu_torch.models.llama import LlamaConfig

    d = DRILL_DIMS
    shape = planner.ModelShape(
        name="elastic-drill", head_dim=d["hidden_size"] // d["num_heads"],
        global_batch=8, **d)
    mcfg = LlamaConfig.tiny(
        num_layers=d["num_layers"], max_seq_len=d["seq_len"],
        vocab_size=d["vocab_size"], num_heads=d["num_heads"],
        num_kv_heads=d["num_kv_heads"], hidden_size=d["hidden_size"],
        ffn_size=d["ffn_size"], policy=get_policy(level))

    def cfg_of(plan):
        return planner.llama3d_config_from_plan(plan, mcfg,
                                                learning_rate=3e-3,
                                                ignore_zero=True)

    def make_template(plan):
        return L3.global_state_template(cfg_of(plan), device="meta")

    def batch_at(i, cfg, device):
        # a canonical (global_batch, seq) draw regrouped by the layout's
        # (M, B) factorization (sequence g = m*B + b), so the layouts
        # before the kill and after the reshard train the SAME sequences
        # at step i
        rng = np.random.default_rng([seed, i])
        cols = cfg.microbatch_size * cfg.dp * cfg.ep
        canon = rng.integers(0, d["vocab_size"],
                             (cfg.num_microbatches * cols, d["seq_len"]))
        toks = torch.from_numpy(np.ascontiguousarray(
            canon.reshape(cfg.num_microbatches, cols,
                          d["seq_len"]).transpose(0, 2, 1))).to(device)
        return toks, torch.roll(toks, -1, dims=1)

    return shape, cfg_of, make_template, batch_at


def _mesh_of(cfg):
    from apex1_tpu_torch.core.mesh import make_mesh
    return make_mesh(dp=cfg.dp, pp=cfg.pp, cp=cfg.cp, ep=cfg.ep, tp=cfg.tp)


def _train_leg(plan_a: dict, ckpt_dir: str, seed: int, steps_total: int,
               kill_step: int, level: str) -> dict:
    """Phase 1, one rank of the ``n_from`` gloo ranks: train
    ``steps_total`` steps under ``plan_a`` from `init_params(cfg, 0)`,
    rank 0 committing the global state (`gather_state`) after each of
    the first ``kill_step`` steps; what comes after is lost."""
    import torch
    import torch.distributed as dist

    from apex1_tpu_torch.models import llama_3d as L3
    from apex1_tpu_torch.resilience.checkpointer import ResilientCheckpointer

    torch.set_num_threads(1)
    _shape, cfg_of, _template, batch_at = _drill_fixture(seed, level)
    cfg = cfg_of(plan_a)
    mesh = _mesh_of(cfg)
    step, state, _ = L3.make_train_step(cfg, mesh, device="cpu", seed=0)
    ck = (ResilientCheckpointer(ckpt_dir, keep=8, plan=plan_a)
          if dist.get_rank() == 0 else None)
    losses = []
    try:
        for i in range(steps_total):
            state, loss = step(state, *batch_at(i, cfg, "cpu"))
            losses.append(float(loss))
            if i < kill_step:
                g = L3.gather_state(cfg, state, mesh)  # on every rank
                if ck is not None:
                    ck.save(int(state["step"]), g,
                            meta={"data_step": i + 1})
    finally:
        if ck is not None:
            ck.close()
    return {"losses": losses}


def _resume_leg(ckpt_dir: str, work: str, n_to: int, seed: int,
                steps_total: int, level: str = "O2",
                device: str = "cpu", verbose: bool = True) -> dict:
    """Phases 2 and 3, one rank of the ``n_to`` fleet (its own process):
    rank 0 runs `elastic_resume` (re-plan and reshard) and hands the
    decision to the others; every rank restores the resharded checkpoint
    and trains to ``steps_total``. Then the CONTROL: rank 0 reshards the
    same source again (the leaf digests must be the same), every rank
    restores that and trains the same steps; losses and final params
    must equal the elastic leg's bit for bit. Returns the leg's facts
    for the parent to hold against the spine events."""
    import torch
    import torch.distributed as dist

    from apex1_tpu_torch.checkpoint import restore_checkpoint
    from apex1_tpu_torch.models import llama_3d as L3
    from apex1_tpu_torch.resilience.checkpointer import ResilientCheckpointer
    from apex1_tpu_torch.resilience.manifest import tree_entries, verify_tree

    rank, world = dist.get_rank(), dist.get_world_size()
    dev = torch.device(device)
    if dev.type == "cpu" and world > 1:
        torch.set_num_threads(1)

    def say(msg):
        if verbose and rank == 0:
            print(f"[elastic drill] {msg}", flush=True)

    _shape, cfg_of, make_template, batch_at = _drill_fixture(seed, level)
    box = [None]
    if rank == 0:
        decision = elastic_resume(ckpt_dir, n_devices=n_to,
                                  make_template=make_template,
                                  planner_kw={"allow_zero": False})
        if not decision.resharded:
            raise AssertionError("drill expected a layout change; got a "
                                 "same-layout resume")
        box = [dict(path=decision.path, source=decision.source,
                    plan=decision.plan, old_plan=decision.old_plan,
                    report=decision.report,
                    digests=[(e["path"], e["sha256"])
                             for e in decision.manifest.tree])]
    if world > 1:
        dist.broadcast_object_list(box, src=0)
    dec = box[0]
    plan_a, plan_b = dec["old_plan"], dec["plan"]
    cfg_b = cfg_of(plan_b)
    mesh_b = _mesh_of(cfg_b)
    step_b, _ = L3.build_step(cfg_b, mesh_b)

    def run(state, start):
        losses = []
        for i in range(start, steps_total):
            state, loss = step_b(state, *batch_at(i, cfg_b, dev))
            losses.append(float(loss))
            yield state, i, losses

    ck_b = ResilientCheckpointer(ckpt_dir, keep=8, plan=plan_b)
    try:
        g, man_e = ck_b.restore(L3.global_state_template(cfg_b, dev),
                                path=dec["path"])
        start = int(man_e.meta["data_step"])
        say(f"phase 2: elastic resume {mesh_str(plan_a)} -> "
            f"{mesh_str(plan_b)} at data step {start} "
            f"({dec['report']['n_restacked']} restacked / "
            f"{dec['report']['n_copied']} copied leaves, all "
            f"digest-verified) on {world} x {dev.type}")
        state_e, losses_e = L3.local_state(cfg_b, g, mesh_b), []
        for state_e, i, losses_e in run(state_e, start):
            g = L3.gather_state(cfg_b, state_e, mesh_b)
            if rank == 0:
                ck_b.save(int(state_e["step"]), g,
                          meta={"data_step": i + 1})
    finally:
        ck_b.close()

    # -- the CONTROL: an independent second reshard of the same source --
    out2 = os.path.join(work, "control_reshard")
    if rank == 0:
        _out, man_c, _rep = reshard_checkpoint(
            dec["source"], make_template(plan_a), plan_b, out2)
        if [(e["path"], e["sha256"]) for e in man_c.tree] \
                != [tuple(x) for x in dec["digests"]]:
            raise AssertionError(
                "reshard is not deterministic: two reshards of the same "
                "(checkpoint, target plan) gave different leaf digests")
    if world > 1:
        dist.barrier()
    man_c = verify_files(out2)
    g_c = restore_checkpoint(os.path.join(out2, "state"),
                             template=L3.global_state_template(cfg_b, dev))
    verify_tree(out2, g_c, man_c)
    state_c, losses_c = L3.local_state(cfg_b, g_c, mesh_b), []
    for state_c, _i, losses_c in run(state_c, start):
        pass

    if losses_e != losses_c:
        raise AssertionError(f"elastic loss trajectory diverged from the "
                             f"control: {losses_e} != {losses_c}")
    pe = tree_entries(L3.gather_state(cfg_b, state_e, mesh_b)["params"])
    pc = tree_entries(L3.gather_state(cfg_b, state_c, mesh_b)["params"])
    if pe != pc:
        raise AssertionError("final params differ between the elastic "
                             "leg and the control")
    say(f"bit-exact: {len(losses_e)} resumed steps match the control "
        f"(losses {['%.4f' % v for v in losses_e]})")
    return {"data_step": start, "n_to": n_to,
            "old_mesh": mesh_str(plan_a), "new_mesh": mesh_str(plan_b),
            "plan": plan_b, "losses": losses_e, "losses_control": losses_c,
            "n_leaves": dec["report"]["n_leaves"],
            "n_restacked": dec["report"]["n_restacked"],
            "conserved": dec["report"]["conserved"],
            "n_tree_digests": len(dec["digests"]), "path": dec["path"],
            "device": dev.type, "world": world}


def _alone(device: str, fn, *args):
    """``fn(*args)`` in this process as rank 0 of a one-rank group of its
    own (NCCL on the card, gloo on the CPU)."""
    import shutil
    import tempfile

    import torch
    import torch.distributed as dist

    from apex1_tpu_torch.parallel import init_distributed

    dev = torch.device(device)
    tmp = tempfile.mkdtemp(prefix="apex1_elastic_")
    if dev.type == "cuda":
        torch.cuda.set_device(dev.index or 0)
    init_distributed("nccl" if dev.type == "cuda" else "gloo",
                     init_method=f"file://{tmp}/store", rank=0,
                     world_size=1)
    try:
        return fn(*args)
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)


def drill(n_from: int = 8, n_to: Optional[int] = None, *,
          seed: int = 20260804, steps_total: int = 6,
          work_dir: Optional[str] = None, verbose: bool = True,
          device: Optional[str] = None, level: str = "O2") -> dict:
    """The elastic acceptance drill (module docstring). Phase 1 trains on
    ``n_from`` gloo ranks of the CPU and dies mid-run; phases 2 and 3 run
    in fresh processes making up ``n_to`` devices: ``n_to`` gloo ranks of
    the CPU, or with ``n_to`` 1 one process on ``device`` (the card when
    one is present, else the CPU). ``level`` is the precision policy
    (the JAX drill's O2). Raises ``AssertionError`` naming the broken
    property; returns the episode summary on success."""
    import contextlib
    import json
    import subprocess
    import sys
    import tempfile
    import time

    import torch

    from apex1_tpu_torch import planner
    from apex1_tpu_torch.obs import spine
    from apex1_tpu_torch.parallel import launch
    from apex1_tpu_torch.testing import chaos

    def say(msg):
        if verbose:
            print(f"[elastic drill] {msg}", flush=True)

    kill_step, auto_to = chaos.shrink_schedule(
        seed, n_devices=n_from, lo=2, hi=max(3, steps_total - 1))
    n_to = n_to or auto_to
    if device is None:
        device = "cuda" if (n_to == 1 and torch.cuda.is_available()) \
            else "cpu"
    if n_to > 1 and torch.device(device).type != "cpu":
        raise ValueError(f"a resume leg of {n_to} devices runs as gloo "
                         f"ranks of the CPU, not on {device}")

    shape, _cfg_of, _template, _batch = _drill_fixture(seed, level)
    if n_from == 8:
        # stated dp2 pp2 tp2 with an INTERLEAVED stack (num_chunks=2):
        # the planner never searches num_chunks > 1, so any re-plan
        # lands on chunks=1 and the resume exercises a real restack
        plan_a = planner.plan_for_layout(
            shape, planner.Layout(dp=2, pp=2, tp=2, num_microbatches=4,
                                  num_chunks=2))
    else:
        plan_a = planner.make_plan(shape, n_from, allow_zero=False)

    with contextlib.ExitStack() as stack:
        work = work_dir or stack.enter_context(
            tempfile.TemporaryDirectory(prefix="elastic_drill_"))
        obs_dir = os.path.join(work, "obs")
        old_env = os.environ.get("APEX1_OBS_DIR")
        os.environ["APEX1_OBS_DIR"] = obs_dir
        stack.callback(lambda: (
            os.environ.__setitem__("APEX1_OBS_DIR", old_env)
            if old_env is not None
            else os.environ.pop("APEX1_OBS_DIR", None)))
        ckdir = os.path.join(work, "ckpt")

        # -- phase 1: train on n_from ranks, die mid-run ---------------
        say(f"phase 1: {mesh_str(plan_a)} on {n_from} gloo ranks — "
            f"{steps_total} steps, kill after {kill_step} committed saves")
        t0 = time.perf_counter()
        first = launch(_train_leg, n_from, plan_a, ckdir, seed,
                       steps_total, kill_step, level, backend="gloo",
                       timeout=600)[0]
        t1 = time.perf_counter()

        # -- phases 2 and 3: the changed fleet, in fresh processes ------
        if n_to > 1:
            leg = launch(_resume_leg, n_to, ckdir, work, n_to, seed,
                         steps_total, level, "cpu", verbose,
                         backend="gloo", timeout=600)[0]
        else:
            repo = os.path.dirname(os.path.dirname(os.path.dirname(
                os.path.abspath(__file__))))
            out_json = os.path.join(work, "resume_leg.json")
            env = dict(os.environ, APEX1_OBS_DIR=obs_dir)
            env["PYTHONPATH"] = repo + os.pathsep + env.get(
                "PYTHONPATH", "")
            cmd = [sys.executable, "-m", "apex1_tpu_torch.resilience."
                   "elastic", "--resume-leg", "--ckpt-dir", ckdir,
                   "--work", work, "--to-devices", "1", "--seed",
                   str(seed), "--steps", str(steps_total), "--level",
                   level, "--device", device, "--out-json", out_json]
            r = subprocess.run(cmd, env=env, cwd=repo, capture_output=True,
                               text=True, timeout=600)
            if verbose:
                for line in r.stdout.splitlines():
                    if line.startswith("[elastic drill]"):
                        print(line, flush=True)
            if r.returncode != 0:
                raise AssertionError(
                    f"resume leg failed (rc={r.returncode}):\n"
                    f"{r.stdout[-2000:]}\n{r.stderr[-2000:]}")
            with open(out_json) as f:
                leg = json.load(f)

        t2 = time.perf_counter()
        say(f"phase 1 took {t1 - t0:.1f} s, phases 2 and 3 {t2 - t1:.1f} s "
            f"(process starts included)")
        if int(leg["data_step"]) != kill_step:
            raise AssertionError(f"resumed at data step {leg['data_step']}"
                                 f", the kill was after {kill_step}")
        if n_from == 8 and not leg["n_restacked"]:
            raise AssertionError("the 8-device drill must restack")
        if not leg["losses"]:
            raise AssertionError("no resumed step ran")

        # -- phase 4: the episode from the banked events alone ---------
        events = []
        for name in sorted(os.listdir(obs_dir)):
            if name.endswith(".jsonl"):
                events += spine.read_events(os.path.join(obs_dir, name))
        ev = {e["name"]: e for e in events
              if str(e.get("name", "")).startswith("elastic.")}
        for need in EPISODE_EVENTS:
            if need not in ev:
                raise AssertionError(f"episode not reconstructable: {need}"
                                     f" missing from the spine")
        checks = {
            "detect n_devices": ev["elastic.detect"]["n_devices"] == n_to,
            "detect data_step":
                ev["elastic.detect"]["data_step"] == kill_step,
            "replan old_mesh": ev["elastic.replan"]["old_mesh"]
                == mesh_str(plan_a) == leg["old_mesh"],
            "replan new_mesh":
                ev["elastic.replan"]["new_mesh"] == leg["new_mesh"],
            "reshard n_leaves":
                ev["elastic.reshard"]["n_leaves"] == leg["n_tree_digests"],
            "verify conserved": ev["elastic.verify"]["conserved"] is True,
            "resume path": ev["elastic.resume"]["path"] == leg["path"]}
        bad = [k for k, ok in checks.items() if not ok]
        if bad:
            raise AssertionError(f"the spine's episode disagrees with the "
                                 f"leg: {bad}")
        say("episode reconstructed from banked obs-spine events alone "
            "(detect -> replan -> reshard -> verify -> resume)")
        return {"kill_step": kill_step, "n_from": n_from, "n_to": n_to,
                "plan_from": plan_a, "plan_to": leg["plan"],
                "old_mesh": leg["old_mesh"], "new_mesh": leg["new_mesh"],
                "losses_from": first["losses"], "losses": leg["losses"],
                "losses_control": leg["losses_control"],
                "n_leaves": leg["n_leaves"],
                "n_restacked": leg["n_restacked"],
                "conserved": leg["conserved"], "device": leg["device"],
                "launches": leg.get("launches", {}),
                "events": sorted(ev),
                "replan_event": ev["elastic.replan"],
                "seconds": {"train_leg": t1 - t0, "resume_leg": t2 - t1}}


def main(argv=None) -> int:
    import argparse
    import json

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--drill", action="store_true",
                    help="run the elastic acceptance drill: gloo ranks "
                         "of the CPU, then the resume leg")
    ap.add_argument("--from-devices", type=int, default=8)
    ap.add_argument("--to-devices", type=int, default=None)
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--seed", type=int, default=20260804)
    ap.add_argument("--level", default="O2",
                    help="the drill model's precision policy")
    ap.add_argument("--device", default=None,
                    help="the one-device resume leg's device (default: "
                         "the card when present, else the CPU)")
    # internal: the changed fleet's one-process leg (spawned by drill)
    ap.add_argument("--resume-leg", action="store_true",
                    help=argparse.SUPPRESS)
    ap.add_argument("--ckpt-dir", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--work", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--out-json", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    if args.resume_leg:
        from apex1_tpu_torch import ops
        from apex1_tpu_torch.resilience.manifest import atomic_write_json

        ops.reset_launches()
        leg = _alone(args.device or "cpu", _resume_leg, args.ckpt_dir,
                     args.work, args.to_devices, args.seed, args.steps,
                     args.level, args.device or "cpu")
        # the kernels the resumed and the control steps launched
        leg["launches"] = {k: v for k, v in ops.launch_counts().items()
                           if v}
        atomic_write_json(args.out_json, leg)
        return 0
    if not args.drill:
        ap.print_help()
        return 0
    res = drill(args.from_devices, args.to_devices, seed=args.seed,
                steps_total=args.steps, device=args.device,
                level=args.level)
    print(f"elastic drill OK: {res['old_mesh']} -> {res['new_mesh']} "
          f"(killed after step {res['kill_step']}, "
          f"{res['n_restacked']}/{res['n_leaves']} leaves restacked, "
          f"{len(res['losses'])} resumed steps bit-exact vs control on "
          f"{res['device']}, episode reconstructed from "
          f"{len(res['events'])} banked event kinds)", flush=True)
    print(json.dumps({k: res[k] for k in ("n_from", "n_to", "old_mesh",
                                          "new_mesh", "losses")}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
