"""Deterministic host-side checkpoint resharding between
``apex1-plan-v1`` layouts (the port of
``apex1_tpu/resilience/reshard.py``).

A committed checkpoint that banks its producing plan in the manifest
``meta["plan"]`` (`ResilientCheckpointer(plan=...)`) is
self-describing: `reshard_state` remaps its state tree onto any other
legal plan for the same model from the plans alone. Three leaf
classes:

- pipeline-stacked leaves (``['chunk']`` in the key path, leading dims
  ``(num_chunks, pp, layers_per_stage)``): global layer
  ``(v·pp + s)·lps + j`` sits at slot ``(v, s, j)``, the row-major
  flattening of the stack (`models.llama_3d.reshape_chunks`), so
  another factorization of ``num_layers`` is a reshape; params and
  the optimizer moments that mirror them alike;
- ZeRO flat shards (``…_shard`` leaves of
  `parallel.distributed_optimizer` states saved as their global padded
  buffer through `checkpoint.to_global`; 1-D, padded to a multiple of
  the plan's dp): repacked by
  `parallel.distributed_optimizer.repack_flat_shard`. Exact: the
  padding's params and grads are zero, so its moments are too;
- everything else: layout-independent bytes, copied.

Never trusted, always verified: the source is digest-checked before the
remap (`verify_files`, `checkpointer.check_payload`), every remap is
conservation-checked (restacked leaves layer by layer against an
independent index computation; repacked shards on the unpadded prefix
and a zero source tail), and the output is re-digested into a fresh
manifest, committed like a live save and `verify_files`-checked.

Deterministic: numpy on host bytes, no clocks. A leaf keeps its type
(a tensor stays a tensor of its dtype, a numpy array an array), so the
same (checkpoint, target plan) always gives the same leaf digests, the
JAX package's too. A zero on/off flip between plans changes the
optimizer state's structure and is refused (`LayoutMismatch`).

A plan here is a plain dict with the keys this module reads
(``schema``, ``n_devices``, ``mesh``, ``schedule``, ``zero``,
``model``): `planner.make_plan`'s for a searched layout,
`planner.plan_for_layout`'s for a stated one, or the JAX planner's JSON.
The schema name, the layout-identity keys and `plan_spec` are spelled
here so that this module reads plans without importing the planner.
"""

from __future__ import annotations

import os
from typing import Any, Optional, Tuple

import numpy as np
import torch

from apex1_tpu_torch.checkpoint import CheckpointError, restore_checkpoint
from apex1_tpu_torch.core.pytree import (keystr, tree_flatten_with_path,
                                         tree_map_with_path)
from apex1_tpu_torch.resilience.manifest import (Manifest, host_array,
                                                 read_manifest,
                                                 verify_files)

#: the JAX planner's ``PLAN_SCHEMA``
PLAN_SCHEMA = "apex1-plan-v1"

_STATE_SUBDIR = "state"

#: the plan fields that define layout identity (the JAX package's
#: ``planner.emit.PLAN_SPEC_KEYS``): two checkpoints restore into each
#: other's state without a reshard iff their `plan_spec` dicts are equal
PLAN_SPEC_KEYS = ("schema", "n_devices", "mesh", "schedule", "zero",
                  "model")


def plan_spec(plan: dict) -> dict:
    """The layout-identity subset of a plan (`PLAN_SPEC_KEYS`; of
    ``zero`` only ``enabled`` and ``axis``), the JAX planner's
    ``plan_spec``."""
    out = {}
    for k in PLAN_SPEC_KEYS:
        v = plan.get(k)
        out[k] = dict(v) if isinstance(v, dict) else v
    z = out.get("zero")
    if isinstance(z, dict):
        out["zero"] = {"enabled": bool(z.get("enabled")),
                       "axis": z.get("axis")}
    return out


class LayoutMismatch(CheckpointError):
    """The checkpoint's banked layout and the layout asked for disagree,
    or the checkpoint banks no plan. A `CheckpointError`; the message
    says what to do next."""


def plan_meta(manifest: Manifest, path: str | os.PathLike) -> dict:
    """The producing plan banked in a manifest's meta, or a typed
    `LayoutMismatch`."""
    plan = manifest.meta.get("plan")
    if not isinstance(plan, dict) or plan.get("schema") != PLAN_SCHEMA:
        raise LayoutMismatch(
            path, "no plan meta: this checkpoint does not bank its "
            f"producing {PLAN_SCHEMA} spec, so it cannot be resharded "
            "or layout-checked; re-save it with "
            "ResilientCheckpointer(plan=...)")
    return plan


def mesh_str(plan: dict) -> str:
    """Compact ``dp2 pp2 cp1 ep1 tp2 /8`` label for messages/events."""
    m = plan.get("mesh", {})
    return (" ".join(f"{a}{m.get(a, '?')}"
                     for a in ("dp", "pp", "cp", "ep", "tp"))
            + f" /{plan.get('n_devices', '?')}")


# -- remap geometry from the plans ------------------------------------------

def _stack_dims(plan: dict, path: str) -> Tuple[int, int, int]:
    """(num_chunks, pp, layers_per_stage) the plan implies."""
    layers = int(plan["model"]["num_layers"])
    chunks = int(plan["schedule"]["num_chunks"])
    pp = int(plan["mesh"]["pp"])
    if chunks < 1 or pp < 1 or layers % (chunks * pp):
        raise LayoutMismatch(
            path, f"plan stacking is inconsistent: num_layers={layers} "
            f"does not factor as num_chunks={chunks} x pp={pp} x "
            f"layers_per_stage")
    return chunks, pp, layers // (chunks * pp)


def _zero_world(plan: dict) -> Optional[int]:
    """dp world of the flat optimizer shards, or None when the plan
    runs the unsharded optimizer."""
    return (int(plan["mesh"]["dp"])
            if plan.get("zero", {}).get("enabled") else None)


def _bytes_equal(x: np.ndarray, y: np.ndarray) -> bool:
    """Bytewise equality: NaN-safe and dtype-agnostic."""
    x, y = np.ascontiguousarray(x), np.ascontiguousarray(y)
    return (x.dtype == y.dtype and x.shape == y.shape
            and np.array_equal(x.view(np.uint8), y.view(np.uint8)))


_FLOAT_NAMES = ("float16", "bfloat16", "float32", "float64",
                "float8_e4m3fn", "float8_e5m2")


def _flat_len(params) -> int:
    """The unpadded flat float length of ``params`` (any tree): the set
    the distributed optimizers shard, as the JAX package's
    ``flat_param_len`` counts it (a 0-d float counts one)."""
    n = 0
    for _, leaf in tree_flatten_with_path(params):
        if isinstance(leaf, torch.Tensor):
            if torch.is_floating_point(leaf):
                n += max(1, leaf.numel())
            continue
        a, name = host_array(leaf)
        if name in _FLOAT_NAMES:
            n += max(1, a.size)
    return n


def _back(x, a: np.ndarray):
    """``a`` (host bytes of ``x``'s dtype) in ``x``'s type."""
    if isinstance(x, torch.Tensor):
        t = torch.from_numpy(a if a.flags.c_contiguous
                             else np.ascontiguousarray(a))
        return t.view(x.dtype) if t.dtype != x.dtype else t
    return a


# -- the remap --------------------------------------------------------------

def reshard_state(state: Any, plan_from: dict, plan_to: dict, *,
                  flat_len: Optional[int] = None,
                  path: str = "<state>") -> Tuple[Any, dict]:
    """Remap a host state tree saved under ``plan_from`` onto
    ``plan_to``. Returns ``(new_state, report)``: leaf counts per remap
    class and the conservation verdicts. Deterministic host numpy.

    ``flat_len`` is the true (unpadded) flat float-param length the
    ZeRO shards pack; when None and shard leaves are present it is
    counted from ``state["params"]``."""
    for key in ("model",):
        if plan_from.get(key) != plan_to.get(key):
            raise LayoutMismatch(
                path, f"plans disagree on {key!r}: elastic resume "
                "changes the topology, never the model "
                f"({plan_from.get(key)} != {plan_to.get(key)})")
    if bool(plan_from.get("zero", {}).get("enabled")) != \
            bool(plan_to.get("zero", {}).get("enabled")):
        raise LayoutMismatch(
            path, "optimizer-shard layout change (zero on<->off) is a "
            "tree-STRUCTURE change, not a leaf remap — re-plan with "
            "the source checkpoint's zero setting")
    stack_from = _stack_dims(plan_from, path)
    stack_to = _stack_dims(plan_to, path)
    w_from, w_to = _zero_world(plan_from), _zero_world(plan_to)

    n_flat = flat_len
    counts = {"restacked": 0, "repacked": 0, "copied": 0}
    checks: list = []

    def need_flat_len() -> int:
        nonlocal n_flat
        if n_flat is None:
            params = state.get("params") if isinstance(state, dict) \
                else None
            if params is None:
                raise LayoutMismatch(
                    path, "cannot derive the flat shard length: state "
                    "has no 'params' subtree — pass flat_len= "
                    "explicitly")
            n_flat = _flat_len(params)
        return n_flat

    def leaf(kp, x):
        key = keystr(kp)
        a, _name = host_array(x)
        if ("['chunk']" in key and a.ndim >= 3
                and a.shape[:3] == stack_from):
            if stack_from == stack_to:
                counts["copied"] += 1
                return _back(x, a.copy())
            out = np.ascontiguousarray(a).reshape(stack_to + a.shape[3:])
            counts["restacked"] += 1
            # an independent per-layer provenance check, not a reshape
            # compared to itself: global layer l must sit at
            # unravel(l, stack) on each side
            n_layers = stack_from[0] * stack_from[1] * stack_from[2]
            ok = all(
                _bytes_equal(a[np.unravel_index(layer, stack_from)],
                             out[np.unravel_index(layer, stack_to)])
                for layer in range(n_layers))
            checks.append({"leaf": key, "kind": "restack", "ok": ok})
            return _back(x, out)
        if "['chunk']" in key and a.ndim >= 3:
            raise LayoutMismatch(
                path, f"leaf {key}: shape {a.shape} does not start "
                f"with the banked plan's stack {stack_from} — the "
                "checkpoint disagrees with its own plan meta")
        if "_shard" in key and a.ndim == 1 and w_from is not None:
            from apex1_tpu_torch.parallel.distributed_optimizer import (
                repack_flat_shard, shard_padded_len)

            n = need_flat_len()
            if a.shape[0] != shard_padded_len(n, w_from):
                raise LayoutMismatch(
                    path, f"leaf {key}: length {a.shape[0]} != flat "
                    f"length {n} padded for dp={w_from} — the "
                    "checkpoint disagrees with its own plan meta")
            out = repack_flat_shard(a, flat_len=n, world_from=w_from,
                                    world_to=w_to)
            counts["repacked"] += 1
            # the tail check is on the source: a nonzero padded tail
            # means the zero-padding invariant broke upstream
            checks.append({"leaf": key, "kind": "repack",
                           "ok": _bytes_equal(a[:n], out[:n])
                           and not a[n:].view(np.uint8).any()})
            return _back(x, out)
        counts["copied"] += 1
        return _back(x, a.copy())

    new_state = tree_map_with_path(leaf, state)
    report = {
        "n_leaves": sum(counts.values()),
        "n_restacked": counts["restacked"],
        "n_repacked": counts["repacked"],
        "n_copied": counts["copied"],
        "stack_from": list(stack_from), "stack_to": list(stack_to),
        "conserved": all(c["ok"] for c in checks),
        "n_checks": len(checks),
    }
    if not report["conserved"]:
        bad = [c["leaf"] for c in checks if not c["ok"]]
        raise LayoutMismatch(
            path, f"reshard conservation check failed for {bad[:4]} — "
            "remapped bytes do not match the source")
    return new_state, report


# -- checkpoint-level reshard ----------------------------------------------

def reshard_checkpoint(src_dir: str | os.PathLike, template: Any,
                       plan_to: dict, out_dir: str | os.PathLike, *,
                       fingerprint: Optional[int] = None,
                       flat_len: Optional[int] = None,
                       manifest: Optional[Manifest] = None
                       ) -> Tuple[str, Manifest, dict]:
    """Reshard a committed checkpoint onto ``plan_to`` as a fresh
    committed checkpoint at ``out_dir``. Returns ``(out_dir,
    new_manifest, report)``.

    ``template`` is a state tree with the source plan's structure,
    shapes and dtypes (meta tensors do; the remap runs on the host
    whatever the template's device). The verification chain of the module docstring runs here.
    Pass ``manifest`` when the caller just ran `verify_files` on the
    source itself: the file digests are then skipped (the leaf-level
    payload check before the restore still runs)."""
    # the checkpointer imports this module (the plan checks)
    from apex1_tpu_torch.resilience.checkpointer import (check_payload,
                                                         write_step_dir)
    src_dir = os.fspath(src_dir)
    out_dir = os.fspath(os.path.abspath(out_dir))
    man = manifest if manifest is not None else verify_files(src_dir)
    plan_from = plan_meta(man, src_dir)
    # the remap runs on host bytes: every tensor restores to the CPU
    # whatever device the template's lies on
    host_template = tree_map_with_path(
        lambda p, x: torch.empty(x.shape, dtype=x.dtype, device="meta")
        if isinstance(x, torch.Tensor) else x, template)
    check_payload(src_dir, man)
    state = restore_checkpoint(os.path.join(src_dir, _STATE_SUBDIR),
                               template=host_template, device="cpu")
    new_state, report = reshard_state(state, plan_from, plan_to,
                                      flat_len=flat_len, path=src_dir)

    meta = dict(man.meta)
    meta["plan"] = plan_to
    meta["resharded_from"] = {
        "path": src_dir, "step": man.step,
        "mesh": mesh_str(plan_from), "to_mesh": mesh_str(plan_to),
        "n_leaves": report["n_leaves"],
        "n_restacked": report["n_restacked"],
        "n_repacked": report["n_repacked"],
    }
    os.makedirs(os.path.dirname(out_dir) or ".", exist_ok=True)
    write_step_dir(out_dir, new_state, step=man.step,
                   fingerprint=fingerprint, meta=meta)
    new_man = verify_files(out_dir)
    return out_dir, new_man, report


def read_plan(ckpt_dir: str | os.PathLike) -> dict:
    """The banked producing plan of a committed checkpoint dir (typed
    errors for uncommitted/plan-less dirs)."""
    ckpt_dir = os.fspath(ckpt_dir)
    return plan_meta(read_manifest(ckpt_dir), ckpt_dir)
