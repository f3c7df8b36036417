"""The search loop: enumerate -> pre-filter -> price -> pick -> emit (the
port of ``apex1_tpu/planner/search.py``).

`make_plan` is the planner's front door: given a ModelShape and a device
count it returns the plan document of the cheapest CALIBRATED layout,
deterministically. The enumeration order is fixed
(`layouts.enumerate_layouts`), prices are pure functions of (inputs,
banked calibration table) and ties break on `Layout.sort_key`: the same
inputs give a byte-identical `emit.plan_json`.

Failure is loud and sized: no legal layout raises `PlanError` naming the
violated rules; every layout over the memory budget raises with the
SMALLEST over-budget sizing message. The default generation is the
detected card (h100 with no card).
"""

from __future__ import annotations

from typing import Optional

from apex1_tpu_torch.core.capability import default_generation
from apex1_tpu_torch.planner import cost, emit, memory
from apex1_tpu_torch.planner.layouts import (Layout, ModelShape,
                                             check_layout,
                                             enumerate_layouts)


class PlanError(RuntimeError):
    """No plan exists for the request; the message carries the why."""


def search_layouts(shape: ModelShape, n_devices: int, *,
                   generation: Optional[str] = None,
                   results_dir: Optional[str] = None,
                   use_calibration: bool = True,
                   **enum_kw) -> dict:
    """Full ranked search. Returns ``{"ranked": [(price, layout)...],
    "n_enumerated": int, "hbm_rejected": [msg...]}``, ``ranked``
    cheapest-calibrated first."""
    gen = generation or default_generation()
    legal = list(enumerate_layouts(shape, n_devices, **enum_kw))
    if not legal:
        # name WHY: re-check the all-dp layout so the error carries
        # rules, not a shrug
        probe = Layout(dp=n_devices,
                       num_microbatches=max(1, shape.global_batch
                                            // max(1, n_devices)))
        why = "; ".join(str(v) for v in
                        check_layout(shape, probe, n_devices)) \
            or "no axis factorization satisfies the legality rules"
        raise PlanError(
            f"no legal (dp,pp,cp,ep,tp) layout for "
            f"{shape.name} on {n_devices} device(s): {why}")
    fitting, rejected = [], []
    for lay in legal:
        msg = memory.fit_check(shape, lay, gen)
        if msg is None:
            fitting.append(lay)
        else:
            rejected.append(msg)
    if not fitting:
        closest = min(
            legal, key=lambda l: memory.hbm_breakdown(shape, l,
                                                      gen)["total"])
        raise PlanError(
            f"every legal layout for {shape.name} on {n_devices} "
            f"device(s) is over the HBM budget; closest: "
            f"{memory.fit_check(shape, closest, gen)}")
    # the step factor is a property of the shape, the fused-kernel
    # factor of (tp>1, fused): read the banked table once a search
    cal = (cost.calibration_factor(shape, results_dir, gen)
           if use_calibration else None)
    kf_fused = cost._sp_kernel_factor(
        Layout(tp=2, sp_mode="fused", num_microbatches=1),
        results_dir, gen)
    kf_none = cost._sp_kernel_factor(Layout(num_microbatches=1),
                                     results_dir, gen)
    priced = [(cost.price_layout(
        shape, lay, generation=gen, results_dir=results_dir,
        use_calibration=use_calibration, calibration=cal,
        sp_kernel=(kf_fused if (lay.tp > 1 and lay.sp_mode == "fused")
                   else kf_none)), lay)
              for lay in fitting]
    priced.sort(key=lambda pl: (pl[0]["calibrated_step_ms"],
                                pl[1].sort_key()))
    return {"ranked": priced, "n_enumerated": len(legal),
            "hbm_rejected": rejected}


def make_plan(shape: ModelShape, n_devices: int, *,
              generation: Optional[str] = None,
              results_dir: Optional[str] = None,
              use_calibration: bool = True,
              top_k: int = 5, **enum_kw) -> dict:
    """Search and emit the winning plan document (`emit.build_plan`).
    ``enum_kw`` forwards to `layouts.enumerate_layouts` (allow_cp /
    allow_ep / allow_zero / require_zero / sp_modes /
    microbatch_size)."""
    gen = generation or default_generation()
    res = search_layouts(shape, n_devices, generation=gen,
                         results_dir=results_dir,
                         use_calibration=use_calibration, **enum_kw)
    price, lay = res["ranked"][0]
    mem = memory.hbm_breakdown(shape, lay, gen)
    ranked_top = [
        {"mesh": l.mesh_str(),
         "calibrated_step_ms": round(p["calibrated_step_ms"], 4),
         "step_ms": round(p["step_ms"], 4)}
        for p, l in res["ranked"][:top_k]]
    return emit.build_plan(
        shape, lay, price, mem, generation=gen,
        search={"n_enumerated": res["n_enumerated"],
                "n_hbm_rejected": len(res["hbm_rejected"]),
                "ranked_top": ranked_top},
        provenance=_calibration_provenance(results_dir, gen))


def plan_for_layout(shape: ModelShape, layout: Layout, *,
                    generation: Optional[str] = None,
                    results_dir: Optional[str] = None,
                    use_calibration: bool = True) -> dict:
    """A full plan document for a STATED layout (no search): checked,
    priced and emitted like a searched plan, ``search.stated = True``
    marking that nothing was enumerated. A hand-picked run banks the
    same ``apex1-plan-v1`` spec in its checkpoints as ``--plan auto``
    would, so elastic resume works from either. An illegal layout
    raises `PlanError` naming the rules; the memory verdict is recorded
    in ``memory`` but not enforced (a stated layout is the operator's
    claim)."""
    gen = generation or default_generation()
    violations = check_layout(shape, layout)
    if violations:
        raise PlanError(
            f"stated layout {layout.mesh_str()} is illegal for "
            f"{shape.name}: "
            + "; ".join(str(v) for v in violations))
    price = cost.price_layout(shape, layout, generation=gen,
                              results_dir=results_dir,
                              use_calibration=use_calibration)
    mem = memory.hbm_breakdown(shape, layout, gen)
    return emit.build_plan(
        shape, layout, price, mem, generation=gen,
        search={"n_enumerated": 0, "n_hbm_rejected": 0,
                "ranked_top": [], "stated": True},
        provenance=_calibration_provenance(results_dir, gen))


def _calibration_provenance(results_dir: Optional[str] = None,
                            generation: Optional[str] = None) -> dict:
    """Identity of the calibration table the prices rode on: banked
    fields only (no clock reads). A table refused for being another
    chip's is named as refused."""
    from apex1_tpu_torch.obs.calibrate import CAL_NAME, table_for

    doc, refused = table_for(generation, results_dir)
    if doc is None:
        return ({"calibration_table": None,
                 "calibration_refused": f"{CAL_NAME}: {refused}"}
                if refused else {"calibration_table": None})
    return {"calibration_table": CAL_NAME,
            "calibration_generated_unix": doc.get("generated_unix"),
            "calibration_n_pairs": doc.get("n_pairs"),
            "calibration_prediction_table": doc.get("prediction_table")}
