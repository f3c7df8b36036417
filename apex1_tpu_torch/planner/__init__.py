"""The auto-parallel planner (the port of ``apex1_tpu/planner``): instead
of hand-picking dp x pp x cp x ep x tp, SEARCH it. Enumerate the legal
layouts of a model on a device count (`layouts`), prune them by the
analytic per-device memory model (`memory`), price each survivor with
the roofline and link models at the card's capability row, corrected by
banked measurements of the same card (`cost` over `perf_model` and
`obs.calibrate`), and emit the winner as an executable plan document
(`emit`): mesh axes, partition rules for `parallel.specs.specs_from_rules`,
the microbatch schedule and the SP-boundary kernel flag.

Consumers: ``apex1_tpu_torch/examples/llama_3d.py --plan auto|PATH``,
`resilience.elastic_resume`'s re-plan onto another device count, and
``chip_smoke.py``'s ``train-llama-3d`` (the bench's ``llama_3d`` layout
from `make_plan`). CLI: ``python -m apex1_tpu_torch.planner`` (``--smoke``
runs enumerate, price, emit and the example end to end).

The default generation is the detected card, h100 without one; prices
carry a calibration factor only from a table fitted for that generation.
"""

from apex1_tpu_torch.planner.cost import (calibration_factor, price_layout,
                                          step_flops)
from apex1_tpu_torch.planner.emit import (PLAN_SCHEMA, PLAN_SPEC_KEYS,
                                          build_plan, check_plan_model,
                                          layout_from_plan,
                                          llama3d_config_from_plan,
                                          load_plan, model_shape_from_plan,
                                          partition_rules, plan_json,
                                          plan_param_specs, plan_spec,
                                          rules_to_specs, save_plan)
from apex1_tpu_torch.planner.layouts import (BANKED_SHAPES, SP_MODES,
                                             Layout, ModelShape, Violation,
                                             check_layout,
                                             enumerate_layouts)
from apex1_tpu_torch.planner.memory import (fit_check, hbm_breakdown,
                                            params_per_device)
from apex1_tpu_torch.planner.search import (PlanError, make_plan,
                                            plan_for_layout,
                                            search_layouts)

__all__ = [
    "BANKED_SHAPES", "Layout", "ModelShape", "PLAN_SCHEMA",
    "PLAN_SPEC_KEYS",
    "PlanError", "SP_MODES", "Violation", "build_plan",
    "calibration_factor", "check_layout", "check_plan_model",
    "enumerate_layouts",
    "fit_check", "hbm_breakdown", "layout_from_plan",
    "llama3d_config_from_plan", "load_plan", "make_plan",
    "model_shape_from_plan",
    "params_per_device", "partition_rules", "plan_for_layout",
    "plan_json",
    "plan_param_specs", "plan_spec", "price_layout", "rules_to_specs",
    "save_plan",
    "search_layouts", "step_flops",
]
