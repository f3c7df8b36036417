"""The auto-parallel planner's legality half (the port of
``apex1_tpu/planner``'s ``layouts``): `ModelShape`, `Layout`,
`Violation`, `check_layout`, `enumerate_layouts` and `BANKED_SHAPES`.

A hand layout is checked here before anything is built
(``apex1_tpu_torch/examples/llama_3d.py`` exits 2 naming each broken
rule). The planner's pricing, memory model, search and plan emission
wait: ROADMAP.md queue A item 11.
"""

from apex1_tpu_torch.planner.layouts import (BANKED_SHAPES, Layout,
                                             ModelShape, Violation,
                                             check_layout,
                                             enumerate_layouts)

__all__ = ["BANKED_SHAPES", "Layout", "ModelShape", "Violation",
           "check_layout", "enumerate_layouts"]
