"""Precision policy — the amp opt levels as a frozen bundle of dtypes
(the port of ``apex1_tpu/core/policy.py``).

    O0  — fp32 everything (debug/gold)
    O1  — params fp32, compute bf16/fp16, fragile ops fp32, dynamic loss
          scaling for fp16 (bf16 needs none)
    O2  — params stored fp32 (the master weights ARE the params), model
          applied in half via cast-on-use, norms fp32
    O3  — half everything

The ``_fp16`` variants compute in fp16; O1_fp16 and O2_fp16 scale the
loss dynamically (`core.loss_scale`).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch


def map_tensors(tree, fn):
    """``fn`` on every tensor of a tree of dicts, lists and tuples;
    other leaves unchanged."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: map_tensors(v, fn) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_tensors(v, fn) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tensors(v, fn) for v in tree)
    return tree


def _tensors_of(tree) -> list:
    out = []
    map_tensors(tree, out.append)
    return out


def _cast_floats(tree, dtype):
    """Cast every floating tensor of a tree (a flat ``{name: tensor}``
    dict, or dicts, lists and tuples of tensors)."""
    return map_tensors(tree, lambda v: (v.to(dtype)
                                         if torch.is_floating_point(v)
                                         else v))


@dataclasses.dataclass(frozen=True)
class PrecisionPolicy:
    """- ``param_dtype``: storage dtype of parameters.
    - ``compute_dtype``: dtype activations and matmuls run in.
    - ``output_dtype``: dtype of model outputs.
    - ``keep_norms_fp32``: norm γ/β stay fp32 (stats are fp32 anyway).
    - ``fp32_fragile_ops``: softmax/loss ops in fp32 (O1) or in half
      (O2).
    - ``loss_scale``: "dynamic", None, or a static float."""

    name: str = "O1"
    param_dtype: Any = torch.float32
    compute_dtype: Any = torch.bfloat16
    output_dtype: Any = torch.float32
    keep_norms_fp32: bool = True
    fp32_fragile_ops: bool = True
    loss_scale: Any = None

    def cast_to_compute(self, tree: dict) -> dict:
        """Every float leaf to the compute dtype (differentiable: grads
        reach the source tensors through the cast)."""
        return _cast_floats(tree, self.compute_dtype)

    def cast_to_param(self, tree: dict) -> dict:
        return _cast_floats(tree, self.param_dtype)

    def cast_to_output(self, tree):
        return _cast_floats(tree, self.output_dtype)

    def with_overrides(self, **kw) -> "PrecisionPolicy":
        return dataclasses.replace(self, **kw)

    # the reference's amp.half_function / float_function /
    # promote_function: ``fn`` wrapped so that its float tensor inputs
    # (positional and keyword, nested in dicts, lists and tuples) are
    # cast before it runs
    def half_function(self, fn):
        """Float inputs cast to the compute dtype (FP16_FUNCS)."""
        def wrapped(*args, **kw):
            args, kw = _cast_floats((args, kw), self.compute_dtype)
            return fn(*args, **kw)
        return wrapped

    def float_function(self, fn):
        """Float inputs cast to fp32 (FP32_FUNCS: the fragile ops)."""
        def wrapped(*args, **kw):
            args, kw = _cast_floats((args, kw), torch.float32)
            return fn(*args, **kw)
        return wrapped

    def promote_function(self, fn):
        """Float inputs promoted to the widest float dtype among them
        (CASTS: bf16 with fp16 gives fp32, as in JAX)."""
        def wrapped(*args, **kw):
            dts = [t.dtype for t in _tensors_of((args, kw))
                   if torch.is_floating_point(t)]
            if dts:
                widest = dts[0]
                for dt in dts[1:]:
                    widest = torch.promote_types(widest, dt)
                args, kw = _cast_floats((args, kw), widest)
            return fn(*args, **kw)
        return wrapped


POLICIES = {
    "O0": PrecisionPolicy("O0", compute_dtype=torch.float32),
    "O1": PrecisionPolicy("O1", compute_dtype=torch.bfloat16),
    "O2": PrecisionPolicy("O2", compute_dtype=torch.bfloat16,
                          fp32_fragile_ops=False),
    "O3": PrecisionPolicy("O3", param_dtype=torch.bfloat16,
                          compute_dtype=torch.bfloat16,
                          output_dtype=torch.bfloat16,
                          keep_norms_fp32=False, fp32_fragile_ops=False),
    "O1_fp16": PrecisionPolicy("O1_fp16", compute_dtype=torch.float16,
                               loss_scale="dynamic"),
    "O2_fp16": PrecisionPolicy("O2_fp16", compute_dtype=torch.float16,
                               fp32_fragile_ops=False,
                               loss_scale="dynamic"),
    "O3_fp16": PrecisionPolicy("O3_fp16", param_dtype=torch.float16,
                               compute_dtype=torch.float16,
                               output_dtype=torch.float16,
                               keep_norms_fp32=False,
                               fp32_fragile_ops=False),
}


def get_policy(spec, **overrides) -> PrecisionPolicy:
    """Resolve a policy by name (or pass one through) with per-property
    overrides."""
    if isinstance(spec, PrecisionPolicy):
        pol = spec
    else:
        try:
            pol = POLICIES[spec]
        except KeyError:
            raise ValueError(
                f"unknown opt level {spec!r}; valid: {sorted(POLICIES)}")
    if overrides:
        pol = pol.with_overrides(**overrides)
    return pol
