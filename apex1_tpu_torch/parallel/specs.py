"""Partition specs by name rules (the port of ``apex1_tpu/parallel/
specs.py``; reference ``apex/transformer/tensor_parallel/layers.py ::
set_tensor_model_parallel_attributes``).

A `PartitionSpec` says, per dimension of a tensor, which mesh axis (or
tuple of axes, the first the major one) splits it, None for a whole
dimension: the port's own counterpart of ``jax.sharding.PartitionSpec``
(a tuple, so ``P(None, "fsdp") == P(None, "fsdp")``, ``len`` counts the
dimensions it names, and trailing dimensions it leaves out are whole).
`core.mesh.place` shards a tensor by one.

`specs_from_rules` builds the spec dict of a model's ``{name: tensor}``
parameters from ``(regex, spec)`` rules over the port's dotted names;
each model ships its rule table (`models.gpt2.param_specs`, ...).
"""

from __future__ import annotations

import re


class PartitionSpec(tuple):
    """``P("tp", None)``: mesh axis names (or tuples of them) or None,
    one per leading dimension."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"

    def __reduce__(self):
        return (PartitionSpec, tuple(self))


P = PartitionSpec


def specs_from_rules(params: dict, rules, *, default=P()) -> dict:
    """``{name: spec}`` for ``params``: each name (``"h.0.qkv.weight"``)
    takes the spec of the first ``(regex, spec)`` rule it matches
    (``re.search``), else ``default``."""
    def spec_for(name):
        for pat, spec in rules:
            if re.search(pat, name):
                return spec
        return default

    return {name: spec_for(name) for name in params}
