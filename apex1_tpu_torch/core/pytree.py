"""Whole-model reductions over flat ``{name: tensor}`` dicts (the port
of the parts of ``apex1_tpu/core/pytree.py`` the amp step uses).

The JAX package's pytrees of parameters are the port's flat dicts
keyed by ``named_parameters()`` names, so a tree map is a dict
comprehension and ``tree_map_unzip`` a loop that fills several dicts.
"""

from __future__ import annotations

import torch


def global_norm(tree: dict) -> torch.Tensor:
    """L2 norm over every float tensor, fp32, as the JAX package sums
    it: the square root of the sum of per-leaf sums of squares (the
    role of ``amp_C.multi_tensor_l2norm``). Stays on the device."""
    sq = [v.float().square().sum() for v in tree.values()
          if torch.is_floating_point(v)]
    if not sq:
        return torch.zeros((), dtype=torch.float32)
    return torch.stack(sq).sum().sqrt()


def tree_scale(tree: dict, factor) -> dict:
    """Every float tensor times ``factor`` in fp32, cast back to its
    dtype (``amp_C.multi_tensor_scale``)."""
    return {k: ((v.float() * factor).to(v.dtype)
                if torch.is_floating_point(v) else v)
            for k, v in tree.items()}
