"""Whole-model reductions and the flat buffer over ``{name: tensor}``
dicts (the port of the parts of ``apex1_tpu/core/pytree.py`` the amp
step and the distributed optimizers use).

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


def flatten_tree(tree: dict, dtype=None):
    """The float tensors of ``tree`` raveled into one 1-D buffer (in
    ``dtype``, else each keeps its own, which must then agree), in the
    dict's own key order; ``(flat, unflatten)`` with ``unflatten(buf)``
    the dict again, each piece reshaped and cast back, the non-float
    values carried through untouched (the role of ``apex_C.flatten``).

    The JAX package flattens a pytree in its sorted key order
    (``h0, h1, h10, ...``); the port keeps ``named_parameters()``
    order, so the two buffers hold the same elements in another order.
    """
    floats = {k: v for k, v in tree.items() if torch.is_floating_point(v)}
    shapes = {k: v.shape for k, v in floats.items()}
    dtypes = {k: v.dtype for k, v in floats.items()}
    flat = (torch.cat([v.reshape(-1).to(dtype or v.dtype)
                       for v in floats.values()]) if floats
            else torch.zeros((0,), dtype=dtype or torch.float32))

    def unflatten(buf: torch.Tensor) -> dict:
        out, off = {}, 0
        for k, v in tree.items():
            if k in floats:
                n = shapes[k].numel()
                out[k] = buf[off:off + n].reshape(shapes[k]).to(dtypes[k])
                off += n
            else:
                out[k] = v
        return out

    return flat, unflatten
