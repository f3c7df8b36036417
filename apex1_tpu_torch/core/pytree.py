"""Whole-model reductions and the flat buffer over ``{name: tensor}``
dicts (the port of ``apex1_tpu/core/pytree.py``: what the amp step and
the distributed optimizers use), key paths over the port's nested
containers (``jax.tree_util``'s, for checkpoints), and the tree helpers
over those containers: `tree_float_leaves`, `tree_axpby`,
`tree_cast_like` and `named_tree_map`.

The JAX package's pytrees of parameters are the port's flat dicts
keyed by ``named_parameters()`` names, so a tree map is a dict
comprehension and ``tree_map_unzip`` a loop that fills several dicts.
"""

from __future__ import annotations

import dataclasses

import torch


def whole(x: torch.Tensor) -> torch.Tensor:
    """A reduction of a DTensor as the plain tensor of its full value
    (the collective its placement needs); any other tensor as it is."""
    from torch.distributed.tensor import DTensor
    return x.full_tensor() if isinstance(x, DTensor) else x


def global_norm(tree: dict) -> torch.Tensor:
    """L2 norm over every float tensor, fp32, as the JAX package sums
    it: the square root of the sum of per-leaf sums of squares (the
    role of ``amp_C.multi_tensor_l2norm``). Stays on the device. A
    DTensor leaf (a placed parameter's gradient) counts every shard."""
    sq = [whole(v.float().square().sum()) for v in tree.values()
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


# ---- key paths ---------------------------------------------------------------
#
# The JAX package names each leaf of a pytree by its key path
# (``jax.tree_util.keystr``): ``['key']`` for a dict entry (dict keys
# visited sorted), ``[i]`` for a list or tuple item, ``.name`` for a
# namedtuple field or a registered dataclass field. Manifests, their
# leaf digests and the reshard's ``"['chunk']" in key`` test read
# those strings, so the port names the leaves of its own containers the
# same way: dicts, lists, tuples, namedtuples and dataclasses (in field
# order, or sorted where the class sets ``_tree_sorted_fields``: chex
# dataclasses, the JAX package's `AmpState`, `LossScaleState` and
# `SentinelState`, flatten their fields sorted). None is an empty
# subtree; a threefry key (a tuple of two Python ints, `core.random`)
# is one leaf, as JAX's key array is; anything else is a leaf.


def is_key_data(x) -> bool:
    """A threefry key as `core.random` holds it: a plain tuple of two
    Python ints."""
    return (type(x) is tuple and len(x) == 2
            and all(type(v) is int for v in x))


def _children(node):
    """``(entries, rebuild)`` of a container, None for a leaf; an entry
    is ``(kind, key, child)`` with kind "dict", "seq" or "attr"."""
    if node is None:
        return [], lambda _: None
    if isinstance(node, dict):
        keys = sorted(node)
        return ([("dict", k, node[k]) for k in keys],
                lambda new: type(node)((k, new[k]) for k in node))
    if is_key_data(node):
        return None
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return ([("attr", f, getattr(node, f)) for f in node._fields],
                lambda new: type(node)(**new))
    if isinstance(node, (list, tuple)):
        return ([("seq", i, v) for i, v in enumerate(node)],
                lambda new: type(node)(new[i] for i in range(len(node))))
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        names = [f.name for f in dataclasses.fields(node)]
        if getattr(node, "_tree_sorted_fields", False):
            names = sorted(names)
        return ([("attr", f, getattr(node, f)) for f in names],
                lambda new: dataclasses.replace(node, **new))
    return None


def keystr(path) -> str:
    """``jax.tree_util.keystr`` of a port key path."""
    out = []
    for kind, key in path:
        out.append(f".{key}" if kind == "attr" else
                   f"[{key}]" if kind == "seq" else f"[{key!r}]")
    return "".join(out)


def tree_flatten_with_path(tree, is_leaf=None) -> list:
    """``[(path, leaf)]`` in JAX's leaf order; ``path`` a tuple of
    ``(kind, key)`` entries (`keystr` renders it). ``is_leaf(x)`` true
    stops the descent at ``x``."""
    out = []

    def walk(node, path):
        ch = None if is_leaf is not None and is_leaf(node) else \
            _children(node)
        if ch is None:
            out.append((path, node))
            return
        for kind, key, child in ch[0]:
            walk(child, path + ((kind, key),))

    walk(tree, ())
    return out


def tree_map_with_path(fn, tree, *rest, is_leaf=None):
    """``fn(path, leaf, *leaves of rest)`` over every leaf, the result
    in ``tree``'s containers (dicts keep their own key order). The
    trees of ``rest`` have ``tree``'s structure."""

    def walk(node, others, path):
        ch = None if is_leaf is not None and is_leaf(node) else \
            _children(node)
        if ch is None:
            return fn(path, node, *others)
        entries, rebuild = ch
        new = {}
        for kind, key, child in entries:
            sub = [o[key] if kind != "attr" else getattr(o, key)
                   for o in others]
            new[key] = walk(child, sub, path + ((kind, key),))
        return rebuild(new)

    return walk(tree, list(rest), ())


# ---- tree helpers over nested containers ---------------------------------


def _float_tensor(x) -> bool:
    return isinstance(x, torch.Tensor) and torch.is_floating_point(x)


def tree_float_leaves(tree) -> list:
    """The floating leaves of ``tree`` as tensors, in JAX's leaf order
    (numpy arrays and Python scalars taken as tensors first, as the JAX
    package takes them as arrays)."""
    leaves = [torch.as_tensor(x) for _, x in tree_flatten_with_path(tree)]
    return [x for x in leaves if torch.is_floating_point(x)]


def tree_axpby(a, x_tree, b, y_tree, out_dtype=None):
    """``amp_C.multi_tensor_axpby``: ``a * x + b * y`` leaf by leaf,
    accumulated in fp32, in x's dtype (or ``out_dtype``); where x is not
    floating, y's leaf passes through unchanged."""

    def axpby(_, x, y):
        x, y = torch.as_tensor(x), torch.as_tensor(y)
        if not torch.is_floating_point(x):
            return y
        acc = a * x.float() + b * y.float()
        return acc.to(out_dtype or x.dtype)

    return tree_map_with_path(axpby, x_tree, y_tree)


def tree_cast_like(tree, like):
    """Each leaf of ``tree`` cast to the dtype of ``like``'s leaf."""
    return tree_map_with_path(
        lambda _, x, l: torch.as_tensor(x).to(torch.as_tensor(l).dtype),
        tree, like)


def named_tree_map(f, tree, sep: str = "/"):
    """``tree_map`` with a ``"path/to/leaf"`` first argument: each key
    path's keys (dict key, sequence index or field name) joined by
    ``sep``, as the JAX package names them for its regex sharding
    rules."""
    return tree_map_with_path(
        lambda path, x: f(sep.join(str(key) for _, key in path), x), tree)
