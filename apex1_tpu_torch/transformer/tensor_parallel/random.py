"""The RNG tracker and activation checkpointing (the port of
``apex1_tpu/transformer/tensor_parallel/random.py``; reference
``tensor_parallel/random.py :: CudaRNGStatesTracker,
model_parallel_cuda_manual_seed, checkpoint``).

`RNGStatesTracker` keeps named RNG domains as `core.random` keys (jax's
threefry key data, no mutable generator state): ``add(name, seed)``
registers one, ``fork(name)`` hands out its key with this rank's
tensor-parallel index folded in (any domain, as the JAX tracker's
``fork``), so dropout differs across the tp ranks. Outside a
tensor-parallel group
(no `parallel_state` mesh) ``fork`` returns the key as it is, one
rank's semantics. `model_parallel_seed` seeds ``default`` with the seed
and ``model-parallel-rng`` with the seed + 2718, as the reference.

A policy is named as in ``jax.checkpoint_policies``:

- ``nothing_saveable``: full recompute, ``torch.utils.checkpoint``
  (non-reentrant) around the function: its forward runs again in the
  backward;
- ``dots_saveable`` (alias ``checkpoint_dots``) and
  ``dots_with_no_batch_dims_saveable`` (alias
  ``checkpoint_dots_with_no_batch_dims``): selective recompute, the
  matrix products' outputs saved (all of them, or those without a batch
  dimension: ``mm``/``addmm`` but not ``bmm``), everything else
  recomputed (``torch.utils.checkpoint.create_selective_checkpoint_
  contexts``);
- ``everything_saveable``: no recompute.

`checkpoint_module` runs a model block under a policy with its
parameters as the checkpoint's inputs (Llama's and T5's remat).

The other names JAX knows (the name-based and offloading policies)
raise NotImplementedError; an unknown name raises ValueError at once,
so a typo fails where a config is made.
"""

from __future__ import annotations

import functools
from typing import Callable

import torch
import torch.utils.checkpoint as ckpt

from apex1_tpu_torch.core.mesh import AXIS_TP
from apex1_tpu_torch.core.random import fold_in, prng_key

_MODEL_PARALLEL_RNG = "model-parallel-rng"


class RNGStatesTracker:
    """``CudaRNGStatesTracker``'s named domains as threefry keys."""

    def __init__(self):
        self._keys: dict = {}

    def reset(self) -> None:
        self._keys.clear()

    def get_states(self) -> dict:
        return dict(self._keys)

    def set_states(self, states: dict) -> None:
        self._keys = dict(states)

    def add(self, name: str, seed: int) -> None:
        if name in self._keys:
            raise RuntimeError(f"rng domain {name} already present")
        self._keys[name] = prng_key(seed)

    def fork(self, name: str = _MODEL_PARALLEL_RNG, *, tp_axis=AXIS_TP):
        """The domain's key, with this rank's index in ``tp_axis`` (a
        mesh axis of `parallel_state` or a process group) folded in;
        the key as it is when there is no such group or ``tp_axis`` is
        None."""
        from apex1_tpu_torch.transformer import parallel_state
        key = self._keys[name]
        group = (None if tp_axis is None
                 else parallel_state.resolve_group(tp_axis))
        if group is not None:
            key = fold_in(key, parallel_state.group_size_rank(group)[1])
        return key


_TRACKER = RNGStatesTracker()


def get_rng_tracker() -> RNGStatesTracker:
    """``get_cuda_rng_tracker``."""
    return _TRACKER


def model_parallel_seed(seed: int) -> None:
    """``model_parallel_cuda_manual_seed(seed)``: the ``default`` domain
    seeded ``seed`` (the same on every tp rank), the model-parallel one
    ``seed + 2718``, its per-rank fold applied at ``fork``."""
    _TRACKER.reset()
    _TRACKER.add("default", seed)
    _TRACKER.add(_MODEL_PARALLEL_RNG, seed + 2718)


#: every name of ``jax.checkpoint_policies``
JAX_POLICIES = (
    "checkpoint_dots", "checkpoint_dots_with_no_batch_dims",
    "dots_saveable", "dots_with_no_batch_dims_saveable",
    "everything_saveable", "nothing_saveable",
    "offload_dot_with_no_batch_dims", "save_and_offload_only_these_names",
    "save_any_names_but_these", "save_anything_except_these_names",
    "save_from_both_policies", "save_only_these_names")

_aten = torch.ops.aten
_DOTS_NO_BATCH = (_aten.mm.default, _aten.addmm.default)
_DOTS = _DOTS_NO_BATCH + (_aten.bmm.default, _aten.baddbmm.default)

#: ported name -> the saved ops (None: save nothing; "all": no remat)
_PORTED = {"nothing_saveable": None, "everything_saveable": "all",
           "dots_saveable": _DOTS, "checkpoint_dots": _DOTS,
           "dots_with_no_batch_dims_saveable": _DOTS_NO_BATCH,
           "checkpoint_dots_with_no_batch_dims": _DOTS_NO_BATCH}


def checkpoint_policy(name: str = "nothing_saveable"):
    """The ops a policy keeps: None (``nothing_saveable``), "all"
    (``everything_saveable``) or a tuple of aten ops. Raises at once on
    an unknown name (ValueError) and on the six names of
    ``jax.checkpoint_policies`` that are policy factories (TypeError):
    ``save_only_these_names``, ``save_any_names_but_these``,
    ``save_anything_except_these_names``, ``save_from_both_policies``,
    ``offload_dot_with_no_batch_dims`` and
    ``save_and_offload_only_these_names`` each take names (or policies,
    or memory kinds) and return a policy. The JAX package passes the
    factory itself to ``jax.checkpoint``, which calls it as the policy
    when the step is traced and raises a TypeError (on the arguments,
    e.g. "unexpected keyword argument 'dimension_numbers'", or on the
    function it returns), and none of its models tags a tensor with
    ``checkpoint_name``, so there is no policy there to port."""
    if name not in JAX_POLICIES:
        raise ValueError(f"unknown checkpoint policy {name!r}; valid "
                         f"names: {list(JAX_POLICIES)}")
    if name not in _PORTED:
        raise TypeError(
            f"checkpoint policy {name!r} is a policy factory that takes "
            f"names (of tensors tagged with checkpoint_name), not a "
            f"policy: the JAX reference calls it as the policy and fails "
            f"with a TypeError when the step is traced, and no "
            f"model of the reference tags a tensor with checkpoint_name; "
            f"use one of {sorted(_PORTED)}")
    return _PORTED[name]


def _context_fn(saved: tuple):
    def policy(ctx, op, *args, **kwargs):
        return (ckpt.CheckpointPolicy.MUST_SAVE if op in saved
                else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)

    return functools.partial(ckpt.create_selective_checkpoint_contexts,
                             policy)


def checkpoint_with_policy(fn: Callable, policy_name: str) -> Callable:
    """``fn`` recomputed in the backward under the named policy."""
    saved = checkpoint_policy(policy_name)
    if saved == "all":
        return fn
    kw: dict = {"use_reentrant": False}
    if saved is not None:
        kw["context_fn"] = _context_fn(saved)

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        return ckpt.checkpoint(fn, *args, **kw, **kwargs)

    return wrapped


def checkpoint(fn: Callable) -> Callable:
    """``fn`` recomputed in full in the backward (the reference's
    ``checkpoint``, JAX's ``jax.checkpoint``)."""
    return checkpoint_with_policy(fn, "nothing_saveable")


def checkpoint_module(module: torch.nn.Module, policy_name: str, *args):
    """``module(*args)`` recomputed in the backward under the named
    policy (a model block's remat). The module's parameters enter the
    checkpointed function as inputs: under ``torch.func.functional_call``
    its attributes are swapped back before the backward runs, so the
    recompute must not read them."""
    names, params = zip(*module.named_parameters())
    n = len(args)

    def run(*inputs):
        return torch.func.functional_call(
            module, dict(zip(names, inputs[n:])), inputs[:n])

    return checkpoint_with_policy(run, policy_name)(*args, *params)

