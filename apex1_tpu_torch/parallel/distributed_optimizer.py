"""ZeRO-style sharded optimizers (the port of ``apex1_tpu/parallel/
distributed_optimizer.py``; reference ``apex/contrib/optimizers/
distributed_fused_adam.py :: DistributedFusedAdam`` and
``distributed_fused_lamb.py :: DistributedFusedLAMB``).

Two forms, as in the JAX package:

1. **Sharding as data**: `fsdp_param_specs` and `shard_opt_state_specs`
   give `parallel.specs.PartitionSpec`s that split each parameter (the
   largest dimension) and its moments over ``fsdp``; placed with
   `core.mesh.place`, a loss that gathers its parameters
   (`core.mesh.gather`) leaves reduce-scattered gradients, and an
   element-wise optimizer then updates each rank's block where it lies.
2. **The explicit dataflow**: `distributed_fused_adam` and
   `distributed_fused_lamb` flatten the float parameters and gradients
   (`core.pytree.flatten_tree`), zero-pad them to a multiple of the
   group, reduce-scatter the mean gradient (`mappings.reduce_scatter`),
   update this rank's slice of the flat buffer, and all-gather the
   result (`mappings.all_gather`): one reduce-scatter and one
   all-gather a step, LAMB adding one all-reduce for its global
   gradient norm and, with weight decay or ``use_nvlamb``, two for its
   per-tensor trust ratios (segment sums over the slice).

The flat buffer follows the params dict's order (`flatten_tree`), not
the JAX package's sorted key order, so rank r's slice holds other
elements than JAX's device r; Adam is element-wise and unaffected,
LAMB's sums round in another order. The padding is zero in the
parameters and gradients, so its moments stay zero: `repack_flat_shard`
moves a global flat buffer between world sizes exactly.

``axis_name`` is a mesh axis of `parallel_state` (or a process group);
with no mesh installed the group is this one rank.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Union

import numpy as np
import torch

from apex1_tpu_torch.core.mesh import AXIS_FSDP
from apex1_tpu_torch.core.pytree import flatten_tree
from apex1_tpu_torch.optim.fused_adam import (FusedAdamState,
                                              bias_corrections, fused_adam)
from apex1_tpu_torch.parallel.specs import PartitionSpec as P
from apex1_tpu_torch.transformer import parallel_state
from apex1_tpu_torch.transformer.tensor_parallel import mappings as mp


def _flax_order(name: str, ndim: int) -> tuple:
    """The port dimensions of parameter ``name`` in the JAX package's
    layout: an ``nn.Linear`` ``*.weight`` (out, in) is the flax kernel
    (in, out) transposed, a convolution's OIHW weight its HWIO kernel;
    every other parameter keeps the flax layout."""
    if name.endswith("weight") and ndim == 2:
        return (1, 0)
    if name.endswith("weight") and ndim == 4:
        return (2, 3, 1, 0)
    return tuple(range(ndim))


def fsdp_param_specs(params: dict, *, axis: str = AXIS_FSDP,
                     min_size: int = 2 ** 12,
                     divisor: Union[int, None] = None) -> dict:
    """ZeRO-3 as data: a spec per parameter splitting one dimension
    over ``axis``, the largest one divisible by ``divisor`` (the fsdp
    degree: no uneven blocks), else the largest. A tie goes to the
    first dimension in the JAX package's layout (its stable sort), so a
    square ``nn.Linear`` weight splits its input dimension, as flax's
    kernel splits its dimension 0. Parameters under ``min_size``
    elements stay whole (gathering them costs more than they save)."""
    def spec(name, p):
        shape = tuple(p.shape)
        if not shape or math.prod(shape) < min_size:
            return P()
        order = _flax_order(name, len(shape))
        ranked = sorted(order, key=lambda i: -shape[i])
        if divisor:
            ok = [i for i in ranked if shape[i] % divisor == 0]
            d = ok[0] if ok else ranked[0]
        else:
            d = ranked[0]
        return P(*[axis if i == d else None for i in range(len(shape))])

    return {k: spec(k, p) for k, p in params.items()}


def shard_opt_state_specs(opt_state, *, axis: str = AXIS_FSDP,
                          param_specs: Union[dict, None] = None):
    """Specs for an optimizer state, ZeRO-1 as data: with
    ``param_specs`` every dict of the state keyed like the params (a
    moment) takes the params' specs, so each moment splits on its
    parameter's dimension and the update stays where it lies; any
    other tensor of one or more dimensions splits dimension 0, a 0-d
    one (a step count) stays whole. The result mirrors the state's
    dataclasses, dicts and tuples with specs for tensors."""
    def dim0(leaf):
        if leaf.dim() == 0:
            return P()
        return P(axis, *([None] * (leaf.dim() - 1)))

    def fits(node):
        return (param_specs is not None and isinstance(node, dict)
                and set(node) == set(param_specs)
                and all(isinstance(v, torch.Tensor)
                        and len(param_specs[k]) <= v.dim()
                        for k, v in node.items()))

    def walk(node):
        if fits(node):
            return dict(param_specs)
        if isinstance(node, torch.Tensor):
            return dim0(node)
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if dataclasses.is_dataclass(node):
            return dataclasses.replace(node, **{
                f.name: walk(getattr(node, f.name))
                for f in dataclasses.fields(node)})
        if isinstance(node, (tuple, list)):
            return type(node)(walk(v) for v in node)
        return node

    return walk(opt_state)


def flat_param_len(params: dict) -> int:
    """The unpadded length of the flat float buffer `flatten_tree` packs
    (float tensors only), the set the distributed optimizers shard."""
    return sum(v.numel() for v in params.values()
               if torch.is_floating_point(v))


def shard_padded_len(n: int, world: int) -> int:
    """``n`` padded to a multiple of ``world``."""
    return int(n) + (-int(n)) % int(world)


def repack_flat_shard(flat, *, flat_len: int, world_from: int,
                      world_to: int) -> np.ndarray:
    """A global flat optimizer buffer (the ranks' slices concatenated)
    padded for ``world_from`` ranks, repacked for ``world_to``: the old
    padding cut at ``flat_len``, zeros appended. Exact: the padding's
    parameters and gradients are zero, so its moments are too. Host
    numpy, the reshard hook of a checkpoint."""
    a = np.asarray(flat)
    if a.ndim != 1:
        raise ValueError(f"flat shard buffer must be 1-D, got {a.shape}")
    want = shard_padded_len(flat_len, world_from)
    if a.shape[0] != want:
        raise ValueError(
            f"flat shard buffer has {a.shape[0]} elements, expected "
            f"{want} (= {flat_len} padded for world {world_from})")
    pad = shard_padded_len(flat_len, world_to) - int(flat_len)
    core = a[:int(flat_len)]
    if pad == 0:
        return core.copy()
    return np.concatenate([core, np.zeros((pad,), a.dtype)])


@dataclasses.dataclass(frozen=True)
class DistributedAdamState:
    """``step`` int32 0-d; the moments of this rank's flat slice."""

    step: torch.Tensor
    exp_avg_shard: torch.Tensor
    exp_avg_sq_shard: torch.Tensor


@dataclasses.dataclass(frozen=True)
class DistributedLambState:
    step: torch.Tensor
    exp_avg_shard: torch.Tensor
    exp_avg_sq_shard: torch.Tensor


class _Sharded:
    """The flat-buffer dataflow both optimizers share. ``update``
    (the `GradientTransformation` face, for `Amp`) all-gathers the
    update slices; ``step`` all-gathers the new parameter slices."""

    state_cls = DistributedAdamState

    def __init__(self, axis_name, overlap_grad_sync=True,
                 bucket_cap_mb=None, process_group_size=None):
        self.axis_name = axis_name
        # the reference's knobs, kept for its configs: the collectives
        # are one call each, so there is nothing to bucket or overlap
        self.overlap_grad_sync = overlap_grad_sync
        self.bucket_cap_mb = bucket_cap_mb
        self.process_group_size = process_group_size

    def _group(self):
        return parallel_state.resolve_group(self.axis_name)

    def init(self, params: dict, world: Union[int, None] = None):
        """Zero moments for this rank's slice; ``world`` defaults to the
        group's size."""
        if world is None:
            world = parallel_state.group_size_rank(self._group())[0]
        shard = shard_padded_len(flat_param_len(params), world) // world
        dev = next(iter(params.values())).device
        z = torch.zeros((shard,), dtype=torch.float32, device=dev)
        return self.state_cls(
            step=torch.zeros((), dtype=torch.int32, device=dev),
            exp_avg_shard=z, exp_avg_sq_shard=z.clone())

    def _run(self, grads: dict, state, params: dict, apply: bool):
        group = self._group()
        world, idx = parallel_state.group_size_rank(group)
        gflat, _ = flatten_tree(grads, torch.float32)
        pflat, unflatten = flatten_tree(params, torch.float32)
        n = gflat.shape[0]
        pad = (-n) % world
        if pad:
            gflat = torch.nn.functional.pad(gflat, (0, pad))
            pflat = torch.nn.functional.pad(pflat, (0, pad))
        shard = gflat.shape[0] // world
        if group is None:
            g = gflat / world
        else:
            g = mp.reduce_scatter(gflat, group, 0) / world
        p = pflat[idx * shard:(idx + 1) * shard]
        where = _Where(group, world, idx, shard, params)
        u, new_state = self._shard_update(g, p, state, where)
        out = p + u if apply else u
        if group is not None:
            out = mp.all_gather(out, group, 0)
        return unflatten(out[:n]), new_state

    def update(self, grads: dict, state, params: dict):
        """``(updates, new_state)``: apply with ``p + u``."""
        return self._run(grads, state, params, apply=False)

    def step(self, grads: dict, state, params: dict):
        """``(new_params, new_state)``."""
        return self._run(grads, state, params, apply=True)


@dataclasses.dataclass(frozen=True)
class _Where:
    """Where a rank's slice lies: its group (None: one rank), the group
    size, its index, the slice length and the params it flattens."""

    group: object
    world: int
    idx: int
    shard: int
    params: dict


class _DistAdam(_Sharded):
    def __init__(self, inner, **kw):
        super().__init__(**kw)
        self._inner = inner

    def _shard_update(self, g, p, state, where):
        st = FusedAdamState(step=state.step,
                            exp_avg={"p": state.exp_avg_shard},
                            exp_avg_sq={"p": state.exp_avg_sq_shard})
        upd, st = self._inner.update({"p": g}, st, {"p": p})
        return upd["p"], DistributedAdamState(
            step=st.step, exp_avg_shard=st.exp_avg["p"],
            exp_avg_sq_shard=st.exp_avg_sq["p"])


def distributed_fused_adam(
        learning_rate: Union[float, Callable] = 1e-3, b1: float = 0.9,
        b2: float = 0.999, eps: float = 1e-8, weight_decay: float = 0.0,
        adam_w_mode: bool = True, bias_correction: bool = True, *,
        axis_name=AXIS_FSDP, overlap_grad_sync: bool = True,
        bucket_cap_mb=None, process_group_size=None):
    """Sharded Adam: ``init(params, world=None)``, ``update(grads,
    state, params) -> (updates, state)`` and ``step(grads, state,
    params) -> (params, state)``. The slice's update is
    `optim.fused_adam`'s on ``{"p": slice}``, as the JAX package calls
    its own."""
    return _DistAdam(fused_adam(learning_rate, b1, b2, eps, weight_decay,
                                adam_w_mode, bias_correction),
                     axis_name=axis_name,
                     overlap_grad_sync=overlap_grad_sync,
                     bucket_cap_mb=bucket_cap_mb,
                     process_group_size=process_group_size)


class _DistLamb(_Sharded):
    state_cls = DistributedLambState

    def __init__(self, learning_rate, b1, b2, eps, weight_decay,
                 bias_correction, max_grad_norm, use_nvlamb, axis_name):
        super().__init__(axis_name)
        self.hp = (learning_rate, b1, b2, eps, weight_decay,
                   bias_correction, max_grad_norm, use_nvlamb)

    @staticmethod
    def _spans(where: _Where):
        """The segments this rank's slice meets, as (segment, start,
        end) within the slice, and the segment count: tensor i of the
        float params is segment i, the padding the last one."""
        sizes = [v.numel() for v in where.params.values()
                 if torch.is_floating_point(v)]
        sizes.append((-sum(sizes)) % where.world)
        lo, hi = where.idx * where.shard, (where.idx + 1) * where.shard
        spans, off = [], 0
        for i, size in enumerate(sizes):
            a, b = max(off, lo), min(off + size, hi)
            if a < b:
                spans.append((i, a - lo, b - lo))
            off += size
        return spans, len(sizes)

    def _shard_update(self, g, p, state, where):
        (lr, b1, b2, eps, wd, bias_correction, max_grad_norm,
         use_nvlamb) = self.hp

        def psum(x):
            return x if where.group is None else mp.all_reduce(x,
                                                               where.group)

        gsq = psum(g.square().sum())
        clip = torch.clamp(torch.sqrt(gsq) / max_grad_norm, min=1.0)
        step = state.step + 1
        lr = lr(step) if callable(lr) else lr
        bc1, bc2 = bias_corrections(b1, b2, step, bias_correction)
        g = g / clip
        m = b1 * state.exp_avg_shard + (1.0 - b1) * g
        v = b2 * state.exp_avg_sq_shard + (1.0 - b2) * g.square()
        u = (m / bc1) / (torch.sqrt(v / bc2) + eps)
        if wd:
            u = u + wd * p
        if wd or use_nvlamb:
            spans, n_seg = self._spans(where)
            ids = torch.tensor([i for i, _, _ in spans], device=p.device)

            def seg_sum(x):
                # each segment a contiguous run of the slice: one
                # reduction a run, scattered to its segment's entry
                part = torch.stack([x[a:b].sum() for _, a, b in spans])
                return psum(torch.zeros(n_seg, dtype=x.dtype,
                                        device=x.device).index_copy(
                                            0, ids, part))

            w_sq, u_sq = seg_sum(p.square()), seg_sum(u.square())
            ratio = torch.where((w_sq > 0) & (u_sq > 0),
                                torch.sqrt(w_sq) / torch.sqrt(
                                    torch.clamp(u_sq, min=1e-30)), 1.0)
            lengths = torch.tensor([b - a for _, a, b in spans],
                                   device=p.device)
            u = ratio[ids].repeat_interleave(
                lengths, output_size=where.shard) * u
        return -lr * u, DistributedLambState(
            step=step, exp_avg_shard=m, exp_avg_sq_shard=v)


def distributed_fused_lamb(
        learning_rate: Union[float, Callable] = 1e-3, b1: float = 0.9,
        b2: float = 0.999, eps: float = 1e-6, weight_decay: float = 0.01,
        bias_correction: bool = True, max_grad_norm: float = 1.0,
        use_nvlamb: bool = False, *, axis_name=AXIS_FSDP):
    """Sharded LAMB (the MLPerf BERT recipe's optimizer), the same
    flat-buffer dataflow as `distributed_fused_adam` with LAMB's two
    norm passes rebuilt over the slices: the global gradient norm from
    one all-reduce, and each tensor's ||p|| / ||u|| trust ratio from
    segment sums and one all-reduce each. A segment is a contiguous run
    of the slice, so each sum is one reduction over its run: an
    ``index_add_`` of the slice's elements is atomics into a few
    addresses on the card, slow, and its fp32 sums of millions of terms
    round far worse than a tree reduction."""
    return _DistLamb(learning_rate, b1, b2, eps, weight_decay,
                     bias_correction, max_grad_norm, use_nvlamb, axis_name)
