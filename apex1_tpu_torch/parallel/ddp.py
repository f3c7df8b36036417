"""Data-parallel gradient averaging (the port of
``apex1_tpu/parallel/ddp.py``; reference ``apex/parallel/distributed.py
:: DistributedDataParallel``).

- `allreduce_grads`: the mean of a gradient dict over the data-parallel
  groups with the reference's ``gradient_predivide_factor`` (predivide,
  sum, postdivide by world / factor), each dtype's tensors flattened
  into one buffer and all-reduced once (the reference's bucket);
- `broadcast_params`: every rank takes the group's first rank's values
  (the reference's broadcast at construction);
- `DistributedDataParallel`: the reference's constructor over a
  ``loss_fn(params, *batch)``; ``value_and_grad()`` returns the loss
  and the averaged gradients. ``message_size``, ``delay_allreduce`` and
  ``retain_allreduce_buffers`` are recorded and change nothing: the
  gradients are averaged once, after the backward, in one bucket a
  dtype.

A group is a ``ProcessGroup`` or a mesh axis name (``"dp"``), which
`parallel_state`'s installed mesh resolves; the default is the
data-parallel group.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from apex1_tpu_torch.transformer.tensor_parallel import mappings as mp


def resolve_groups(groups) -> list:
    """Process groups for ``groups``: ProcessGroups as given, axis names
    through `parallel_state`'s mesh; None is the data-parallel group."""
    from apex1_tpu_torch.transformer import parallel_state
    if groups is None:
        return [parallel_state.get_data_parallel_group()]
    if isinstance(groups, (str, dist.ProcessGroup)):
        groups = (groups,)
    return [parallel_state.get_mesh().group(g) if isinstance(g, str) else g
            for g in groups]


def _flat_sum(tensors: list, groups: list) -> list:
    """``tensors`` summed over every group, one all-reduce a group for
    each dtype's flattened bucket; new tensors, in order."""
    out = list(tensors)
    by_dtype = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(i)
    for idx in by_dtype.values():
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        for g in groups:
            flat = mp.all_reduce(flat, g)
        offset = 0
        for i in idx:
            n = tensors[i].numel()
            out[i] = flat[offset:offset + n].view_as(tensors[i])
            offset += n
    return out


def mean_over(tree: dict, groups) -> dict:
    """The mean of each floating tensor of ``tree`` over ``groups``
    (JAX's ``pmean``: the sum, divided by the group size), group by
    group; other entries unchanged."""
    out = dict(tree)
    for g in resolve_groups(groups):
        keys = [k for k, v in out.items() if torch.is_floating_point(v)]
        summed = _flat_sum([out[k] for k in keys], [g])
        n = dist.get_world_size(g)
        out.update({k: s / n for k, s in zip(keys, summed)})
    return out


def allreduce_grads(grads: dict, *, groups=None,
                    gradient_predivide_factor: float = 1.0) -> dict:
    """The mean of ``grads`` over the data-parallel ``groups``: each
    floating gradient times 1/factor, summed over the groups, times
    factor/world (the reference's predivide semantics, exactly). A new
    dict; other entries unchanged."""
    groups = resolve_groups(groups)
    world = 1
    for g in groups:
        world *= dist.get_world_size(g)
    pre = 1.0 / gradient_predivide_factor
    post = gradient_predivide_factor / world
    keys = [k for k, v in grads.items() if torch.is_floating_point(v)]
    summed = _flat_sum([grads[k] * pre for k in keys], groups)
    out = dict(grads)
    out.update({k: s * post for k, s in zip(keys, summed)})
    return out


def broadcast_params(params: dict, *, groups=None) -> dict:
    """Each tensor of ``params`` as the first rank of each group holds it
    (rank 0 of the data-parallel replicas wins); new tensors."""
    out = dict(params)
    for g in resolve_groups(groups):
        src = dist.get_process_group_ranks(g)[0]
        for k, v in out.items():
            t = v.detach().clone()
            dist.broadcast(t, src=src, group=g)
            out[k] = t
    return out


class DistributedDataParallel:
    """The reference's ``DistributedDataParallel(module, message_size,
    delay_allreduce, ...)`` over ``loss_fn(params, *batch)``:
    ``value_and_grad()(params, *batch)`` returns (loss, grads) with the
    grads averaged over the data-parallel groups."""

    def __init__(self, loss_fn: Callable, *,
                 message_size: int = 10_000_000,
                 delay_allreduce: bool = False,
                 gradient_predivide_factor: float = 1.0,
                 retain_allreduce_buffers: bool = False,
                 groups=None):
        self.loss_fn = loss_fn
        self.message_size = message_size
        self.delay_allreduce = delay_allreduce
        self.gradient_predivide_factor = gradient_predivide_factor
        self.retain_allreduce_buffers = retain_allreduce_buffers
        self.groups = groups

    def __call__(self, params, *batch):
        return self.loss_fn(params, *batch)

    def value_and_grad(self) -> Callable:
        def f(params: dict, *batch):
            leaves = {k: p.detach().requires_grad_() for k, p in
                      params.items() if torch.is_floating_point(p)}
            with torch.enable_grad():
                loss = self.loss_fn({**params, **leaves}, *batch)
                got = torch.autograd.grad(loss, list(leaves.values()),
                                          allow_unused=True)
            grads = {k: torch.zeros_like(p) if g is None else g
                     for (k, p), g in zip(leaves.items(), got)}
            return loss.detach(), allreduce_grads(
                grads, groups=self.groups,
                gradient_predivide_factor=self.gradient_predivide_factor)

        return f
