"""Synchronized batch norm (the port of
``apex1_tpu/parallel/sync_batchnorm.py``; reference
``apex/parallel/optimized_sync_batchnorm.py``).

Statistics are per channel in fp32 over every axis but the feature
axis (channel-last by default). Two paths, as in the JAX package:

- local (no process group bound): mean and the two-pass variance
  ``mean((x - mean)^2)``;
- cross-replica: (Σx, Σx²) all-reduced over the groups (the reference's
  parallel Welford merge as one sum), mean = Σx/n and var = Σx²/n -
  mean², n the local count times the group size. ``group_size`` splits
  the group into subgroups of that many consecutive ranks. The sum's
  backward is a sum again (JAX's ``psum`` transpose), so the gradient
  of each rank's loss is the gradient of the summed loss: the
  reference's two all-reduced gradient statistics.

Groups are named as `parallel.ddp` resolves them: a mesh axis name
(``"dp"``, the default) through `parallel_state`'s mesh, a tuple of
names, or a ``ProcessGroup``; a name with no process group or mesh
installed means the local path (JAX's unbound axis).

Running statistics use the reference's momentum convention, new =
(1 - momentum)·old + momentum·batch, with the unbiased variance
stored. The normalized values are computed in fp32 and cast to the
input's dtype; γ and β enter in their own dtype (bf16 under O2, as
the amp step casts every float param).

`convert_syncbn_model` swaps every ``nn.BatchNorm*d`` of a torch model
for a `SyncBatchNorm` on the channel axis 1, weights and running
statistics copied.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
from torch import nn

from apex1_tpu_torch.ops._common import resolve_device
from apex1_tpu_torch.transformer.tensor_parallel import mappings as mp


class _PSum(torch.autograd.Function):
    """An all-reduced sum whose backward all-reduces the cotangent."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return mp.all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return mp.all_reduce(g, ctx.group), None


_SUBGROUPS: dict = {}


def _subgroup(group, group_size: int):
    """The subgroup of ``group_size`` consecutive ranks of ``group`` that
    holds this rank. Every rank enumerates the subgroups of every
    rank's group, so ``new_group`` runs alike everywhere."""
    ranks = tuple(dist.get_process_group_ranks(group))
    if len(ranks) % group_size:
        raise ValueError(f"group_size {group_size} must divide dp world "
                         f"{len(ranks)}")
    key = (id(dist.group.WORLD), ranks, group_size)
    if key not in _SUBGROUPS:
        every = [None] * dist.get_world_size()
        dist.all_gather_object(every, ranks)
        me = dist.get_rank()
        for grp in sorted(set(every)):
            for g in range(len(grp) // group_size):
                sub = list(grp[g * group_size:(g + 1) * group_size])
                pg = dist.new_group(sub)
                if me in sub and grp == ranks:
                    _SUBGROUPS[key] = pg
    return _SUBGROUPS[key]


def _groups(axis_name) -> list:
    """The process groups ``axis_name`` names, or [] where none is bound
    (the local path)."""
    if axis_name is None:
        return []
    if isinstance(axis_name, dist.ProcessGroup):
        return [axis_name]
    from apex1_tpu_torch.transformer import parallel_state
    if not (dist.is_available() and dist.is_initialized()
            and parallel_state.model_parallel_is_initialized()):
        return []
    from apex1_tpu_torch.parallel.ddp import resolve_groups
    return resolve_groups(axis_name)


def sync_batch_stats(x: torch.Tensor, *, groups: list, reduce_dims: tuple,
                     group_size: Optional[int] = None):
    """Cross-replica per-channel (mean, var, count): (Σx, Σx²) in fp32
    all-reduced over ``groups`` (one all-reduce a group)."""
    n = 1
    for d in reduce_dims:
        n *= x.shape[d]
    x32 = x.float()
    s = torch.stack([x32.sum(reduce_dims), x32.square().sum(reduce_dims)])
    if group_size is not None:
        if len(groups) != 1:
            raise ValueError("group_size needs exactly one group")
        groups = [_subgroup(groups[0], group_size)]
    for g in groups:
        s = _PSum.apply(s, g)
        n *= dist.get_world_size(g)
    mean = s[0] / n
    var = s[1] / n - mean.square()
    return mean, var, n


def batch_norm(x: torch.Tensor, scale, bias, mean, var, *, train: bool,
               momentum: float = 0.1, eps: float = 1e-5,
               feature_axis: int = -1, groups: list = (),
               group_size: Optional[int] = None,
               track_running_stats: bool = True):
    """``(y, new_mean, new_var)``: the functional batch norm. ``train``
    normalizes with the batch statistics (synced over ``groups`` when
    there are any) and, with ``track_running_stats``, returns the new
    running statistics (detached); else it normalizes with ``mean`` and
    ``var`` and returns them unchanged."""
    ax = feature_axis % x.ndim
    dims = tuple(d for d in range(x.ndim) if d != ax)
    shape = [1] * x.ndim
    shape[ax] = x.shape[ax]
    x32 = x.float()
    new_mean, new_var = mean, var
    if not train:
        m, v = mean, var
        xc = x32 - m.reshape(shape)
    else:
        if groups:
            m, v, n = sync_batch_stats(x, groups=list(groups),
                                       reduce_dims=dims,
                                       group_size=group_size)
            xc = x32 - m.reshape(shape)
        else:
            m = x32.mean(dims)
            xc = x32 - m.reshape(shape)
            v = xc.square().mean(dims)
            n = x32.numel() // x.shape[ax]
        if track_running_stats:
            unbiased = v.detach() * (n / max(n - 1, 1))
            new_mean = (1 - momentum) * mean + momentum * m.detach()
            new_var = (1 - momentum) * var + momentum * unbiased
    y = xc * torch.rsqrt(v.reshape(shape) + eps)
    if scale is not None:
        y = y * scale.reshape(shape)
    if bias is not None:
        y = y + bias.reshape(shape)
    return y.to(x.dtype), new_mean, new_var


class SyncBatchNorm(nn.Module):
    """``apex.parallel.SyncBatchNorm(num_features, eps, momentum, affine,
    track_running_stats, process_group, channel_last)``: params
    ``scale`` and ``bias`` (fp32, (C,)), buffers ``mean`` and ``var``.
    ``forward`` updates the buffers in place in training (torch's
    idiom); `stats_forward` returns the new statistics instead, for a
    functional step that carries them (`models.resnet`). The tensors
    live on ``device``: CUDA unless the caller names another (asking
    for CUDA without a card raises)."""

    def __init__(self, num_features: int, eps: float = 1e-5,
                 momentum: float = 0.1, affine: bool = True,
                 track_running_stats: bool = True,
                 use_running_average: Optional[bool] = None,
                 feature_axis: int = -1, axis_name="dp",
                 group_size: Optional[int] = None, device=None):
        super().__init__()
        self.num_features, self.eps, self.momentum = num_features, eps, \
            momentum
        self.affine = affine
        self.track_running_stats = track_running_stats
        self.use_running_average = use_running_average
        self.feature_axis, self.axis_name = feature_axis, axis_name
        self.group_size = group_size
        kw = dict(dtype=torch.float32, device=resolve_device(device))
        self.scale = (nn.Parameter(torch.ones(num_features, **kw))
                      if affine else None)
        self.bias = (nn.Parameter(torch.zeros(num_features, **kw))
                     if affine else None)
        self.register_buffer("mean", torch.zeros(num_features, **kw))
        self.register_buffer("var", torch.ones(num_features, **kw))

    def _use_running(self, use_running_average) -> bool:
        for v in (use_running_average, self.use_running_average):
            if v is not None:
                return bool(v)
        return not self.training

    def stats_forward(self, x: torch.Tensor,
                      use_running_average: Optional[bool] = None):
        """``(y, {"mean", "var"})``: the new running statistics (the
        buffers' values when they are not updated)."""
        y, m, v = batch_norm(
            x, self.scale, self.bias, self.mean, self.var,
            train=not self._use_running(use_running_average),
            momentum=self.momentum, eps=self.eps,
            feature_axis=self.feature_axis, groups=_groups(self.axis_name),
            group_size=self.group_size,
            track_running_stats=self.track_running_stats)
        return y, {"mean": m, "var": v}

    def forward(self, x: torch.Tensor,
                use_running_average: Optional[bool] = None) -> torch.Tensor:
        y, stats = self.stats_forward(x, use_running_average)
        if stats["mean"] is not self.mean:
            with torch.no_grad():
                self.mean.copy_(stats["mean"])
                self.var.copy_(stats["var"])
        return y


def convert_syncbn_model(module: nn.Module, *, axis_name="dp",
                         group_size: Optional[int] = None) -> nn.Module:
    """``apex.parallel.convert_syncbn_model(net)``: every
    ``nn.BatchNorm1d/2d/3d`` (and torch's own ``SyncBatchNorm``) of
    ``module`` replaced, in place, by a `SyncBatchNorm` on the channel
    axis 1 with its eps, momentum, affine flags, training mode, weights
    and running statistics, on the device of the batch norm's first
    parameter or buffer (the CPU where it holds none, as a torch batch
    norm made without a device is); returns ``module`` (the converted
    module if ``module`` itself is a batch norm)."""
    if isinstance(module, nn.modules.batchnorm._BatchNorm):
        if module.momentum is None:
            raise ValueError("momentum=None (a cumulative average) has no "
                             "SyncBatchNorm counterpart")
        ref = next(iter(module.parameters()),
                   next(iter(module.buffers()), None))
        sbn = SyncBatchNorm(
            module.num_features, eps=module.eps, momentum=module.momentum,
            affine=module.affine,
            track_running_stats=module.track_running_stats,
            feature_axis=1, axis_name=axis_name, group_size=group_size,
            device="cpu" if ref is None else ref.device)
        with torch.no_grad():
            if module.affine:
                sbn.scale.copy_(module.weight)
                sbn.bias.copy_(module.bias)
            if module.running_mean is not None:
                sbn.mean.copy_(module.running_mean)
                sbn.var.copy_(module.running_var)
        sbn.train(module.training)
        return sbn
    for name, child in module.named_children():
        new = convert_syncbn_model(child, axis_name=axis_name,
                                   group_size=group_size)
        if new is not child:
            setattr(module, name, new)
    return module
