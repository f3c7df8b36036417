"""Halo exchange: spatial parallelism for convolutions (the port of
``apex1_tpu/parallel/halo.py``; reference ``apex/contrib/bottleneck/
halo_exchangers.py :: HaloExchangerPeer / HaloExchangerNccl``).

An activation is split along H (or W) over a group; before a k x k
convolution each rank takes ``k // 2`` boundary rows from each
neighbour. Two directional transfers an exchange, each a
``dist.batch_isend_irecv`` (`mappings.Hop`): my last rows to the next
rank (its top halo), my first rows to the previous one (its bottom
halo). At the global edges the halos are zeros (a SAME convolution's
padding) unless ``periodic``. The backward sends each halo's gradient
back the way it came. A group of one rank exchanges with itself: no
transfer.

`exchange_overlap` posts both transfers before it runs the caller's
``interior_fn`` on the local shard (computation that needs no halo), and
waits after it. `spatial_conv2d` is the whole pattern: an exchange,
then a convolution VALID on the split axis and SAME on the other, equal
to the SAME convolution of the unsplit activation.

``axis_name`` is a mesh axis of `parallel_state` or a process group.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from apex1_tpu_torch.transformer import parallel_state
from apex1_tpu_torch.transformer.tensor_parallel.mappings import (
    OVERLAP_SPANS, Hop)


def _edges(x: torch.Tensor, halo: int, dim: int):
    """(the last ``halo`` slices, the first ``halo`` slices) along
    ``dim``."""
    size = x.shape[dim]
    if halo > size:
        raise ValueError(f"halo {halo} exceeds local extent {size}")
    return x.narrow(dim, size - halo, halo), x.narrow(dim, 0, halo)


class _Posted:
    """Both transfers of an exchange in flight: ``to_next`` to the next
    rank, ``to_prev`` to the previous one (for one rank, to itself);
    ``wait`` returns what came (from the previous, from the next)."""

    def __init__(self, to_next, to_prev, group):
        if group is None or parallel_state.group_size_rank(group)[0] == 1:
            self._hops, self._got = None, (to_next, to_prev)
        else:
            self._hops = (Hop([to_next], group, 1), Hop([to_prev], group, -1))

    def wait(self):
        if self._hops is None:
            return self._got
        return self._hops[0].wait()[0], self._hops[1].wait()[0]


class _Received(torch.autograd.Function):
    """Ties the received halos to the edges they came from: the
    backward sends each halo's gradient back to its sender."""

    @staticmethod
    def forward(ctx, last, first, from_prev, from_next, group):
        ctx.group = group
        return from_prev.view_as(from_prev), from_next.view_as(from_next)

    @staticmethod
    def backward(ctx, g_prev, g_next):
        # the previous rank's bottom halo came from my first rows, the
        # next rank's top halo from my last rows
        g_first, g_last = _Posted(g_next.contiguous(), g_prev.contiguous(),
                                  ctx.group).wait()
        return g_last, g_first, None, None, None


def _post(x, axis_name, halo: int, dim: int):
    group = parallel_state.resolve_group(axis_name)
    last, first = _edges(x, halo, dim)
    return group, last, first, _Posted(last.detach().contiguous(),
                                       first.detach().contiguous(), group)


def _finish(group, last, first, posted, periodic: bool):
    from_prev, from_next = _Received.apply(last, first, *posted.wait(),
                                           group)
    if not periodic:
        n, idx = parallel_state.group_size_rank(group)
        if idx == 0:
            from_prev = torch.zeros_like(from_prev)
        if idx == n - 1:
            from_next = torch.zeros_like(from_next)
    return from_prev, from_next


def halo_exchange(x: torch.Tensor, axis_name, *, halo: int, dim: int = 1,
                  periodic: bool = False) -> torch.Tensor:
    """The local shard ``x`` extended along ``dim`` by ``halo`` slices
    from each neighbour."""
    if halo <= 0:
        return x
    group, last, first, posted = _post(x, axis_name, halo, dim)
    from_prev, from_next = _finish(group, last, first, posted, periodic)
    return torch.cat([from_prev, x, from_next], dim=dim)


def exchange_overlap(x: torch.Tensor, interior_fn: Callable, axis_name, *,
                     halo: int, dim: int = 1, periodic: bool = False):
    """``(halo_exchange(x, ...), interior_fn(x))``, with both transfers
    posted before ``interior_fn`` runs and waited on after it: the span
    ``overlap.body:halo`` of a profiler trace, ``interior_fn`` its
    ``overlap.compute`` (what the overlap probe reads)."""
    if halo <= 0:
        return x, interior_fn(x)
    with record_function(f"{OVERLAP_SPANS['body']}:halo"):
        group, last, first, posted = _post(x, axis_name, halo, dim)
        with record_function(OVERLAP_SPANS["compute"]):
            interior = interior_fn(x)
        from_prev, from_next = _finish(group, last, first, posted, periodic)
    return torch.cat([from_prev, x, from_next], dim=dim), interior


def spatial_conv2d(x: torch.Tensor, weight: torch.Tensor, axis_name, *,
                   dim: int = 1) -> torch.Tensor:
    """The SAME convolution of an NHWC activation split along H
    (``dim=1``) or W (``dim=2``): a halo exchange on the split axis,
    then ``F.conv2d`` (``weight`` OIHW, odd sizes, stride 1) VALID on
    it and SAME on the other."""
    if dim not in (1, 2):
        raise ValueError("dim must be 1 (H-sharded) or 2 (W-sharded)")
    kh, kw = weight.shape[2], weight.shape[3]
    if kh % 2 == 0 or kw % 2 == 0:
        raise ValueError("odd kernel sizes only")
    halo = (kh if dim == 1 else kw) // 2
    other = (kw if dim == 1 else kh) // 2
    ext = halo_exchange(x, axis_name, halo=halo, dim=dim)
    pad = (0, other) if dim == 1 else (other, 0)
    y = F.conv2d(ext.permute(0, 3, 1, 2), weight, padding=pad)
    return y.permute(0, 2, 3, 1)
