"""Tensor-parallel collectives (the port of
``apex1_tpu/transformer/tensor_parallel/mappings.py``; reference
``apex/transformer/tensor_parallel/mappings.py``).

Each region function is a ``torch.autograd.Function`` pairing a forward
collective over a process group with its dual in the backward:

    copy_to_tensor_model_parallel_region      fwd identity        bwd all-reduce
    reduce_from_tensor_model_parallel_region  fwd all-reduce      bwd identity
    scatter_to_tensor_model_parallel_region   fwd split(last)     bwd all-gather
    gather_from_tensor_model_parallel_region  fwd all-gather      bwd split
    scatter_to_sequence_parallel_region       fwd split(seq)      bwd all-gather
    gather_from_sequence_parallel_region      fwd all-gather(seq) bwd reduce-scatter
                                              (or split without
                                              ``tensor_parallel_output_grad``)
    reduce_scatter_to_sequence_parallel_region fwd reduce-scatter bwd all-gather

``group`` defaults to `parallel_state`'s tensor-parallel group. Gathers
concatenate the ranks' chunks in group order, as JAX's tiled
``all_gather``; a reduce-scatter leaves rank i chunk i of the sum.

The decomposed collective matmuls `all_gather_matmul` and
`matmul_reduce_scatter` (the JAX package's ``_agm_loop`` and
``_mrs_loop``) pipeline the sequence-parallel boundary over a ring of
point-to-point hops: each hop (``dist.batch_isend_irecv`` to group
index i + 1 from i - 1, JAX's ``ppermute``) is posted before the
chunk product it overlaps and waited on after it. The reduce-scatter's
travelling accumulator keeps JAX's order exactly: a hop ships
``acc + pend``, there are n hops including the zero seed, and each rank
ends with its own chunk, so the fused forms (`ops.fused_collective`)
equal these bit for bit. The chunk products are ``torch.matmul`` with
an fp32 result, as JAX leaves them to XLA.

`COLLECTIVES` counts the calls of each kind (a tensor a hop for
``send_recv``), the port's answer to the JAX package's count of
collectives in the compiled program: `reset_collectives` and
`collective_counts` read it like the kernels' ``.launches``.
"""

from __future__ import annotations

import itertools
from typing import Callable

import torch
import torch.distributed as dist
from torch.profiler import record_function

#: calls of each collective kind since the last `reset_collectives`
COLLECTIVES = {"all_reduce": 0, "all_gather": 0, "reduce_scatter": 0,
               "send_recv": 0, "all_to_all": 0, "broadcast": 0}


#: ring steps posted (each `Hop`) or entered (each ring attention call,
#: a ring of one rank too): the count the pipeline schedules watch to
#: keep the JAX package's bubble-skip contract (no ``ppermute`` in a
#: skipped stage)
PERMUTES = {"count": 0}

#: the span names of a ``torch.profiler`` trace that the overlap probe
#: (`testing.hlo_probe`) reads: a ring's or an exchange's ``body``
#: (``overlap.body:<name>``), each `Hop`'s ``post`` and ``wait``
#: (``#<id>``), and the ``compute`` a hop in flight should hide
OVERLAP_SPANS = {"body": "overlap.body", "post": "overlap.hop.post",
                 "wait": "overlap.hop.wait", "compute": "overlap.compute"}


def reset_collectives() -> None:
    for k in COLLECTIVES:
        COLLECTIVES[k] = 0


def collective_counts() -> dict:
    return dict(COLLECTIVES)


def _group(group):
    if group is not None:
        return group
    from apex1_tpu_torch.transformer import parallel_state
    return parallel_state.get_tensor_model_parallel_group()


# ---- the collectives, counted -------------------------------------------


def all_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """A new tensor: ``op`` of ``x`` over the group."""
    out = x.contiguous().clone()
    dist.all_reduce(out, op=op, group=group)
    COLLECTIVES["all_reduce"] += 1
    return out


def all_gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim`` in group order."""
    n = dist.get_world_size(group)
    xt = x.movedim(dim, 0).contiguous()
    out = xt.new_empty((n * xt.shape[0],) + tuple(xt.shape[1:]))
    gather = (getattr(dist, "all_gather_single", None)
              or dist.all_gather_into_tensor)
    gather(out, xt, group=group)
    COLLECTIVES["all_gather"] += 1
    return out.movedim(0, dim).contiguous()


def reduce_scatter(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """This rank's chunk along ``dim`` of the group's sum of ``x``."""
    n = dist.get_world_size(group)
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} size {x.shape[dim]} not divisible by "
                         f"group size {n}")
    xt = x.movedim(dim, 0).contiguous()
    out = xt.new_empty((xt.shape[0] // n,) + tuple(xt.shape[1:]))
    scatter = (getattr(dist, "reduce_scatter_single", None)
               or dist.reduce_scatter_tensor)
    scatter(out, xt, group=group)
    COLLECTIVES["reduce_scatter"] += 1
    return out.movedim(0, dim).contiguous()


def all_to_all(x: torch.Tensor, group, split_dim: int,
               concat_dim: int) -> torch.Tensor:
    """JAX's tiled ``all_to_all``: ``x`` split along ``split_dim`` into
    one chunk a rank (chunk j to group index j), the chunks received
    concatenated along ``concat_dim`` in group order (one
    ``all_to_all_single``)."""
    n = dist.get_world_size(group)
    if x.shape[split_dim] % n:
        raise ValueError(f"dim {split_dim} size {x.shape[split_dim]} not "
                         f"divisible by group size {n}")
    xt = x.movedim(split_dim, 0).contiguous()
    out = torch.empty_like(xt)
    dist.all_to_all_single(out, xt, group=group)
    COLLECTIVES["all_to_all"] += 1
    rest = list(xt.shape[1:])
    z = out.reshape([n, xt.shape[0] // n] + rest)
    # the concat axis among z's dims: 2 + its index without split_dim
    pos = 2 + (concat_dim if concat_dim < split_dim else concat_dim - 1)
    z = z.movedim(0, pos - 1)
    shape = list(z.shape)
    shape[pos - 1:pos + 1] = [shape[pos - 1] * shape[pos]]
    return z.reshape(shape).movedim(0, split_dim).contiguous()


def split(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """This rank's chunk of ``x`` along ``dim``."""
    n = dist.get_world_size(group)
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} size {x.shape[dim]} not divisible by "
                         f"group size {n}")
    chunk = x.shape[dim] // n
    return x.narrow(dim, dist.get_rank(group) * chunk, chunk).contiguous()


class Hop:
    """One ring hop in flight: each tensor sent to group index
    ``(i + shift) % n`` and received from ``(i - shift) % n``, posted at
    construction (``dist.batch_isend_irecv``); `wait` returns the
    received tensors. The posting and the wait are named spans of a
    ``torch.profiler`` trace, ``overlap.hop.post#<id>`` and
    ``overlap.hop.wait#<id>`` (`OVERLAP_SPANS`), which the overlap probe
    (`testing.hlo_probe`) pairs by id."""

    _ids = itertools.count()

    def __init__(self, tensors, group, shift: int = 1):
        n, me = dist.get_world_size(group), dist.get_rank(group)
        ranks = dist.get_process_group_ranks(group)
        dst, src = ranks[(me + shift) % n], ranks[(me - shift) % n]
        self.id = next(Hop._ids)
        self._sent = [t.contiguous() for t in tensors]
        self._recv = [torch.empty_like(t) for t in self._sent]
        p2p = []
        for i, (s, r) in enumerate(zip(self._sent, self._recv)):
            p2p.append(dist.P2POp(dist.isend, s, dst, group, tag=i))
            p2p.append(dist.P2POp(dist.irecv, r, src, group, tag=i))
        with record_function(f"{OVERLAP_SPANS['post']}#{self.id}"):
            self._works = dist.batch_isend_irecv(p2p)
        COLLECTIVES["send_recv"] += len(self._sent)
        PERMUTES["count"] += 1

    def wait(self) -> list:
        with record_function(f"{OVERLAP_SPANS['wait']}#{self.id}"):
            for w in self._works:
                w.wait()
        self._sent = None
        return self._recv


# ---- region functions ---------------------------------------------------


class _CopyToRegion(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _ReduceFromRegion(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _ScatterToRegion(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.args = (group, dim)
        return split(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, *ctx.args), None, None


class _GatherFromRegion(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim, reduce_grad):
        ctx.args = (group, dim, reduce_grad)
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        group, dim, reduce_grad = ctx.args
        if reduce_grad:
            return reduce_scatter(g, group, dim), None, None, None
        return split(g, group, dim), None, None, None


class _ReduceScatterToRegion(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.args = (group, dim)
        return reduce_scatter(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, *ctx.args), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_dim, concat_dim):
        ctx.args = (group, split_dim, concat_dim)
        return all_to_all(x, group, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        group, split_dim, concat_dim = ctx.args
        return all_to_all(g, group, concat_dim, split_dim), None, None, None


def all_to_all_region(x, group, split_dim: int, concat_dim: int):
    """Differentiable `all_to_all`; its backward is the all-to-all with
    the two dimensions swapped (JAX's transpose)."""
    return _AllToAll.apply(x, group, split_dim, concat_dim)


def copy_to_tensor_model_parallel_region(x, group=None):
    """``_CopyToModelParallelRegion``: identity fwd, all-reduce bwd."""
    return _CopyToRegion.apply(x, _group(group))


def reduce_from_tensor_model_parallel_region(x, group=None):
    """``_ReduceFromModelParallelRegion``: all-reduce fwd, identity bwd."""
    return _ReduceFromRegion.apply(x, _group(group))


def scatter_to_tensor_model_parallel_region(x, group=None):
    """``_ScatterToModelParallelRegion``: split last dim fwd, gather bwd."""
    return _ScatterToRegion.apply(x, _group(group), x.dim() - 1)


def gather_from_tensor_model_parallel_region(x, group=None):
    """``_GatherFromModelParallelRegion``: gather last dim fwd, split bwd."""
    return _GatherFromRegion.apply(x, _group(group), x.dim() - 1, False)


def scatter_to_sequence_parallel_region(x, group=None, seq_dim=0):
    """``_ScatterToSequenceParallelRegion``: split seq fwd, gather bwd."""
    return _ScatterToRegion.apply(x, _group(group), seq_dim)


def gather_from_sequence_parallel_region(x, group=None, seq_dim=0,
                                         tensor_parallel_output_grad=True):
    """``_GatherFromSequenceParallelRegion``: all-gather seq fwd; the bwd
    reduce-scatters when the consumer is a tensor-parallel op (each rank
    holds a full-size gradient), else splits."""
    return _GatherFromRegion.apply(x, _group(group), seq_dim,
                                   bool(tensor_parallel_output_grad))


def reduce_scatter_to_sequence_parallel_region(x, group=None, seq_dim=0):
    """``_ReduceScatterToSequenceParallelRegion``: reduce-scatter fwd,
    all-gather bwd."""
    return _ReduceScatterToRegion.apply(x, _group(group), seq_dim)


# ---- decomposed collective matmuls --------------------------------------


def dot_f32(rows: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``rows @ w`` with an fp32 result (``jnp.dot(...,
    preferred_element_type=float32)``): the operands widened, so every
    product of half operands is exact and the sums are fp32."""
    return torch.matmul(rows.float(), w.float())


def _agm_loop(x, w, group, seq_dim: int, dot: Callable = dot_f32,
              serialize: bool = False):
    """``all_gather(x, seq_dim) @ w`` over the ring (fp32). The hop for
    chunk t + 1 is posted before chunk t's product (n - 1 hops);
    ``serialize`` hops first and multiplies the chunk just received, so
    every hop is exposed (the same products, placed in the same
    order)."""
    n = dist.get_world_size(group)
    if n == 1:
        return dot(x, w)
    idx = dist.get_rank(group)
    chunk = x.shape[seq_dim]
    shape = list(x.shape)
    shape[seq_dim] = chunk * n
    shape[-1] = w.shape[-1]
    y = torch.zeros(shape, dtype=torch.float32, device=x.device)

    def place(part, src):
        y.narrow(seq_dim, src * chunk, chunk).copy_(part)

    if serialize:
        place(dot(x, w), idx)
        cur = x
        for t in range(1, n):
            cur = Hop([cur], group).wait()[0]
            place(dot(cur, w), (idx - t) % n)
        return y
    hop = Hop([x], group)
    place(dot(x, w), idx)
    cur = hop.wait()[0]
    for t in range(1, n - 1):
        hop = Hop([cur], group)
        place(dot(cur, w), (idx - t) % n)
        cur = hop.wait()[0]
    place(dot(cur, w), (idx - (n - 1)) % n)
    return y


def _mrs_loop(x, w, group, seq_dim: int, dot: Callable = dot_f32):
    """``reduce_scatter(x @ w, seq_dim)`` over the ring (fp32): a
    travelling accumulator hops toward its owner while each step's
    partial product runs; every hop ships ``acc + pend`` (the zero seed
    first), so per chunk the sum runs over the ranks after its owner in
    ring order and ends with the owner's own partial."""
    n = dist.get_world_size(group)
    S = x.shape[seq_dim]
    if S % n:
        raise ValueError(f"seq dim {seq_dim} size {S} not divisible by "
                         f"tp size {n}")
    chunk = S // n

    def part(c):
        return dot(x.narrow(seq_dim, c * chunk, chunk), w)

    if n == 1:
        return part(0)
    idx = dist.get_rank(group)
    shape = list(x.shape)
    shape[seq_dim] = chunk
    shape[-1] = w.shape[-1]
    acc = torch.zeros(shape, dtype=torch.float32, device=x.device)
    pend = torch.zeros_like(acc)
    for t in range(n):
        hop = Hop([acc + pend], group)
        pend = part((idx - 1 - t) % n)
        acc = hop.wait()[0]
    return acc + pend


def _regathered_dw(a, b, group, seq_dim: int, gather_a: bool):
    """dw = aᵀ·b over the flattened rows, fp32, with ``a`` (the input,
    for the all-gather matmul) or ``b`` (the cotangent, for the
    reduce-scatter) re-gathered along the sequence, as Megatron
    re-gathers in the backward instead of saving the gathered copy."""
    if gather_a:
        a = all_gather(a, group, seq_dim)
    else:
        b = all_gather(b, group, seq_dim)
    return torch.matmul(a.reshape(-1, a.shape[-1]).float().t(),
                        b.reshape(-1, b.shape[-1]).float())


class _AllGatherMatmul(torch.autograd.Function):
    """``all_gather_matmul``'s custom VJP: dx through the reduce-scatter
    dual, dw from the re-gathered input."""

    @staticmethod
    def forward(ctx, x, w, group, seq_dim, dot):
        ctx.save_for_backward(x, w)
        ctx.args = (group, seq_dim, dot)
        return _agm_loop(x, w, group, seq_dim, dot)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        group, seq_dim, dot = ctx.args
        dx = _mrs_loop(g, w.t(), group, seq_dim, dot)
        dw = _regathered_dw(x, g, group, seq_dim, gather_a=True)
        return dx.to(x.dtype), dw.to(w.dtype), None, None, None


class _MatmulReduceScatter(torch.autograd.Function):
    """``matmul_reduce_scatter``'s custom VJP: dx through the all-gather
    dual, dw against the re-gathered cotangent."""

    @staticmethod
    def forward(ctx, x, w, group, seq_dim, dot):
        ctx.save_for_backward(x, w)
        ctx.args = (group, seq_dim, dot)
        return _mrs_loop(x, w, group, seq_dim, dot)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        group, seq_dim, dot = ctx.args
        dx = _agm_loop(g, w.t(), group, seq_dim, dot)
        dw = _regathered_dw(x, g, group, seq_dim, gather_a=False)
        return dx.to(x.dtype), dw.to(w.dtype), None, None, None


def all_gather_matmul(x, w, group=None, seq_dim: int = 0):
    """``all_gather(x, seq_dim) @ w`` with the gather decomposed into the
    overlapped ring: ``x`` the local sequence chunk (S/n, ..., in), ``w``
    (in, out_shard); the full-sequence product (S, ..., out_shard) in
    fp32. Differentiable."""
    return _AllGatherMatmul.apply(x, w, _group(group), seq_dim, dot_f32)


def matmul_reduce_scatter(x, w, group=None, seq_dim: int = 0):
    """``reduce_scatter(x @ w, seq_dim)`` with the reduce-scatter
    decomposed into the travelling-accumulator ring: ``x`` the full
    sequence (S, ..., in_shard), ``w`` (in_shard, out); this rank's
    chunk (S/n, ..., out) of the sum, in fp32. Differentiable."""
    return _MatmulReduceScatter.apply(x, w, _group(group), seq_dim, dot_f32)
