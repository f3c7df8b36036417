"""Process-group mesh (the port of ``apex1_tpu/core/mesh.py``).

The JAX package builds one ``jax.sharding.Mesh`` whose named axes are
the groups; here the same six axes become one ``torch.distributed``
process group each, carved out of the initialized default group:

    dp    — replica data parallel (Apex DDP's all-reduce)
    fsdp  — sharded data parallel
    pp    — pipeline stages
    cp    — context parallel (ring attention)
    ep    — expert parallel
    tp    — tensor model parallel, innermost

Rank r sits at the mesh coordinate of device r in the JAX package's
``make_mesh`` on a plain device list: ``np.unravel_index(r, shape)``
over the axes in `MESH_AXES` order, tp innermost (contiguous ranks),
dp outermost. So rank r of a port run and device r of a JAX
``shard_map`` hold the same shard.

The JAX package's ``jax.device_put(x, NamedSharding(mesh, spec))`` is
`place`: a full tensor becomes a ``torch.distributed.tensor.DTensor``
over the mesh's ``DeviceMesh``, split (``Shard(d)``) on each dimension
``spec`` names and ``Replicate()`` on every other mesh axis. Its
inverse `gather` is autograd-aware: the gradient of a gathered tensor
is averaged over the data-parallel axes and scattered back to the
placement (ZeRO-3's reduce-scatter), so a loss that gathers its placed
parameters runs the model on plain tensors, through the kernels, and
leaves sharded gradients. `MeshResource` binds a model's logical axes
(batch, heads, ...) to mesh axes; `shard_batch` and `replicate` place a
batch by it. `make_hybrid_mesh` folds its ``dcn_dp`` slices into dp in
the JAX package's slice-major order: one host has one fabric.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Union

import torch
import torch.distributed as dist

AXIS_DP = "dp"
AXIS_FSDP = "fsdp"
AXIS_PP = "pp"
AXIS_CP = "cp"
AXIS_EP = "ep"
AXIS_TP = "tp"
MESH_AXES = (AXIS_DP, AXIS_FSDP, AXIS_PP, AXIS_CP, AXIS_EP, AXIS_TP)


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Parallelism degrees; their product is the world size. A degree of
    -1 (at most one) absorbs the ranks the others leave."""

    dp: int = -1
    fsdp: int = 1
    pp: int = 1
    cp: int = 1
    ep: int = 1
    tp: int = 1

    def resolve(self, n_devices: int) -> "MeshConfig":
        sizes = dataclasses.asdict(self)
        wild = [k for k, v in sizes.items() if v == -1]
        if len(wild) > 1:
            raise ValueError(f"at most one axis may be -1, got {wild}")
        bad = {k: v for k, v in sizes.items() if v != -1 and v < 1}
        if bad:
            raise ValueError(f"axis sizes must be >= 1 (or -1), got {bad}")
        fixed = math.prod(v for v in sizes.values() if v != -1)
        if wild:
            if n_devices % fixed:
                raise ValueError(
                    f"fixed axes product {fixed} does not divide {n_devices}")
            sizes[wild[0]] = n_devices // fixed
        if math.prod(sizes.values()) != n_devices:
            raise ValueError(
                f"mesh {sizes} needs {math.prod(sizes.values())} devices, "
                f"have {n_devices}")
        return MeshConfig(**sizes)

    @property
    def shape(self) -> tuple:
        return (self.dp, self.fsdp, self.pp, self.cp, self.ep, self.tp)


class Mesh:
    """One process group per axis of `MESH_AXES`, for this rank.

    ``group(axis)`` is the ``ProcessGroup`` of the ranks that differ
    from this one only along ``axis``; ``ranks(axis)`` their global
    ranks in axis order; ``index(axis)`` this rank's coordinate;
    ``size(axis)`` the degree; ``device_mesh`` the
    ``torch.distributed.device_mesh.DeviceMesh`` the groups come from
    (`place` puts DTensors on it); ``data_group`` the ranks that differ
    only along dp and fsdp, which replicate the gradients."""

    def __init__(self, config: MeshConfig, device_mesh, data_group):
        self.config = config
        self.device_mesh = device_mesh
        self.data_group = data_group
        self._groups = {ax: device_mesh.get_group(ax) for ax in MESH_AXES}
        self._ranks = {ax: dist.get_process_group_ranks(g)
                       for ax, g in self._groups.items()}

    @property
    def shape(self) -> dict:
        return dict(zip(MESH_AXES, self.config.shape))

    def size(self, axis: str) -> int:
        return self.shape[axis]

    def group(self, axis: str):
        return self._groups[axis]

    def ranks(self, axis: str) -> list:
        return list(self._ranks[axis])

    def index(self, axis: str) -> int:
        return self._ranks[axis].index(dist.get_rank())

    def local_shard(self, x, spec):
        """This rank's block of the global tensor ``x`` under ``spec``
        (JAX's PartitionSpec as a tuple, one entry a leading dimension):
        a dimension named by an axis, or a tuple of axes (the first the
        major one), is cut in equal pieces and this rank's coordinate
        picks one; None leaves it whole."""
        for dim, ax in enumerate(spec):
            if ax is None:
                continue
            axes = ax if isinstance(ax, tuple) else (ax,)
            n, idx = 1, 0
            for a in axes:
                n *= self.size(a)
                idx = idx * self.size(a) + self.index(a)
            x = x.chunk(n, dim)[idx]
        return x


def make_mesh(config: Optional[MeshConfig] = None,
              **axis_sizes: int) -> Mesh:
    """The six-axis mesh over the initialized default process group:
    ``make_mesh(dp=2, tp=2)`` or ``make_mesh(MeshConfig(tp=4))``, one
    subgroup a dimension through
    ``torch.distributed.device_mesh.init_device_mesh`` (the axes as its
    ``mesh_dim_names``; CUDA under NCCL, the CPU under gloo)."""
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized default process "
                           "group: call parallel.multiproc.init_distributed "
                           "first")
    if config is None:
        config = MeshConfig(**axis_sizes) if axis_sizes else MeshConfig()
    elif axis_sizes:
        raise ValueError("pass either a MeshConfig or axis sizes, not both")
    config = config.resolve(dist.get_world_size())
    dm = init_device_mesh("cuda" if dist.get_backend() == "nccl" else "cpu",
                          config.shape, mesh_dim_names=MESH_AXES)
    if config.fsdp == 1 or config.dp == 1:
        data = dm.get_group(AXIS_DP if config.fsdp == 1 else AXIS_FSDP)
    else:
        # one group for each coordinate of the other axes, created on
        # every rank in the same order, dp major and fsdp minor
        ranks = torch.arange(math.prod(config.shape)).reshape(config.shape)
        data, _ = dist.new_subgroups_by_enumeration(
            ranks.permute(2, 3, 4, 5, 0, 1).reshape(
                -1, config.dp * config.fsdp).tolist())
    return Mesh(config, dm, data)


def make_hybrid_mesh(config: Optional[MeshConfig] = None, *,
                     dcn_dp: int = 1, **axis_sizes: int) -> Mesh:
    """The JAX package's multi-slice mesh: ``dcn_dp`` slices of
    contiguous ranks, each resolving ``config`` on its own ranks, with
    the slices stacked along dp, slice-major (dp index // ici_dp is the
    slice), so ``dp = dcn_dp * ici_dp``. Ranks in `make_mesh`'s order
    already are slice-major along dp, so this is `make_mesh` with dp
    multiplied; the gradient all-reduce over dp has no separate
    inter-slice stage here (one host, one fabric)."""
    if dcn_dp < 1:
        raise ValueError(f"dcn_dp must be >= 1, got {dcn_dp}")
    if config is None:
        config = MeshConfig(**axis_sizes) if axis_sizes else MeshConfig()
    elif axis_sizes:
        raise ValueError("pass either a MeshConfig or axis sizes, not both")
    if dcn_dp == 1:
        return make_mesh(config)
    world = dist.get_world_size()
    if world % dcn_dp:
        raise ValueError(f"{world} ranks do not split into dcn_dp={dcn_dp} "
                         "slices")
    ici = config.resolve(world // dcn_dp)
    return make_mesh(dataclasses.replace(ici, dp=dcn_dp * ici.dp))


def local_mesh(**axis_sizes: int) -> Mesh:
    """The mesh over every rank of the default group."""
    return make_mesh(MeshConfig(**axis_sizes) if axis_sizes else None)


def axis_size(mesh: Mesh, axis: str) -> int:
    return mesh.shape.get(axis, 1)


def data_parallel_size(mesh: Mesh) -> int:
    """Gradient replicas: dp x fsdp (fsdp shards, then reduces)."""
    return mesh.size(AXIS_DP) * mesh.size(AXIS_FSDP)


@dataclasses.dataclass(frozen=True)
class MeshResource:
    """Logical axis -> mesh axis binding: models name logical axes
    ("batch", "embed", "heads", "mlp", "vocab", "seq", "kv", "stages"),
    a config binds them, so one model runs under any layout."""

    batch: Union[str, tuple, None] = (AXIS_DP, AXIS_FSDP)
    seq: Optional[str] = AXIS_CP
    embed: Optional[str] = None
    heads: Optional[str] = AXIS_TP
    mlp: Optional[str] = AXIS_TP
    vocab: Optional[str] = AXIS_TP
    kv: Optional[str] = None
    stages: Optional[str] = AXIS_PP

    def spec(self, *logical: Optional[str]):
        """The `parallel.specs.PartitionSpec` of the logical names (None:
        a whole dimension)."""
        from apex1_tpu_torch.parallel.specs import PartitionSpec
        out = []
        for name in logical:
            if name is not None and not hasattr(self, name):
                raise ValueError(f"unknown logical axis {name!r}")
            out.append(None if name is None else getattr(self, name))
        return PartitionSpec(*out)


DEFAULT_RESOURCE = MeshResource()


def placements(spec, ndim: int, names=MESH_AXES) -> list:
    """DTensor placements, one per mesh axis of ``names``, for a tensor
    of ``ndim`` dimensions split by ``spec``: ``Shard(d)`` on each mesh
    axis that dimension d names, ``Replicate()`` on the others. A
    dimension split over a tuple of axes takes them major to minor,
    which must be their order in the mesh."""
    from torch.distributed.tensor import Replicate, Shard
    if len(spec) > ndim:
        raise ValueError(f"spec {spec} names {len(spec)} dimensions of a "
                         f"{ndim}-d tensor")
    out = [Replicate()] * len(names)
    for d, ax in enumerate(spec):
        if ax is None:
            continue
        axes = ax if isinstance(ax, tuple) else (ax,)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx) or len(set(idx)) != len(idx):
            raise ValueError(f"axes {axes} of spec {spec} must follow the "
                             f"mesh order {names}")
        for i in idx:
            if not isinstance(out[i], Replicate):
                raise ValueError(f"mesh axis {names[i]} splits two "
                                 f"dimensions in spec {spec}")
            out[i] = Shard(d)
    return out


def _spec_axes(spec) -> set:
    return {a for ax in spec if ax is not None
            for a in (ax if isinstance(ax, tuple) else (ax,))}


def spanned_mesh(mesh: Mesh, specs) -> tuple:
    """``(device mesh, axes)``: the part of ``mesh.device_mesh`` spanned
    by the axes above one rank and the axes ``specs`` name (`place`)."""
    named = set().union(set(), *(_spec_axes(s) for s in specs))
    axes = tuple(ax for ax in MESH_AXES
                 if mesh.size(ax) > 1 or ax in named) or (AXIS_DP,)
    return mesh.device_mesh[axes if len(axes) > 1 else axes[0]], axes


def place(params: dict, specs: dict, mesh: Mesh) -> dict:
    """Each full tensor of ``params`` as a DTensor split by its spec in
    ``specs`` (`placements`): this rank keeps its block. The tensors
    must be the same on every rank (no data moves).

    The DTensors live on the part of ``mesh.device_mesh`` spanned by
    the axes above one rank and the axes the specs name (DTensor's
    sharding propagation grows with the mesh's rank, and an axis of one
    rank holding no split changes nothing), so tensors that meet in one
    operation must come from calls that span the same axes."""
    from torch.distributed.tensor import distribute_tensor
    dm, axes = spanned_mesh(mesh, specs.values())
    return {k: distribute_tensor(v.detach(), dm,
                                 placements(specs[k], v.ndim, axes),
                                 src_data_rank=None)
            for k, v in params.items()}


class _MeanGrad(torch.autograd.Function):
    """The identity, its gradient divided by ``n``."""

    @staticmethod
    def forward(ctx, x, n):
        ctx.n = n
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None


def _full(v, data_axes):
    """A DTensor's full tensor, its gradient as `gather` says; any
    other value as it is."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    if not isinstance(v, DTensor):
        return v
    dm = v.device_mesh
    data = [i for i, name in enumerate(dm.mesh_dim_names)
            if name in data_axes]
    full = v.full_tensor(grad_placements=[
        Partial() if i in data else Replicate() for i in range(dm.ndim)])
    n = math.prod(dm.size(i) for i in data)
    return _MeanGrad.apply(full, n) if n > 1 else full


def gather(tree: dict, data_axes=(AXIS_DP, AXIS_FSDP)) -> dict:
    """The full tensors of ``tree``'s DTensors (other values as they
    are): `place`'s inverse. Under autograd each gathered tensor's
    gradient is the mean over the ``data_axes`` ranks (each ran the
    loss on its own batch) and lands on the DTensor split as the
    tensor was: a reduce-scatter on the axes that split it, an
    all-reduce on the data axes that replicate it, nothing on the
    others (their ranks computed the same gradient)."""
    return {k: _full(v, data_axes) for k, v in tree.items()}


def gathered(*xs) -> tuple:
    """``xs`` with each DTensor gathered as `gather` does: the operands
    of a kernel wrapper (a wrapper takes plain tensors only)."""
    return tuple(_full(x, (AXIS_DP, AXIS_FSDP)) for x in xs)


def shard_batch(mesh: Mesh, batch: dict,
                resource: MeshResource = DEFAULT_RESOURCE) -> dict:
    """``batch`` placed split along the batch logical axis (dp x fsdp)
    on dimension 0: each data-parallel rank keeps its rows."""
    spec = resource.spec("batch")
    return place(batch, {k: spec for k in batch}, mesh)


def replicate(mesh: Mesh, tree: dict) -> dict:
    """``tree`` placed whole on every rank."""
    from apex1_tpu_torch.parallel.specs import PartitionSpec
    return place(tree, {k: PartitionSpec() for k in tree}, mesh)
