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

Every axis but fsdp takes a degree above 1; fsdp raises until the
distributed optimizer is ported (ROADMAP.md queue A item 7).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch.distributed as dist

AXIS_DP = "dp"
AXIS_FSDP = "fsdp"
AXIS_PP = "pp"
AXIS_CP = "cp"
AXIS_EP = "ep"
AXIS_TP = "tp"
MESH_AXES = (AXIS_DP, AXIS_FSDP, AXIS_PP, AXIS_CP, AXIS_EP, AXIS_TP)

#: axes whose degree may exceed 1 in the port so far
_PORTED_AXES = (AXIS_DP, AXIS_PP, AXIS_CP, AXIS_EP, AXIS_TP)


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
    ``size(axis)`` the degree."""

    def __init__(self, config: MeshConfig, groups: dict):
        self.config = config
        self._groups = groups
        self._ranks = {ax: dist.get_process_group_ranks(g)
                       for ax, g in groups.items()}

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
    for ax, n in zip(MESH_AXES, config.shape):
        if n > 1 and ax not in _PORTED_AXES:
            raise NotImplementedError(
                f"a {ax} degree above 1 is not ported yet (the port runs "
                f"{'/'.join(_PORTED_AXES)}; fsdp waits on "
                f"parallel/distributed_optimizer.py): ROADMAP.md queue A "
                f"item 7")
    dm = init_device_mesh("cuda" if dist.get_backend() == "nccl" else "cpu",
                          config.shape, mesh_dim_names=MESH_AXES)
    return Mesh(config, {ax: dm.get_group(ax) for ax in MESH_AXES})
