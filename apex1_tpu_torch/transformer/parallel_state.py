"""Model-parallel topology state (the port of
``apex1_tpu/transformer/parallel_state.py``; reference
``apex/transformer/parallel_state.py :: initialize_model_parallel``).

As in the reference, the world's ranks are carved into groups once and
the getters answer from module-level state. The groups come from
`core.mesh.make_mesh`: tp innermost (contiguous ranks), then cp, then
pp, then fsdp and dp outermost, dp inferred from the world size. Group
getters return ``ProcessGroup``s where the JAX package returns axis
names, and rank getters plain integers where it returns traced axis
indices.

The data-parallel group is dp x fsdp together, as in the JAX module:
both replicate the gradients (fsdp also shards the parameters and the
optimizer state). The virtual pipeline's size and rank are module
state, as in the JAX module: the interleaved schedule's bookkeeping,
read by the virtual-aware `is_pipeline_first_stage` /
`is_pipeline_last_stage`.
"""

from __future__ import annotations

import math
from typing import Optional

import torch.distributed as dist

from apex1_tpu_torch.core.mesh import (AXIS_CP, AXIS_DP, AXIS_FSDP, AXIS_PP,
                                       AXIS_TP, Mesh, MeshConfig, make_mesh)

_MESH: Optional[Mesh] = None
_VIRTUAL_PP_SIZE: Optional[int] = None
_VIRTUAL_PP_RANK: Optional[int] = None


def initialize_model_parallel(
        tensor_model_parallel_size: int = 1,
        pipeline_model_parallel_size: int = 1,
        virtual_pipeline_model_parallel_size: Optional[int] = None,
        context_parallel_size: int = 1,
        fsdp_size: int = 1) -> Mesh:
    """Build and install the mesh over the default process group; the
    data-parallel degree is world // (tp·pp·cp·fsdp). A virtual pipeline
    size (the interleaved schedule's chunks per stage) needs pp > 1."""
    global _MESH, _VIRTUAL_PP_SIZE, _VIRTUAL_PP_RANK
    if _MESH is not None:
        raise RuntimeError("model parallel already initialized; call "
                           "destroy_model_parallel first")
    mesh = make_mesh(MeshConfig(dp=-1, fsdp=fsdp_size,
                                pp=pipeline_model_parallel_size,
                                cp=context_parallel_size,
                                tp=tensor_model_parallel_size))
    if virtual_pipeline_model_parallel_size is not None:
        if pipeline_model_parallel_size <= 1:
            raise ValueError("virtual pipeline requires pp > 1")
    _MESH = mesh
    _VIRTUAL_PP_SIZE = virtual_pipeline_model_parallel_size
    _VIRTUAL_PP_RANK = 0 if virtual_pipeline_model_parallel_size else None
    return _MESH


def model_parallel_is_initialized() -> bool:
    return _MESH is not None


def destroy_model_parallel() -> None:
    global _MESH, _VIRTUAL_PP_SIZE, _VIRTUAL_PP_RANK
    _MESH = None
    _VIRTUAL_PP_SIZE = None
    _VIRTUAL_PP_RANK = None


def get_mesh() -> Mesh:
    if _MESH is None:
        raise RuntimeError("call initialize_model_parallel() first")
    return _MESH


def set_mesh(mesh: Mesh) -> None:
    """Install a mesh built elsewhere."""
    global _MESH
    _MESH = mesh


def resolve_group(axis_name=AXIS_PP):
    """The process group behind ``axis_name``: a mesh axis name (through
    the installed mesh; None while no mesh is installed, which is one
    rank on the axis) or a ``ProcessGroup`` given as it is."""
    if not isinstance(axis_name, str):
        return axis_name
    if _MESH is None:
        return None
    return _MESH.group(axis_name)


def group_size_rank(group) -> tuple:
    """(size, this rank's index) of ``group``; (1, 0) for None."""
    if group is None:
        return 1, 0
    return dist.get_world_size(group), dist.get_rank(group)


# -- groups -----------------------------------------------------------------

def get_tensor_model_parallel_group():
    return get_mesh().group(AXIS_TP)


def get_pipeline_model_parallel_group():
    return get_mesh().group(AXIS_PP)


def get_data_parallel_group():
    """The dp x fsdp group: both axes replicate the gradients (fsdp
    shards them)."""
    return get_mesh().data_group


def get_context_parallel_group():
    return get_mesh().group(AXIS_CP)


def get_embedding_group():
    """The reference's embedding group ({first, last} pipeline stage)
    as the JAX package has it: the whole pp group, whose embedding-grad
    all-reduce (`pipeline_parallel.schedules.allreduce_embedding_grads`)
    gets zeros from the middle stages, the same sum as the reference's
    two-rank all-reduce."""
    return get_mesh().group(AXIS_PP)


def is_rank_in_embedding_group() -> bool:
    """Does this pp rank hold a tied-embedding copy that receives a
    nonzero gradient (the first or the last stage)?"""
    s = get_pipeline_model_parallel_rank()
    return s == 0 or s == get_pipeline_model_parallel_world_size() - 1


# -- sizes ------------------------------------------------------------------

def get_tensor_model_parallel_world_size() -> int:
    return get_mesh().size(AXIS_TP)


def get_pipeline_model_parallel_world_size() -> int:
    return get_mesh().size(AXIS_PP)


def get_data_parallel_world_size() -> int:
    return get_mesh().size(AXIS_DP) * get_mesh().size(AXIS_FSDP)


def get_context_parallel_world_size() -> int:
    return get_mesh().size(AXIS_CP)


def get_world_size() -> int:
    return math.prod(get_mesh().config.shape)


# -- ranks ------------------------------------------------------------------

def get_tensor_model_parallel_rank() -> int:
    return get_mesh().index(AXIS_TP)


def get_pipeline_model_parallel_rank() -> int:
    return get_mesh().index(AXIS_PP)


def get_data_parallel_rank() -> int:
    """The index in the dp x fsdp group, dp major."""
    mesh = get_mesh()
    return mesh.index(AXIS_DP) * mesh.size(AXIS_FSDP) + mesh.index(AXIS_FSDP)


def get_context_parallel_rank() -> int:
    return get_mesh().index(AXIS_CP)


def is_pipeline_first_stage(ignore_virtual: bool = False) -> bool:
    if not ignore_virtual and _VIRTUAL_PP_SIZE is not None:
        if _VIRTUAL_PP_RANK != 0:
            return False
    return get_pipeline_model_parallel_rank() == 0


def is_pipeline_last_stage(ignore_virtual: bool = False) -> bool:
    if not ignore_virtual and _VIRTUAL_PP_SIZE is not None:
        if _VIRTUAL_PP_RANK != _VIRTUAL_PP_SIZE - 1:
            return False
    return (get_pipeline_model_parallel_rank()
            == get_pipeline_model_parallel_world_size() - 1)


# -- virtual pipeline (interleaved schedule bookkeeping) --------------------

def get_virtual_pipeline_model_parallel_world_size() -> Optional[int]:
    return _VIRTUAL_PP_SIZE


def get_virtual_pipeline_model_parallel_rank() -> Optional[int]:
    return _VIRTUAL_PP_RANK


def set_virtual_pipeline_model_parallel_rank(rank: int) -> None:
    global _VIRTUAL_PP_RANK
    _VIRTUAL_PP_RANK = rank
