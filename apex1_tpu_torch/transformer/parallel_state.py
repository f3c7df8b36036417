"""Model-parallel topology state (the port of
``apex1_tpu/transformer/parallel_state.py``; reference
``apex/transformer/parallel_state.py :: initialize_model_parallel``).

As in the reference, the world's ranks are carved into groups once and
the getters answer from module-level state. The groups come from
`core.mesh.make_mesh`: tp innermost (contiguous ranks), then cp, then
dp outermost, dp inferred from the world size. Group getters return
``ProcessGroup``s where the JAX package returns axis names, and rank
getters plain integers where it returns traced axis indices.

Pipeline stages (``pp > 1``), virtual pipelines and fsdp above 1 raise
(ROADMAP.md queue A item 7).
"""

from __future__ import annotations

import math
from typing import Optional

from apex1_tpu_torch.core.mesh import (AXIS_CP, AXIS_DP, AXIS_PP, AXIS_TP,
                                       Mesh, MeshConfig, make_mesh)

_MESH: Optional[Mesh] = None


def initialize_model_parallel(
        tensor_model_parallel_size: int = 1,
        pipeline_model_parallel_size: int = 1,
        virtual_pipeline_model_parallel_size: Optional[int] = None,
        context_parallel_size: int = 1,
        fsdp_size: int = 1) -> Mesh:
    """Build and install the mesh over the default process group; the
    data-parallel degree is world // (tp·pp·cp·fsdp)."""
    global _MESH
    if _MESH is not None:
        raise RuntimeError("model parallel already initialized; call "
                           "destroy_model_parallel first")
    if virtual_pipeline_model_parallel_size is not None:
        raise NotImplementedError(
            "virtual pipelines are not ported yet: ROADMAP.md queue A "
            "item 7")
    _MESH = make_mesh(MeshConfig(dp=-1, fsdp=fsdp_size,
                                 pp=pipeline_model_parallel_size,
                                 cp=context_parallel_size,
                                 tp=tensor_model_parallel_size))
    return _MESH


def model_parallel_is_initialized() -> bool:
    return _MESH is not None


def destroy_model_parallel() -> None:
    global _MESH
    _MESH = None


def get_mesh() -> Mesh:
    if _MESH is None:
        raise RuntimeError("call initialize_model_parallel() first")
    return _MESH


def set_mesh(mesh: Mesh) -> None:
    """Install a mesh built elsewhere."""
    global _MESH
    _MESH = mesh


# -- groups -----------------------------------------------------------------

def get_tensor_model_parallel_group():
    return get_mesh().group(AXIS_TP)


def get_pipeline_model_parallel_group():
    return get_mesh().group(AXIS_PP)


def get_data_parallel_group():
    """The dp group (fsdp is 1 in the port, so dp alone replicates the
    gradients)."""
    return get_mesh().group(AXIS_DP)


def get_context_parallel_group():
    return get_mesh().group(AXIS_CP)


def get_embedding_group():
    """The reference's {first, last} pipeline stage group: the pp group,
    of one stage while pp is 1."""
    return get_mesh().group(AXIS_PP)


# -- sizes ------------------------------------------------------------------

def get_tensor_model_parallel_world_size() -> int:
    return get_mesh().size(AXIS_TP)


def get_pipeline_model_parallel_world_size() -> int:
    return get_mesh().size(AXIS_PP)


def get_data_parallel_world_size() -> int:
    return get_mesh().size(AXIS_DP)


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
    return get_mesh().index(AXIS_DP)


def get_context_parallel_rank() -> int:
    return get_mesh().index(AXIS_CP)


def is_pipeline_first_stage(ignore_virtual: bool = False) -> bool:
    return get_pipeline_model_parallel_rank() == 0


def is_pipeline_last_stage(ignore_virtual: bool = False) -> bool:
    return (get_pipeline_model_parallel_rank()
            == get_pipeline_model_parallel_world_size() - 1)
