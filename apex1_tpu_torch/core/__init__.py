from apex1_tpu_torch.core.mesh import MESH_AXES, Mesh, MeshConfig, make_mesh
from apex1_tpu_torch.core.policy import POLICIES, PrecisionPolicy, get_policy

__all__ = ["MESH_AXES", "Mesh", "MeshConfig", "make_mesh", "POLICIES",
           "PrecisionPolicy", "get_policy"]
