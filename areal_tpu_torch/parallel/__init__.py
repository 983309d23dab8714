"""Multi-process training of the port: the torch.distributed runtime and
data plane (`distributed`) and the (dp, fsdp, ep, sp, tp) mesh (`mesh`)."""

from areal_tpu_torch.parallel import distributed
from areal_tpu_torch.parallel.mesh import (
    MESH_AXES,
    Mesh,
    build_mesh,
    mesh_from_alloc,
    mesh_shape_from_alloc,
)

__all__ = ["MESH_AXES", "Mesh", "build_mesh", "distributed", "mesh_from_alloc",
           "mesh_shape_from_alloc"]
