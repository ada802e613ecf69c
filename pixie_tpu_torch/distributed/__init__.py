"""Mesh geometry of the sharded fold (pixie_tpu/distributed).

Ref: pixie_tpu/distributed/mesh.py. The reference's planner (the PEM/Kelvin
splitter, ``distributed/planner.py``) is not ported yet.
"""

from pixie_tpu_torch.distributed.mesh import (
    Mesh,
    MeshConfig,
    MeshGeometryError,
    resolve_mesh,
)

__all__ = ["Mesh", "MeshConfig", "MeshGeometryError", "resolve_mesh"]
