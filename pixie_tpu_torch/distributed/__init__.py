"""The distributed layer: the PEM/Kelvin plan splitter and the mesh geometry.

Ref: pixie_tpu/distributed. ``planner.py`` cuts a logical plan at its
blocking aggregation into per-agent PEM fragments (``Agg(PARTIAL) ->
BridgeSink``) and a Kelvin fragment (``BridgeSource -> Agg(MERGE) -> ...``),
pruning agents without the tables; ``mesh.py`` is the geometry of the
sharded fold on a device mesh.
"""

from pixie_tpu_torch.distributed.mesh import (
    Mesh,
    MeshConfig,
    MeshGeometryError,
    resolve_mesh,
)
from pixie_tpu_torch.distributed.planner import (
    AgentInfo,
    DistributedPlanner,
    DistributedState,
)

__all__ = [
    "AgentInfo",
    "DistributedPlanner",
    "DistributedState",
    "Mesh",
    "MeshConfig",
    "MeshGeometryError",
    "resolve_mesh",
]
