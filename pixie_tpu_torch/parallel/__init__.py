"""Device execution of the port: staging and the device fold.

Ref: pixie_tpu/parallel (MeshExecutor). The executor folds over a mesh of
devices (distributed/mesh.py), one shard a device, and merges the shards'
states at the root (ops/merge.py, K18). On a mesh with a ``hosts`` axis a
join partitions its key range over the hosts (the partitioned join), and
every fold runs under the mesh recovery plane (the degradation ladder, the
per-geometry breaker, the watchdog and the stream's window checkpoints).
"""

from pixie_tpu_torch.parallel.pipeline import DeviceExecutor
from pixie_tpu_torch.parallel.staging import StagedColumns, stage_columns

__all__ = ["DeviceExecutor", "StagedColumns", "stage_columns"]
