"""Multi-query serving for the port.

``shared_scan``: concurrent compatible queries coalesce into one device
fold dispatch on a two-rung ladder (identical fold signatures share the
leader's outputs; predicate-compatible queries batch into one scan whose
per-query predicate masks stack state lanes on a slot axis), with
per-query finalize either way. ``residency``: the executor's staged-table
cache as a byte-accounted, pinnable pool with watermark eviction.
``resident``: device-resident ingest, rings of full append windows kept on
the card that queries convert instead of staging. The reference's admission
control, its closed-loop controller and the fold-signature store
(pixie_tpu/serving/) are not ported yet (ROADMAP queue 1).
"""

from pixie_tpu_torch.serving.residency import ResidencyPool, staged_nbytes
from pixie_tpu_torch.serving.resident import (
    ResidentIngestManager,
    ResidentRing,
    ResidentWindow,
)
from pixie_tpu_torch.serving.shared_scan import SharedScanCoordinator

__all__ = [
    "ResidencyPool",
    "ResidentIngestManager",
    "ResidentRing",
    "ResidentWindow",
    "SharedScanCoordinator",
    "staged_nbytes",
]
