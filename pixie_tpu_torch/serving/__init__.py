"""Multi-query serving for the port.

``shared_scan``: concurrent compatible queries coalesce into one device
fold dispatch on a two-rung ladder (identical fold signatures share the
leader's outputs; predicate-compatible queries batch into one scan whose
per-query predicate masks stack state lanes on a slot axis), with
per-query finalize either way. The reference's admission control, its
closed-loop controller, the HBM residency pool and the fold-signature
store (pixie_tpu/serving/) are not ported yet (ROADMAP queue 1).
"""

from pixie_tpu_torch.serving.shared_scan import SharedScanCoordinator

__all__ = ["SharedScanCoordinator"]
