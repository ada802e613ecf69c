"""H27's edge groups: the inputs on which the CPU tests
(tests/test_torch_ml.py), the card tests (tests/test_torch_kernels.py) and
chip_smoke.py hold ``ml.kmeans_fit`` against ``ml.kmeans_fit_plain`` (and
the plain version against the reference) where NaN and infinities reach
k-means: a JSON embedding may hold ``NaN`` or ``Infinity``
(udf/builtins/ml_ops.py parses it with ``json.loads``).
"""

from __future__ import annotations

import numpy as np

# The groups of ``nan_groups``, in order.
NAN_GROUPS = ("nan_live", "nan_dead", "nan_first_live", "pos_inf", "neg_inf", "all_dead",
              "plain")


def nan_groups(S: int = 16, d: int = 4, seed: int = 9) -> tuple:
    """(points f32 [7, S, d], weights f32 [7, S]), one group a case of
    NAN_GROUPS: a NaN coordinate in a live point, in a dead point and in
    the first live point (point 1; point 0 is dead in every group), +inf and
    -inf coordinates in a live point, every point dead, and a group with
    none of these."""
    rng = np.random.default_rng(seed)
    G = len(NAN_GROUPS)
    pts = rng.normal(0.0, 3.0, (G, S, d)).astype(np.float32)
    w = (rng.random((G, S)) < 0.8).astype(np.float32)
    w[:, 1] = 1.0
    w[:, 0] = 0.0
    pts[0, 5, 2] = np.nan
    w[0, 5] = 1.0
    pts[1, 3, 1] = np.nan
    w[1, 3] = 0.0
    pts[2, 1, 0] = np.nan
    pts[3, 7, 1] = np.inf
    w[3, 7] = 1.0
    pts[4, 2, 3] = -np.inf
    w[4, 2] = 1.0
    w[5] = 0.0
    return pts, w


def tie_groups() -> tuple:
    """(points, weights): two groups of exactly duplicated points on a
    square (one reversed): every argmax and argmin meets ties, which take
    the first index."""
    base = np.array([[0, 0], [0, 0], [4, 0], [4, 0], [0, 4], [0, 4], [4, 4], [4, 4]], np.float32)
    return np.stack([base, base[::-1].copy()]), np.ones((2, 8), np.float32)
