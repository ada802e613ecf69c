"""The t-digest merge's (H8's) edge digests: the inputs on which the card
tests (tests/test_torch_kernels.py), the CPU model of the merge
(tests/test_torch_sketches.py) and chip_smoke.py hold
``kernels.tdigest_merge`` against ``tdigest.merge_plain``.

An empty a; a digest of three blocks and a block's H7 sums (raw_b) at G =
1, 16, 254 and 300; a sparse group (10 rows: empties between live
clusters); equal means across the halves; an inverted pair in a (the
all-pairs rank) and a negative weight before a +inf mean (clusters that
drop back: the per-cluster walk), each in every group; NaN, +-inf and
-0/+0 means; raw sums with cells of zero weight.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from pixie_tpu_torch.ops import tdigest


def h8_digest(rng, G: int, C: int, live: int, sort: bool = True) -> dict:
    """A digest of ``live`` centroids a group at random cluster slots (the
    rest empty, mean 0), integer weights, means increasing along the slots
    (``sort``)."""
    means = np.zeros((G, C), np.float32)
    weights = np.zeros((G, C), np.float32)
    for g in range(G):
        slots = np.sort(rng.choice(C, live, replace=False))
        mv = rng.exponential(3e7, live).astype(np.float32)
        means[g, slots] = np.sort(mv) if sort else mv
        weights[g, slots] = rng.integers(1, 5000, live)
    return {"means": torch.from_numpy(means), "weights": torch.from_numpy(weights)}


def h8_inputs(case: str, G: int, C: int = tdigest.DEFAULT_CAPACITY):
    """(a, b, raw_b) of H8's edge case, CPU tensors: b is a digest, or with
    raw_b H7's f64 sums ("weights" the weight sums, "means" the value
    sums)."""
    rng = np.random.default_rng([G, H8_CASES.index((case, G))])
    if case == "a_empty":
        return tdigest.init(G, "cpu"), h8_digest(rng, G, C, C), False
    if case == "blocks":  # a digest of three plain blocks and a block's sums
        blocks = [(torch.from_numpy(rng.integers(0, G, 8000).astype(np.int32)),
                   torch.from_numpy(rng.exponential(3e7, 8000)),
                   torch.from_numpy(rng.random(8000) < 0.9)) for _ in range(4)]
        a = tdigest.init(G, "cpu")
        for gids, v, mask in blocks[:3]:
            a = tdigest.update_plain(a, gids, v, mask)
        g_s, v_s = tdigest._sorted_rows(blocks[3][0], blocks[3][1].float(), blocks[3][2], G)
        sums = tdigest._cluster_sums_plain(g_s, v_s, G, C)
        return a, {"weights": sums[0], "means": sums[1]}, True
    if case == "sparse":  # 10 rows: empties between live clusters
        a = tdigest.init(G, "cpu")
        a = tdigest.update_plain(a, torch.from_numpy(rng.integers(0, G, 10).astype(np.int32)),
                                 torch.from_numpy(rng.exponential(3e7, 10)))
        return a, h8_digest(rng, G, C, 7), False
    a, b = h8_digest(rng, G, C, C), h8_digest(rng, G, C, C // 2)
    if case == "equal_means":  # b's means repeat a's: ties across the halves
        b["means"][:, :] = a["means"]
        b["weights"][:, :] = a["weights"].flip(1)
    elif case == "inverted":  # an inverted pair in a: the all-pairs rank
        a["means"][:, [10, 11]] = a["means"][:, [11, 10]]
    elif case == "repeat":  # a negative weight, then a +inf mean: the clusters drop back
        b["weights"][:, -3] = 0.0
        b["means"][:, -2], b["weights"][:, -2] = 0.0, -20000.0
        b["means"][:, -1], b["weights"][:, -1] = math.inf, 30000.0
    elif case == "specials":  # NaN, +-inf and -0/+0 means, live and empty
        a["means"][:, 0], a["means"][:, 1] = -math.inf, -0.0
        b["means"][:, 0], b["weights"][:, 0] = 0.0, 7.0
        b["means"][:, 1], b["weights"][:, 1] = math.nan, 3.0
        b["means"][:, 2], b["weights"][:, 2] = math.inf, 5.0
        b["means"][:, 3], b["weights"][:, 3] = math.nan, 0.0
        b["means"][:, 4:] = torch.sort(b["means"][:, 4:], dim=1).values
    elif case == "raw_zero":  # raw sums, some cells of zero weight
        w = b["weights"].double()
        return a, {"weights": w, "means": w * b["means"].double()}, True
    return a, b, False


H8_CASES = [("a_empty", 16), ("blocks", 1), ("blocks", 16), ("blocks", 254), ("blocks", 300),
            ("sparse", 16), ("equal_means", 16), ("inverted", 16), ("repeat", 16),
            ("specials", 16), ("raw_zero", 16)]


def h8_expected_branches(case: str, G: int) -> Optional[list]:
    """[groups ranked by all pairs, groups summed cluster by cluster] the
    case must give (None: either may take a branch)."""
    return {"inverted": [G, 0], "repeat": [0, G], "blocks": None}.get(case, [0, 0])
