"""Warm query latency of the port, for comparing two checkouts on one card.

    python3 tools/warm_ab.py ROOT [ROOT ...]

Runs on an NVIDIA GPU. For each ROOT (a checkout of this repository; run
parent, change, change, parent to compare two commits in one call on one
card) it starts a fresh process that imports ``pixie_tpu_torch`` and
``chip_smoke.py`` from ROOT, builds service_stats's http_events table (2^26
rows) and config 1's http_small table (2^24 rows) with chip_smoke.py's
generators, runs one query of each to stage it, then 25 warm queries, and
prints one JSON line per ROOT: the median and minimum seconds of each
query, ending in ``torch.cuda.synchronize()``. The first line is the
card's name and power limit.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

REPS = 25


def measure(root: str) -> dict:
    import numpy as np
    import torch

    os.chdir(root)
    sys.path.insert(0, root)
    sys.argv = ["chip_smoke"]
    import chip_smoke as cs
    from pixie_tpu_torch.ops import kernels

    if not torch.cuda.is_available():
        raise SystemExit("warm_ab: no CUDA device")
    kernels.library()
    rows = 1 << 26
    carnot = cs.build_carnot(cs.http_events(rows), rows, "cuda")
    small = cs.build_small_carnot(cs.http_small(1 << 24), 1 << 24, "cuda")
    out = {"root": root}
    for name, c, query in (("service_stats", carnot, cs.SERVICE_STATS),
                           ("http_data", small, cs.HTTP_DATA)):
        c.execute_query(query)
        torch.cuda.synchronize()
        ts = []
        for _ in range(REPS):
            t0 = time.perf_counter()
            c.execute_query(query)
            torch.cuda.synchronize()
            ts.append(time.perf_counter() - t0)
        out[name] = {"median": float(np.median(ts)), "min": float(min(ts))}
    return out


def main() -> int:
    if len(sys.argv) >= 3 and sys.argv[1] == "--one":
        print(json.dumps(measure(os.path.abspath(sys.argv[2]))), flush=True)
        return 0
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    print(smi.stdout.strip().splitlines()[0], flush=True)
    for root in sys.argv[1:]:
        res = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", root],
                             capture_output=True, text=True, timeout=900)
        if res.returncode != 0:
            print(res.stderr[-4000:], file=sys.stderr)
            return res.returncode
        print(res.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
