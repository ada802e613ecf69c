"""Times of H4 (hist_quantiles) and H9 (tdigest_quantiles) on the card at
every shape the main paths send them and at their edge states, each beside
an empty kernel's floor on its launch's grid, and the same calls on another
tree of the repository (its earlier designs) for comparison.

    python3 tools/h4_h9_phases.py [--out FILE.json] [--parent DIR] [--shapes LOG.json]

Run from the repository root on a machine with an H100 and the CUDA
toolkit. The shapes:

- H4 over the histogram states the paths finalize (PATH_H4, and any in
  ``--shapes``, a ``chip_smoke.py --log-shapes`` file), at 4096 groups,
  and at the edge states of ``ops/quantile_edges.py`` (empty, bin 0, one
  bin, counts near 2^40) at 16 groups of every width of HIST_NBINS, for the
  UDAs' 7 qs and for 40.
- H9 over the digests the paths finalize (PATH_H9, and any in
  ``--shapes``) and at the edge digests of every capacity of
  TD_CAPACITIES, for 7 qs and 40.

Inputs are made from seed 24. Every H4 result is checked against
``histogram.quantile_values_plain`` on the same card bit for bit (an
earlier tree, whose kernel computed the midpoints itself: within a
relative 1e-12, as it was held); every H9 result against
``tdigest.quantile_values_plain`` bit for bit on the groups whose weights
are whole and total at most 2^24, within ``quantile_edges.td_inexact_tol``
on the others. Median device ms of 30 calls (``chip_smoke.time_ms``).
Floors: an empty kernel on the launch's grid (``kernels.empty_launch``),
this tree's and the earlier design's (a CTA of 256 a group for H4, a
thread a (group, q) in CTAs of 128 for H9); this tree's CTA 0 phases from
the kernels' probes (µs between clock64 stamps of its first lane). With ``--parent DIR`` (a tree
of an earlier commit, e.g. ``git archive 32f8072 | tar -x -C DIR``) the
same calls run through that tree's kernels in a child process, on the same
inputs.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

# (name, S, nbins, Q) of every distinct H4 launch on the paths and (name,
# G, C, Q) of every distinct H9 launch (chip_smoke.py --log-shapes, H100
# 80GB HBM3, 700.00 W): H4 over service_stats' and shared_scan's 16
# services (13 launches) and svc_let's 1024 groups (4); H9 over the 16
# services' digests of sketches, sketches_mesh4, sketches_small and
# sketches_ring (16), every group's weights whole and totalling at most 2^24.
PATH_H4 = (
    ("service_stats", 16, 1024, 7),
    ("svc_let", 1024, 1024, 7),
)
PATH_H9 = (
    ("sketches", 16, 256, 7),
)
WIDE_Q = 40


# ---------------------------------------------------------------- inputs
def h4_cases(path_h4) -> list:
    """(name, S, nbins, Q, edge) of every H4 input: the paths', 4096 groups,
    and the edge states at 16 groups of every width."""
    from pixie_tpu_torch.ops.quantile_edges import HIST_NBINS

    cases = [(nm, S, nb, Q, False) for nm, S, nb, Q in path_h4]
    cases.append(("groups_4096", 4096, 1024, 7, False))
    cases += [(f"edges_{nb}_q{Q}", 16, nb, Q, True) for nb in HIST_NBINS for Q in (7, WIDE_Q)]
    return cases


def h9_cases(path_h9) -> list:
    """(name, G, C, Q, edge) of every H9 input: the paths' and the edge
    digests at every capacity."""
    from pixie_tpu_torch.ops.quantile_edges import TD_CAPACITIES

    cases = [(nm, G, C, Q, False) for nm, G, C, Q in path_h9]
    cases += [(f"edges_{C}_q{Q}", 16, C, Q, True) for C in TD_CAPACITIES for Q in (7, WIDE_Q)]
    return cases


def qs_of(Q: int) -> tuple:
    from pixie_tpu_torch.ops.quantile_edges import QS, QS_WIDE

    return {len(QS): QS, len(QS_WIDE): QS_WIDE}[Q]


def h4_state(rng, S: int, nbins: int, edge: bool) -> np.ndarray:
    """The edge state, or a path's: latency-like counts (a log-normal's
    bins, about 2^22 rows a group) with a few empty groups."""
    from pixie_tpu_torch.ops.quantile_edges import hist_edge_state

    if edge:
        return hist_edge_state(nbins, S, int(rng.integers(1 << 30)))
    centre = rng.uniform(0.45, 0.6, S) * nbins
    width = rng.uniform(8, 40, S)
    bins = np.arange(nbins)
    lam = 4e6 / np.sqrt(2 * np.pi) / width[:, None] * np.exp(
        -0.5 * ((bins[None, :] - centre[:, None]) / width[:, None]) ** 2)
    state = rng.poisson(lam).astype(np.int64)
    state[rng.random(S) < 0.1] = 0
    return state


def h9_state(rng, G: int, C: int, edge: bool) -> tuple[np.ndarray, np.ndarray]:
    """The edge digests, or a path's: every centroid live, whole weights
    summing to about 2^22 a group, ascending means."""
    from pixie_tpu_torch.ops.quantile_edges import td_edge_state

    if edge:
        return td_edge_state(C, G, int(rng.integers(1 << 30)))
    means = np.sort(rng.exponential(3e7, (G, C)), axis=1).astype(np.float32)
    weights = rng.integers(1, 2 * (1 << 22) // C, (G, C)).astype(np.float32)
    return means, weights


# ---------------------------------------------------------------- timing
def measure(spec: dict, own: bool) -> dict:
    """Times and checks of this process's tree on ``spec``'s inputs; with
    ``own`` also the floors, bounds and plain versions' times."""
    import chip_smoke
    from pixie_tpu_torch.ops import histogram, kernels, tdigest

    dev = torch.device("cuda", 0)
    kernels.library()
    t = chip_smoke.time_ms
    table = hasattr(histogram, "midpoint_table")  # H4 reads its values from a table
    out: dict = {"h4": {}, "h9": {}}
    for name, path in spec["h4"].items():
        data = np.load(path)
        state = torch.from_numpy(data["state"]).to(dev)
        S, nbins = state.shape
        qs = tuple(float(q) for q in data["qs"])
        hspec = histogram.LogHistogramSpec(nbins=nbins)
        qs_t = torch.tensor(qs, dtype=torch.float64, device=dev)
        if table:
            mid = histogram.midpoint_table(hspec, dev)
            call = lambda: kernels.hist_quantiles(state, qs_t, mid)  # noqa: E731
        else:
            g = hspec.gamma
            call = lambda: kernels.hist_quantiles(  # noqa: E731
                state, qs_t, hspec.min_value, g, g ** 0.5)
        got = call()
        want = histogram.quantile_values_plain(state, qs, hspec)
        torch.cuda.synchronize()
        rel = float(((got - want).abs() / want.abs().clamp_min(1e-300)).max())
        bits = bool(torch.equal(got, want))
        row = {"S": S, "nbins": nbins, "Q": len(qs), "bit_equal": bits, "max_rel_err": rel,
               "equal": bits if table else rel <= 1e-12, "ms": t(call)}
        if own:
            row["plain_ms"] = t(lambda: histogram.quantile_values_plain(state, qs, hspec))
            # the function's own bytes: the counts and the qs read once, the
            # output written once (the midpoint table is the kernel's design)
            row["bound_ms"], row["bound_by"] = chip_smoke.bound(
                S * nbins * 8 + len(qs) * 8 + S * len(qs) * 8,
                2 * S * nbins * len(qs))
            row["parent_grid_floor_ms"] = t(lambda: kernels.empty_launch(dev, S, 256))
            if hasattr(kernels, "hist_quantiles_geometry"):
                geo = kernels.hist_quantiles_geometry(S)
                row["grid"] = list(geo)
                row["floor_ms"] = t(lambda: kernels.empty_launch(dev, *geo))
            if hasattr(kernels, "HQ_PROBE"):
                probe = torch.zeros(kernels.HQ_PROBE, dtype=torch.int64, device=dev)
                for _ in range(3):
                    kernels.hist_quantiles(state, qs_t, mid, probe=probe)
                row["cta0_phases_us"] = chip_smoke.probe_phases_us(
                    probe, ("total", "searches", "stores"), 0, kernels.sm_clock_khz(dev))
        out["h4"][name] = row
    for name, path in spec["h9"].items():
        data = np.load(path)
        st = {"means": torch.from_numpy(data["means"]).to(dev),
              "weights": torch.from_numpy(data["weights"]).to(dev)}
        exact = torch.from_numpy(data["exact"]).to(dev)
        tol = torch.from_numpy(data["tol"]).to(dev)  # [the inexact groups, Q]
        G, C = st["means"].shape
        qs = tuple(float(q) for q in data["qs"])
        qs_t = torch.tensor(qs, dtype=torch.float32, device=dev)
        call = lambda: kernels.tdigest_quantiles(st["means"], st["weights"], qs_t)  # noqa: E731
        got = call()
        want = tdigest.quantile_values_plain(st, qs)
        torch.cuda.synchronize()
        err = (got - want).abs()
        bits = bool(torch.equal(got[exact], want[exact]))
        row = {"G": G, "C": C, "Q": len(qs), "exact_groups": int(exact.sum()),
               "bit_equal_exact": bits,
               "max_rel_err": float((err / want.abs().clamp_min(1e-300)).max()),
               # a bound of 0 holds only an error of 0
               "inexact_err_over_tol": float((err[~exact] / tol.clamp_min(1e-300)).max())
               if bool((~exact).any()) else 0.0}
        row["equal"] = bits and row["inexact_err_over_tol"] <= 1.0
        row["ms"] = t(call)
        if own:
            row["plain_ms"] = t(lambda: tdigest.quantile_values_plain(st, qs))
            # weights and means read once, the qs once, the output written once;
            # about 6 operations a centroid and q
            row["bound_ms"], row["bound_by"] = chip_smoke.bound(
                2 * G * C * 4 + len(qs) * 4 + G * len(qs) * 8, 6 * G * len(qs) * C)
            row["parent_grid_floor_ms"] = t(lambda: kernels.empty_launch(
                dev, -(-G * len(qs) // 128), 128))
            if hasattr(kernels, "tdigest_quantiles_geometry"):
                geo = kernels.tdigest_quantiles_geometry(G)
                row["grid"] = list(geo)
                row["floor_ms"] = t(lambda: kernels.empty_launch(dev, *geo))
            if hasattr(kernels, "TQ_PROBE"):
                probe = torch.zeros(kernels.TQ_PROBE, dtype=torch.int64, device=dev)
                for _ in range(3):
                    kernels.tdigest_quantiles(st["means"], st["weights"], qs_t, probe=probe)
                row["cta0_phases_us"] = chip_smoke.probe_phases_us(
                    probe, ("checks", "midpoints", "searches", "stores"), 0,
                    kernels.sm_clock_khz(dev))
        out["h9"][name] = row
    return out


def logged_shapes(path: str) -> tuple[list, list]:
    """The distinct H4 and H9 shapes of a ``chip_smoke.py --log-shapes``
    file, as PATH_H4 and PATH_H9 entries."""
    with open(path) as f:
        log = json.load(f)
    h4, h9 = {}, {}
    for p, entries in log.items():
        for e in entries:
            if e["kernel"] == "hist_quantiles":
                h4.setdefault((e["S"], e["nbins"], e["Q"]), f"{p}_{len(h4)}")
            elif e["kernel"] == "tdigest_quantiles":
                h9.setdefault((e["G"], e["C"], e["Q"]), f"{p}_{len(h9)}")
    return ([(nm,) + k for k, nm in h4.items()], [(nm,) + k for k, nm in h9.items()])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="write the results here as JSON")
    ap.add_argument("--parent", default=None, help="a tree of an earlier commit to time too")
    ap.add_argument("--shapes", default=None,
                    help="a chip_smoke.py --log-shapes file whose H4 and H9 shapes to add")
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:  # the earlier tree's process: its package first on the path
        with open(args.child) as f:
            spec = json.load(f)
        sys.path.insert(0, spec["tree"])
        print(json.dumps(measure(spec, own=False)), flush=True)
        return 0
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    import chip_smoke
    from pixie_tpu_torch.ops import tdigest
    from pixie_tpu_torch.ops.quantile_edges import td_inexact_tol

    path_h4, path_h9 = list(PATH_H4), list(PATH_H9)
    if args.shapes:
        more4, more9 = logged_shapes(args.shapes)
        path_h4 += [e for e in more4 if e[1:] not in {p[1:] for p in path_h4}]
        path_h9 += [e for e in more9 if e[1:] not in {p[1:] for p in path_h9}]
    rng = np.random.default_rng(24)
    with tempfile.TemporaryDirectory() as tmp:
        spec: dict = {"h4": {}, "h9": {}}
        for name, S, nbins, Q, edge in h4_cases(path_h4):
            spec["h4"][name] = os.path.join(tmp, f"h4_{name}.npz")
            np.savez(spec["h4"][name], state=h4_state(rng, S, nbins, edge), qs=qs_of(Q))
        for name, G, C, Q, edge in h9_cases(path_h9):
            means, weights = h9_state(rng, G, C, edge)
            spec["h9"][name] = os.path.join(tmp, f"h9_{name}.npz")
            exact = tdigest.quantile_exact_groups(torch.from_numpy(weights)).numpy()
            np.savez(spec["h9"][name], means=means, weights=weights, qs=qs_of(Q), exact=exact,
                     tol=td_inexact_tol(torch.from_numpy(means[~exact]),
                                        torch.from_numpy(weights[~exact]), qs_of(Q)).numpy())
        res = {"card": chip_smoke.nvidia_smi_line()}
        if args.parent:
            path = os.path.join(tmp, "spec.json")
            with open(path, "w") as f:
                json.dump(dict(spec, tree=os.path.abspath(args.parent)), f)
            child = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--child", path],
                cwd=os.path.abspath(args.parent), capture_output=True, text=True, timeout=900)
            if child.returncode != 0:
                print(child.stderr, file=sys.stderr)
                return child.returncode
            res["parent"] = json.loads(child.stdout.strip().splitlines()[-1])
            if args.out:  # kept should this tree's measurement fail
                with open(args.out, "w") as f:
                    json.dump(res, f, indent=1)
        res["this_tree"] = measure(spec, own=True)
    text = json.dumps(res, indent=1)
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    bad = [f"{tree}:{k}:{name}" for tree in ("this_tree", "parent") if tree in res
           for k in ("h4", "h9") for name, row in res[tree][k].items() if not row["equal"]]
    if bad:
        print(f"results differ from the plain versions: {bad}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
