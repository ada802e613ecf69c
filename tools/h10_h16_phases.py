"""Times of H16 (join_agg_fold) and H10 (hll_estimate) on the card at every
shape the main paths send them, each beside an empty kernel's floor on its
launch's grid, H16's first-CTA phases, and the same calls on another tree of
the repository (its earlier designs) for comparison.

    python3 tools/h10_h16_phases.py [--out FILE.json] [--parent DIR] [--shapes LOG.json]

Run from the repository root on a machine with an H100 and the CUDA
toolkit. The shapes:

- H16 at the shapes ``chip_smoke.py --log-shapes`` logged on the paths
  (PATH_H16, and any in ``--shapes``): join8_oncall_agg's block (chip_smoke's
  shape (a): 2^21 rows, K 16, 16 groups, one left sum, one right sum,
  ``jk`` and ``gids`` staged as uint8) and join8_team_agg's; at a narrowed
  uint16 ``jk`` with an offset, over 64 groups with two left sums (the warp
  lane) and at chip_smoke's case (b) (K 2^20, 2^16 groups: the atomic
  lanes). Each is timed as the kernel alone and as the fold's whole
  call of a block: the staged columns handed over as they are (this tree),
  or widened to int64, offset, cast to int32 and the left sums stacked
  first (what the fold did before H16 read its rows as staged); the call's
  device operations are counted from a profiler trace.
- H10 over the states the paths estimate (PATH_H10, and any in
  ``--shapes``), and over 4096 groups one of which holds a register
  outside [0, 33 - p].

Every H16 result is checked against ``segment.join_agg_fold_plain`` on the
same inputs (the count row and the effective mask exactly, every sum within
1e-12 * sum |terms| of its cell) and, for this tree, for the same bits in two
launches; every H10 result against ``hll.estimate_plain`` (within a relative
1e-12, rounded estimates equal, the groups equal bit for bit counted). Median
device ms of 30 calls (``chip_smoke.time_ms``). Floors: an empty kernel on
the launch's grid (``kernels.empty_launch``), this tree's and the earlier
design's (``grid_for``'s CTAs of 512 for H16, a CTA of 256 a group for H10).
With ``--parent DIR`` (a tree of an earlier commit, e.g. ``git archive
77097a6 | tar -x -C DIR``) the same calls run through that tree's kernels in
a child process, on the same inputs.
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

BLOCK_ROWS = 1 << 21
# (name, n, K, cap, S_l, S_r, staged jk dtype, jk offset, staged gids dtype)
# of every distinct H16 launch on the paths (chip_smoke.py --log-shapes, H100
# 80GB HBM3, 700.00 W): join8_oncall_agg's two blocks of join_fact (keyed and
# grouped by service, latency summed, seats gathered) and join8_team_agg's
# svc_owners block (padded to 256 rows, 4 owners in 8 slots, latency's sum
# and mean gathered from the right).
PATH_H16 = (
    ("join8_oncall_agg", BLOCK_ROWS, 16, 16, 1, 1, "uint8", 0, "uint8"),
    ("join8_team_agg", 256, 16, 8, 0, 2, "uint8", 0, "uint8"),
)
# (name, S, m) of every distinct H10 launch on the paths (the same log):
# status_mix's and shared_scan's 16 services, endpoint_load's and the mesh
# sweep's 64 groups, flows' 4096 pod pairs.
PATH_H10 = (
    ("status_mix", 16, 2048),
    ("endpoint_load", 64, 2048),
    ("flows", 4096, 2048),
)
H16_CASES = (
    ("narrow_jk_uint16", BLOCK_ROWS, 300, 16, 1, 1, "uint16", 5, "uint8"),
    ("warps_64", BLOCK_ROWS, 300, 64, 2, 1, "uint16", 5, "uint8"),
    ("case_b", BLOCK_ROWS, 1 << 20, 1 << 16, 1, 1, "int32", 0, "uint16"),
)
H10_CASES = (
    ("out_of_range_4096", 4096, 2048),
)
NUMPY = {"uint8": np.uint8, "uint16": np.uint16, "int32": np.int32}


# ---------------------------------------------------------------- inputs
def h16_arrays(rng, n, K, cap, S_l, S_r, jk_dtype, off, gid_dtype) -> dict:
    """One H16 shape's inputs: keys in [0, K) staged as ``jk_dtype`` less
    ``off``, gids in [0, cap), weights 0-5 (0: a key with no match), a
    mask of about 95% of the rows, masked and zero-weight rows carrying
    +-inf and NaN in their left values."""
    keys = rng.integers(0, K, n)
    gids = rng.integers(0, cap, n)
    mask = rng.random(n) < 0.95
    n_right = rng.integers(0, 6, K).astype(np.float64)
    left = rng.exponential(3e7, (S_l, n))
    dead = ~mask | (n_right[keys] == 0)
    left[:, dead] = rng.choice([np.inf, -np.inf, np.nan], (S_l, int(dead.sum())))
    return dict(jk=(keys - off).astype(NUMPY[jk_dtype]), off=off,
                gids=gids.astype(NUMPY[gid_dtype]), mask=mask, n_right=n_right, left=left,
                right=rng.exponential(3e7, (S_r, K)), cap=cap)


def h10_state(rng, S: int, m: int, odd: bool) -> np.ndarray:
    """Registers as HLL states hold them (in [0, 33 - p]): each group a
    share of zero registers (linear counting) and geometric ranks, a few
    groups near 2^32 distinct (the large-range correction); with ``odd``
    group 0 holds a register outside the range."""
    p = m.bit_length() - 1
    top = 33 - p
    state = np.minimum(rng.geometric(0.5, (S, m)), top).astype(np.int32)
    zero_share = rng.random(S)
    state[rng.random((S, m)) < zero_share[:, None]] = 0
    high = rng.random(S) < 0.05
    state[high] = rng.integers(min(15, top), top + 1, (int(high.sum()), m))
    if odd:
        state[0, 7] = top + 3
    return state


# ---------------------------------------------------------------- timing
def measure(spec: dict, own: bool) -> dict:
    """Times and checks of this process's tree on ``spec``'s inputs; with
    ``own`` (the tree of this file) also floors, bounds and H16's probe
    phases."""
    import chip_smoke
    from pixie_tpu_torch.ops import hll, kernels, segment

    dev = torch.device("cuda", 0)
    kernels.library()
    t = chip_smoke.time_ms
    staged = hasattr(kernels, "join_agg_fold_geometry")  # H16 reads its rows as staged
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    out: dict = {"h16": {}, "h10": {}}
    for name, path in spec["h16"].items():
        data = np.load(path)
        off, cap = int(data["off"]), int(data["cap"])
        jk, gids, mask, n_right, left, right = (
            torch.from_numpy(data[k]).to(dev)
            for k in ("jk", "gids", "mask", "n_right", "left", "right"))
        n, K, S_l, S_r = jk.shape[0], n_right.shape[0], left.shape[0], right.shape[0]
        rows = list(left)
        R = 1 + S_l + S_r
        acc = lambda: torch.zeros((R, cap), dtype=torch.float64, device=dev)
        eff = torch.empty(n, dtype=torch.bool, device=dev)
        jk32 = (jk.to(torch.int64) + off).to(torch.int32)
        gids32 = gids.to(torch.int32)
        stack = lambda: (torch.stack(rows) if rows
                         else torch.empty((0, n), dtype=torch.float64, device=dev))
        stacked = stack()
        if staged:
            kernel = lambda a: kernels.join_agg_fold(jk, gids, mask, n_right, rows, right, a,
                                                     eff, jk_offset=off)
            call = lambda a: segment.join_agg_fold(segment.Narrow(jk, off), gids, mask,
                                                   n_right, rows, right, a, eff)
        else:
            kernel = lambda a: kernels.join_agg_fold(jk32, gids32, mask, n_right, stacked,
                                                     right, a, eff)

            def call(a):  # the fold's per-block steps before H16 read rows as staged
                j = (jk.to(torch.int64) + off).to(torch.int32)
                kernels.join_agg_fold(j, gids.to(torch.int32), mask, n_right, stack(), right,
                                      a, eff)
        got, got2, want, mag = acc(), acc(), acc(), acc()
        want_eff = torch.empty_like(eff)
        kernel(got)
        eff_got = eff.clone()
        kernel(got2)
        segment.join_agg_fold_plain(jk32, gids32, mask, n_right, stacked, right, want, want_eff)
        segment.join_agg_fold_plain(jk32, gids32, mask, n_right, stacked.abs(), right.abs(),
                                    mag)
        torch.cuda.synchronize()
        err = (got - want).abs()
        row = {"n": n, "K": K, "cap": cap, "S_l": S_l, "S_r": S_r,
               "jk": str(data["jk"].dtype), "jk_offset": off, "gids": str(data["gids"].dtype),
               "equal": bool(torch.equal(eff_got, want_eff) and torch.equal(got[0], want[0])
                             and bool(torch.all(err <= 1e-12 * mag))),
               "max_abs_err": float(err.max()),
               "same_bits_twice": bool(torch.equal(got.view(torch.int64),
                                                   got2.view(torch.int64)))}
        a1 = acc()
        row["ms"] = t(lambda: kernel(a1))
        row["call_ms"] = t(lambda: call(a1))
        row["call_device_ops"] = chip_smoke.device_ops(lambda: call(a1))
        if own:
            row["plain_ms"] = t(lambda: segment.join_agg_fold_plain(
                jk32, gids32, mask, n_right, stacked, right, a1, eff))
            # the staged keys and gids, the mask and the left rows read once,
            # the effective mask written once, the per-key statistics read
            # once, the sums read and written once
            nbytes = n * (jk.element_size() + gids.element_size() + 1 + 8 * S_l + 1) \
                + 8 * K * (1 + S_r) + 16 * R * cap
            row["bound_ms"], row["bound_by"] = chip_smoke.bound(nbytes, n * (1 + 2 * S_l + S_r))
            parent_grid = min(-(-n // 512), sms * 2)
            row["parent_grid_floor_ms"] = t(lambda: kernels.empty_launch(dev, parent_grid, 512))
            if staged:
                geo = kernels.join_agg_fold_geometry(dev, n, R, cap, K, S_r)
                row["grid"], row["lane"] = list(geo[:3]), geo[3]
                row["floor_ms"] = t(lambda: kernels.empty_launch(dev, *geo[:3]))
                probe = torch.zeros(kernels.JOIN_AGG_PROBE, dtype=torch.int64, device=dev)
                kernels.join_agg_fold(jk, gids, mask, n_right, rows, right, acc(), eff,
                                      jk_offset=off, probe=probe)
                row["cta0_phases_us"] = chip_smoke.probe_phases_us(
                    probe, ("load", "fold", "combine"), 0, kernels.sm_clock_khz(dev))
        out["h16"][name] = row
    for name, path in spec["h10"].items():
        state = torch.from_numpy(np.load(path)["state"]).to(dev)
        S, m = state.shape
        alpha = hll._alpha(m)
        est, rounded = kernels.hll_estimate(state, alpha)
        want = hll.estimate_plain(state)
        torch.cuda.synchronize()
        rel = ((est - want).abs() / want.abs().clamp_min(1e-300)).max().item()
        half = (want - torch.floor(want) - 0.5).abs() <= 1e-12 * want
        row = {"S": S, "m": m, "max_rel_err": rel,
               "equal": bool(rel <= 1e-12 and torch.all(
                   (rounded == torch.round(want).long()) | half)),
               "bit_equal_groups": int((est.view(torch.int64) == want.view(torch.int64)).sum())}
        row["ms"] = t(lambda: kernels.hll_estimate(state, alpha))
        if own:
            row["plain_ms"] = t(lambda: hll.estimate_plain(state))
            row["bound_ms"], row["bound_by"] = chip_smoke.bound(S * m * 4 + S * 16, 3 * S * m)
            row["parent_grid_floor_ms"] = t(lambda: kernels.empty_launch(dev, S, 256))
            if hasattr(kernels, "hll_estimate_geometry"):
                geo = kernels.hll_estimate_geometry(S)
                row["grid"] = list(geo)
                row["floor_ms"] = t(lambda: kernels.empty_launch(dev, *geo))
        out["h10"][name] = row
    return out


def logged_shapes(path: str) -> tuple[list, list]:
    """The distinct H16 and H10 shapes of a ``chip_smoke.py --log-shapes``
    file, as PATH_H16 and PATH_H10 entries."""
    with open(path) as f:
        log = json.load(f)
    h16, h10 = {}, {}
    for p, entries in log.items():
        for e in entries:
            if e["kernel"] == "join_agg_fold":
                key = (e["n"], e["K"], e["cap"], e["S_l"], e["S_r"], e["jk"],
                       e.get("jk_offset", 0), e["gids"])
                h16.setdefault(key, f"{p}_{len(h16)}")
            elif e["kernel"] == "hll_estimate":
                h10.setdefault((e["S"], e["m"]), f"{p}_{len(h10)}")
    return ([(nm,) + k for k, nm in h16.items()], [(nm,) + k for k, nm in h10.items()])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="write the results here as JSON")
    ap.add_argument("--parent", default=None, help="a tree of an earlier commit to time too")
    ap.add_argument("--shapes", default=None,
                    help="a chip_smoke.py --log-shapes file whose H16 and H10 shapes to add")
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

    h16_cases, h10_cases = list(H16_CASES) + list(PATH_H16), list(H10_CASES) + list(PATH_H10)
    if args.shapes:
        more16, more10 = logged_shapes(args.shapes)
        h16_cases += more16
        h10_cases += more10
    rng = np.random.default_rng(23)
    with tempfile.TemporaryDirectory() as tmp:
        spec: dict = {"h16": {}, "h10": {}}
        for name, *shape in h16_cases:
            spec["h16"][name] = os.path.join(tmp, f"h16_{name}.npz")
            np.savez(spec["h16"][name], **h16_arrays(rng, *shape))
        for name, S, m in h10_cases:
            spec["h10"][name] = os.path.join(tmp, f"h10_{name}.npz")
            np.savez(spec["h10"][name], state=h10_state(rng, S, m, name.startswith("out_of")))
        res = {"card": chip_smoke.nvidia_smi_line(), "this_tree": measure(spec, own=True)}
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
    text = json.dumps(res, indent=1)
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    bad = [f"{k}:{name}" for tree in ("this_tree", "parent") if tree in res
           for k in ("h16", "h10") for name, row in res[tree][k].items() if not row["equal"]]
    if bad:
        print(f"results differ from the plain versions: {bad}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
