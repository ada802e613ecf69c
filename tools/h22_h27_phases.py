"""Times of H22 (pred_slot_masks) and H27 (kmeans_fit) on the card at the
main paths' shapes, H27 by CTA 0's phases, and the same calls on another
tree of the repository (its earlier designs) for comparison.

    python3 tools/h22_h27_phases.py [--out FILE.json] [--parent DIR]

Run from the repository root on a machine with an H100 and the CUDA
toolkit. H22 over a 2^21-row block of service_stats' columns (resp_status
narrowed to uint16 at offset 200, f64 latency, 97% of the rows in the block
mask) at B 7 (the soak's families), 1, 16 and 32 (ops/pred_edges.py
wide_terms): median device ms of 30 calls (chip_smoke.time_ms), the floor
of an empty kernel on the launch's grid, the program with no term (the
mask in, the bits out), each bit for bit against the plain version. H27 at
G 16, S 128, d 64, k 4 and 8 (chip_smoke.py's points: 8 separated
clusters, a quarter of them exact duplicates, 90% live): ms, floor and the
phases of its probe (load, seeding, Lloyd; Lloyd's assign and update),
within 1e-5 of the plain version; one NaN coordinate in one group (that
group's centers merge: its CTA sets the time); and the NaN and infinity
groups of ops/kmeans_edges.py against the plain version: the groups whose
NaN pattern or other centers differ. With ``--parent DIR`` (a tree of an
earlier commit, e.g. ``git archive 99e111b | tar -x -C DIR``) the same
calls run through that tree's ``batched.slot_masks`` and ``ml.kmeans_fit``
in a child process, on the same inputs.
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

ROWS = 1 << 21
STATUSES = (200, 301, 404, 500)
KM_G, KM_S, KM_D = 16, 128, 64


def h22_inputs(dev) -> tuple:
    """(columns {name: (tensor, offset)}, dtypes, base) of the H22 block."""
    rng = np.random.default_rng(24)
    status = np.array(STATUSES)[rng.choice(4, ROWS, p=[0.85, 0.05, 0.05, 0.05])]
    cols = {"resp_status": (torch.from_numpy((status - 200).astype(np.uint16)).to(dev), 200),
            "latency": (torch.from_numpy(rng.exponential(3e7, ROWS)).to(dev), 0)}
    dtypes = {"resp_status": np.uint16, "latency": np.float64}
    return cols, dtypes, torch.from_numpy(rng.random(ROWS) < 0.97).to(dev)


def h27_inputs(dev) -> tuple:
    """(points, weights) of the H27 groups, as chip_smoke.py makes them."""
    rng = np.random.default_rng(40)
    truth = rng.normal(0, 3, (8, KM_D)).astype(np.float32)
    lab = rng.integers(0, 8, (KM_G, KM_S))
    pts = (truth[lab] + 0.05 * rng.normal(0, 1, (KM_G, KM_S, KM_D))).astype(np.float32)
    pts[:, 96:] = pts[:, :32]
    w = (rng.random((KM_G, KM_S)) < 0.9).astype(np.float32)
    return torch.from_numpy(pts).to(dev), torch.from_numpy(w).to(dev)


def nan_diff(got: torch.Tensor, want: torch.Tensor, names: list) -> list:
    """The groups whose NaN pattern differs, or whose other centers differ
    by more than 1e-5 (equal infinities agree)."""
    out = []
    for g in range(want.shape[0]):
        nan = torch.isnan(want[g])
        ok = (got[g] == want[g]) | ((got[g] - want[g]).abs() <= 1e-5)
        if not torch.equal(torch.isnan(got[g]), nan) or not bool(ok[~nan].all()):
            out.append(names[g])
    return out


def measure(spec: dict, own: bool) -> dict:
    """Times and checks of this process's tree (``own``: the tree of this
    file, with its probes, floors and the empty program) on ``spec``'s
    inputs: the slot terms by B and the NaN groups' file."""
    import chip_smoke
    from pixie_tpu_torch.ops import batched, kernels, ml

    dev = torch.device("cuda", 0)
    kernels.library()
    out: dict = {"h22": {}, "h27": {}}
    cols, dtypes, base = h22_inputs(dev)
    for B, slot_terms in spec["terms"].items():
        slot_terms = [[tuple(t[:5]) + (tuple(t[5]),) for t in terms] for terms in slot_terms]
        table = batched.build_term_table(slot_terms, dtypes).to(dev)
        tcols = [cols[c][0] for c in table.columns]
        offs = [cols[c][1] for c in table.columns]
        got = batched.slot_masks(tcols, offs, base, table)
        row = {"equal": bool(torch.equal(got, batched.slot_masks_plain(tcols, offs, base, table))),
               "ms": chip_smoke.time_ms(lambda: batched.slot_masks(tcols, offs, base, table))}
        if own:
            prog = table.prog
            geo = kernels.pred_slot_masks_geometry(ROWS, prog.num_terms, prog.shared_words)
            row.update(
                distinct_terms=prog.num_terms, lists=prog.forms,
                floor_ms=chip_smoke.time_ms(lambda: kernels.empty_launch(dev, *geo)),
                no_term_ms=chip_smoke.time_ms(lambda: kernels.pred_slot_masks(
                    tcols, offs, base, prog.terms[:0], prog.lists, 0, table.slot_on)))
        out["h22"][f"B{B}"] = row
    pts, w = h27_inputs(dev)
    for k in (4, 8):
        want = ml.kmeans_fit_plain(pts, w, k)
        row = {"max_abs_err": float((ml.kmeans_fit(pts, w, k) - want).abs().max()),
               "ms": chip_smoke.time_ms(lambda: ml.kmeans_fit(pts, w, k))}
        if own:
            probe = torch.zeros(kernels.KMEANS_PROBE, dtype=torch.int64, device=dev)
            kernels.kmeans_fit(pts, w, k, probe=probe)
            p = probe.cpu().tolist()
            us = 1e3 / kernels.sm_clock_khz(dev)
            row.update(
                floor_ms=chip_smoke.time_ms(lambda: kernels.empty_launch(
                    dev, *kernels.kmeans_fit_geometry(KM_G, KM_S, KM_D, k))),
                phases_us={"load": (p[1] - p[0]) * us, "seeding": (p[2] - p[1]) * us,
                           "lloyd": (p[3] - p[2]) * us, "assign": p[4] * us,
                           "update": p[5] * us})
        out["h27"][f"k{k}"] = row
    one = pts.clone()
    one[3, 40, 7] = float("nan")
    out["h27"]["k8_one_nan_ms"] = chip_smoke.time_ms(lambda: ml.kmeans_fit(one, w, 8))
    groups = np.load(spec["nan_groups"])
    npts, nw = torch.from_numpy(groups["points"]).to(dev), torch.from_numpy(groups["weights"]).to(dev)
    for k in (3, 8, 20):
        out["h27"][f"nan_groups_k{k}_differ"] = nan_diff(
            ml.kmeans_fit(npts, nw, k).cpu(), ml.kmeans_fit_plain(npts, nw, k).cpu(),
            spec["nan_names"])
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="write the results here as JSON")
    ap.add_argument("--parent", default=None, help="a tree of an earlier commit to time too")
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
    from pixie_tpu_torch.ops import kmeans_edges, pred_edges

    with tempfile.TemporaryDirectory() as tmp:
        npz = os.path.join(tmp, "nan_groups.npz")
        gp, gw = kmeans_edges.nan_groups()
        np.savez(npz, points=gp, weights=gw)
        spec = {"terms": {B: pred_edges.soak_terms() if B == 7 else pred_edges.wide_terms(B)
                          for B in (7, 1, 16, 32)},
                "nan_groups": npz, "nan_names": list(kmeans_edges.NAN_GROUPS)}
        res = {"card": subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True).stdout.strip(), "this_tree": measure(spec, own=True)}
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
    return 0


if __name__ == "__main__":
    sys.exit(main())
