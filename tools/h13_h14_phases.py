"""Times of H13 (join_probe) and H14 (join_emit_pairs) on the card at the two
shapes the sort-merge join lane sends them, each beside an empty kernel's
floor on its launch's grid, H13's lanes over a sweep of key spaces, and the
same calls on another tree of the repository (its earlier designs) for
comparison.

    python3 tools/h13_h14_phases.py [--out FILE.json] [--parent DIR]

Run from the repository root on a machine with an H100 and the CUDA
toolkit. The shapes are chip_smoke.py's (``config8_join_keys``,
``join_left_agg_keys``): config 8's standalone join (the 16-row build side
padded to 256, 4,000,000 probe rows padded to 4,194,304, one match each,
cap 4,194,304) and join8_left_agg's (join_fact's 4,000,000 keys padded to
4,194,304 as the build side, svc_owners_partial's 18 padded to 256 as the
probe side, K 20, M 3,501,010: 14 rows of about 250,000 pairs). H13 with no
presence and with the presence array of a LEFT join, with the key space
local_sort_merge passes (the lane its launcher takes) and without one (the
search lane), each with its floor, and the library's two searchsorted; H14
in the lane its launcher takes and, at config 8's shape, also in the merge
lane (``order`` padded past the row lane's build side with entries no slot
reads), each with its floor. The sweep: uniform keys of [0, K) on a
4,194,304-row build side, H13 with the key space against the same call
without one (SWEEP_KEY_SPACES x SWEEP_PROBE_ROWS). Every result is checked
bit for bit against the plain versions (lo, fanout and presence; the pairs
below M). Median device ms of 30 calls (chip_smoke.time_ms). With
``--parent DIR`` (a tree of an earlier commit, e.g. ``git archive dfb67b4 |
tar -x -C DIR``) the shapes' calls run through that tree's
``kernels.join_probe`` and ``kernels.join_emit_pairs`` in a child process,
on the same inputs.
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


# H13's key-space sweep: uniform keys of [0, K) on a 4,194,304-row build
# side, probed by 256 to 4,194,304 rows.
SWEEP_KEY_SPACES = (22, 64, 256, 1024, 2048, 4096, 8192, 16384)
SWEEP_PROBE_ROWS = (256, 1 << 16, 1 << 20, 1 << 21, 1 << 22)
SWEEP_BUILD_ROWS = 1 << 22


def sweep(dev) -> list:
    """H13 with the key space passed (its launcher's lane for it) against
    the same call without one (the search lane), with and without a LEFT
    join's presence array, over SWEEP_KEY_SPACES x SWEEP_PROBE_ROWS; each
    checked bit for bit against the plain version."""
    import chip_smoke
    from pixie_tpu_torch.ops import kernels, segment

    rng = np.random.default_rng(21)
    rows = []
    for K in SWEEP_KEY_SPACES:
        lk = torch.from_numpy(rng.integers(0, K, SWEEP_BUILD_ROWS).astype(np.int32)).to(dev)
        sk = torch.sort(lk)[0]
        for n in SWEEP_PROBE_ROWS:
            rk = torch.from_numpy(rng.integers(0, K, n).astype(np.int32)).to(dev)
            row = {"K": K, "nb": SWEEP_BUILD_ROWS, "n": n}
            for ps in (0, K):
                want = segment.join_probe_plain(sk, rk, ps)
                for tag, ks in (("key_space", K), ("none", 0)):
                    got = kernels.join_probe(sk, rk, ps, ks)
                    ok = all((a is None and b is None) or torch.equal(a, b)
                             for a, b in zip(got, want))
                    name = f"{tag}{'_present' if ps else ''}"
                    row[f"{name}_equal"] = ok
                    row[f"{name}_ms"] = chip_smoke.time_ms(
                        lambda: kernels.join_probe(sk, rk, ps, ks))
            for tag, ks in (("key_space", K), ("none", 0)):
                row[f"{tag}_launch"] = kernels.join_probe_geometry(n, ks)
            rows.append(row)
    return rows


def measure(spec: dict, own: bool) -> dict:
    """Times and checks of this process's tree (``own``: the tree of this
    file, with its lanes, floors and the library yardstick) on ``spec``'s
    inputs."""
    import chip_smoke
    from pixie_tpu_torch.ops import kernels, segment

    dev = torch.device("cuda", 0)
    kernels.library()
    t = chip_smoke.time_ms
    out = {}
    for shape, path in spec["shapes"].items():
        data = np.load(path)
        lkey, rkey = (torch.from_numpy(data[k]).to(dev) for k in ("lkey", "rkey"))
        K = int(data["K"])
        n, ks = rkey.shape[0], K + 2
        sk, order = torch.sort(lkey, stable=True)
        order = order.to(torch.int32)
        lo, fanout, present = segment.join_probe_plain(sk, rkey, ks)
        prefix = torch.cumsum(fanout, 0, dtype=torch.int32)
        M, cap = int(prefix[-1]), int(data["cap"])
        row: dict = {"M": M, "cap": cap, "max_fanout": int(fanout.max())}
        probes = {"table": (ks,), "search": (0,)} if own else {"search": ()}
        for lane, extra in probes.items():
            for tag, ps in (("", 0), ("_present", ks)):
                got = kernels.join_probe(sk, rkey, ps, *extra)
                ok = torch.equal(got[0], lo) and torch.equal(got[1], fanout)
                if ps:
                    ok = ok and torch.equal(got[2], present)
                row[f"h13_{lane}{tag}_equal"] = ok
                row[f"h13_{lane}{tag}_ms"] = t(lambda: kernels.join_probe(sk, rkey, ps, *extra))
            if own:
                geo = kernels.join_probe_geometry(n, extra[0])
                row[f"h13_{lane}_grid"] = geo[:3]
                row[f"h13_{lane}_floor_ms"] = t(lambda: kernels.empty_launch(dev, *geo[:3]))
        wb, wp = segment.join_emit_pairs_plain(lo, fanout, prefix, order, cap)
        S, nb = min(M, cap), lkey.shape[0]
        orders = {"h14": order}
        if own and nb <= kernels.JOIN_ROWS_LANE_BUILD:
            # The merge lane on the same pairs: order padded past the row
            # lane's build side with entries no slot reads.
            orders["h14_merge"] = torch.cat([order, order.new_full(
                (kernels.JOIN_ROWS_LANE_BUILD + 1 - nb,), -1)])
        for tag, o in orders.items():
            gb, gp = kernels.join_emit_pairs(lo, fanout, prefix, o, cap)
            row[f"{tag}_equal"] = bool(
                torch.equal(gb[:S], wb[:S]) and torch.equal(gp[:S], wp[:S]))
            row[f"{tag}_ms"] = t(lambda: kernels.join_emit_pairs(lo, fanout, prefix, o, cap))
            if own:
                geo = kernels.join_emit_pairs_geometry(n, o.shape[0], cap)
                row[f"{tag}_lane"], row[f"{tag}_grid"] = geo[3], geo[:3]
                row[f"{tag}_floor_ms"] = t(lambda: kernels.empty_launch(dev, *geo[:3]))
        if own:
            row["library_two_searchsorted_ms"] = t(lambda: (
                torch.searchsorted(sk, rkey), torch.searchsorted(sk, rkey, right=True)))
            # chip_smoke.py's bounds: the build keys and order read where a
            # search or a slot reads them, at most once each
            lg = max(nb, 1).bit_length()
            row["h13_bound_ms"] = chip_smoke.bound(
                n * 12 + min(nb, 2 * lg * n) * 4, 2 * lg * n)[0]
            row["h14_bound_ms"] = chip_smoke.bound(n * 12 + min(nb, M) * 4 + M * 8, M)[0]
        out[shape] = row
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
    import chip_smoke

    with tempfile.TemporaryDirectory() as tmp:
        spec = {"shapes": {}}
        cpu = torch.device("cpu")
        lkey, rkey, K, _ = chip_smoke.config8_join_keys(cpu)
        lk, rk, K_left, _, cap_left = chip_smoke.join_left_agg_keys(cpu)
        for name, arrays in {
            "config8": dict(lkey=lkey.numpy(), rkey=rkey.numpy(), K=K, cap=1 << 22),
            "join8_left_agg": dict(lkey=lk.numpy(), rkey=rk.numpy(), K=K_left, cap=cap_left),
        }.items():
            spec["shapes"][name] = os.path.join(tmp, f"{name}.npz")
            np.savez(spec["shapes"][name], **arrays)
        res = {"card": chip_smoke.nvidia_smi_line(), "this_tree": measure(spec, own=True),
               "key_space_sweep": sweep(torch.device("cuda", 0))}
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
