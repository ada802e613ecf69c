"""Times of H12 (scan_compact) and H18 (codec_rle_decode) on the card at every
shape the main paths send them and at the codec's worst admitted shapes, each
beside an empty kernel's floor on its launch's grid, the first CTA's phases, and
the same calls on another tree of the repository (its earlier designs) for
comparison.

    python3 tools/h12_h18_phases.py [--out FILE.json] [--parent DIR]

Run from the repository root on a machine with an H100 and the CUDA
toolkit. The shapes:

- H12 over columns: config 1's first block (2^21 rows, 10% selected, time_
  int64, service codes int32, latency f64, limit 1000, ``written`` 0), the
  same block reached with ``written`` at the limit (a later block's launch,
  which returns at once), and a wide copy (50% selected, a limit above the
  count); H12's index lane as ``segment.compact_unmatched_rows`` calls it at
  config 8 OUTER (499,200 unmatched of 4,194,304 probe rows, cap 524,288),
  the kernel alone and the whole call with its device operations; and the
  shapes ``chip_smoke.py --log-shapes`` logged on the paths (PATH_H12).
- H18 at a 2^23-row stream window with 4096 runs in every block dtype, at the
  shapes the paths send (PATH_H18), and at the codec's worst admitted shapes:
  the most runs ``codec.plan_codec_local`` still ships as RLE under the
  ``staging_codec_min_ratio`` flag for int64 (about L / 2.1) and uint8
  (about L / 7) blocks, at L = 2^23 and over a 4-shard window of 2^23 rows.
  Their payloads come from ``codec.encode_window`` of generated runs.

Every result is checked bit for bit against the plain versions
(``scan.compact_rows_plain``, the reference's sentinel sort for the index
lane, ``codec.rle_decode_plain``). Median device ms of 30 calls
(``chip_smoke.time_ms``); each H12 call gets a fresh ``written``
(``chip_smoke.fresh``). Floors: an empty kernel on the launch's grid
(``kernels.empty_launch``), this tree's and the earlier design's (a CTA a
2048-row tile for H12; ``min(ceil(d L / 512), 8 SMs)`` CTAs of 512 for H18).
With ``--parent DIR`` (a tree of an earlier commit, e.g. ``git archive
825c812 | tar -x -C DIR``) the same calls run through that tree's kernels in
a child process, on the same inputs. It also times an empty kernel on the
grids of H20, H21, H16 and H10, the kernels next in line (``next_floors``).
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
WINDOW_ROWS = 1 << 23
SCAN_LIMIT = 1000
# (name, n, selected, limit, written, column widths in bytes; none: the
# index lane) of every distinct H12 launch on the paths (chip_smoke.py
# --log-shapes, H100 80GB HBM3, 700.00 W): http_data and http_data_ring's
# scans; the OUTER and LEFT joins' unmatched probe rows (join8_outer,
# join8_left_agg, the 2-host mesh's hosts) and build rows; the 4-host mesh's
# hosts, two of whose probe shards hold every unmatched row.
PATH_H12 = (
    ("http_data", 2097152, 209241, 1000, 0, (8, 4, 8)),
    ("join_probe_unmatched", 4194304, 498990, 524288, 0, ()),
    ("join_build_unmatched", 256, 4, 8, 0, ()),
    ("mesh2_probe_none", 4194304, 0, 524288, 0, ()),
    ("mesh2_build", 1024, 4, 8, 0, ()),
    ("mesh2_build_none", 1024, 0, 8, 0, ()),
    ("mesh4_probe", 2097152, 498990, 524288, 0, ()),
    ("mesh4_probe_none", 2097152, 0, 524288, 0, ()),
    ("mesh4_build", 512, 4, 8, 0, ()),
    ("mesh4_build_none", 512, 0, 8, 0, ()),
)
# (name, d, L, runs used in each shard, R, block dtype) of every distinct H18
# launch on the paths (the same log): sorted_keys' gid lane and status,
# http_data's monolithic staging of 64M rows (about 5.7 rows a run),
# http_data_ring's window, and the join tables' service codes.
PATH_H18 = (
    ("sorted_keys_uint16", 1, 1048576, (64,), 80, "uint16"),
    ("sorted_keys_uint8", 1, 1048576, (64,), 80, "uint8"),
    ("http_data_uint16", 1, 67108864, (11842204,), 12582912, "uint16"),
    ("http_data_ring_uint16", 1, 2097152, (200362,), 393216, "uint16"),
    ("join8_uint8", 1, 256, (17,), 20, "uint8"),
    ("join8_oncall_uint8", 1, 256, (18,), 20, "uint8"),
    ("join8_outer_uint8", 1, 256, (19,), 20, "uint8"),
    ("join8_oncall_seats_uint8", 1, 256, (13,), 14, "uint8"),
)
DTYPES = {"uint8": np.uint8, "uint16": np.uint16, "int32": np.int32, "int64": np.int64,
          "float32": np.float32, "float64": np.float64}
TORCH = {"uint8": torch.uint8, "uint16": torch.uint16, "int32": torch.int32,
         "int64": torch.int64, "float32": torch.float32, "float64": torch.float64}


# ---------------------------------------------------------------- inputs
def h12_columns(rng, n: int, widths: list) -> dict:
    cols = {}
    for i, w in enumerate(widths):
        if w == 8 and i % 2 == 0:
            cols[f"col{i}"] = rng.integers(0, 1 << 40, n)
        elif w == 8:
            cols[f"col{i}"] = rng.exponential(30.0, n)
        else:
            cols[f"col{i}"] = rng.integers(0, 16, n).astype(np.int32)
    return cols


def selected_mask(rng, n: int, selected: int) -> np.ndarray:
    mask = np.zeros(n, bool)
    mask[rng.choice(n, selected, replace=False)] = True
    return mask


def h12_specs(rng) -> dict:
    """name -> arrays of each H12 shape (mask, columns, limit, written)."""
    import chip_smoke

    n = BLOCK_ROWS
    widths = [8, 4, 8]
    out = {}
    block = dict(mask=rng.random(n) < 0.1, **h12_columns(rng, n, widths))
    out["config1"] = dict(block, limit=SCAN_LIMIT, written=0)
    out["config1_full"] = dict(block, limit=SCAN_LIMIT, written=SCAN_LIMIT)
    out["wide_copy"] = dict(mask=rng.random(n) < 0.5, **h12_columns(rng, n, widths),
                            limit=n, written=0)
    lkey, rkey, K, _ = chip_smoke.config8_join_keys(torch.device("cpu"))
    rk = rkey.numpy()
    unmatched = np.isin(rk, chip_smoke.UNOWNED) & (np.arange(rk.shape[0]) < chip_smoke.JOIN_ROWS)
    ur = int(unmatched.sum())
    out["config8_outer"] = dict(mask=unmatched, limit=1 << (ur - 1).bit_length(), written=0)
    for name, n, sel, limit, written, ws in PATH_H12:
        spec = dict(mask=selected_mask(rng, n, sel), limit=limit, written=written)
        if ws:
            spec.update(h12_columns(rng, n, list(ws)))
        out[name] = spec
    return out


def h18_specs(rng) -> dict:
    """name -> arrays of each H18 shape (values as bytes, ends, L, dtype,
    the runs each shard uses)."""
    import chip_smoke

    out = {}
    for name in DTYPES:
        out[f"window_4096_{name}"] = chip_smoke.rle_payload(
            rng, 1, WINDOW_ROWS, [4096], DTYPES[name])
    for name, d, L, runs, R, dt in PATH_H18:
        out[name] = chip_smoke.rle_payload(rng, d, L, list(runs), DTYPES[dt], R)
    for dt in ("int64", "uint8"):
        out[f"worst_{dt}_L2^23"] = chip_smoke.rle_worst_payload(rng, 1, WINDOW_ROWS, DTYPES[dt])
        out[f"worst_{dt}_d4"] = chip_smoke.rle_worst_payload(
            rng, 4, WINDOW_ROWS // 4, DTYPES[dt])
    return out


# ---------------------------------------------------------------- timing
def measure(spec: dict, own: bool) -> dict:
    """Times and checks of this process's tree on ``spec``'s inputs; with
    ``own`` (the tree of this file) also floors, bounds, library calls and
    H12's probe phases."""
    import chip_smoke
    from pixie_tpu_torch.ops import codec, kernels, scan, segment

    dev = torch.device("cuda", 0)
    kernels.library()
    t = chip_smoke.time_ms
    index_lane = hasattr(kernels, "scan_compact_indices")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    out: dict = {"h12": {}, "h18": {}}
    for name, path in spec["h12"].items():
        data = np.load(path)
        mask = torch.from_numpy(data["mask"]).to(dev)
        n, limit, w0 = mask.shape[0], int(data["limit"]), int(data["written"])
        sel = torch.nonzero(mask).flatten()
        row: dict = {"n": n, "selected": int(sel.numel()), "limit": limit, "written": w0}
        names = sorted(k for k in data.files if k.startswith("col"))
        if not names:  # the index lane: compact_unmatched_rows
            want = torch.full((limit,), n, dtype=torch.int32, device=dev)
            take = min(limit, sel.numel())
            want[:take] = sel[:take].to(torch.int32)
            idx = torch.arange(n, dtype=torch.int32, device=dev)
            buf = torch.full((limit,), n, dtype=torch.int32, device=dev)
            counters = chip_smoke.fresh(lambda: torch.zeros(1, dtype=torch.int32, device=dev))
            if index_lane:
                fn = lambda: kernels.scan_compact_indices(mask, limit)
                got = fn()
            else:
                fn = lambda: kernels.scan_compact(mask, [idx], counters(), [buf], limit)
                fn()
                got = buf
            call = lambda: segment.compact_unmatched_rows(mask, limit)
            row["equal"] = bool(torch.equal(got, want) and torch.equal(call(), want))
            row["ms"] = t(fn)
            row["call_ms"] = t(call)
            row["call_device_ops"] = chip_smoke.device_ops(call)
            if own:
                row["library_ms"] = t(lambda: torch.nonzero(mask))
                row["bound_ms"] = chip_smoke.bound(n + 4 * limit, n)[0]
                row["parent_kernel_bound_ms"] = chip_smoke.bound(n + 8 * sel.numel(), n)[0]
            cols, row_bytes = [idx], 4
        else:
            cols = [torch.from_numpy(data[k]).to(dev) for k in names]
            row_bytes = sum(c.element_size() for c in cols)
            bufs = [torch.zeros(limit, dtype=c.dtype, device=dev) for c in cols]
            wbufs = [torch.zeros(limit, dtype=c.dtype, device=dev) for c in cols]
            written = torch.full((1,), w0, dtype=torch.int32, device=dev)
            want_w = torch.full((1,), w0, dtype=torch.int32, device=dev)
            kernels.scan_compact(mask, cols, written, bufs, limit)
            scan.compact_rows_plain(mask, cols, want_w, wbufs, limit)
            row["equal"] = bool(torch.equal(written, want_w) and all(
                torch.equal(a.view(torch.uint8), b.view(torch.uint8))
                for a, b in zip(bufs, wbufs)))
            counters = chip_smoke.fresh(
                lambda: torch.full((1,), w0, dtype=torch.int32, device=dev))
            fn = lambda: kernels.scan_compact(mask, cols, counters(), bufs, limit)
            row["ms"] = t(fn)
            if own:
                take = max(min(sel.numel(), limit - w0), 0)
                span = int(sel[take - 1]) + 1 if take else (0 if w0 >= limit else n)
                row["library_ms"] = t(lambda: [c[mask] for c in cols])
                row["bound_ms"] = chip_smoke.bound(span + 2 * take * row_bytes + 4, span)[0]
        if own:
            row["parent_grid_floor_ms"] = t(lambda: kernels.empty_launch(
                dev, -(-n // 2048), 256))
            if index_lane:
                geo = kernels.scan_compact_geometry(dev, n)
                row["grid"] = geo
                row["floor_ms"] = t(lambda: kernels.empty_launch(dev, *geo))
                if w0 < limit:  # else the launch returns at once: no phases
                    probe = torch.zeros(kernels.SCAN_PROBE, dtype=torch.int64, device=dev)
                    if names:
                        written = torch.full((1,), w0, dtype=torch.int32, device=dev)
                        kernels.scan_compact(mask, cols, written, bufs, limit, probe=probe)
                    else:
                        kernels.scan_compact_indices(mask, limit, probe=probe)
                    row["cta0_phases_us"] = chip_smoke.probe_phases_us(
                        probe, ("count", "wait", "copy", "pad"), 0, kernels.sm_clock_khz(dev))
        out["h12"][name] = row
    for name, path in spec["h18"].items():
        data = np.load(path)
        dtype = TORCH[str(data["dtype"])]
        w = torch.empty(0, dtype=dtype).element_size()
        L = int(data["L"])
        values = torch.from_numpy(data["values"]).to(dev).view(dtype)
        ends = torch.from_numpy(data["ends"]).to(dev)
        d, R = ends.shape
        got = torch.empty((d, L), dtype=dtype, device=dev)
        want = torch.empty((d, L), dtype=dtype, device=dev)
        kernels.codec_rle_decode(values, ends, got)
        codec.rle_decode_plain(values, ends, want)
        row = {"d": d, "L": L, "R": R, "dtype": str(data["dtype"]),
               "runs": [int(x) for x in data["runs"]],
               "equal": bool(torch.equal(got.view(torch.uint8), want.view(torch.uint8)))}
        row["ms"] = t(lambda: kernels.codec_rle_decode(values, ends, got))
        if own:
            runs = int(np.sum(data["runs"]))
            row["plain_ms"] = t(lambda: codec.rle_decode_plain(values, ends, want))
            # the runs used read once (values and ends), the block written once
            row["bound_ms"], row["bound_by"] = chip_smoke.bound(
                runs * (w + 4) + d * L * w, d * L + runs)
            row["parent_grid_floor_ms"] = t(lambda: kernels.empty_launch(
                dev, min(-(-d * L // 512), 8 * sms), 512))
            if hasattr(kernels, "codec_rle_decode_geometry"):
                geo = kernels.codec_rle_decode_geometry(d, L, w)
                row["grid"] = geo
                row["floor_ms"] = t(lambda: kernels.empty_launch(dev, *geo))
                probe = torch.zeros(kernels.RLE_PROBE, dtype=torch.int64, device=dev)
                kernels.codec_rle_decode(values, ends, got, probe=probe)
                row["cta0_phases_us"] = chip_smoke.probe_phases_us(
                    probe, ("search", "stage", "expand"), 0, kernels.sm_clock_khz(dev))
        out["h18"][name] = row
    return out


def next_floors(dev) -> dict:
    """An empty kernel's time on the grids of the kernels that lead the
    ranking after H12 and H18 (their launchers' grids at the paths'
    shapes): H20 and H21 over config 5's 16 x 4 cells (one CTA of 512
    threads), H16 over a 2^21-row block with its sums in shared memory
    (two CTAs of 512 an SM) and H10 over 4096 groups (a CTA of 256 a
    group)."""
    import chip_smoke
    from pixie_tpu_torch.ops import kernels

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    grids = {"H20_H21": (1, 512), "H16": (min(-(-BLOCK_ROWS // 512), 2 * sms), 512),
             "H10": (4096, 256)}
    return {name: {"grid": g, "floor_ms": chip_smoke.time_ms(
        lambda: kernels.empty_launch(dev, *g))} for name, g in grids.items()}


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

    rng = np.random.default_rng(22)
    with tempfile.TemporaryDirectory() as tmp:
        spec: dict = {"h12": {}, "h18": {}}
        for kind, specs in (("h12", h12_specs(rng)), ("h18", h18_specs(rng))):
            for name, arrays in specs.items():
                spec[kind][name] = os.path.join(tmp, f"{kind}_{name}.npz")
                np.savez(spec[kind][name], **arrays)
        res = {"card": chip_smoke.nvidia_smi_line(), "this_tree": measure(spec, own=True),
               "next_floors": next_floors(torch.device("cuda", 0))}
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
           for k in ("h12", "h18") for name, row in res[tree][k].items() if not row["equal"]]
    if bad:
        print(f"results differ from the plain versions: {bad}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
