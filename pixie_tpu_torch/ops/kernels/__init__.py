"""The hand-written Hopper kernels: build, bind, launch, count.

``hopper_kernels.cu`` holds the CUDA C++ kernels of the sum and
log-histogram fold (H1-H4), ``sketch_kernels.cu`` those of the sketches
(the hash kernel and H5-H10; H7a and H7b the t-digest's sorting update of
more than 254 groups), ``tdigest_kernels.cu`` the t-digest's block update
without a sort (H7, up to 254 groups), ``minmax_kernels.cu`` the segment min/max
(H11), ``scan_kernels.cu`` the scan's stream compaction (H12) and
``join_kernels.cu`` the sort-merge join's probe, pair emission and gathers
(H13-H15), ``join_agg_kernels.cu`` the join-aggregate lane's weighted
fold (H16), ``scalar_kernels.cu`` the fused scalar-expression
interpreter (H17), ``codec_kernels.cu`` the staging codec's device decode
(H18, H19), ``cell_kernels.cu`` the sketches' int-dictionary cell lane
(H20, H21) and ``batch_kernels.cu`` the predicate-batched fold's slot masks
and slot-batched segment sums (H22, H23), ``convert_kernels.cu`` the
resident ring's raw -> plan converters (H24), ``ml_kernels.cu`` the ML
lane's reservoir priorities, reservoir top-k and k-means (H25-H27, with the
64-bit hashes of ``hash64.cuh``) and ``transformer_kernels.cu`` the
transformer UDF's encoder (H28), ``merge_kernels.cu`` the sharded
fold's cross-shard merge of the states (H29), and ``hash_kernels.cu`` the
row-wise 64-bit hash of several columns and the u64 leading-zero count
(H31, H32; ``sketch_kernels.cu`` also holds the count-min query, H30:
these three have no caller in either package yet, and the hash kernel has
none in the port: H5, H6, H20 and H21 hash in registers); ``rows.cuh``
holds the typed row loads of H1, H3, H5, H6 and H11 (a column read as
staged, ``ROW_*`` kinds), ``tdigest_cluster.cuh`` the t-digest's cluster of
a mid-quantile that H7 and H8 share; see each file's header. At
the first launch, ``library()`` compiles them with ``nvcc`` for
``sm_90a``, one process per source started together, and links them into
``pixie_tpu_torch/_build/`` as one shared library with a plain C
interface, keyed by a hash of the sources, their headers and the flags, and
loads it with ctypes; a later process finds the library there and skips the
build. Nothing here is imported, built or
probed at module import: the CPU tests import this module on machines with
no CUDA toolkit.

Each wrapper checks device, dtype, shape and contiguity, allocates its output
with torch on the input's device, makes that device current for the launch
(the library launches on the CUDA runtime's current device), launches on
torch's current stream of that device, raises on a non-zero launch status,
and adds one to ``LAUNCHES[name]`` for each kernel launch it makes (and
nowhere else). There is no fallback: a kernel that does not build or launch
raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from typing import Optional

import torch

KERNELS = (
    "segment_rows_sum_i64",
    "segment_rows_sum_f64",
    "log_histogram_update",
    "hist_quantiles",
    "hash32",
    "hll_update",
    "countmin_update",
    "tdigest_update",
    "tdigest_pack",
    "tdigest_cluster",
    "tdigest_merge",
    "tdigest_quantiles",
    "hll_estimate",
    "segment_minmax",
    "scan_compact",
    "join_probe",
    "join_emit_pairs",
    "join_gather",
    "join_agg_fold",
    "scalar_eval",
    "codec_rle_decode",
    "codec_delta_decode",
    "hll_cell_update",
    "countmin_cell_update",
    "pred_slot_masks",
    "batched_segment_sums",
    "ring_convert",
    "reservoir_priority",
    "reservoir_topk",
    "reservoir_topk_rows",
    "kmeans_fit",
    "encoder_forward",
    "merge_states",
    "countmin_query",
    "hash_columns",
    "clz64",
)

# Launch counts per kernel since the last reset_launches().
LAUNCHES: dict[str, int] = {k: 0 for k in KERNELS}

_DIR = os.path.dirname(os.path.abspath(__file__))
SOURCES = (
    "hopper_kernels.cu", "sketch_kernels.cu", "minmax_kernels.cu", "scan_kernels.cu",
    "join_kernels.cu", "join_agg_kernels.cu", "scalar_kernels.cu", "codec_kernels.cu",
    "cell_kernels.cu", "batch_kernels.cu", "convert_kernels.cu", "ml_kernels.cu",
    "transformer_kernels.cu", "merge_kernels.cu", "hash_kernels.cu", "tdigest_kernels.cu",
)
HEADERS = ("common.cuh", "sketch_hash.cuh", "hash64.cuh", "rows.cuh", "tdigest_cluster.cuh")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_DIR)), "_build")
ARCH = "-gencode=arch=compute_90a,code=sm_90a"
NVCC_FLAGS = ("-O3", "-std=c++17", ARCH, "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_SIGNATURES = {
    "px_smem_optin_bytes": (ctypes.POINTER(ctypes.c_int),),
    "px_segment_rows_sum_i64": (_P, _P, _P, _I, _LL, _P, _P, _I, _P, _I, _I, _P),
    "px_segment_rows_sum_f64": (
        _P, _P, _P, ctypes.c_uint, _I, _LL, _P, _P, _I, _P, _I, _I, _P, _P, _P,
    ),
    "px_log_histogram_update": (
        _P, _I, _LL, _P, _P, _I, _I, ctypes.c_float, ctypes.c_float, _P, _I, _P, _P,
    ),
    "px_log_histogram_geometry": (_LL, _I, _I, _I, _P),
    "px_empty_launch": (_I, _I, _I, _P),
    "px_sm_clock_khz": (ctypes.POINTER(ctypes.c_int),),
    "px_hist_quantiles": (_P, _I, _I, _P, _I, _P, _P, _P, _P),
    "px_hist_quantiles_geometry": (_I, _P),
    "px_hash32": (_P, _LL, ctypes.c_uint, _I, _P, _P),
    "px_hll_update": (_P, _I, _LL, _LL, _P, _P, _I, _I, _P, _I, _P),
    "px_countmin_update": (_P, _I, _LL, _LL, _P, _P, _I, _I, _I, _P, _P, _I, _P),
    "px_tdigest_update": (
        _P, _I, _LL, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _LL, _P, _P, _P,
    ),
    "px_tdigest_pack": (_P, _LL, _P, _P, _I, _I, _I, _P, _P, _I, _P),
    "px_tdigest_cluster": (_P, _LL, _P, _I, _I, _I, _I, _P, _P, _P),
    "px_tdigest_merge": (_P, _P, _P, _P, _I, _I, _I, _P, _P, _P, _P),
    "px_tdigest_merge_geometry": (_I, _I, _P),
    "px_tdigest_quantiles": (_P, _P, _I, _I, _P, _I, _P, _P, _P),
    "px_tdigest_quantiles_geometry": (_I, _P),
    "px_hll_estimate": (_P, _I, _I, _I, ctypes.c_double, _P, _P, _P),
    "px_hll_estimate_geometry": (_I, _P),
    "px_segment_minmax": (_P, _I, _LL, _LL, _P, _P, _I, _P, _I, _I, _I, _P),
    "px_scan_compact": (_P, _LL, _P, _P, _P, _I, _P, _I, _P, _I, _I, _LL, _P, ctypes.c_uint, _P,
                        _P),
    "px_join_probe": (_P, _I, _P, _LL, _P, _P, _P, _I, _I, _P),
    "px_join_probe_geometry": (_LL, _I, _P),
    "px_join_emit_pairs": (_P, _P, _P, _LL, _P, _I, _LL, _P, _P, _P),
    "px_join_emit_pairs_geometry": (_LL, _I, _LL, _P),
    "px_join_gather": (_P, _LL, _I, _I, _LL, _P, _LL, _P, _LL, _P, _LL, _LL, _P, _P),
    "px_join_agg_fold": (_P, _I, _LL, _P, _I, _P, _LL, _P, _I, _P, _I, _P, _P, _P, _I, _P, _I,
                         _P, _I, _I, _I, _P, _P, _P, _P),
    "px_join_agg_fold_geometry": (_I, _I, _I, _I, _I, _I, _P),
    "px_scalar_eval": (_P, _I, _P, _I, _I, _I, _P, _P, _P, _I, _P, _P, _P, _I, _P, _P, _I, _LL,
                       _P),
    "px_codec_rle_decode": (_P, _P, _I, _I, _LL, _I, _P, _P, _P),
    "px_codec_delta_decode": (_P, _P, _LL, _I, _P, _LL, _I, _LL, _I, _P, _P, _P),
    "px_hll_cell_update": (_P, _P, _I, _I, _I, _P, _P),
    "px_countmin_cell_update": (_P, _P, _I, _I, _I, _I, _P, _P, _P),
    "px_pred_slot_masks": (
        _P, _P, _P, _I, _P, _LL, _P, _I, _P, _I, ctypes.c_uint, _P, _P,
    ),
    "px_pred_slot_masks_geometry": (_LL, _I, _I, _P),
    "px_batched_segment_sums": (
        _P, _P, _P, _I, _P, _P, _P, _I, _LL, _P, _P, _I, _I, _P, _P, _I, _I, _I, _P, _P, _P,
    ),
    "px_ring_convert": (_P, _I, _P, _I, _I, _LL, _P, _I, _I, _LL, _LL, _LL, _P),
    "px_reservoir_priority": (_P, _LL, _P, _P, _P, _P),
    "px_reservoir_topk": (_P, _P, _I, _I, _P, _P, _P, _P, _P, _P, _P),
    "px_reservoir_topk_rows": (
        _P, _P, _P, _I, _I, _P, _P, _P, _LL, _I, _I, _P, _P, _P, _P, _P, _P,
    ),
    "px_kmeans_fit": (_P, _P, _I, _I, _I, _I, _I, _P, _P, _P),
    "px_kmeans_fit_geometry": (_I, _I, _I, _I, _P),
    "px_encoder_forward": (_P, _P, _P, _I, _P, _P, _P, _I, _P, _P),
    "px_merge_states": (_P, _I, _LL, _I, _I, _P, _P),
    "px_countmin_query": (_P, _I, _I, _I, _P, _P, _LL, _P, _P),
    "px_hash_columns": (
        _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, ctypes.c_ulonglong, _LL, _P, _P,
    ),
    "px_clz64": (_P, _LL, _P, _P),
}

_lock = threading.Lock()
# Concurrent queries launch from their own threads: LAUNCHES updates hold it.
_launch_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
# Opt-in shared-memory limit per block, by device index.
_smem_optin: dict[int, int] = {}
# What the last build() did, for chip_smoke.py's report.
BUILD_INFO: dict = {}


def reset_launches() -> None:
    with _launch_lock:
        for k in KERNELS:
            LAUNCHES[k] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError(
        "nvcc not found (PATH, CUDA_HOME, /usr/local/cuda/bin): the CUDA "
        "kernels of pixie_tpu_torch cannot be built"
    )


def _run(cmd: list) -> subprocess.Popen:
    return subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True
    )


def _finish(proc: subprocess.Popen, what: str) -> str:
    out, err = proc.communicate(timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc {what} failed ({proc.returncode}):\n{err}{out}")
    return err


def build() -> str:
    """Compile the kernels (once per source hash) and return the library path."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        with open(os.path.join(_DIR, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    so_path = os.path.join(BUILD_DIR, f"libpixie_kernels_{h.hexdigest()[:16]}.so")
    if os.path.exists(so_path):
        BUILD_INFO.update(path=so_path, cached=True, seconds=0.0, ptxas="")
        return so_path
    os.makedirs(BUILD_DIR, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        nvcc = _nvcc()
        objs = [os.path.join(tmp, f"{os.path.splitext(n)[0]}.o") for n in SOURCES]
        # One nvcc per source, all started together.
        procs = [
            _run([nvcc, *NVCC_FLAGS, "-c", os.path.join(_DIR, n), "-o", o])
            for n, o in zip(SOURCES, objs)
        ]
        try:
            ptxas = "".join(_finish(p, n) for p, n in zip(procs, SOURCES))
        finally:  # a failed compile leaves no other nvcc running
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        lib = os.path.join(tmp, "lib.so")
        _finish(_run([nvcc, "-shared", ARCH, *objs, "-o", lib]), "link")
        os.replace(lib, so_path)
    BUILD_INFO.update(
        path=so_path, cached=False, seconds=time.perf_counter() - t0, ptxas=ptxas
    )
    return so_path


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def smem_optin_bytes(device: torch.device) -> int:
    """The per-block opt-in shared-memory limit of ``device``."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _smem_optin:
        out = ctypes.c_int(0)
        with torch.cuda.device(index):
            _check(library().px_smem_optin_bytes(ctypes.byref(out)), "smem query")
        _smem_optin[index] = out.value
    return _smem_optin[index]


def empty_launch(device: torch.device, grid: int, threads: int, smem: int = 0) -> None:
    """Launches an empty kernel of ``grid`` CTAs of ``threads`` (``smem``
    bytes of dynamic shared memory) on ``device``'s current stream: the
    floor under a kernel's launch of that shape. No port kernel, so not
    counted in LAUNCHES."""
    with torch.cuda.device(device):
        status = library().px_empty_launch(
            grid, threads, smem, torch.cuda.current_stream(device).cuda_stream)
    _check(status, "empty_launch")


def sm_clock_khz(device: torch.device) -> int:
    """The SM clock's rate (kHz) of ``device``: H3's and H8's probe stamps
    are its cycles (clock64)."""
    out = ctypes.c_int(0)
    with torch.cuda.device(device):
        _check(library().px_sm_clock_khz(ctypes.byref(out)), "clock query")
    return out.value


def _check(status: int, what: str) -> None:
    if status != 0:
        raise RuntimeError(f"CUDA kernel {what} failed to launch: cudaError {status}")


def _launch(name: str, device: torch.device, *args) -> None:
    """Calls the library's ``px_<name>`` with ``device`` current and torch's
    current stream of ``device`` as the last argument, and counts it as a
    launch of ``name``."""
    with torch.cuda.device(device):
        status = getattr(library(), f"px_{name}")(
            *args, torch.cuda.current_stream(device).cuda_stream
        )
    _check(status, name)
    count_launch(name)


def count_launch(name: str) -> None:
    """LAUNCHES[name] += 1, atomically."""
    with _launch_lock:
        LAUNCHES[name] += 1


def _require(t: torch.Tensor, name: str, dtype: torch.dtype, device, ndim: int) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} has {t.dim()} dims, expected {ndim}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _probe_arg(probe: Optional[torch.Tensor], n: int, device) -> None:
    """Checks an optional probe: int64 [>= n] on ``device``."""
    if probe is None:
        return
    _require(probe, "probe", torch.int64, device, 1)
    if probe.shape[0] < n:
        raise ValueError(f"probe has {probe.shape[0]} entries, expected {n}")


def _gids_mask(gids, mask, n, device):
    _require(gids, "gids", torch.int32, device, 1)
    if gids.shape[0] != n:
        raise ValueError(f"gids has {gids.shape[0]} rows, expected {n}")
    if mask is None:
        return None
    _require(mask, "mask", torch.bool, device, 1)
    if mask.shape[0] != n:
        raise ValueError(f"mask has {mask.shape[0]} rows, expected {n}")
    return mask


# Row kinds of H1, H5, H6 and H11 (rows.cuh RowKind): how a staged row's
# bytes widen to 64 bits.
ROW_PRESENCE, ROW_U8, ROW_U16, ROW_I32, ROW_I64, ROW_U32, ROW_F64 = range(7)
SUM_ROW_KINDS = {
    torch.bool: ROW_U8, torch.uint8: ROW_U8, torch.uint16: ROW_U16, torch.int32: ROW_I32,
    torch.int64: ROW_I64,
}
H1_MAX_ROWS = 32  # kMaxRows of hopper_kernels.cu: output rows a launch
H1_REGS_MAX_S = 32  # the register lane's largest bucket
H1_CLUSTER = 8  # CTAs of the cluster lane (kCluster of hopper_kernels.cu)


def _i64(x: int) -> int:
    """``x`` mod 2^64 as a signed int64."""
    return ((int(x) + (1 << 63)) % (1 << 64)) - (1 << 63)


def h1_lane(value_rows: int, S: int, optin: int) -> tuple[str, int]:
    """H1's lane for ``value_rows`` rows that read bytes (a presence row
    reads none) over S groups, with ``optin`` bytes of shared memory a
    block: ("regs", bucket) for S <= 32, the bucket 8, 16 or 32 groups;
    ("cluster", CTAs) while the whole partial (8 B a value row and a 4-byte
    count a group, ``h1_partial_bytes``) fits each CTA, the cluster adding
    its CTAs' partials before the flush; else ("global", 0)."""
    if S <= 0:
        raise ValueError(f"H1 needs groups, got S={S}")
    if S <= H1_REGS_MAX_S:
        return "regs", 8 if S <= 8 else 16 if S <= 16 else 32
    if h1_partial_bytes(value_rows, S) <= optin:
        return "cluster", H1_CLUSTER
    return "global", 0


def h1_partial_bytes(value_rows: int, S: int) -> int:
    """Shared bytes of a CTA of H1's cluster lane: S groups times (8 B a
    value row + a 4-byte count)."""
    return S * (8 * value_rows + 4)


def cluster_slices(S: int, cluster: int) -> list:
    """[lo, hi) of the groups each CTA of a cluster adds up and flushes
    (rank order); trailing ranks may hold none."""
    slice_ = -(-S // cluster)
    return [(min(S, r * slice_), min(S, (r + 1) * slice_)) for r in range(cluster)]


def _row_spec(t, off: int, i: int, n: int, device) -> tuple:
    if t is None:
        return None, ROW_PRESENCE, 0
    if t.dtype not in SUM_ROW_KINDS:
        raise TypeError(f"rows[{i}] has dtype {t.dtype}, expected one of {list(SUM_ROW_KINDS)}")
    _require(t, f"rows[{i}]", t.dtype, device, 1)
    if t.shape[0] != n:
        raise ValueError(f"rows[{i}] has {t.shape[0]} rows, expected {n}")
    return t.data_ptr(), SUM_ROW_KINDS[t.dtype], _i64(off)


def segment_rows_sum_i64(rows, gids: torch.Tensor, mask: Optional[torch.Tensor],
                         num_segments: int) -> torch.Tensor:
    """H1: int64 [R + 1, S] — row r's per-segment sums (mod 2^64) for r < R,
    then the per-segment count of valid rows. Rows with mask False or a gid
    outside [0, S) contribute nothing. ``rows``: an int64 [R, n] tensor, or
    R pairs (tensor, offset), each tensor [n] of bool, uint8, uint16, int32
    or int64 read as it lies, every value plus ``offset`` summed (a
    narrowed column with its frame-of-reference offset), or (None, 0): the
    presence row, which reads nothing and equals the count. One launch
    count per H1_MAX_ROWS rows."""
    device = gids.device
    if isinstance(rows, torch.Tensor):
        _require(rows, "rows", torch.int64, device, 2)
        pairs, n = [(r, 0) for r in rows], rows.shape[1]
    else:
        pairs, n = list(rows), gids.shape[0]
    mask = _gids_mask(gids, mask, n, device)
    specs = [_row_spec(t, off, i, n, device) for i, (t, off) in enumerate(pairs)]
    R, S = len(specs), num_segments
    out = torch.zeros((R + 1, S), dtype=torch.int64, device=device)
    if n == 0 or S == 0:
        return out
    if n >= 1 << 31:
        raise ValueError(f"H1 takes fewer than 2^31 rows, got {n}")
    optin = smem_optin_bytes(device)
    for lo in range(0, max(R, 1), H1_MAX_ROWS):
        part = specs[lo:lo + H1_MAX_ROWS]
        dst = out if R <= H1_MAX_ROWS else torch.zeros(
            (len(part) + 1, S), dtype=torch.int64, device=device)
        lane, arg = h1_lane(sum(k != ROW_PRESENCE for _, k, _ in part), S, optin)
        r = len(part)
        _launch(
            "segment_rows_sum_i64", device,
            ctypes.cast((ctypes.c_void_p * max(r, 1))(*[p for p, _, _ in part]), ctypes.c_void_p),
            ctypes.cast((ctypes.c_int * max(r, 1))(*[k for _, k, _ in part]), ctypes.c_void_p),
            ctypes.cast((ctypes.c_longlong * max(r, 1))(*[o for _, _, o in part]), ctypes.c_void_p),
            r, n, gids.data_ptr(), mask.data_ptr() if mask is not None else None, S,
            dst.data_ptr(), ("regs", "cluster", "global").index(lane), arg,
        )
        if dst is not out:
            out[lo:lo + r] = dst[:r]
            out[R] = dst[r]
    return out


# H2's lanes (hopper_kernels.cu): private cells and the warp lane up to
# H2_WARP_MAX_S groups, H2_WARP_ROWS rows a launch.
H2_MAX_ROWS = 32  # kF64MaxRows: rows a launch of the atomic lanes
H2_WARP_ROWS = 4  # kF64WarpRows
H2_WARP_MAX_S = 64  # kF64WarpMaxS
H2_PRIVATE_CELLS = 64  # kF64PrivMaxCells: rows a launch x S's bucket
H2_THREADS = 512  # kF64Threads
H2_PRIVATE_THREADS = 256  # kF64PrivThreads
H2_KINDS = {**SUM_ROW_KINDS, torch.float64: ROW_F64}


def h2_bucket(S: int) -> int:
    """The private lane's groups a row: S rounded up to 8, 16, 32 or 64."""
    return 8 if S <= 8 else 16 if S <= 16 else 32 if S <= 32 else 64


def h2_lane(rows: int, S: int, optin: int) -> tuple[str, int]:
    """H2's lane for ``rows`` value rows over S groups, and the rows a launch
    takes. Up to H2_WARP_MAX_S groups, H2_WARP_ROWS rows a launch, no f64
    atomics, the last CTA writing the output: ("private", k) while k rows
    times S's bucket is at most H2_PRIVATE_CELLS cells (each thread's cells
    in shared memory), else ("warps", k) (equal gids of a warp added by
    shuffles); above, ("shared", k) while k rows' [k, S] f64 partial fits a
    CTA's ``optin`` bytes of shared memory; else ("global", H2_MAX_ROWS)."""
    if S <= 0 or rows <= 0:
        raise ValueError(f"H2 needs rows and groups, got {rows} rows, S={S}")
    if S <= H2_WARP_MAX_S:
        per = min(rows, H2_WARP_ROWS)
        return ("private" if per * h2_bucket(S) <= H2_PRIVATE_CELLS else "warps"), per
    fit = optin // (8 * S)
    if fit >= 1:
        return "shared", min(rows, fit, H2_MAX_ROWS)
    return "global", min(rows, H2_MAX_ROWS)


def h2_grid(n: int, sms: int, lane: str, rows: int, S: int) -> int:
    """CTAs of H2's private or warp lane over n rows, 8 rows a thread: the
    private lane two CTAs an SM up to 48 cells a thread (two CTAs' cells
    fit an SM's shared memory), one above; the warp lane one (its
    registers)."""
    chunks = -(-n // 8)
    if lane == "private":
        ctas = 2 if rows * h2_bucket(S) <= 48 else 1
        return max(1, min(-(-chunks // H2_PRIVATE_THREADS), sms * ctas))
    return max(1, min(-(-chunks // H2_THREADS), sms))


def h2_parts(R: int, S: int, n: int, sms: int, optin: int) -> list:
    """H2's launches for R rows over S groups and n rows: (first row, rows,
    lane, CTAs) each, ``h2_lane``'s rows a launch; a last part of fewer
    rows takes its own lane (one row over at most 64 groups always the
    private one). CTAs are 0 for the atomic lanes."""
    lane, per = h2_lane(R, S, optin)
    parts = []
    for lo in range(0, R, per):
        r = min(per, R - lo)
        if lane in ("private", "warps"):
            part_lane = h2_lane(r, S, optin)[0]
            parts.append((lo, r, part_lane, h2_grid(n, sms, part_lane, r, S)))
        else:
            parts.append((lo, r, lane, 0))
    return parts


# H2's warp-lane tickets, by (device index, stream): one int32 the last CTA
# sets back to 0, so launches in one stream share it in turn.
_h2_tickets: dict[tuple, torch.Tensor] = {}


def _h2_ticket(device: torch.device) -> torch.Tensor:
    index = device.index if device.index is not None else torch.cuda.current_device()
    key = (index, torch.cuda.current_stream(device).cuda_stream)
    ticket = _h2_tickets.get(key)
    if ticket is None:
        with _lock:
            ticket = _h2_tickets.setdefault(key, torch.zeros(1, dtype=torch.int32, device=device))
    return ticket


def segment_rows_sum_f64(rows, gids: torch.Tensor, mask: Optional[torch.Tensor],
                         num_segments: int) -> torch.Tensor:
    """H2: f64 [R, S] — row r's per-segment sums of the valid rows (mask set
    or none, 0 <= gid < S). ``rows``: R triples (tensor, offset, square),
    each tensor [n] of f64 or of an integer kind H1 reads (bool, uint8,
    uint16, int32, int64) read as it lies, an integer value plus ``offset``
    rounded to f64; ``square`` sums each value's square. The lane of
    ``h2_lane``; one launch count per launch."""
    device = gids.device
    rows = list(rows)
    n = gids.shape[0]
    mask = _gids_mask(gids, mask, n, device)
    specs = []
    for i, (t, off, square) in enumerate(rows):
        if t.dtype not in H2_KINDS:
            raise TypeError(f"rows[{i}] has dtype {t.dtype}, expected one of {list(H2_KINDS)}")
        _require(t, f"rows[{i}]", t.dtype, device, 1)
        if t.shape[0] != n:
            raise ValueError(f"rows[{i}] has {t.shape[0]} rows, expected {n}")
        specs.append((t.data_ptr(), H2_KINDS[t.dtype], _i64(off), bool(square)))
    R, S = len(specs), num_segments
    if n == 0 or S == 0 or R == 0:
        return torch.zeros((R, S), dtype=torch.float64, device=device)
    if n >= 1 << 31:
        raise ValueError(f"H2 takes fewer than 2^31 rows, got {n}")
    parts = h2_parts(R, S, n, sm_count(device), smem_optin_bytes(device))
    whole = parts[0][2] in ("private", "warps")  # the kernel writes the output whole
    if whole:  # the output, then the largest part's partials, in one buffer
        scratch = max(grid * r for _, r, _, grid in parts) * S
        buf = torch.empty(R * S + scratch, dtype=torch.float64, device=device)
        out, ticket = buf[:R * S].view(R, S), _h2_ticket(device)
    else:
        out, ticket = torch.zeros((R, S), dtype=torch.float64, device=device), None
    base = out.data_ptr()
    for lo, r, part_lane, grid in parts:
        part = specs[lo:lo + r]
        _launch(
            "segment_rows_sum_f64", device,
            ctypes.cast((ctypes.c_void_p * r)(*[p for p, _, _, _ in part]), ctypes.c_void_p),
            ctypes.cast((ctypes.c_int * r)(*[k for _, k, _, _ in part]), ctypes.c_void_p),
            ctypes.cast((ctypes.c_longlong * r)(*[o for _, _, o, _ in part]), ctypes.c_void_p),
            sum(1 << j for j, (_, _, _, sq) in enumerate(part) if sq),
            r, n, gids.data_ptr(), mask.data_ptr() if mask is not None else None, S,
            base + lo * S * 8, ("private", "warps", "shared", "global").index(part_lane), grid,
            base + R * S * 8 if whole else None,
            ticket.data_ptr() if ticket is not None else None,
        )
    return out


H3_CLUSTER = 8  # CTAs of a cluster of H3's cluster lane (kCluster of hopper_kernels.cu)
H3_PROBE = 6  # probe words: [0] global atomics, [2..5] CTA 0's clocks (start, zeroed, rows, flushed)
_H3_LANES = ("cluster", "global")


def h3_lane(S: int, nbins: int, optin: int) -> tuple[str, int]:
    """H3's lane over S groups of ``nbins`` bins with ``optin`` bytes of
    shared memory a block: ("cluster", 8) while the whole [S, nbins]
    partial of u16 counts (two a word, rounded up to 16 bytes) fits a CTA
    (each CTA of a cluster of 8 counts into its own); else ("global", 0)."""
    if S <= 0 or nbins <= 0:
        raise ValueError(f"H3 needs groups and bins, got S={S}, nbins={nbins}")
    if -(-(S * nbins) // 8) * 16 <= optin:
        return "cluster", H3_CLUSTER
    return "global", 0


def h3_geometry(device: torch.device, n: int, S: int, nbins: int) -> tuple[int, int, int]:
    """(CTAs, threads a CTA, dynamic shared bytes a CTA) of H3's launch over
    ``n`` rows of S groups of ``nbins`` bins on ``device``, as its launcher
    computes them."""
    lane, _ = h3_lane(S, nbins, smem_optin_bytes(device))
    out = (ctypes.c_int * 3)()
    with torch.cuda.device(device):
        status = library().px_log_histogram_geometry(n, S, nbins, _H3_LANES.index(lane), out)
    _check(status, "log_histogram_update geometry")
    return tuple(out)


def log_histogram_update(
    values: torch.Tensor, gids: torch.Tensor, mask: Optional[torch.Tensor],
    state: torch.Tensor, min_value: float, log_gamma: float,
    probe: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """H3: adds each valid row's (group, log bin) count into ``state``
    (int64 [S, nbins]) IN PLACE and returns it. ``values``: f32, or f64
    (rounded to f32 in registers, as ``.to(torch.float32)``), read as
    staged; the lane by ``h3_lane``. ``probe``: None, or int64 [H3_PROBE]
    on the device: [0] gains the launch's global atomics, [2..5] take CTA
    0's SM clock at the start and after the zeroing, the rows and the
    flush."""
    device = gids.device
    if values.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"values has dtype {values.dtype}, expected float32 or float64")
    _require(values, "values", values.dtype, device, 1)
    _require(state, "state", torch.int64, device, 2)
    _probe_arg(probe, H3_PROBE, device)
    n = values.shape[0]
    mask = _gids_mask(gids, mask, n, device)
    S, nbins = state.shape
    if n == 0 or S == 0:
        return state
    lane, _ = h3_lane(S, nbins, smem_optin_bytes(device))
    _launch(
        "log_histogram_update", device,
        values.data_ptr(), int(values.dtype == torch.float64), n, gids.data_ptr(),
        mask.data_ptr() if mask is not None else None,
        S, nbins, min_value, log_gamma, state.data_ptr(), _H3_LANES.index(lane),
        probe.data_ptr() if probe is not None else None,
    )
    return state


HQ_PROBE = 4  # H4's probe: CTA 0's clock64 at the start, the total, the searches, the stores


def hist_quantiles(
    state: torch.Tensor, qs: torch.Tensor, mid: torch.Tensor,
    probe: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """H4: f64 [S, Q] quantile estimates of each group's log histogram: per
    q the first bin whose cumulative count reaches max(q * total, 1e-9)
    (bin 0 when none does), its value ``mid[bin]`` (f64 [nbins],
    ``histogram.midpoint_table``), 0 for an empty group. A warp a group.
    ``probe``: None, or int64 [HQ_PROBE] on the device for CTA 0's clock64
    phases."""
    device = state.device
    _require(state, "state", torch.int64, device, 2)
    _require(qs, "qs", torch.float64, device, 1)
    S, nbins = state.shape
    _require(mid, "mid", torch.float64, device, 1)
    if mid.shape[0] != nbins:
        raise ValueError(f"hist_quantiles: mid has {mid.shape[0]} bins, the state {nbins}")
    Q = qs.shape[0]
    out = torch.empty((S, Q), dtype=torch.float64, device=device)
    if S == 0 or Q == 0:
        return out
    if S >= 2**31 or nbins >= 2**31 or S * Q >= 2**31:
        raise ValueError(f"hist_quantiles: S, nbins and S * Q must fit int32, got {S}, {nbins}, {Q}")
    _probe_arg(probe, HQ_PROBE, device)
    _launch(
        "hist_quantiles", device,
        state.data_ptr(), S, nbins, qs.data_ptr(), Q, mid.data_ptr(), out.data_ptr(),
        probe.data_ptr() if probe is not None else None,
    )
    return out


def hist_quantiles_geometry(S: int) -> tuple[int, int, int]:
    """(CTAs, threads a CTA, dynamic shared bytes) of H4's launch over S
    groups, as its launcher computes them."""
    out = (ctypes.c_int * 3)()
    _check(library().px_hist_quantiles_geometry(S, out), "hist_quantiles geometry")
    return tuple(out)


# ---------------------------------------------------------------- sketches
def hash32(words: torch.Tensor, seed: int, pair: bool) -> torch.Tensor:
    """The hash kernel: u32 hashes of 64-bit words (int64 [n]) as their bit
    patterns in int32, [1, n] (hash32) or [2, n] (hash32_pair)."""
    device = words.device
    _require(words, "words", torch.int64, device, 1)
    n = words.shape[0]
    out = torch.empty((2 if pair else 1, n), dtype=torch.int32, device=device)
    if n == 0:
        return out
    _launch("hash32", device, words.data_ptr(), n, seed & 0xFFFFFFFF, int(pair),
            out.data_ptr())
    return out


def hll_lane(G: int, precision: int, optin: int) -> str:
    """H5's lane: "shared" while [G, 2^p] int32 registers fit a block's
    opt-in shared memory, else "onepass"."""
    return "shared" if G * (1 << precision) * 4 <= optin else "onepass"


_HLL_LANES = ("shared", "onepass")


def word_kind(dtype: torch.dtype, offset: Optional[int]) -> int:
    """The row kind H5 and H6 read a ``dtype`` column as: with an offset (a
    narrowed int64 column) the int64 value plus it, so an int32 sign-
    extends; without, ``hashing.words64``'s word, so an int32 zero-extends
    as u32 and an f64 is its bits."""
    if dtype == torch.float64:
        if offset is not None:
            raise ValueError("a float column has no offset")
        return ROW_F64
    if dtype == torch.int32 and offset is None:
        return ROW_U32
    if dtype in SUM_ROW_KINDS:
        return SUM_ROW_KINDS[dtype]
    raise TypeError(f"H5 and H6 take no {dtype} column")


def _word_column(values: torch.Tensor, offset: Optional[int]) -> torch.Tensor:
    """A column H5 and H6 read as it lies: f32, int8 and int16 (no staged
    kind) first take ``hashing.words64``'s f64 and u32 words."""
    if values.dtype in (torch.float32, torch.int8, torch.int16) and offset is None:
        return values.to(torch.float64 if values.is_floating_point() else torch.int32)
    return values


def hll_update(
    values: torch.Tensor, gids: torch.Tensor, mask: Optional[torch.Tensor],
    state: torch.Tensor, offset: Optional[int] = None,
) -> torch.Tensor:
    """H5: folds each valid row's (register, rho) into ``state`` (int32
    [S, 2^p]) IN PLACE by atomic max, and returns it. ``values`` [n] is read
    as it lies. With ``offset`` (a narrowed int64 column: bool, uint8,
    uint16, int32 or int64) a row hashes as its int64 value plus the
    offset; without, as ``hashing.words64`` gives its word (int64 as is,
    a narrower int zero-extended as u32, a float's f64 bits)."""
    device = gids.device
    _require(state, "state", torch.int32, device, 2)
    values = _word_column(values, offset)
    kind = word_kind(values.dtype, offset)
    _require(values, "values", values.dtype, device, 1)
    n = values.shape[0]
    mask = _gids_mask(gids, mask, n, device)
    S, m = state.shape
    precision = m.bit_length() - 1
    if m != 1 << precision or precision < 4:
        raise ValueError(f"HLL state width {m} is not a power of two >= 16")
    if n == 0 or S == 0:
        return state
    lane = hll_lane(S, precision, smem_optin_bytes(device))
    _launch(
        "hll_update", device,
        values.data_ptr(), kind, _i64(offset or 0), n, gids.data_ptr(),
        mask.data_ptr() if mask is not None else None,
        S, precision, state.data_ptr(), _HLL_LANES.index(lane),
    )
    return state


# H6 counts (group, bucket pair) keys in a table of 2^H6_TABLE_BITS slots a
# CTA before it adds them to the cells; a sketch wider than
# 2^H6_MAX_TABLE_WBITS (where a key no longer fits 64 bits) takes no table.
H6_TABLE_BITS = 13  # 8192 slots: 96 KB a CTA
H6_MAX_TABLE_WBITS = 16


def h6_table_bits(width: int) -> int:
    """log2 of H6's table slots a CTA for a sketch of ``width`` buckets (a
    power of two): H6_TABLE_BITS, or 0 (no table: every row adds to its
    cells) past 2^H6_MAX_TABLE_WBITS buckets."""
    return H6_TABLE_BITS if width.bit_length() - 1 <= H6_MAX_TABLE_WBITS else 0


def countmin_update(
    values: torch.Tensor, gids: torch.Tensor, mask: Optional[torch.Tensor],
    cm: torch.Tensor, total: torch.Tensor, offset: Optional[int] = None,
) -> None:
    """H6: adds one to each valid row's ``depth`` buckets of ``cm`` (int64
    [S, depth, width]) and to its group's ``total`` (int64 [S]), IN PLACE.
    ``values`` [n] is read as it lies and hashed in the kernel
    (``hash32_pair`` of the word, seed 1): with ``offset`` (a narrowed int64
    column) a row's word is its int64 value plus the offset; without,
    ``hashing.words64``'s word, as H5's."""
    device = gids.device
    _require(cm, "cm", torch.int64, device, 3)
    _require(total, "total", torch.int64, device, 1)
    values = _word_column(values, offset)
    kind = word_kind(values.dtype, offset)
    _require(values, "values", values.dtype, device, 1)
    n = values.shape[0]
    mask = _gids_mask(gids, mask, n, device)
    S, depth, width = cm.shape
    if total.shape[0] != S or width < 1 or width & (width - 1):
        raise ValueError("countmin_update: total must be [S], width a power of two")
    if n == 0 or S == 0:
        return
    _launch(
        "countmin_update", device,
        values.data_ptr(), kind, _i64(offset or 0), n, gids.data_ptr(),
        mask.data_ptr() if mask is not None else None,
        S, depth, width.bit_length() - 1, cm.data_ptr(), total.data_ptr(),
        h6_table_bits(width),
    )


def countmin_query(state: torch.Tensor, gids: torch.Tensor, words: torch.Tensor) -> torch.Tensor:
    """H30: int64 [n], each (gid, word)'s count-min estimate: the min over
    the depth rows of ``state[gid, d, (h1 + d * h2) & (width - 1)]`` with
    (h1, h2) the hash kernel's seed-1 pair of the word. ``state`` int64
    [G, depth, width], width a power of two; gids int32 [n] in [0, G) (the
    kernel clamps any other into the state); words int64 [n]."""
    device = state.device
    _require(state, "state", torch.int64, device, 3)
    _require(gids, "gids", torch.int32, device, 1)
    _require(words, "words", torch.int64, device, 1)
    G, depth, width = state.shape
    n = words.shape[0]
    if gids.shape[0] != n or width & (width - 1) or depth < 1:
        raise ValueError("countmin_query: gids and words of one length, width a power of two")
    out = torch.empty(n, dtype=torch.int64, device=device)
    if n == 0:
        return out
    if G == 0:
        raise ValueError("countmin_query: a query of an empty state")
    _launch("countmin_query", device, state.data_ptr(), G, depth, width, gids.data_ptr(),
            words.data_ptr(), n, out.data_ptr())
    return out


PACK_MAX_GROUP_BITS = 8
TD_UPDATE_MAX_G = 254  # the packed lane: G + 1 fits PACK_MAX_GROUP_BITS key bits
TD_L1_MAX_CELLS = 40960  # level-1 counts a CTA's shared memory holds (160 KB)
TD_BITMAP_WORDS = 8192  # shared words for the level-2 bitmap: 1024 slots of 2^8 bins
TD_SHARED_BYTES = 64 * 1024  # the final pass's value sums in shared memory, at most


def td_levels(num_groups: int) -> tuple[int, int, int]:
    """(b1, b2, b3): the bits of a packed key (32 - bits_g of them) that each
    level of H7's select resolves: level 1 as many as leave 16 while G << b1
    counts fit TD_L1_MAX_CELLS, level 2 eight, level 3 the rest."""
    bits_g = max((num_groups + 1).bit_length(), 1)
    W = 32 - bits_g
    b1 = W - 16
    while (num_groups << b1) > TD_L1_MAX_CELLS:
        b1 -= 1
    return b1, 8, W - b1 - 8


def tdigest_update_scratch_words(n: int, G: int, C: int, levels: tuple, grid: int,
                                 shared_sums: bool) -> int:
    """The u32 words of H7's scratch (tdigest_kernels.cu scratch_words:
    each array on a 16-byte boundary; level 2's slots min(2^b1, C) a group,
    level 3's C)."""
    b1, b2, b3 = levels
    up4 = lambda w: -(-w // 4) * 4  # noqa: E731
    L1, R, S1 = G << b1, up4(G * C), G * min(1 << b1, C)
    w = up4(2 * grid * G * C if shared_sums else 0) + up4(n) + 2 * L1 + up4(G) + 4
    w += 3 * 32 * G + 9 * R
    return w + 2 * (S1 << b2) + up4((S1 << b2) // 32) + (R << b3)


# H7's grid barriers, by (device index, stream): two u32 (arrivals,
# generation), zero before the first launch, left with no arrivals.
_td_bars: dict[tuple, torch.Tensor] = {}


def _td_bar(device: torch.device) -> torch.Tensor:
    index = device.index if device.index is not None else torch.cuda.current_device()
    key = (index, torch.cuda.current_stream(device).cuda_stream)
    bar = _td_bars.get(key)
    if bar is None:
        with _lock:
            bar = _td_bars.setdefault(key, torch.zeros(2, dtype=torch.int32, device=device))
    return bar


TD_STAMPS = 16  # the stamps px_tdigest_update writes


def tdigest_update_sums(
    values: torch.Tensor, gids: torch.Tensor, mask: Optional[torch.Tensor],
    num_groups: int, capacity: int, stamps: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """H7: f64 [2, G, C] per-(group, cluster) row counts and value sums of a
    block, the rows in their (group, value) order without a sort: the
    values (f32, or f64 rounded to f32) packed with their groups as H7a
    packs them (masked rows and gids outside [0, G) left out), each group's
    keys selected at the ranks where the cluster changes (``td_levels``),
    and the sums added up from those keys. One cooperative launch for up to
    TD_UPDATE_MAX_G groups; a cluster that comes back traps. ``stamps``:
    None, or int64 [TD_STAMPS] on the device for the device clock (ns) at
    the end of each phase (0: the start, 11: the end; entries 14 and 15 the
    level-2 and level-3 bins that held a run start)."""
    device = gids.device
    if values.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"values has dtype {values.dtype}, expected float32 or float64")
    _require(values, "values", values.dtype, device, 1)
    n = values.shape[0]
    mask = _gids_mask(gids, mask, n, device)
    G, C = num_groups, capacity
    if not 1 <= G <= TD_UPDATE_MAX_G or C < 1:
        raise ValueError(f"H7 takes 1 to {TD_UPDATE_MAX_G} groups, got G={G}, C={C}")
    if n >= 1 << 31:
        raise ValueError(f"H7 takes fewer than 2^31 rows, got {n}")
    if stamps is not None:
        _require(stamps, "stamps", torch.int64, device, 1)
        if stamps.shape[0] < TD_STAMPS:
            raise ValueError(f"stamps has {stamps.shape[0]} entries, expected {TD_STAMPS}")
    if n == 0:
        return torch.zeros((2, G, C), dtype=torch.float64, device=device)
    bits_g = max((G + 1).bit_length(), 1)
    levels = td_levels(G)
    R, L1 = G * C, G << levels[0]
    shared_sums = R * 8 <= TD_SHARED_BYTES
    # Level 1's counts, later its slots and the bitmap of level 2's bins
    # (TD_BITMAP_WORDS, while it fits); a group's runs; the final pass's sums.
    region = max(L1 + TD_BITMAP_WORDS, 10 * C, 2 * R if shared_sums else 0)
    smem = 4 * (region + 3 * G + 67)  # then the starts, the counts, the scans
    if smem > smem_optin_bytes(device):
        raise ValueError(f"H7 needs {smem} B of shared memory at G={G}, C={C}")
    grid = sm_count(device)
    words = tdigest_update_scratch_words(n, G, C, levels, grid, shared_sums)
    scratch = torch.empty(words, dtype=torch.int32, device=device)
    sums = torch.empty((2, G, C), dtype=torch.float64, device=device)
    _launch(
        "tdigest_update", device,
        values.data_ptr(), int(values.dtype == torch.float64), n, gids.data_ptr(),
        mask.data_ptr() if mask is not None else None, G, C, bits_g, *levels,
        int(shared_sums), region, smem, grid, sums.data_ptr(),
        scratch.data_ptr(), words, _td_bar(device).data_ptr(),
        stamps.data_ptr() if stamps is not None else None,
    )
    return sums


def tdigest_pack(
    values: torch.Tensor, gids: torch.Tensor, mask: Optional[torch.Tensor],
    num_groups: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """H7a: (keys, counts) — each row's sort key (int32 packed keys with the
    sign bit flipped up to 254 groups, else int64 (group << 32 | value
    order key)) and int32 [G + 1] rows per group, the last the masked rows."""
    device = gids.device
    _require(values, "values", torch.float32, device, 1)
    n = values.shape[0]
    mask = _gids_mask(gids, mask, n, device)
    bits_g = max((num_groups + 1).bit_length(), 1)
    wide = bits_g > PACK_MAX_GROUP_BITS
    keys = torch.empty(n, dtype=torch.int64 if wide else torch.int32, device=device)
    counts = torch.zeros(num_groups + 1, dtype=torch.int32, device=device)
    if n == 0:
        return keys, counts
    _launch(
        "tdigest_pack", device,
        values.data_ptr(), n, gids.data_ptr(),
        mask.data_ptr() if mask is not None else None,
        num_groups, bits_g, int(wide), keys.data_ptr(), counts.data_ptr(),
        int((num_groups + 1) * 4 <= 48 * 1024),
    )
    return keys, counts


TD_SHARED_STARTS = 16384  # kTdSharedStarts of sketch_kernels.cu


def tdigest_cluster(
    keys: torch.Tensor, counts: torch.Tensor, num_groups: int, capacity: int
) -> torch.Tensor:
    """H7b: f64 [2, G, C] per-(group, cluster) row counts and value sums
    over H7a's keys, sorted, and its counts (the groups' starts are their
    scan). Above TD_SHARED_STARTS - 2 groups a first grid of the same
    launch scans the starts into scratch."""
    device = keys.device
    bits_g = max((num_groups + 1).bit_length(), 1)
    wide = bits_g > PACK_MAX_GROUP_BITS
    _require(keys, "keys", torch.int64 if wide else torch.int32, device, 1)
    _require(counts, "counts", torch.int32, device, 1)
    if counts.shape[0] != num_groups + 1:
        raise ValueError(f"counts has {counts.shape[0]} entries, expected {num_groups + 1}")
    n = keys.shape[0]
    sums = torch.zeros((2, num_groups, capacity), dtype=torch.float64, device=device)
    if n == 0 or num_groups == 0:
        return sums
    if n >= 1 << 31:
        raise ValueError(f"H7b takes fewer than 2^31 keys, got {n}")
    starts = (
        torch.empty(num_groups + 2, dtype=torch.int32, device=device)
        if num_groups + 2 > TD_SHARED_STARTS else None
    )
    _launch(
        "tdigest_cluster", device,
        keys.data_ptr(), n, counts.data_ptr(), num_groups, capacity, bits_g,
        int(wide), sums.data_ptr(), starts.data_ptr() if starts is not None else None,
    )
    return sums


TD_MERGE_PROBE = 8  # probe words of H8: [0], [1] its exact branches' groups, [2..7] clocks


def tdigest_merge_geometry(G: int, C: int) -> tuple[int, int, int]:
    """(CTAs, threads a CTA, dynamic shared bytes a CTA) of H8's launch over
    G groups of capacity C, as its launcher computes them."""
    out = (ctypes.c_int * 3)()
    _check(library().px_tdigest_merge_geometry(G, C, out), "tdigest_merge geometry")
    return tuple(out)


def tdigest_merge(
    a_means: torch.Tensor, a_weights: torch.Tensor, b0: torch.Tensor,
    b1: torch.Tensor, raw_b: bool = False, probe: Optional[torch.Tensor] = None,
) -> dict:
    """H8: the merged digest {"means", "weights"} (new f32 [G, C] tensors)
    of digest a and digest b (f32 means, weights) or, with ``raw_b``, of a
    and H7's or H7b's f64 (weight, value) sums. ``probe``: None, or int64
    [TD_MERGE_PROBE] on the device: [0] gains the groups ranked by all
    pairs (a half whose finite means were not in order), [1] the groups
    summed by the per-cluster walk (clusters not nondecreasing), [2..7]
    take CTA 0's SM clock at the start and after each of the five steps
    (sketch_kernels.cu)."""
    device = a_means.device
    G, C = a_means.shape
    b_dtype = torch.float64 if raw_b else torch.float32
    for t, name, dtype in ((a_means, "a_means", torch.float32),
                           (a_weights, "a_weights", torch.float32),
                           (b0, "b0", b_dtype), (b1, "b1", b_dtype)):
        _require(t, name, dtype, device, 2)
        if tuple(t.shape) != (G, C):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {(G, C)}")
    if 2 * C > 1024:
        raise ValueError(f"t-digest capacity {C} above 512 is not supported")
    _probe_arg(probe, TD_MERGE_PROBE, device)
    out = {
        "means": torch.empty((G, C), dtype=torch.float32, device=device),
        "weights": torch.empty((G, C), dtype=torch.float32, device=device),
    }
    if G == 0:
        return out
    _launch(
        "tdigest_merge", device,
        a_means.data_ptr(), a_weights.data_ptr(), b0.data_ptr(), b1.data_ptr(),
        int(raw_b), G, C, out["means"].data_ptr(), out["weights"].data_ptr(),
        probe.data_ptr() if probe is not None else None,
    )
    return out


TQ_PROBE = 5  # H9's probe: CTA 0's clock64 at the start, the checks, the midpoints, the
# searches, the stores


def tdigest_quantiles(
    means: torch.Tensor, weights: torch.Tensor, qs: torch.Tensor,
    probe: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """H9: f64 [G, Q] quantiles of each group's digest, a warp a group. A
    group whose weights are whole numbers in [0, 2^24] summing to at most
    2^24 (``tdigest.quantile_exact_groups``) gets the plain version's bits;
    another sums its weights in centroid order. ``probe``: None, or int64
    [TQ_PROBE] on the device for CTA 0's clock64 phases."""
    device = means.device
    _require(means, "means", torch.float32, device, 2)
    _require(weights, "weights", torch.float32, device, 2)
    _require(qs, "qs", torch.float32, device, 1)
    G, C = means.shape
    if weights.shape != means.shape:
        raise ValueError(f"tdigest_quantiles: weights {tuple(weights.shape)}, means {(G, C)}")
    Q = qs.shape[0]
    out = torch.empty((G, Q), dtype=torch.float64, device=device)
    if G == 0 or Q == 0:
        return out
    if G >= 2**31 or C >= 2**31 or G * Q >= 2**31:
        raise ValueError(f"tdigest_quantiles: G, C and G * Q must fit int32, got {G}, {C}, {Q}")
    _probe_arg(probe, TQ_PROBE, device)
    _launch(
        "tdigest_quantiles", device,
        means.data_ptr(), weights.data_ptr(), G, C, qs.data_ptr(), Q, out.data_ptr(),
        probe.data_ptr() if probe is not None else None,
    )
    return out


def tdigest_quantiles_geometry(G: int) -> tuple[int, int, int]:
    """(CTAs, threads a CTA, dynamic shared bytes) of H9's launch over G
    groups, as its launcher computes them."""
    out = (ctypes.c_int * 3)()
    _check(library().px_tdigest_quantiles_geometry(G, out), "tdigest_quantiles geometry")
    return tuple(out)


def hll_estimate(state: torch.Tensor, alpha: float) -> tuple[torch.Tensor, torch.Tensor]:
    """H10: (f64 [S] estimates, int64 [S] estimates rounded half to even).
    A warp a group sums 2^(33 - p - r) in integers (p = floor(log2 m)),
    exact for registers in [0, 33 - p], which is every register an update
    keeps; a group with another register sums 2^-r in f64."""
    device = state.device
    _require(state, "state", torch.int32, device, 2)
    S, m = state.shape
    est = torch.empty(S, dtype=torch.float64, device=device)
    rounded = torch.empty(S, dtype=torch.int64, device=device)
    if S == 0:
        return est, rounded
    if S >= 2**31 or m >= 2**31:
        raise ValueError(f"hll_estimate: S and m must fit int32, got {S} x {m}")
    _launch(
        "hll_estimate", device,
        state.data_ptr(), S, m, m.bit_length() - 1, alpha * m * m, est.data_ptr(),
        rounded.data_ptr(),
    )
    return est, rounded


def hll_estimate_geometry(S: int) -> tuple[int, int, int]:
    """(CTAs, threads a CTA, dynamic shared bytes) of H10's launch over S
    groups, as its launcher computes them."""
    out = (ctypes.c_int * 3)()
    _check(library().px_hll_estimate_geometry(S, out), "hll_estimate geometry")
    return tuple(out)


# ---------------------------------------------------------------- min/max
MINMAX_KINDS = {**SUM_ROW_KINDS, torch.float64: ROW_F64}
H11_REGS_BUCKETS = (1, 8)  # the register lane's group buckets
H11_CLUSTER = 8  # CTAs of the cluster lane (kCluster of minmax_kernels.cu)
_H11_LANES = ("regs", "cluster", "global")


def h11_lane(S: int, optin: int) -> tuple[str, int]:
    """H11's lane over S groups with ``optin`` bytes of shared memory a
    block: ("regs", bucket) for S <= 8, the bucket 1 (a register a thread)
    or 8 groups (a private shared cell a group and thread); ("cluster",
    CTAs) while S 8-byte keys fit a CTA, the cluster picking over its CTAs'
    keys before the flush; else ("global", 0). The cluster lane beats
    private cells from about 8 groups on (PERF.md §6)."""
    if S <= 0:
        raise ValueError(f"H11 needs groups, got S={S}")
    if S <= H11_REGS_BUCKETS[-1]:
        return "regs", next(b for b in H11_REGS_BUCKETS if S <= b)
    if S * 8 <= optin:
        return "cluster", H11_CLUSTER
    return "global", 0


def segment_minmax(
    values: torch.Tensor, gids: torch.Tensor, mask: Optional[torch.Tensor],
    state: torch.Tensor, is_min: bool, offset: int = 0,
) -> torch.Tensor:
    """H11: ``state[g] = min/max(state[g], v)`` over each valid row's value,
    IN PLACE on ``state``, and returns it. ``values`` [n] is read as it
    lies: f64 (``state`` f64), or bool, uint8, uint16, int32 or int64 whose
    row value is its int64 value plus ``offset`` (a narrowed column with its
    frame-of-reference offset; ``state`` int64). f64 orders -0.0 below
    +0.0; a NaN wins and is written as the canonical quiet NaN; a NaN
    already in the state stays."""
    device = gids.device
    if values.dtype not in MINMAX_KINDS:
        raise TypeError(f"values has dtype {values.dtype}, expected one of {list(MINMAX_KINDS)}")
    f64 = values.dtype == torch.float64
    if f64 and offset:
        raise ValueError("H11: an f64 column has no offset")
    _require(values, "values", values.dtype, device, 1)
    _require(state, "state", torch.float64 if f64 else torch.int64, device, 1)
    n = values.shape[0]
    mask = _gids_mask(gids, mask, n, device)
    S = state.shape[0]
    if n == 0 or S == 0:
        return state
    lane, arg = h11_lane(S, smem_optin_bytes(device))
    _launch(
        "segment_minmax", device,
        values.data_ptr(), MINMAX_KINDS[values.dtype], _i64(offset), n, gids.data_ptr(),
        mask.data_ptr() if mask is not None else None, S, state.data_ptr(), int(is_min),
        _H11_LANES.index(lane), arg,
    )
    return state


# ---------------------------------------------------------------- scan
SCAN_MAX_COLS = 64  # kMaxScanCols of scan_kernels.cu
SCAN_GROUP_ROWS = 16  # kGroup: rows of one 16-byte mask load; a share is a multiple
SCAN_CHUNK_ROWS = 8192  # kChunk: rows a copy round stages, and a share's least size
SCAN_THREADS = 256  # kScanThreads
SCAN_CTAS_PER_SM = 2
SCAN_PROBE = 5  # CTA 0's clock64 at the start and after the count, wait, copy, padding
_SCAN_WIDE = {torch.int64: 1, torch.float64: 1, torch.int32: 0}


def h12_shares(n: int, sms: int) -> tuple[int, int]:
    """(CTAs, rows a CTA) of H12's launch over ``n`` rows on a card of
    ``sms`` SMs: at most SCAN_CTAS_PER_SM CTAs an SM and no more CTAs than
    the rows' SCAN_CHUNK_ROWS-row chunks, each share a multiple of
    SCAN_GROUP_ROWS rows and none of them empty."""
    if n < 1 or sms < 1:
        raise ValueError(f"h12_shares: n {n} and sms {sms} must be positive")
    grid = max(1, min(sms * SCAN_CTAS_PER_SM, -(-n // SCAN_CHUNK_ROWS)))
    share = -(-(-(-n // grid)) // SCAN_GROUP_ROWS) * SCAN_GROUP_ROWS
    return -(-n // share), share


class ScanEpochs:
    """H12's status words, one buffer of int64 words for each (device,
    stream) it launches on: zeroed once when made, then never, and the
    epoch of each launch on it (1, 2, ...). A launch publishes its shares'
    counts tagged with its epoch and waits only for words of that epoch, so
    an earlier launch's words are never taken for its own. Launches on one
    stream run in turn, so a buffer is never shared by two at once; the
    epoch wraps after MAX_EPOCH launches, and the buffer is zeroed again
    (on the same stream, before the next launch)."""

    MAX_EPOCH = 2**32 - 1

    def __init__(self) -> None:
        self._bufs: dict = {}
        self._lock = threading.Lock()

    def take(self, device: torch.device, key, words: int) -> tuple[torch.Tensor, int]:
        """(the buffer of ``key``, of at least ``words`` words, and the next
        launch's epoch)."""
        with self._lock:
            entry = self._bufs.get(key)
            if entry is None or entry[0].shape[0] < words:
                entry = self._bufs[key] = [torch.zeros(words, dtype=torch.int64, device=device), 0]
            if entry[1] >= self.MAX_EPOCH:
                entry[0].zero_()
                entry[1] = 0
            entry[1] += 1
            return entry[0], entry[1]


_scan_epochs = ScanEpochs()


def scan_compact_geometry(device: torch.device, n: int) -> tuple[int, int, int]:
    """(CTAs, threads a CTA, dynamic shared bytes a CTA) of H12's launch over
    ``n`` rows on ``device``."""
    return h12_shares(n, sm_count(device))[0], SCAN_THREADS, 0


def _scan_launch(mask: torch.Tensor, cols: list, bufs: list, written, limit: int, index_out,
                 pad: int, probe: Optional[torch.Tensor]) -> None:
    device = mask.device
    _probe_arg(probe, SCAN_PROBE, device)
    n, k = mask.shape[0], len(cols)
    sms = sm_count(device)
    grid, share = h12_shares(n, sms)
    index = device.index if device.index is not None else torch.cuda.current_device()
    words, epoch = _scan_epochs.take(
        device, (index, torch.cuda.current_stream(device).cuda_stream), sms * SCAN_CTAS_PER_SM)
    _launch(
        "scan_compact", device,
        mask.data_ptr(), n,
        (ctypes.c_void_p * max(k, 1))(*[c.data_ptr() for c in cols]),
        (ctypes.c_void_p * max(k, 1))(*[b.data_ptr() for b in bufs]),
        (ctypes.c_int * max(k, 1))(*[_SCAN_WIDE[c.dtype] for c in cols]),
        k, written.data_ptr() if written is not None else None, limit,
        index_out.data_ptr() if index_out is not None else None, pad, grid, share,
        words.data_ptr(), epoch, probe.data_ptr() if probe is not None else None,
    )


def scan_compact(
    mask: torch.Tensor, cols: list, written: torch.Tensor, bufs: list, limit: int,
    probe: Optional[torch.Tensor] = None,
) -> None:
    """H12: writes the rows of one block whose ``mask`` is true, in row
    order, to ``bufs[c][written + rank]`` while that is below ``limit``, and
    sets ``written`` (int32 [1], on the device) to min(written + count,
    limit), all on the device; a launch that finds written >= limit returns
    at once. ``cols[c]`` ([n]) and ``bufs[c]`` share an int64, f64 or int32
    dtype. ``probe``: None, or int64 [SCAN_PROBE] on the device for CTA 0's
    clock64 at the start and after the count, the wait for the shares'
    counts, the copy and the padding (none here)."""
    device = mask.device
    _require(mask, "mask", torch.bool, device, 1)
    _require(written, "written", torch.int32, device, 1)
    n = mask.shape[0]
    if len(cols) != len(bufs) or len(cols) > SCAN_MAX_COLS:
        raise ValueError(f"scan_compact takes up to {SCAN_MAX_COLS} columns and one buffer each")
    if not 0 <= limit < 2**31 or n >= 2**31 or written.shape[0] != 1:
        raise ValueError("scan_compact: limit and rows must fit int32, written must be [1]")
    for i, (c, b) in enumerate(zip(cols, bufs)):
        if c.dtype not in _SCAN_WIDE:
            raise TypeError(f"column {i} has dtype {c.dtype}, expected int64, f64 or int32")
        _require(c, f"column {i}", c.dtype, device, 1)
        _require(b, f"buffer {i}", c.dtype, device, 1)
        if c.shape[0] != n or b.shape[0] < limit:
            raise ValueError(f"column {i} must have {n} rows and its buffer {limit} or more")
    if n == 0:
        return
    _scan_launch(mask, cols, bufs, written, limit, None, -1, probe)


def scan_compact_indices(
    mask: torch.Tensor, cap: int, probe: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """H12's index lane: the indices of the rows whose ``mask`` is true, in
    row order, int32 [cap], and ``n`` (the mask's length) in every slot past
    their count: the reference's sentinel sort (pixie_tpu/ops/segment.py
    compact_unmatched_rows), in one launch that reads no index column.
    ``probe`` as ``scan_compact``'s."""
    device = mask.device
    _require(mask, "mask", torch.bool, device, 1)
    n = mask.shape[0]
    if not 0 <= cap < 2**31 or n >= 2**31:
        raise ValueError(f"scan_compact_indices: cap {cap} and rows {n} must fit int32")
    out = torch.empty(cap, dtype=torch.int32, device=device)
    if cap == 0:
        return out
    if n == 0:
        return out.fill_(0)  # every slot is padding
    _scan_launch(mask, [], [], None, cap, out, n, probe)
    return out


# ---------------------------------------------------------------- join
def _int32_1d(t: torch.Tensor, name: str, device) -> int:
    _require(t, name, torch.int32, device, 1)
    return t.shape[0]


# H13's launcher tables a key space K (K + 1 bounds) of at most
# JOIN_TABLE_IDS ids where K + 1 <= JOIN_TABLE_ALWAYS_IDS or the probe side
# has at least JOIN_TABLE_ROWS_PER_ID rows for each bound (join_kernels.cu
# kTableIds, kTableAlwaysIds, kTableLaneRowsPerId); else it searches.
JOIN_TABLE_IDS = 8192
JOIN_TABLE_ALWAYS_IDS = 512
JOIN_TABLE_ROWS_PER_ID = 128


def join_probe_geometry(n: int, key_space: int) -> tuple[int, int, int, str]:
    """(CTAs, threads a CTA, dynamic shared bytes a CTA, lane) of H13's launch
    over ``n`` probe rows with keys of ``key_space`` ids (0: unknown), as its
    launcher computes them; the lane is "table" or "search"."""
    out = (ctypes.c_int * 4)()
    _check(library().px_join_probe_geometry(n, key_space, out), "join_probe geometry")
    return out[0], out[1], out[2], "table" if out[3] > 0 else "search"


def join_probe(
    sorted_keys: torch.Tensor, keys: torch.Tensor, present_size: int = 0, key_space: int = 0,
) -> tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """H13: (lo, fanout, present) — each probe key's lower bound in the
    ascending int32 build keys ``sorted_keys`` and its count of equal keys
    (int32 [n] each); with ``present_size`` > 0 also a bool presence array
    [present_size] whose entry k is True iff some probe key equals k (else
    None). ``key_space`` > 0 says the keys are ids of [0, key_space), which
    lets the launcher look them up in a table of every id's bounds in shared
    memory (``join_probe_geometry`` says when; a key outside the table is
    searched); the results are the same either way."""
    device = keys.device
    nb = _int32_1d(sorted_keys, "sorted_keys", device)
    n = _int32_1d(keys, "keys", device)
    if nb >= 2**31 or not 0 <= present_size < 2**31 or not 0 <= key_space < 2**31:
        raise ValueError("join_probe: build rows, presence size and key space must fit int32")
    lo = torch.empty(n, dtype=torch.int32, device=device)
    fanout = torch.empty(n, dtype=torch.int32, device=device)
    present = (
        torch.zeros(present_size, dtype=torch.bool, device=device) if present_size else None
    )
    if n == 0:
        return lo, fanout, present
    _launch(
        "join_probe", device,
        sorted_keys.data_ptr(), nb, keys.data_ptr(), n, lo.data_ptr(), fanout.data_ptr(),
        present.data_ptr() if present is not None else None, present_size, key_space,
    )
    return lo, fanout, present


# H14's launcher takes its row lane while the build side has at most this
# many rows (join_kernels.cu kRowsLaneBuild), its merge lane above.
JOIN_ROWS_LANE_BUILD = 256


def join_emit_pairs_geometry(n: int, nb: int, cap: int) -> tuple[int, int, int, str]:
    """(CTAs, threads a CTA, dynamic shared bytes a CTA, lane) of H14's launch
    over ``n`` probe rows, ``nb`` build rows and ``cap`` slots, as its
    launcher computes them; the lane is "rows" or "merge"."""
    out = (ctypes.c_int * 4)()
    _check(library().px_join_emit_pairs_geometry(n, nb, cap, out), "join_emit_pairs geometry")
    return out[0], out[1], out[2], ("rows", "merge")[out[3]]


def join_emit_pairs(
    lo: torch.Tensor, fanout: torch.Tensor, prefix: torch.Tensor, order: torch.Tensor,
    cap: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """H14: (build_rows, probe_rows), int32 [cap] — probe row p's pairs at
    slots prefix[p] - fanout[p] + j (j < fanout[p], slot < cap), build row
    ``order[lo[p] + j]`` (the position clamped into ``order``). ``prefix`` is
    the inclusive int32 prefix sum of ``fanout``. Slots at or past the match
    count are left unwritten. The launcher gives a probe row a thread while
    the build side (so every fanout) has at most ``JOIN_ROWS_LANE_BUILD``
    rows, else each CTA an equal share of rows plus slots, so no row's
    fanout sets a thread's work; the results are the same."""
    device = lo.device
    n = _int32_1d(lo, "lo", device)
    for t, name in ((fanout, "fanout"), (prefix, "prefix")):
        if _int32_1d(t, name, device) != n:
            raise ValueError(f"{name} has {t.shape[0]} rows, expected {n}")
    nb = _int32_1d(order, "order", device)
    if not 0 <= cap < 2**31:
        raise ValueError(f"join_emit_pairs: cap {cap} must fit int32")
    build_rows = torch.empty(cap, dtype=torch.int32, device=device)
    probe_rows = torch.empty(cap, dtype=torch.int32, device=device)
    if n == 0 or cap == 0 or nb == 0:
        return build_rows, probe_rows
    _launch(
        "join_emit_pairs", device,
        lo.data_ptr(), fanout.data_ptr(), prefix.data_ptr(), n, order.data_ptr(), nb, cap,
        build_rows.data_ptr(), probe_rows.data_ptr(),
    )
    return build_rows, probe_rows


# Source dtypes H15 reads as unsigned (uint8, uint16) or signed (int32,
# int64) integers when it widens a narrowed column.
_GATHER_WIDEN = {torch.uint8, torch.uint16, torch.int32, torch.int64}


def join_gather(
    col: torch.Tensor, sections: list, offset: Optional[int], null_value,
) -> torch.Tensor:
    """H15: one output column of the join, the concatenation of its
    sections. ``sections`` is three (index or None, rows) pairs, the matched
    pairs, the unmatched probe rows and the unmatched build rows (rows 0
    skips a section): a section with an int32 index reads
    ``col[clamp(index, 0, len(col) - 1)]``, one without holds
    ``null_value``. With ``offset`` (a narrowed int column) the rows are
    widened to int64 and the offset added; otherwise they keep ``col``'s
    dtype, bit for bit."""
    device = col.device
    if col.dim() != 1 or not col.is_contiguous():
        raise ValueError("join_gather: col must be 1-d and contiguous")
    if len(sections) != 3:
        raise ValueError("join_gather takes three sections")
    if offset is not None and col.dtype not in _GATHER_WIDEN:
        raise TypeError(f"join_gather: a {col.dtype} column cannot be widened")
    if col.element_size() not in (1, 2, 4, 8):
        raise TypeError(f"join_gather: {col.dtype} is not a 1, 2, 4 or 8-byte type")
    args, total = [], 0
    for i, (idx, rows) in enumerate(sections):
        if idx is not None and _int32_1d(idx, f"index {i}", device) < rows:
            raise ValueError(f"index {i} has {idx.shape[0]} rows, expected {rows} or more")
        args += [idx.data_ptr() if idx is not None and rows else None, rows]
        total += rows
    widen = offset is not None
    out_dtype = torch.int64 if widen else col.dtype
    out = torch.empty(total, dtype=out_dtype, device=device)
    if total == 0:
        return out
    null_bits = torch.tensor([null_value], dtype=out_dtype).view(
        {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}[out.element_size()]
    )
    _launch(
        "join_gather", device,
        col.data_ptr(), col.shape[0], col.element_size(), int(widen), int(offset or 0),
        *args, int(null_bits[0]), out.data_ptr(),
    )
    return out


# ---------------------------------------------------------------- join-aggregate
JOIN_AGG_MAX_ROWS = 32  # kJaMaxRows of join_agg_kernels.cu: output rows a launch
JOIN_AGG_PROBE = 4  # probe words: CTA 0's clocks at the start, after the load, fold, combine
# The staged kinds H16 reads its keys and gids in.
JOIN_AGG_KINDS = {torch.uint8: ROW_U8, torch.uint16: ROW_U16, torch.int32: ROW_I32}
_JOIN_AGG_LANES = ("private", "warps", "shared", "global")


def join_agg_parts(R: int, cap: int, n: int, sms: int, optin: int) -> list:
    """H16's launches for R output rows over cap groups and n rows: (first
    row, rows, lane, CTAs) each, over a grid-stride loop of 8 rows a
    thread. Up to H2_WARP_MAX_S groups H2's lanes and rows a launch
    (``h2_parts``: private cells or warp shuffles, at most H2_WARP_ROWS rows
    a launch, deterministic), one CTA an SM: 512 threads (256 in the private
    lane above 48 cells). Above, up to JOIN_AGG_MAX_ROWS rows a launch in
    the shared lane while their [rows, cap] partial fits a CTA's ``optin``
    bytes, else the global one (two and eight CTAs of 512 an SM)."""
    chunks = -(-n // 8)
    parts = []
    if 1 <= cap <= H2_WARP_MAX_S:
        for lo, r, lane, _ in h2_parts(R, cap, n, sms, optin):
            threads = 256 if lane == "private" and r * h2_bucket(cap) > 48 else 512
            parts.append((lo, r, lane, max(1, min(-(-chunks // threads), sms))))
        return parts
    for lo in range(0, R, JOIN_AGG_MAX_ROWS):
        r = min(JOIN_AGG_MAX_ROWS, R - lo)
        lane, ctas = ("shared", 2) if r * cap * 8 <= optin else ("global", 8)
        parts.append((lo, r, lane, max(1, min(-(-chunks // 512), sms * ctas))))
    return parts


def join_agg_fold_geometry(device: torch.device, n: int, R: int, cap: int, K: int,
                           S_r: int) -> tuple[int, int, int, str]:
    """(CTAs, threads a CTA, dynamic shared bytes, lane) of H16's first
    launch over n rows for R output rows of cap groups, K keys and S_r
    right sums on ``device``, as its launcher computes them."""
    optin = smem_optin_bytes(device)
    _, r, lane, grid = join_agg_parts(R, cap, n, sm_count(device), optin)[0]
    out = (ctypes.c_int * 2)()
    status = library().px_join_agg_fold_geometry(
        _JOIN_AGG_LANES.index(lane), r, cap, K, S_r, optin, out)
    _check(status, "join_agg_fold geometry")
    return grid, out[0], out[1], lane


def join_agg_fold(
    jk: torch.Tensor, gids: torch.Tensor, mask: Optional[torch.Tensor],
    n_right: torch.Tensor, left_vals, right_sums: torch.Tensor,
    acc: torch.Tensor, eff_mask: Optional[torch.Tensor] = None, jk_offset: int = 0,
    probe: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """H16: for every row r with ``mask[r]`` and w = n_right[k] > 0 (k =
    jk[r] + ``jk_offset``; a key outside [0, K) weighs 0), adds w to acc[0,
    g], left_vals[i][r] * w to acc[1 + i, g] and right_sums[j, k] to acc[1 +
    S_l + j, g] (g = gids[r] in [0, cap)), IN PLACE on ``acc`` (f64 [1 +
    S_l + S_r, cap]), and returns it; writes mask[r] && w > 0 to
    ``eff_mask`` (bool [n]) when given. ``jk`` and ``gids`` uint8, uint16
    or int32 [n], read as staged; ``left_vals`` S_l f64 [n] columns (or an
    f64 [S_l, n] tensor); ``n_right`` f64 [K]; ``right_sums`` f64 [S_r, K].
    The lanes of ``join_agg_parts``,
    one launch count per launch; up to 64 groups the sums are the same bits
    on every run. ``probe``: int64 [JOIN_AGG_PROBE] on the device, CTA 0's
    clock64 phases of the first launch."""
    device = jk.device
    for name, t in (("jk", jk), ("gids", gids)):
        if t.dtype not in JOIN_AGG_KINDS:
            raise TypeError(f"{name} has dtype {t.dtype}, expected one of {list(JOIN_AGG_KINDS)}")
    _require(jk, "jk", jk.dtype, device, 1)
    n = jk.shape[0]
    _require(gids, "gids", gids.dtype, device, 1)
    if gids.shape[0] != n:
        raise ValueError(f"gids has {gids.shape[0]} rows, expected {n}")
    if mask is not None:
        _require(mask, "mask", torch.bool, device, 1)
        if mask.shape[0] != n:
            raise ValueError(f"mask has {mask.shape[0]} rows, expected {n}")
    lefts = list(left_vals)
    for i, col in enumerate(lefts):
        _require(col, f"left_vals[{i}]", torch.float64, device, 1)
        if col.shape[0] != n:
            raise ValueError(f"left_vals[{i}] has {col.shape[0]} rows, expected {n}")
    _require(n_right, "n_right", torch.float64, device, 1)
    _require(right_sums, "right_sums", torch.float64, device, 2)
    _require(acc, "acc", torch.float64, device, 2)
    K = n_right.shape[0]
    S_l, S_r = len(lefts), right_sums.shape[0]
    R, cap = 1 + S_l + S_r, acc.shape[1]
    if right_sums.shape[1] != K or acc.shape[0] != R:
        raise ValueError(
            f"join_agg_fold: right_sums must be [S_r, {K}] and acc [1 + S_l + S_r, cap]; got "
            f"{tuple(right_sums.shape)}, {tuple(acc.shape)} with S_l {S_l}"
        )
    if eff_mask is not None:
        _require(eff_mask, "eff_mask", torch.bool, device, 1)
        if eff_mask.shape[0] != n:
            raise ValueError(f"eff_mask has {eff_mask.shape[0]} rows, expected {n}")
    _probe_arg(probe, JOIN_AGG_PROBE, device)
    if K >= 2**31 or cap >= 2**31:
        raise ValueError("join_agg_fold: K and cap must fit int32")
    if n == 0:
        return acc
    optin = smem_optin_bytes(device)
    parts = join_agg_parts(R, cap, n, sm_count(device), optin)
    scratch = ticket = None
    if parts[0][2] in ("private", "warps"):  # each CTA's partial, then the last CTA adds them
        scratch = torch.empty(max(grid * r for _, r, _, grid in parts) * cap,
                              dtype=torch.float64, device=device)
        ticket = _h2_ticket(device)
    # Output row q: the count (kind 0), left sum q - 1 (1), right sum q - 1 - S_l (2).
    kinds = [0] + [1] * S_l + [2] * S_r
    cols = [None] + [c.data_ptr() for c in lefts] + [None] * S_r
    rights = [0] * (1 + S_l) + list(range(S_r))
    for lo, r, lane, grid in parts:
        _launch(
            "join_agg_fold", device,
            jk.data_ptr(), JOIN_AGG_KINDS[jk.dtype], _i64(jk_offset), gids.data_ptr(),
            JOIN_AGG_KINDS[gids.dtype], mask.data_ptr() if mask is not None else None, n,
            n_right.data_ptr(), K, right_sums.data_ptr(), S_r,
            ctypes.cast((ctypes.c_int * r)(*kinds[lo:lo + r]), ctypes.c_void_p),
            ctypes.cast((ctypes.c_void_p * r)(*cols[lo:lo + r]), ctypes.c_void_p),
            ctypes.cast((ctypes.c_int * r)(*rights[lo:lo + r]), ctypes.c_void_p),
            r, acc.data_ptr() + lo * cap * 8, cap,
            eff_mask.data_ptr() if eff_mask is not None and lo == 0 else None,
            _JOIN_AGG_LANES.index(lane), grid, optin,
            scratch.data_ptr() if scratch is not None else None,
            ticket.data_ptr() if ticket is not None else None,
            probe.data_ptr() if probe is not None and lo == 0 else None,
        )
    return acc


# ---------------------------------------------------------------- scalar programs
# Storage kinds of H17's columns, LUTs and outputs (scalar_kernels.cu Kind).
SCALAR_KINDS = {
    torch.bool: 0, torch.uint8: 1, torch.uint16: 2, torch.int32: 3,
    torch.int64: 4, torch.float32: 5, torch.float64: 6,
}
_SCALAR_OUT = (torch.bool, torch.int32, torch.int64, torch.float64)
_SCALAR_LUT = (torch.bool, torch.int32, torch.int64, torch.float64)


def scalar_eval(
    code: torch.Tensor, consts: torch.Tensor, cols: list, luts: list, out_dtypes: list,
    n: int, offsets: list, n_regs: int, long_ops: bool,
) -> list:
    """H17: runs the lowered program ``code`` (int32 [n_instr, 8],
    ``ops/scalar.py`` lower) with its constant pool ``consts`` (int64 [k],
    the 8-byte constants' bits) and ``n_regs`` registers (at most 32;
    ``long_ops``: the code has an op of ``scalar.LONG_OPS``) for
    every row of one block: ``cols`` are its input columns ([n] each: bool,
    uint8, uint16, int32, int64, f32 or f64; an int column loads as int64
    plus its entry of ``offsets``), ``luts`` its lookup tables
    (1-d bool, int32, int64 or f64). Returns one new [n] tensor per entry of
    ``out_dtypes`` (bool, int32, int64 or f64), in the program's out-index
    order (ops/scalar.py states the program and its semantics)."""
    device = code.device
    _require(code, "code", torch.int32, device, 2)
    _require(consts, "consts", torch.int64, device, 1)
    if code.shape[1] != 8:
        raise ValueError(f"code must be [n_instr, 8], got {tuple(code.shape)}")
    if not 0 <= n_regs <= 32:
        raise ValueError(f"n_regs {n_regs} is outside [0, 32]")
    for i, c in enumerate(cols):
        if c.dtype not in SCALAR_KINDS:
            raise TypeError(f"column {i} has dtype {c.dtype}, which H17 does not read")
        _require(c, f"column {i}", c.dtype, device, 1)
        if c.shape[0] != n:
            raise ValueError(f"column {i} has {c.shape[0]} rows, expected {n}")
    for i, t in enumerate(luts):
        if t.dtype not in _SCALAR_LUT:
            raise TypeError(f"LUT {i} has dtype {t.dtype}, expected bool, int32, int64 or f64")
        _require(t, f"LUT {i}", t.dtype, device, 1)
        if t.shape[0] == 0:
            raise ValueError(f"LUT {i} is empty")
    for dt in out_dtypes:
        if dt not in _SCALAR_OUT:
            raise TypeError(f"H17 writes no {dt} output")
    outs = [torch.empty(n, dtype=dt, device=device) for dt in out_dtypes]
    if n == 0 or code.shape[0] == 0:
        return outs
    k, t, o = len(cols), len(luts), len(outs)
    if len(offsets) != k:
        raise ValueError(f"{len(offsets)} offsets for {k} columns")
    _launch(
        "scalar_eval", device,
        code.data_ptr(), code.shape[0], consts.data_ptr(), consts.shape[0], n_regs, int(long_ops),
        (ctypes.c_void_p * max(k, 1))(*[c.data_ptr() for c in cols]),
        (ctypes.c_int * max(k, 1))(*[SCALAR_KINDS[c.dtype] for c in cols]),
        (ctypes.c_longlong * max(k, 1))(*[int(x) for x in offsets]), k,
        (ctypes.c_void_p * max(t, 1))(*[x.data_ptr() for x in luts]),
        (ctypes.c_int * max(t, 1))(*[SCALAR_KINDS[x.dtype] for x in luts]),
        (ctypes.c_longlong * max(t, 1))(*[x.shape[0] for x in luts]), t,
        (ctypes.c_void_p * max(o, 1))(*[x.data_ptr() for x in outs]),
        (ctypes.c_int * max(o, 1))(*[SCALAR_KINDS[x.dtype] for x in outs]), o, n,
    )
    return outs


# ---------------------------------------------------------------- staging codec
# H19's delta kinds (codec_kernels.cu): nibbles are uint8 with ``nib``.
_DELTA_KINDS = {torch.uint8: 1, torch.uint16: 2, torch.int8: 3, torch.int16: 4, torch.int32: 5}
DELTA_TILE_ROWS = 4096  # kDeltaTile of codec_kernels.cu


def delta_tiles(d: int, L: int) -> int:
    """H19's tiles for a [d, L] block: each shard's rows in tiles of
    DELTA_TILE_ROWS (a ragged last tile), one scratch word a tile."""
    return d * ((L + DELTA_TILE_ROWS - 1) // DELTA_TILE_ROWS)


def _decode_out(out: torch.Tensor, device) -> tuple[int, int]:
    if out.device != device:
        raise ValueError(f"out is on {out.device}, expected {device}")
    if out.dim() != 2 or not out.is_contiguous():
        raise ValueError("out must be a contiguous [d, L] tensor")
    if out.element_size() not in (1, 2, 4, 8):
        raise TypeError(f"out has dtype {out.dtype}, not a 1, 2, 4 or 8-byte type")
    return out.shape[0], out.shape[1]


RLE_THREADS = 256  # kRleThreads of codec_kernels.cu
RLE_PROBE = 4  # the first CTA's clock64 at the start and after the search, staging, expansion


def rle_tile_rows(elem_size: int) -> int:
    """H18's rows a CTA for a block of ``elem_size``-byte elements
    (codec_kernels.cu RleTile::kRows)."""
    if elem_size not in (1, 2, 4, 8):
        raise ValueError(f"rle_tile_rows: elements of {elem_size} bytes")
    return 4096 if elem_size <= 2 else 2048


def codec_rle_decode_geometry(d: int, L: int, elem_size: int) -> tuple[int, int, int]:
    """(CTAs, threads a CTA, dynamic shared bytes a CTA) of H18's launch over
    a [d, L] block of ``elem_size``-byte elements: a CTA a tile of each
    shard."""
    return d * -(-L // rle_tile_rows(elem_size)), RLE_THREADS, 0


def codec_rle_decode(values: torch.Tensor, ends: torch.Tensor, out: torch.Tensor,
                     probe: Optional[torch.Tensor] = None) -> torch.Tensor:
    """H18: writes values[s, min(searchsorted(ends[s], i, right), R - 1)] to
    ``out[s, i]`` for every row i of each shard s, as bits, and returns
    ``out`` ([d, L], the dtype of ``values`` [d, R]; ``ends`` int32 [d, R],
    ascending in each shard; d up to 65535, L below 2^31). A CTA a tile of
    each shard (``codec_rle_decode_geometry``). ``probe``: None, or int64
    [RLE_PROBE] on the device for the first CTA's clock64 at the start and
    after the search for its runs, their staging and the expansion."""
    device = values.device
    d, L = _decode_out(out, device)
    _require(values, "values", out.dtype, device, 2)
    _require(ends, "ends", torch.int32, device, 2)
    R = values.shape[1]
    _probe_arg(probe, RLE_PROBE, device)
    if (values.shape[0] != d or tuple(ends.shape) != (d, R) or R == 0 or R >= 2**31
            or d > 65535 or L >= 2**31):
        raise ValueError(
            f"codec_rle_decode: values and ends must be [{d}, R] with 0 < R < 2^31, "
            f"d <= 65535 and L < 2^31; got "
            f"{tuple(values.shape)}, {tuple(ends.shape)}"
        )
    if d == 0 or L == 0:
        return out
    _launch(
        "codec_rle_decode", device,
        values.data_ptr(), ends.data_ptr(), d, R, L, out.element_size(), out.data_ptr(),
        probe.data_ptr() if probe is not None else None,
    )
    return out


def codec_delta_decode(
    bases: torch.Tensor, deltas: torch.Tensor, rows: torch.Tensor, off: int, nib: bool,
    out: torch.Tensor,
) -> torch.Tensor:
    """H19: writes bases[s] + inclusive_cumsum(d64) to ``out[s, i]`` for i
    below rows[s] and 0 past it, with d64 = delta + off (wrapping int64 adds)
    zeroed at row 0 and past rows[s], each sum cast to ``out``'s integer
    dtype by its low bytes; returns ``out`` ([d, L]). ``bases`` int64 [d],
    ``rows`` int32 [d]; ``deltas`` [d, L] uint8, uint16, int8, int16 or
    int32, or with ``nib`` uint8 [d, ceil(L / 2)], the even row in the low
    nibble. One count for the call's three grids (tile sums, their scan,
    the decode)."""
    device = bases.device
    d, L = _decode_out(out, device)
    if out.dtype.is_floating_point or out.dtype == torch.bool:
        raise TypeError(f"codec_delta_decode writes integers, not {out.dtype}")
    _require(bases, "bases", torch.int64, device, 1)
    _require(rows, "rows", torch.int32, device, 1)
    if nib:
        _require(deltas, "deltas", torch.uint8, device, 2)
        kind, width = 0, (L + 1) // 2
    else:
        if deltas.dtype not in _DELTA_KINDS:
            raise TypeError(f"deltas has dtype {deltas.dtype}, expected uint8, uint16, int8, "
                            "int16 or int32")
        _require(deltas, "deltas", deltas.dtype, device, 2)
        kind, width = _DELTA_KINDS[deltas.dtype], L
    if bases.shape[0] != d or rows.shape[0] != d or tuple(deltas.shape) != (d, width):
        raise ValueError(
            f"codec_delta_decode: bases and rows must be [{d}] and deltas [{d}, {width}]; got "
            f"{tuple(bases.shape)}, {tuple(rows.shape)}, {tuple(deltas.shape)}"
        )
    if d == 0 or L == 0:
        return out
    # The tile sums, then prefixes: every word is written before it is read.
    scratch = torch.empty(delta_tiles(d, L), dtype=torch.int64, device=device)
    _launch(
        "codec_delta_decode", device,
        bases.data_ptr(), deltas.data_ptr(), width, kind, rows.data_ptr(), int(off), d, L,
        out.element_size(), out.data_ptr(), scratch.data_ptr(),
    )
    return out


# ---------------------------------------------------------------- cell lane
def _cell_inputs(hist: torch.Tensor, lut: torch.Tensor, G: int, device) -> int:
    _require(hist, "hist", torch.int64, device, 2)
    _require(lut, "lut", torch.int64, device, 1)
    C = lut.shape[0]
    if tuple(hist.shape) != (G, C):
        raise ValueError(f"hist has shape {tuple(hist.shape)}, expected {(G, C)}")
    return C


def hll_cell_update(state: torch.Tensor, hist: torch.Tensor, lut: torch.Tensor) -> torch.Tensor:
    """H20: for every cell (g, c) with hist[g, c] > 0, register reg(lut[c])
    of group g takes the max with rho(lut[c]), IN PLACE on ``state`` (int32
    [G, 2^p]); returns it. ``hist`` int64 [G, C], ``lut`` int64 [C]."""
    device = state.device
    _require(state, "state", torch.int32, device, 2)
    G, m = state.shape
    precision = m.bit_length() - 1
    if m != 1 << precision or precision < 4:
        raise ValueError(f"HLL state width {m} is not a power of two >= 16")
    C = _cell_inputs(hist, lut, G, device)
    if G == 0 or C == 0:
        return state
    _launch(
        "hll_cell_update", device,
        hist.data_ptr(), lut.data_ptr(), G, C, precision, state.data_ptr(),
    )
    return state


def countmin_cell_update(
    cm: torch.Tensor, total: torch.Tensor, hist: torch.Tensor, lut: torch.Tensor
) -> None:
    """H21: adds hist[g, c] to the ``depth`` buckets of lut[c] in group g of
    ``cm`` (int64 [G, depth, width]) and to total[g] (int64 [G]), IN PLACE.
    ``hist`` int64 [G, C], ``lut`` int64 [C]."""
    device = cm.device
    _require(cm, "cm", torch.int64, device, 3)
    _require(total, "total", torch.int64, device, 1)
    G, depth, width = cm.shape
    if total.shape[0] != G or width & (width - 1):
        raise ValueError("countmin_cell_update: total must be [G], width a power of two")
    C = _cell_inputs(hist, lut, G, device)
    if G == 0 or C == 0:
        return
    _launch(
        "countmin_cell_update", device,
        hist.data_ptr(), lut.data_ptr(), G, C, depth, width, cm.data_ptr(), total.data_ptr(),
    )


# ---------------------------------------------------------------- batched fold
# H22's limits (batch_kernels.cu's kMaxSlots, kMaxPredCols, kMaxProgTerms,
# kProgWords, kListSharedWords); a slot's terms in a term table.
PRED_MAX_SLOTS = 32
PRED_MAX_TERMS = 16
PRED_MAX_COLS = 16
PRED_MAX_PROG_TERMS = PRED_MAX_SLOTS * PRED_MAX_TERMS
PRED_PROG_WORDS = 8
PRED_LIST_SHARED_WORDS = 4096
# H22's codes of the staged block dtypes (batch_kernels.cu enum ColKind).
PRED_COL_KINDS = {
    torch.bool: 0, torch.uint8: 1, torch.uint16: 2, torch.int32: 3, torch.int64: 4,
    torch.float32: 5, torch.float64: 6,
}


def pred_slot_masks_geometry(n: int, U: int, shared_words: int) -> tuple[int, int, int]:
    """(CTAs, threads a CTA, dynamic shared bytes a CTA) of H22's launch over
    ``n`` rows with ``U`` program terms and ``shared_words`` shared list
    words, as its launcher computes them."""
    out = (ctypes.c_int * 3)()
    _check(library().px_pred_slot_masks_geometry(n, U, shared_words, out),
           "pred_slot_masks geometry")
    return tuple(out)


def pred_slot_masks(
    cols: list, offsets: list, base: torch.Tensor, prog: torch.Tensor, lists: torch.Tensor,
    shared_words: int, slot_on: int,
) -> torch.Tensor:
    """H22: int32 [n], each row's uint32 slot bits: bits of ``slot_on``
    where base[i] holds, less the ``need`` slots of every program term that
    is false on row i. ``cols``: the term columns' blocks as staged (bool,
    uint8, uint16, int32, int64 with ``offsets`` added, f32, f64), [n] each;
    ``prog`` int64 [U, PRED_PROG_WORDS] and ``lists`` int64, a compiled
    term table (``ops.batched.compile_terms``), whose first ``shared_words``
    list words go to shared memory."""
    device = base.device
    _require(base, "base", torch.bool, device, 1)
    n = base.shape[0]
    if len(cols) > PRED_MAX_COLS or len(offsets) != len(cols):
        raise ValueError(f"pred_slot_masks: at most {PRED_MAX_COLS} columns, one offset each")
    _require(prog, "prog", torch.int64, device, 2)
    U = prog.shape[0]
    if U > PRED_MAX_PROG_TERMS or prog.shape[1] != PRED_PROG_WORDS:
        raise ValueError(f"prog has shape {tuple(prog.shape)}, expected at most "
                         f"({PRED_MAX_PROG_TERMS}, {PRED_PROG_WORDS})")
    _require(lists, "lists", torch.int64, device, 1)
    if not 0 <= shared_words <= min(PRED_LIST_SHARED_WORDS, lists.shape[0]):
        raise ValueError(f"pred_slot_masks: {shared_words} shared list words of {lists.shape[0]}"
                         f" (at most {PRED_LIST_SHARED_WORDS})")
    for c in cols:
        if c.dtype not in PRED_COL_KINDS:
            raise TypeError(f"a term column has dtype {c.dtype}")
        _require(c, "a term column", c.dtype, device, 1)
        if c.shape[0] != n:
            raise ValueError(f"a term column has {c.shape[0]} rows, expected {n}")
    out = torch.empty(n, dtype=torch.int32, device=device)
    if n == 0:
        return out
    k = max(len(cols), 1)
    ptrs = (ctypes.c_longlong * k)(*[c.data_ptr() for c in cols])
    offs = (ctypes.c_longlong * k)(*[int(o) for o in offsets])
    kinds = (ctypes.c_int * k)(*[PRED_COL_KINDS[c.dtype] for c in cols])
    _launch(
        "pred_slot_masks", device,
        ctypes.addressof(ptrs), ctypes.addressof(offs), ctypes.addressof(kinds), len(cols),
        base.data_ptr(), n, prog.data_ptr(), U, lists.data_ptr(), shared_words, slot_on,
        out.data_ptr(),
    )
    return out


H23_MAX_ROWS = 16  # kSumMaxRows of batch_kernels.cu: integer rows, and f64 rows, a launch
H23_THREADS = 512  # kSumThreads
H23_STAGE = 256  # kSumStage: rows a warp stages
H23_SLOT_MAX_S = 64  # kSumSlotMaxS
H23_MIN_WARPS = 4  # the slot lane's fewest warps a CTA
# The slot lane's most slots: a lane walks its bucket once a slot, so its
# cost grows with B; at B = 16, R = F = 2, S = 16 it took 0.437 ms against
# the shared lane's 0.29 (NVIDIA H100 80GB HBM3, PERF.md section 6).
H23_SLOT_MAX_B = 8
H23_LANES = ("slots", "shared", "global")


def h23_warp_bytes(B: int, R: int, F: int, S: int) -> int:
    """Shared bytes a warp of H23's slot lane takes: its staged rows (slot
    bits and R + F values), its lanes' sums of their (slot, gid) pairs
    (R + 1 + F each) and its bucket counts."""
    pairs_a_lane = -(-B * S // 32)
    return 8 * (H23_STAGE * (1 + R + F) + pairs_a_lane * (R + 1 + F) * 32 + (S + 2) // 2)


def h23_lane(B: int, R: int, F: int, S: int, optin: int) -> tuple[str, int]:
    """H23's lane for B slots of R integer and F f64 rows over S groups,
    and its threads a CTA: ("slots", threads) up to H23_SLOT_MAX_B slots and
    H23_SLOT_MAX_S groups while H23_MIN_WARPS warps' ``h23_warp_bytes`` fit
    ``optin`` bytes of shared memory (up to 16 warps); else ("shared", 0)
    while one CTA's [B, R + 1 + F, S] partial fits; else ("global", 0)."""
    warps = min(H23_THREADS // 32, optin // h23_warp_bytes(B, R, F, S))
    if B <= H23_SLOT_MAX_B and S <= H23_SLOT_MAX_S and warps >= H23_MIN_WARPS:
        return "slots", 32 * warps
    if 8 * B * (R + 1 + F) * S <= optin:
        return "shared", 0
    return "global", 0


def _h23_specs(rows, kinds: dict, what: str, n: int, device) -> list:
    specs = []
    for i, (t, off) in enumerate(rows):
        if t.dtype not in kinds:
            raise TypeError(f"{what}[{i}] has dtype {t.dtype}, expected one of {list(kinds)}")
        _require(t, f"{what}[{i}]", t.dtype, device, 1)
        if t.shape[0] != n:
            raise ValueError(f"{what}[{i}] has {t.shape[0]} rows, expected {n}")
        specs.append((t.data_ptr(), kinds[t.dtype], _i64(off)))
    return specs


def _c_array(ctype, values: list):
    return ctypes.cast((ctype * max(len(values), 1))(*values), ctypes.c_void_p)


def batched_segment_sums(
    irows, frows, gids: torch.Tensor, bits: torch.Tensor, B: int, num_segments: int,
) -> tuple:
    """H23: (int64 [B, R + 1, S], f64 [B, F, S]). Every row i with a gid in
    [0, S) adds, for each set bit s of bits[i] (s < B), its value of integer
    row r into [s, r, g] (wrapping, exact mod 2^64), one into [s, R, g] and
    its value of f64 row f into [s, f, g]. ``irows``: R pairs (tensor,
    offset), each [n] of bool, uint8, uint16, int32 or int64 read as it
    lies, every value plus ``offset``; ``frows``: F pairs (tensor, offset),
    f64 or one of those integer dtypes (its value plus ``offset`` rounded to
    f64); ``gids`` and ``bits`` int32 [n]. The lane of ``h23_lane``; one
    launch count per launch (one a block up to H23_MAX_ROWS rows of each)."""
    device = gids.device
    irows, frows = list(irows), list(frows)
    _require(bits, "bits", torch.int32, device, 1)
    n = gids.shape[0]
    if bits.shape[0] != n:
        raise ValueError("batched_segment_sums: gids and bits need the same rows")
    _gids_mask(gids, None, n, device)
    if not 1 <= B <= PRED_MAX_SLOTS:
        raise ValueError(f"batched_segment_sums: B {B} must be in [1, {PRED_MAX_SLOTS}]")
    S, R, F = num_segments, len(irows), len(frows)
    if R > H23_MAX_ROWS or F > H23_MAX_ROWS:  # a launch for each H23_MAX_ROWS rows of each
        parts = [batched_segment_sums(irows[k:k + H23_MAX_ROWS], frows[k:k + H23_MAX_ROWS],
                                      gids, bits, B, S)
                 for k in range(0, max(R, F), H23_MAX_ROWS)]
        return (torch.cat([p[0][:, :-1] for p in parts] + [parts[0][0][:, -1:]], dim=1),
                torch.cat([p[1] for p in parts], dim=1))
    ispecs = _h23_specs(irows, SUM_ROW_KINDS, "irows", n, device)
    fspecs = _h23_specs(frows, H2_KINDS, "frows", n, device)
    if n == 0 or S == 0:
        return (torch.zeros((B, R + 1, S), dtype=torch.int64, device=device),
                torch.zeros((B, F, S), dtype=torch.float64, device=device))
    if n >= 1 << 31:
        raise ValueError(f"H23 takes fewer than 2^31 rows, got {n}")
    lane, threads = h23_lane(B, R, F, S, smem_optin_bytes(device))
    ci, cf = B * (R + 1) * S, B * F * S
    grid = partials = ticket = None
    if lane == "slots":  # the outputs, then the CTAs' partials, in one buffer
        per_sm = 2 if threads // 32 * h23_warp_bytes(B, R, F, S) <= 100 * 1024 else 1
        tiles = -(-n // H23_STAGE)
        grid = max(1, min(-(-tiles // (threads // 32)), sm_count(device) * per_sm))
        buf = torch.empty(ci + cf + grid * (ci + cf), dtype=torch.int64, device=device)
        out_i = buf[:ci].view(B, R + 1, S)
        out_f = buf[ci:ci + cf].view(torch.float64).view(B, F, S)
        partials, ticket = buf.data_ptr() + 8 * (ci + cf), _h2_ticket(device).data_ptr()
    else:
        out_i = torch.zeros((B, R + 1, S), dtype=torch.int64, device=device)
        out_f = torch.zeros((B, F, S), dtype=torch.float64, device=device)
    _launch(
        "batched_segment_sums", device,
        _c_array(ctypes.c_void_p, [p for p, _, _ in ispecs]),
        _c_array(ctypes.c_int, [k for _, k, _ in ispecs]),
        _c_array(ctypes.c_longlong, [o for _, _, o in ispecs]), R,
        _c_array(ctypes.c_void_p, [p for p, _, _ in fspecs]),
        _c_array(ctypes.c_int, [k for _, k, _ in fspecs]),
        _c_array(ctypes.c_longlong, [o for _, _, o in fspecs]), F,
        n, gids.data_ptr(), bits.data_ptr(), B, S, out_i.data_ptr(), out_f.data_ptr(),
        H23_LANES.index(lane), threads or H23_THREADS, grid or 0,
        partials, ticket,
    )
    return out_i, out_f


# -- H24: the resident ring's raw -> plan converters ---------------------------

# dtype codes of convert_kernels.cu.
_CONVERT_CODES = {
    torch.bool: 0, torch.uint8: 1, torch.uint16: 2, torch.int32: 3, torch.int64: 4,
    torch.float32: 5, torch.float64: 6,
}
_CONVERT_KINDS = {"raw": 0, "narrow": 1, "f32": 2, "intdict": 3}
_INTS = (torch.uint8, torch.uint16, torch.int32, torch.int64)
# The (source, destination) dtype pairs the stream plans produce, per kind.
CONVERT_PAIRS = {
    "raw": {(s, d) for s in (torch.bool, torch.int32, torch.int64)
            for d in (torch.bool,) + _INTS + (torch.float32,)}
    | {(torch.float64, torch.float32), (torch.float64, torch.float64)},
    "narrow": {(s, d) for s in (torch.int32, torch.int64) for d in _INTS},
    "f32": {(torch.float64, torch.float32)},
    "intdict": {(torch.int64, d) for d in (torch.uint8, torch.uint16, torch.int32)},
}
CONVERT_MAX_LUT = 1 << 16  # uint16 codes


def ring_convert_shards(src: torch.Tensor, out: torch.Tensor) -> tuple[int, int, int, int]:
    """(d, L, src_stride, dst_stride) of H24's launch over ``src`` and ``out``
    (strides in elements): both contiguous, one run of every element (d 1);
    else both [d, ...] with d up to 65535, each shard ``t[s]`` a contiguous
    run of L elements at ``s * t.stride(0)``, as a window's slice
    ``staging[:, lo:hi]`` of a one-card staging of d logical shards is.
    Raises ValueError for any other layout, or for runs that overlap."""
    n = src.numel()
    if out.numel() != n:
        raise ValueError(f"ring_convert: src has {n} elements, out {out.numel()}")
    if src.is_contiguous() and out.is_contiguous():
        return 1, n, n, n
    if src.dim() < 2 or src.shape[0] != out.shape[0] or out.dim() < 2:
        raise ValueError("ring_convert: a strided src or out must be [d, ...] like the other")
    d = src.shape[0]
    L = n // d if d else 0
    strides = []
    for t in (src, out):
        if not t[0].is_contiguous() or (d > 1 and t.stride(0) < L):
            raise ValueError("ring_convert: each shard of src and out must be a contiguous run "
                             "of its elements, the runs apart")
        strides.append(t.stride(0) if d > 1 else L)
    if d > 65535:
        raise ValueError(f"ring_convert: {d} shards, at most 65535")
    return d, L, strides[0], strides[1]


def ring_convert(src: torch.Tensor, out: torch.Tensor, kind: str, off: int = 0,
                 lut: Optional[torch.Tensor] = None) -> torch.Tensor:
    """H24: writes ``src`` (a resident block in its raw dtype) converted per
    ``kind`` into ``out`` (the plan's dtype, as many elements) and returns
    ``out``: "raw" a cast, "narrow" (int64(x) - off) keeping the low bytes,
    "f32" f64 -> f32 with NaN payloads kept as the host casts them,
    "intdict" min(searchsorted(lut, x), C - 1) with ``lut`` sorted int64
    [C], 1 <= C <= 65536. ``src`` and ``out`` are contiguous, any shape, or
    [d, ...] views whose shards are contiguous runs at a stride
    (``ring_convert_shards``): one launch converts a window's d shards into
    their slices of a one-card staging."""
    device = src.device
    if kind not in _CONVERT_KINDS:
        raise ValueError(f"ring_convert: unknown kind {kind!r}")
    if (src.dtype, out.dtype) not in CONVERT_PAIRS[kind]:
        raise TypeError(f"ring_convert: {kind} does not convert {src.dtype} to {out.dtype}")
    if out.device != device:
        raise ValueError(f"out is on {out.device}, expected {device}")
    d, L, src_stride, dst_stride = ring_convert_shards(src, out)
    lut_ptr, C = None, 0
    if kind == "intdict":
        if lut is None:
            raise ValueError("ring_convert: intdict needs its lut")
        _require(lut, "lut", torch.int64, device, 1)
        C = lut.numel()
        if not 1 <= C <= CONVERT_MAX_LUT:
            raise ValueError(f"ring_convert: lut of {C} entries, expected 1 to {CONVERT_MAX_LUT}")
        lut_ptr = lut.data_ptr()
    if d * L == 0:
        return out
    _launch(
        "ring_convert", device,
        src.data_ptr(), _CONVERT_CODES[src.dtype], out.data_ptr(), _CONVERT_CODES[out.dtype],
        _CONVERT_KINDS[kind], int(off), lut_ptr, C, d, L, src_stride, dst_stride,
    )
    return out


# ---------------------------------------------------------------- ML lane
RESERVOIR_MAX_K = 1024  # H26's buffer (2048 entries) less one step of rows
TOPK_STEP_ROWS = 1024  # kTopkStep of ml_kernels.cu
TOPK_CTAS_PER_SM = 4
TOPK_ROWS_MAX_G = 64  # kChunkMaxG of ml_kernels.cu
ENCODER_LAYER_FLOATS = 4 * 64 * 64 + 2 * 64 * 256 + 2 * 64  # pack_layer's layout = kLayerFloats


def reservoir_priority(words: torch.Tensor, mask: Optional[torch.Tensor],
                       salt: torch.Tensor) -> torch.Tensor:
    """H25: f64 [n] priorities of a block's rows, -inf where ``mask`` is
    False: combine(hash64(words[i]), hash64(i + salt)) >> 11, / 2^53.
    ``words`` int64 [n] (each value's u64 word), ``salt`` int64 [1] on the
    device (read by the kernel, so nothing waits for it)."""
    device = words.device
    _require(words, "words", torch.int64, device, 1)
    _require(salt, "salt", torch.int64, device, 1)
    n = words.shape[0]
    if mask is not None:
        _require(mask, "mask", torch.bool, device, 1)
        if mask.shape[0] != n:
            raise ValueError(f"mask has {mask.shape[0]} rows, expected {n}")
    out = torch.empty(n, dtype=torch.float64, device=device)
    if n == 0:
        return out
    _launch("reservoir_priority", device, words.data_ptr(), n,
            mask.data_ptr() if mask is not None else None, salt.data_ptr(), out.data_ptr())
    return out


def topk_scratch_words(G: int, S: int, k: int) -> int:
    """int64 words of G x S of H26's lists of k entries: int64 keys, int32
    origins, counts and rows (``list_words`` of ml_kernels.cu)."""
    return G * S * k + (G * S * (k + 2) + 1) // 2


def topk_rows_fits(G: int, k: int) -> bool:
    """Whether H26's sort-free path takes G groups of k: every group's k
    best and one step of rows fit one CTA's buffer."""
    return 1 <= G <= TOPK_ROWS_MAX_G and G * k <= RESERVOIR_MAX_K


def topk_chunks(n: int, k: int, sms: int) -> tuple[int, int]:
    """(C, M) of H26's sort-free path over n rows: C chunks of at least a
    step of rows, up to TOPK_CTAS_PER_SM a SM; M merges of a step's worth
    of lists each (TOPK_STEP_ROWS // k lists)."""
    C = max(1, min(TOPK_CTAS_PER_SM * sms, -(-n // TOPK_STEP_ROWS)))
    per = max(1, TOPK_STEP_ROWS // k)
    return C, -(-C // per)


_sm_count: dict[int, int] = {}


def sm_count(device: torch.device) -> int:
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _sm_count:
        _sm_count[index] = torch.cuda.get_device_properties(index).multi_processor_count
    return _sm_count[index]


def reservoir_topk(
    st_vals: torch.Tensor, st_pri: torch.Tensor, row_vals: torch.Tensor,
    row_pri: torch.Tensor, order: torch.Tensor, offsets: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """H26: each group's k highest priorities of its state slots (``st_vals``
    int64 bits [G, k], ``st_pri`` f64 [G, k]) and its candidate rows, in
    descending order, ties to the state's slots and then to the rows in
    order. Group g's rows are ``order[offsets[g]:offsets[g + 1]]`` (int64
    indices into ``row_vals`` int64 bits [n] and ``row_pri`` f64 [n]; a
    -inf priority never enters). Returns new (values, priorities). One CTA
    a group."""
    device = st_vals.device
    _require(st_vals, "st_vals", torch.int64, device, 2)
    _require(st_pri, "st_pri", torch.float64, device, 2)
    _require(row_vals, "row_vals", torch.int64, device, 1)
    _require(row_pri, "row_pri", torch.float64, device, 1)
    _require(order, "order", torch.int64, device, 1)
    _require(offsets, "offsets", torch.int64, device, 1)
    G, k = st_vals.shape
    n = order.shape[0]
    if st_pri.shape != (G, k) or row_pri.shape != row_vals.shape or offsets.shape[0] != G + 1:
        raise ValueError("reservoir_topk: mismatched shapes")
    if not 1 <= k <= RESERVOIR_MAX_K:
        raise ValueError(f"reservoir_topk: k {k} outside 1..{RESERVOIR_MAX_K}")
    if n + k >= 2**31:
        raise ValueError(f"reservoir_topk: {n} rows exceed H26's int32 origins")
    out_vals = torch.empty_like(st_vals)
    out_pri = torch.empty_like(st_pri)
    if G == 0:
        return out_vals, out_pri
    _launch("reservoir_topk", device, st_vals.data_ptr(), st_pri.data_ptr(), G, k,
            row_vals.data_ptr(), row_pri.data_ptr(), order.data_ptr(), offsets.data_ptr(),
            out_vals.data_ptr(), out_pri.data_ptr())
    return out_vals, out_pri


def reservoir_topk_rows(
    st_vals: torch.Tensor, st_pri: torch.Tensor, st_count: torch.Tensor,
    row_vals: torch.Tensor, row_pri: torch.Tensor, gids: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """H26's sort-free path (``topk_rows_fits``): the function of
    ``reservoir_topk`` over rows in row order, ``gids`` int32 [n] giving
    each row's group (G: not a candidate), no bucketing. Returns new
    (values, priorities, counts), counts = ``st_count`` int64 [G] plus each
    group's candidate rows. One count for the call's three grids; each
    call fills its own per-group thresholds with -1."""
    device = st_vals.device
    _require(st_vals, "st_vals", torch.int64, device, 2)
    _require(st_pri, "st_pri", torch.float64, device, 2)
    _require(st_count, "st_count", torch.int64, device, 1)
    _require(row_vals, "row_vals", torch.int64, device, 1)
    _require(row_pri, "row_pri", torch.float64, device, 1)
    _require(gids, "gids", torch.int32, device, 1)
    G, k = st_vals.shape
    n = gids.shape[0]
    if (st_pri.shape != (G, k) or st_count.shape[0] != G or row_pri.shape != row_vals.shape
            or row_vals.shape[0] != n):
        raise ValueError("reservoir_topk_rows: mismatched shapes")
    if not topk_rows_fits(G, k):
        raise ValueError(f"reservoir_topk_rows: {G} groups of {k} do not fit H26's buffer")
    if n + k >= 2**31:
        raise ValueError(f"reservoir_topk_rows: {n} rows exceed H26's int32 origins")
    out_vals, out_pri = torch.empty_like(st_vals), torch.empty_like(st_pri)
    out_count = torch.empty_like(st_count)
    C, M = topk_chunks(n, k, sm_count(device))
    scratch = torch.empty(topk_scratch_words(G, C, k) + topk_scratch_words(G, M, k),
                          dtype=torch.int64, device=device)
    thr = torch.full((G,), -1, dtype=torch.int64, device=device)
    _launch("reservoir_topk_rows", device, st_vals.data_ptr(), st_pri.data_ptr(),
            st_count.data_ptr(), G, k, row_vals.data_ptr(), row_pri.data_ptr(), gids.data_ptr(),
            n, C, M, scratch.data_ptr(), thr.data_ptr(), out_vals.data_ptr(),
            out_pri.data_ptr(), out_count.data_ptr())
    return out_vals, out_pri, out_count


KMEANS_PROBE = 6  # H27's probe: CTA 0's clock64 at 4 points, its assign and update cycles


def kmeans_fit_geometry(G: int, S: int, d: int, k: int) -> tuple[int, int, int]:
    """(CTAs, threads a CTA, dynamic shared bytes a CTA) of H27's launch, as
    its launcher computes them."""
    out = (ctypes.c_int * 3)()
    _check(library().px_kmeans_fit_geometry(G, S, d, k, out), "kmeans_fit geometry")
    return tuple(out)


def kmeans_fit(points: torch.Tensor, weights: torch.Tensor, k: int,
               iters: int = 10, probe: Optional[torch.Tensor] = None) -> torch.Tensor:
    """H27: f32 [G, k, d] centers of each group's points (f32 [G, S, d]) with
    weights (f32 [G, S], 0 = an empty slot): farthest-point seeding, then
    ``iters`` Lloyd steps, NaN taken as the reference takes it
    (ml_kernels.cu). ``probe``: None, or int64 [KMEANS_PROBE] on the device:
    [0..3] take CTA 0's SM clock at the start, after the load, after the
    seeding and at the end, [4] and [5] its cycles in Lloyd's assign and
    update steps."""
    device = points.device
    _require(points, "points", torch.float32, device, 3)
    _require(weights, "weights", torch.float32, device, 2)
    G, S, d = points.shape
    if weights.shape != (G, S):
        raise ValueError("kmeans_fit: weights must be [G, S]")
    if k < 1 or S < 1 or d < 1 or iters < 0:
        raise ValueError(f"kmeans_fit: k {k}, S {S}, d {d} must be positive, iters {iters} not "
                         f"negative")
    _probe_arg(probe, KMEANS_PROBE, device)
    out = torch.empty((G, k, d), dtype=torch.float32, device=device)
    if G == 0:
        return out
    _launch("kmeans_fit", device, points.data_ptr(), weights.data_ptr(), G, S, d, k, iters,
            out.data_ptr(), probe.data_ptr() if probe is not None else None)
    return out


def encoder_forward(ids: torch.Tensor, lens: torch.Tensor, embed: torch.Tensor,
                    pos: torch.Tensor, layers: torch.Tensor) -> torch.Tensor:
    """H28: f32 [B, 64] unit sentence embeddings of B documents: ``ids``
    int32 [B, 64] (shifted, pad 0), ``lens`` int32 [B] (tokens; clamped into
    0..64), ``embed`` f32 [V, 64], ``pos`` f32 [64, 64], ``layers`` f32
    [n_layers >= 1, ENCODER_LAYER_FLOATS] (``ops/transformer.py``
    pack_layer's layout). The documents' real rows are packed at the
    offsets of a device cumsum of the lengths; only they are computed."""
    device = ids.device
    _require(ids, "ids", torch.int32, device, 2)
    _require(lens, "lens", torch.int32, device, 1)
    _require(embed, "embed", torch.float32, device, 2)
    _require(pos, "pos", torch.float32, device, 2)
    _require(layers, "layers", torch.float32, device, 2)
    B = ids.shape[0]
    if ids.shape[1] != 64 or lens.shape[0] != B or embed.shape[1] != 64 or pos.shape != (64, 64):
        raise ValueError("encoder_forward: expected ids [B, 64], lens [B], d 64, L 64")
    if layers.shape[1] != ENCODER_LAYER_FLOATS or layers.shape[0] < 1:
        raise ValueError(f"encoder_forward: layers must be [n >= 1, {ENCODER_LAYER_FLOATS}]")
    out = torch.empty((B, 64), dtype=torch.float32, device=device)
    if B == 0:
        return out
    lens = lens.clamp(0, 64)
    ends = torch.cumsum(lens, 0, dtype=torch.int32)
    _launch("encoder_forward", device, ids.data_ptr(), lens.data_ptr(), ends.data_ptr(), B,
            embed.data_ptr(), pos.data_ptr(), layers.data_ptr(), layers.shape[0],
            out.data_ptr())
    return out


# ---------------------------------------------------------------- mesh merge
MERGE_KINDS = {"sum": 0, "max": 1, "min": 2}
_MERGE_TYPES = {torch.int64: 0, torch.int32: 1, torch.float64: 2}


def merge_states(stack: torch.Tensor, kind: str) -> torch.Tensor:
    """H29: [L] = the reduction of a [D, L] stack of D shards' leaves over
    the shard axis, in order d = 0..D-1: "sum" of int64 (wrapping mod 2^64)
    or f64 (IEEE adds in that order); "max"/"min" of int64, int32 or f64
    (f64 in H11's order: -0.0 below +0.0, a NaN in the accumulator stays, a
    NaN that arrives wins as the canonical quiet NaN)."""
    device = stack.device
    if kind not in MERGE_KINDS:
        raise ValueError(f"merge_states: unknown kind {kind!r}")
    if stack.dtype not in _MERGE_TYPES or (kind == "sum" and stack.dtype == torch.int32):
        raise TypeError(f"merge_states: no {kind} of {stack.dtype}")
    _require(stack, "stack", stack.dtype, device, 2)
    D, L = stack.shape
    if D < 1:
        raise ValueError("merge_states: a stack of no shards")
    out = torch.empty(L, dtype=stack.dtype, device=device)
    if L == 0:
        return out
    _launch(
        "merge_states", device,
        stack.data_ptr(), D, L, MERGE_KINDS[kind], _MERGE_TYPES[stack.dtype], out.data_ptr(),
    )
    return out


# ---------------------------------------------------------------- 64-bit hashes
HASH_MAX_COLUMNS = 8
_GOLDEN64 = 0x9E3779B97F4A7C15


def hash_columns(cols: list, seed: int) -> torch.Tensor:
    """H31: the row-wise u64 hash of 1-8 columns (int64 and float64 read as
    their 8-byte words, bool as 0/1), hash64 of the first combined left to
    right with each other's, as int64 bit patterns [n]."""
    if not 1 <= len(cols) <= HASH_MAX_COLUMNS:
        raise ValueError(f"hash_columns takes 1 to {HASH_MAX_COLUMNS} columns, got {len(cols)}")
    device = cols[0].device
    n = cols[0].shape[0]
    bool_mask = 0
    for c, col in enumerate(cols):
        if col.dtype == torch.bool:
            bool_mask |= 1 << c
        elif col.dtype not in (torch.int64, torch.float64):
            raise TypeError(f"column {c} has dtype {col.dtype}: int64, float64 or bool")
        _require(col, f"column {c}", col.dtype, device, 1)
        if col.shape[0] != n:
            raise ValueError(f"column {c} has {col.shape[0]} rows, expected {n}")
    out = torch.empty(n, dtype=torch.int64, device=device)
    if n == 0:
        return out
    ptrs = [col.data_ptr() for col in cols] + [None] * (HASH_MAX_COLUMNS - len(cols))
    _launch("hash_columns", device, *ptrs, len(cols), bool_mask,
            (seed * _GOLDEN64) & 0xFFFFFFFFFFFFFFFF, n, out.data_ptr())
    return out


def clz64(x: torch.Tensor) -> torch.Tensor:
    """H32: int32 [n], the leading zeros of each u64 (held in int64), 64
    for zero."""
    device = x.device
    _require(x, "x", torch.int64, device, 1)
    n = x.shape[0]
    out = torch.empty(n, dtype=torch.int32, device=device)
    if n:
        _launch("clz64", device, x.data_ptr(), n, out.data_ptr())
    return out
