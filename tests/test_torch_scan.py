"""Parity of the scan's stable compaction (``compact_rows_plain``, the plain
version of H12) with the reference's device scan program
(pixie_tpu/parallel/pipeline.py ``_build_scan_program``), run through
MeshExecutor on a one-device CPU mesh.

One table of three 4096-row blocks: about 10% of rows survive the
predicate, the second block has no survivor, and the third block holds 10
rows (all survivors) and 4086 rows of padding. The limits: 0, 1, one that
ends inside the first block, one that ends inside the last block, and one
larger than every survivor. The reference's raw program outputs (its
``written`` and its output buffers) are captured, and the port's blocks,
staged by the port and driven through ``compact_rows_plain``, must give the
same ``written`` and the same selected prefix, bit for bit. A numpy model of
H12's share decomposition (its shares, epoch-tagged status words, chunks and
the index lane's padding) is held against the same program, the plain
version and the reference's ``compact_unmatched_rows``; H12's share chooser
and its status words' epochs are checked on their own.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from pixie_tpu.engine import Carnot as RefCarnot
from pixie_tpu.ops import segment as ref_segment
from pixie_tpu.parallel import MeshExecutor
from pixie_tpu.table.column import DictColumn as RefDictColumn
from pixie_tpu.types import DataType as RefDT, Relation as RefRelation
from pixie_tpu_torch.engine import Carnot
from pixie_tpu_torch.ops import kernels, scan
from pixie_tpu_torch.parallel import DeviceExecutor
from pixie_tpu_torch.parallel.staging import stage_columns
from pixie_tpu_torch.table.column import DictColumn
from pixie_tpu_torch.types import DataType, Relation

# Two intra-op threads: the CPU tests share the host with the reference's
# timing-sensitive tests under several workers.
torch.set_num_threads(2)

B = 1 << 12
N = 2 * B + 10
QUERY = (
    "df = px.DataFrame(table='t')\n"
    "df = df[df.resp_status >= 400]\n"
    "df = df[['time_', 'service', 'latency']]\n"
    "df = df.head({limit})\n"
    "px.display(df, 'out')\n"
)


def _columns() -> dict:
    rng = np.random.default_rng(11)
    status = np.array([200, 404, 500], np.int64)[
        np.searchsorted(np.cumsum([0.9, 0.05, 0.05]), rng.random(N), side="right")
    ]
    status[B : 2 * B] = 200  # the second block: no survivor
    status[2 * B :] = 404  # the padded last block: every real row survives
    return {
        "time_": np.arange(N, dtype=np.int64) * 1000,
        "service": rng.integers(0, 16, N).astype(np.int32),
        "resp_status": status,
        "latency": rng.exponential(3e7, N),
    }


def _reference_program_outputs(cols: dict, limit: int):
    """(written, [time_, service codes, latency] buffers) as the reference's
    scan program returns them."""
    ex = MeshExecutor(mesh=Mesh(np.array(jax.devices()[:1]), ("d",)), block_rows=B)
    ref = RefCarnot(device_executor=ex)
    rel = RefRelation.of(("time_", RefDT.TIME64NS), ("service", RefDT.STRING),
                         ("resp_status", RefDT.INT64), ("latency", RefDT.FLOAT64))
    t = ref.table_store.create_table("t", rel)
    d = t.dictionaries["service"]
    for i in range(16):
        d.get_code(f"svc-{i}")
    t.write_pydict({**cols, "service": RefDictColumn(cols["service"], d)})
    query = QUERY.format(limit=limit)
    ref.execute_query(query)
    (sig,) = [k for k in ex._program_cache if k.startswith("scan|")]
    program, nargs, extra = ex._program_cache[sig]
    captured = []
    ex._program_cache[sig] = (lambda *a: captured.append(program(*a)) or captured[-1],
                              nargs, extra)
    ref.execute_query(query)
    assert not ex.fallback_errors and len(captured) == 1
    outs = [np.asarray(o) for o in captured[0]]
    return int(outs[0][0]), outs[1:]


def _port_compaction(cols: dict, limit: int, compact=scan.compact_rows_plain):
    staged = stage_columns(cols, N, "cpu", block_rows=B)
    assert staged.num_blocks == 3 and staged.block_rows == B
    written = torch.zeros(1, dtype=torch.int32)
    bufs = [torch.zeros(limit, dtype=dt) for dt in (torch.int64, torch.int32, torch.float64)]
    for blk in range(staged.num_blocks):
        env = DeviceExecutor._block_env(staged, blk)
        mask = staged.mask[0, blk] & (env["resp_status"] >= 400)
        vals = [env["time_"], env["service"].to(torch.int32), env["latency"]]
        compact(mask, vals, written, bufs, limit)
    return int(written[0]), [b.numpy() for b in bufs]


@pytest.mark.parametrize("limit", [0, 1, 100, 399, 10_000],
                         ids=["limit-0", "limit-1", "in-first-block", "in-padded-block",
                              "past-every-survivor"])
def test_compact_rows_plain_matches_reference_program(limit):
    cols = _columns()
    survivors = np.flatnonzero(cols["resp_status"] >= 400)
    # 394 survivors in the first block, 10 in the last: 399 ends in the last.
    assert np.sum(survivors < B) == 394 and survivors.size == 404
    w_ref, bufs_ref = _reference_program_outputs(cols, limit)
    w, bufs = _port_compaction(cols, limit)
    assert w == w_ref == min(limit, survivors.size)
    for got, want in zip(bufs, bufs_ref):
        assert np.array_equal(got[:w], want[:w])
    assert np.array_equal(bufs[0][:w], survivors[:w] * 1000)
    assert np.array_equal(bufs[2][:w].view(np.int64), cols["latency"][survivors[:w]].view(np.int64))


# H12 (ops/kernels/scan_kernels.cu): a cooperative launch of ``grid``
# shares of ``share`` rows; each share's count is published in a status
# word tagged with the launch's epoch, a CTA sums the words of this epoch
# of the CTAs before it (a word of an earlier launch is not taken), copies
# its selected rows chunk by chunk from that prefix on, none at or past the
# limit; the last CTA's prefix and count set ``written``; in the index lane
# each CTA also reads the later CTAs' words and writes its slice of the
# padding. The model below does the same in numpy at any geometry.
def _h12_model(mask, cols, written, bufs, limit, grid, share, chunk=8192, words=None,
               epoch=1, index_out=None, pad=-1):
    mask = np.asarray(mask, bool)
    n = mask.shape[0]
    base = int(written[0]) if written is not None else 0
    if base >= limit:
        return
    words = np.zeros(grid, np.uint64) if words is None else words
    for b in range(grid):  # 1. every share publishes its count
        count = int(mask[b * share: min(n, (b + 1) * share)].sum())
        words[b] = np.uint64((epoch << 32) | count)

    def published(j0, j1):  # 2. the counts of this epoch's CTAs j0 <= j < j1
        tagged = [int(w) & 0xFFFFFFFF for w in words[j0:j1] if int(w) >> 32 == epoch]
        assert len(tagged) == j1 - j0
        return sum(tagged)

    total = published(0, grid)
    if written is not None:  # the last CTA's prefix and count
        written[0] = min(base + published(0, grid - 1) + int(words[grid - 1]) % (1 << 32), limit)
    for b in range(grid):  # 3. the copy, chunk by chunk
        lo, hi = b * share, min(n, (b + 1) * share)
        pos = base + published(0, b)
        for c0 in range(lo, hi, chunk):
            if pos >= limit:
                break
            rows = c0 + np.flatnonzero(mask[c0: min(hi, c0 + chunk)])
            take = min(rows.size, limit - pos)
            if index_out is not None:
                index_out[pos: pos + take] = rows[:take]
            for col, buf in zip(cols, bufs):
                buf[pos: pos + take] = col[rows[:take]]
            pos += rows.size
        if index_out is not None:  # 4. the CTA's slice of the padding
            filled = min(total, limit)
            per = -(-(limit - filled) // grid)
            index_out[filled + b * per: min(limit, filled + (b + 1) * per)] = pad


@pytest.mark.parametrize("n, sms, want", [
    (1 << 21, 132, (256, 8192)), (4_194_304, 132, (264, 15888)), (1, 132, (1, 16)),
    (5000, 132, (1, 5008)), (20_000, 132, (3, 6672)), (17, 1, (1, 32)),
    (3 * 8192 + 1, 1, (2, 12304)), (1 << 20, 8, (16, 65536)),
])
def test_h12_shares(n, sms, want):
    """H12's shares: at most two CTAs an SM and no more than the rows'
    8192-row chunks, shares a multiple of 16 rows, none empty."""
    grid, share = kernels.h12_shares(n, sms)
    assert (grid, share) == want
    assert share % kernels.SCAN_GROUP_ROWS == 0 and grid <= sms * kernels.SCAN_CTAS_PER_SM
    assert (grid - 1) * share < n <= grid * share
    assert grid <= -(-n // kernels.SCAN_CHUNK_ROWS)


def test_h12_constants_match_the_kernel_source():
    """The wrapper's mirrors of scan_kernels.cu's constants."""
    import os
    import re

    path = os.path.join(os.path.dirname(kernels.__file__), "scan_kernels.cu")
    with open(path) as f:
        src = f.read()
    const = dict(re.findall(r"constexpr int (k\w+) = (\d+);", src))
    assert int(const["kMaxScanCols"]) == kernels.SCAN_MAX_COLS
    assert int(const["kScanThreads"]) == kernels.SCAN_THREADS
    assert int(const["kGroup"]) == kernels.SCAN_GROUP_ROWS
    assert "kThreadRows = 2 * kGroup;" in src and "kChunk = kScanThreads * kThreadRows;" in src
    assert kernels.SCAN_THREADS * 2 * kernels.SCAN_GROUP_ROWS == kernels.SCAN_CHUNK_ROWS
    assert "probe: null or int64 [5]" in src and kernels.SCAN_PROBE == 5


def test_scan_epochs_tag_each_launch_and_zero_on_wrap(monkeypatch):
    """H12's status words: one buffer a (device, stream), zeroed when made,
    epochs 1, 2, ... a launch; at the wrap the buffer is zeroed again and
    the epochs start over; a larger request makes a new buffer."""
    epochs = kernels.ScanEpochs()
    cpu = torch.device("cpu")
    buf, e = epochs.take(cpu, (0, 7), 6)
    assert e == 1 and buf.shape == (6,) and not buf.any()
    buf.fill_(-1)  # a launch's words
    assert epochs.take(cpu, (0, 7), 6)[1] == 2
    other, e = epochs.take(cpu, (0, 8), 6)
    assert e == 1 and not other.any() and other.data_ptr() != buf.data_ptr()
    monkeypatch.setattr(kernels.ScanEpochs, "MAX_EPOCH", 3)
    assert epochs.take(cpu, (0, 7), 6)[1] == 3
    again, e = epochs.take(cpu, (0, 7), 6)
    assert e == 1 and again.data_ptr() == buf.data_ptr() and not buf.any()
    bigger, e = epochs.take(cpu, (0, 7), 12)
    assert e == 1 and bigger.shape == (12,) and not bigger.any()


@pytest.mark.parametrize("seed", range(3))
def test_h12_mask_bits_packing(seed):
    """H12's 16-byte mask loads become bits by __vcmpne4 (0xFF in each
    non-zero byte), a mask of one distinct bit a byte and a multiply that
    sums the four bytes into the top one: no carries, bit j for byte j."""
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 1 << 32, 4096, dtype=np.uint64)
    words[:16] = [0, 1, 0x100, 0x10000, 0x1000000, 0xFFFFFFFF, 0x80, 0x8000, 0x800000,
                  0x80000000, 0x01010101, 0x01000001, 0x00010100, 2, 0x200, 0x7F000000]
    for w in words.tolist():
        b = [(w >> (8 * j)) & 0xFF for j in range(4)]
        cmp = sum(0xFF << (8 * j) for j in range(4) if b[j])
        got = (((cmp & 0x08040201) * 0x01010101) & 0xFFFFFFFF) >> 24
        assert got == sum(1 << j for j in range(4) if b[j])


@pytest.mark.parametrize("geometry", ["kernel", "small"])
@pytest.mark.parametrize("limit", [0, 1, 100, 399, 10_000],
                         ids=["limit-0", "limit-1", "in-first-block", "in-padded-block",
                              "past-every-survivor"])
def test_h12_model_matches_reference_program(limit, geometry):
    """The share decomposition equals the plain compaction and the
    reference's scan program bit for bit over config 1-like blocks, at the
    kernel's geometry and at a small one (shares of 48 rows, chunks of 32:
    many shares, chunks and prefixes), with stale status words of an
    earlier launch in the buffer."""
    cols = _columns()
    rng = np.random.default_rng(limit)

    def model(mask, vals, written, bufs, lim):
        n = mask.shape[0]
        grid, share = kernels.h12_shares(n, 132) if geometry == "kernel" else (-(-n // 48), 48)
        words = (np.uint64(7) << np.uint64(32)) | rng.integers(0, 99, grid).astype(np.uint64)
        outs = [b.numpy() for b in bufs]
        _h12_model(mask.numpy(), [v.numpy() for v in vals], written.numpy(), outs, lim, grid,
                   share, 8192 if geometry == "kernel" else 32, words, epoch=8)

    w_ref, bufs_ref = _reference_program_outputs(cols, limit)
    w, bufs = _port_compaction(cols, limit, model)
    w_plain, bufs_plain = _port_compaction(cols, limit)
    assert w == w_ref == w_plain
    for got, want, plain in zip(bufs, bufs_ref, bufs_plain):
        assert np.array_equal(got[:w].view(np.uint8), want[:w].view(np.uint8))
        assert np.array_equal(got.view(np.uint8), plain.view(np.uint8))


@pytest.mark.parametrize("count, cap", [(0, 64), (1, 64), (700, 700), (700, 3077),
                                        (3000, 3100), (1200, 1000)],
                         ids=["none", "one", "count-at-cap", "cap-past-n", "all-cap-past-n",
                              "count-past-cap"])
@pytest.mark.parametrize("geometry", ["kernel", "small"])
def test_h12_index_lane_model_matches_reference(count, cap, geometry):
    """H12's index lane (the row indices, then ``n`` in every slot past the
    count, each CTA its slice of the padding) equals the reference's
    sentinel sort (pixie_tpu/ops/segment.py compact_unmatched_rows) and the
    plain version, at counts 0, 1 and at the cap, and caps past n."""
    rng = np.random.default_rng(count + cap)
    n = 3000
    mask = np.zeros(n, bool)
    mask[rng.choice(n, count, replace=False)] = True
    grid, share = kernels.h12_shares(n, 132) if geometry == "kernel" else (-(-n // 48), 48)
    out = np.full(cap, -7, np.int32)  # H12 writes every slot
    _h12_model(mask, [], None, [], cap, grid, share, 8192 if geometry == "kernel" else 32,
               index_out=out, pad=n)
    want = np.asarray(ref_segment.compact_unmatched_rows(jnp.asarray(mask), cap))
    assert np.array_equal(out, want)
    plain = scan.compact_indices_plain(torch.from_numpy(mask), cap)
    assert plain.dtype == torch.int32 and np.array_equal(plain.numpy(), want)
    assert torch.equal(scan.compact_indices(torch.from_numpy(mask), cap), plain)


def test_compact_rows_on_cpu_is_the_plain_version():
    cols = _columns()
    w, bufs = _port_compaction(cols, 399, scan.compact_rows)
    w2, bufs2 = _port_compaction(cols, 399)
    assert w == 399
    assert w == w2 and all(np.array_equal(a, b) for a, b in zip(bufs, bufs2))


def test_scan_lane_edge_limits_match_numpy():
    """The port's scan lane end to end on the same table: head(0) to past
    every survivor, strings back through the table's dictionary."""
    cols = _columns()
    survivors = np.flatnonzero(cols["resp_status"] >= 400)
    port = Carnot(device_executor=DeviceExecutor(device="cpu", block_rows=B))
    rel = Relation.of(("time_", DataType.TIME64NS), ("service", DataType.STRING),
                      ("resp_status", DataType.INT64), ("latency", DataType.FLOAT64))
    t = port.table_store.create_table("t", rel)
    d = t.dictionaries["service"]
    for i in range(16):
        d.get_code(f"svc-{i}")
    t.write_pydict({**cols, "service": DictColumn(cols["service"], d)})
    for limit in (0, 1, 100, 399, 10_000):
        got = port.execute_query(QUERY.format(limit=limit)).table("out")
        sel = survivors[:limit]
        if not sel.size:
            assert got == {}
            continue
        assert got["time_"] == (sel * 1000).tolist()
        assert got["service"] == [f"svc-{i}" for i in cols["service"][sel]]
        assert got["latency"] == cols["latency"][sel].tolist()


def _port_table(carnot) -> None:
    cols = _columns()
    rel = Relation.of(("time_", DataType.TIME64NS), ("service", DataType.STRING),
                      ("resp_status", DataType.INT64), ("latency", DataType.FLOAT64))
    t = carnot.table_store.create_table("t", rel)
    t.write_pydict({**cols, "service": DictColumn(cols["service"], t.dictionaries["service"])})


def test_scan_lane_bool_projection_matches_reference():
    """A BOOLEAN projection, carried through H12 as int32 0/1."""
    cols = _columns()
    query = (
        "df = px.DataFrame(table='t')\n"
        "df = df[df.resp_status >= 400]\n"
        "df.fatal = df.resp_status >= 500\n"
        "df = df[['time_', 'fatal']]\n"
        "df = df.head(300)\n"
        "px.display(df, 'out')\n"
    )
    ex = MeshExecutor(mesh=Mesh(np.array(jax.devices()[:1]), ("d",)), block_rows=B)
    ref = RefCarnot(device_executor=ex)
    rel = RefRelation.of(("time_", RefDT.TIME64NS), ("service", RefDT.STRING),
                         ("resp_status", RefDT.INT64), ("latency", RefDT.FLOAT64))
    t = ref.table_store.create_table("t", rel)
    t.write_pydict({**cols, "service": RefDictColumn(cols["service"], t.dictionaries["service"])})
    want = ref.execute_query(query).table("out")
    assert any(k.startswith("scan|") for k in ex._program_cache) and not ex.fallback_errors
    port_ex = DeviceExecutor(device="cpu", block_rows=B)
    port = Carnot(device_executor=port_ex)
    _port_table(port)
    got = port.execute_query(query).table("out")
    assert port_ex.last_fold_ms is not None
    assert got == want and len(got["time_"]) == 300 and 0 < sum(got["fatal"]) < 300


def test_scan_lane_constant_projection_matches_host_graph():
    """A constant column is a scalar broadcast over the block. (The
    reference's scan program cannot cast a Python scalar and sends such a
    query to its host engine; the port's host graph is the comparand.)"""
    query = (
        "df = px.DataFrame(table='t')\n"
        "df = df[df.resp_status >= 400]\n"
        "df.one = 1\n"
        "df = df[['time_', 'one']]\n"
        "df = df.head(300)\n"
        "px.display(df, 'out')\n"
    )
    port_ex = DeviceExecutor(device="cpu", block_rows=B)
    port, host = Carnot(device_executor=port_ex), Carnot()
    _port_table(port)
    _port_table(host)
    got = port.execute_query(query).table("out")
    assert port_ex.last_fold_ms is not None
    assert got == host.execute_query(query).table("out") and got["one"] == [1] * 300



def test_constant_projection_host_graph_matches_reference_host_engine():
    """Fault-10's chain to the reference: the port's host graph (a Carnot
    with no device executor), which the scan lane's constant projection is
    held against above, equals the reference's host engine for the same
    query, every column and row."""
    query = (
        "df = px.DataFrame(table='t')\n"
        "df = df[df.resp_status >= 400]\n"
        "df.one = 1\n"
        "df = df[['time_', 'one']]\n"
        "df = df.head(300)\n"
        "px.display(df, 'out')\n"
    )
    cols = _columns()
    ref = RefCarnot(device_executor=None)
    rel = RefRelation.of(("time_", RefDT.TIME64NS), ("service", RefDT.STRING),
                         ("resp_status", RefDT.INT64), ("latency", RefDT.FLOAT64))
    t = ref.table_store.create_table("t", rel)
    t.write_pydict({**cols, "service": RefDictColumn(cols["service"], t.dictionaries["service"])})
    host = Carnot()
    _port_table(host)
    want = ref.execute_query(query).table("out")
    got = host.execute_query(query).table("out")
    assert got == want and len(got["time_"]) == 300 and got["one"] == [1] * 300