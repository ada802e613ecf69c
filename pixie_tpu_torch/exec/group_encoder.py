"""GroupEncoder — densify group-by keys into stable int32 segment ids.

The reference hashes RowTuples into an absl flat_hash_map per batch
(src/carnot/exec/agg_node.cc HashRowBatch / row_tuple.h). The device fold
takes dense group ids, so group keys are densified host-side into dense,
stable gids that feed its segment reductions (pixie_tpu_torch/ops/segment.py;
a copy of pixie_tpu/exec/group_encoder.py, which imports no JAX). Vectorized: each
batch pays one np.unique over the key columns plus a dict probe per *new*
unique key — telemetry group keys (service, pod, endpoint) are vastly fewer
than rows.

Strings participate via their dictionary codes (already dense per table), so
the composite key is a small int matrix.
"""

from __future__ import annotations

import numpy as np

from pixie_tpu_torch.table.column import DictColumn


class GroupEncoder:
    def __init__(self):
        self._gids: dict[tuple, int] = {}
        # Per key column: list of values aligned with gid order (for
        # reconstructing the output key columns at finalize).
        self._key_rows: list[tuple] = []

    @property
    def num_groups(self) -> int:
        return len(self._key_rows)

    @staticmethod
    def _key_rows_of(key_cols: list) -> tuple[int, "np.ndarray", "np.ndarray"]:
        """(n, unique_rows, inverse) via one np.unique. Integer multi-keys
        whose shifted widths fit 63 bits pack into ONE int64 first —
        np.unique on a plain int64 is a radix-class sort, while the
        structured-record fallback is a comparison sort that costs minutes
        at 64M rows (the r4 config-3 cold-path hotspot). Mixed/wide keys
        keep the record path — stacking would upcast int64/float64 keys to
        float64 and collapse keys beyond 2^53."""
        arrs = [
            c.codes if isinstance(c, DictColumn) else np.asarray(c)
            for c in key_cols
        ]
        n = len(arrs[0])
        if n == 0:
            return 0, np.empty(0), np.empty(0, np.int64)
        if len(arrs) == 1:
            uniq, inverse = np.unique(arrs[0], return_inverse=True)
            rows = [(v,) for v in uniq.tolist()]
            return n, rows, inverse
        packed = GroupEncoder._pack_int_keys(arrs)
        if packed is not None:
            key, mins, widths = packed
            total_bits = sum(widths)
            if total_bits <= 24:
                # Small packed range: O(n) bincount + rank LUT beats the
                # sort inside np.unique by ~10x at 64M rows.
                counts = np.bincount(key, minlength=1 << total_bits)
                uniq = np.nonzero(counts)[0]
                rank = np.full(1 << total_bits, -1, np.int32)
                rank[uniq] = np.arange(len(uniq), dtype=np.int32)
                inverse = rank[key]
            else:
                uniq, inverse = np.unique(key, return_inverse=True)
            rows_cols = []
            rem = uniq
            for lo, w in zip(reversed(mins), reversed(widths)):
                rows_cols.append((rem & ((1 << w) - 1)) + lo)
                rem = rem >> w
            rows_cols.reverse()
            rows = list(zip(*(c.tolist() for c in rows_cols)))
        else:
            rec = np.rec.fromarrays(arrs)
            uniq, inverse = np.unique(rec, return_inverse=True)
            rows = [tuple(r.tolist()) for r in uniq]
        return n, rows, inverse

    @staticmethod
    def _pack_int_keys(arrs):
        """(packed int64 key, per-col mins, per-col bit widths) when every
        column is integral and the shifted widths fit 63 bits; else None."""
        if not all(np.issubdtype(a.dtype, np.integer) for a in arrs):
            return None
        mins, widths = [], []
        for a in arrs:
            lo = int(a.min())
            hi = int(a.max())
            rng = hi - lo
            mins.append(lo)
            widths.append(max(rng.bit_length(), 1))
        if sum(widths) > 63:
            return None
        key = np.zeros(len(arrs[0]), np.int64)
        for a, lo, w in zip(arrs, mins, widths):
            key = (key << w) | (a.astype(np.int64) - lo)
        return key, mins, widths

    def encode(self, key_cols: list) -> np.ndarray:
        """Map rows of the given key columns to gids, assigning new ids to
        unseen keys. Returns int32[n]."""
        if not key_cols:
            raise ValueError("encode requires at least one key column")
        n, rows, inverse = self._key_rows_of(key_cols)
        if n == 0:
            return np.empty(0, np.int32)
        uniq_gids = np.empty(len(rows), np.int32)
        for i, key in enumerate(rows):
            gid = self._gids.get(key)
            if gid is None:
                gid = len(self._key_rows)
                self._gids[key] = gid
                self._key_rows.append(key)
            uniq_gids[i] = gid
        return uniq_gids[inverse.ravel()].astype(np.int32, copy=False)

    def lookup(self, key_cols: list) -> np.ndarray:
        """Like encode but maps unseen keys to -1 (no assignment)."""
        n, rows, inverse = self._key_rows_of(key_cols)
        if n == 0:
            return np.empty(0, np.int32)
        uniq_gids = np.fromiter(
            (self._gids.get(key, -1) for key in rows),
            dtype=np.int32,
            count=len(rows),
        )
        return uniq_gids[inverse.ravel()].astype(np.int32, copy=False)

    def key_arrays(self) -> list[np.ndarray]:
        """Per key column, the values in gid order (int arrays; string key
        columns come back as their dictionary codes). Columns materialize
        individually so mixed key dtypes keep full width."""
        if not self._key_rows:
            return []
        ncols = len(self._key_rows[0])
        return [
            np.asarray([r[i] for r in self._key_rows])
            for i in range(ncols)
        ]

    def reset(self) -> None:
        self._gids.clear()
        self._key_rows.clear()
