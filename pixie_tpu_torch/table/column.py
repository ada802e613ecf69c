"""Column representations.

Ref: src/shared/types/column_wrapper.h:49 (ColumnWrapper) — but where the
reference keeps strings as Arrow string arrays and hashes them row-at-a-time
in the engine, we dictionary-encode at ingest (write-side, off the query
critical path) so group-by keys and equality filters on strings become int32
ops on device. ``StringDictionary`` is append-only: codes are dense and stable
for the lifetime of a table, which makes them directly usable as segment ids
in TPU segment reductions (pixie_tpu_torch.ops.segment).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass

import numpy as np

# Optional native fast path (pixie_tpu/native): C++ dictionary encoder.
try:  # pragma: no cover - exercised when the native lib is built
    from pixie_tpu_torch.native import host_runtime as _native
except Exception:  # pragma: no cover
    _native = None


class StringDictionary:
    """Append-only string<->int32 dictionary.

    Thread-safe for concurrent encode (ingest) + read (query): the values list
    only ever grows, and lookups take the lock only on miss.
    """

    __slots__ = ("_values", "_index", "_lock", "_hashes", "_has_nul")

    def __init__(self, values: list[str] | None = None):
        self._values: list[str] = list(values) if values else []
        self._index: dict[str, int] = {v: i for i, v in enumerate(self._values)}
        self._lock = threading.Lock()
        self._hashes: np.ndarray = np.empty(0, dtype=np.uint64)
        # numpy's fixed-width U layout drops trailing NULs; once any such
        # value enters the dictionary, the native fast path would alias its
        # prefix — route around it permanently.
        self._has_nul = any("\x00" in v for v in self._values)

    def __len__(self) -> int:
        return len(self._values)

    def get_code(self, value: str) -> int:
        """Code for value, adding it if unseen."""
        code = self._index.get(value)
        if code is not None:
            return code
        with self._lock:
            code = self._index.get(value)
            if code is None:
                code = len(self._values)
                if "\x00" in value:
                    self._has_nul = True
                self._values.append(value)
                self._index[value] = code
            return code

    def lookup(self, value: str) -> int:
        """Code for value, -1 if unseen (used by equality filters on strings)."""
        return self._index.get(value, -1)

    def encode(self, values) -> np.ndarray:
        """Vectorized encode of an array/sequence of strings -> int32 codes."""
        arr = np.asarray(values, dtype=object)
        if _native is not None and len(arr) >= 1024 and not self._has_nul:
            # numpy's fixed-width U layout cannot represent trailing NULs;
            # such values (rare in telemetry) take the object-array path so
            # encode semantics never depend on batch size.
            u = arr.astype("U")
            total = int(np.fromiter(map(len, arr), np.int64, len(arr)).sum())
            u_ok = total == int(np.char.str_len(u).sum())
            if u_ok:
                # Native O(n) hash-map pass (the reference's write-side C++
                # analogue); appends unseen values under the lock so codes
                # stay dense + stable. _has_nul re-checked under the lock:
                # a concurrent get_code() may have admitted a NUL value
                # after the unlocked check above.
                with self._lock:
                    if self._has_nul:
                        u_ok = False
                    else:
                        codes, new_values = _native.encode_with_dict(
                            arr, self._values, u=u
                        )
                        for v in new_values:
                            # Append BEFORE indexing: lock-free readers
                            # must never see a code without its value.
                            self._values.append(v)
                            self._index[v] = len(self._values) - 1
                if u_ok:
                    return codes
        # Encode the unique values only, then broadcast back: telemetry string
        # columns (service/pod names, methods, paths) are extremely low-
        # cardinality relative to row count.
        uniq, inverse = np.unique(arr, return_inverse=True)
        uniq_codes = np.fromiter(
            (self.get_code(v) for v in uniq), dtype=np.int32, count=len(uniq)
        )
        return uniq_codes[inverse].astype(np.int32, copy=False)

    def decode(self, codes: np.ndarray) -> np.ndarray:
        values = np.asarray(self._values, dtype=object)
        out = np.empty(len(codes), dtype=object)
        valid = (codes >= 0) & (codes < len(values))
        out[valid] = values[codes[valid]]
        out[~valid] = ""
        return out

    def values(self) -> list[str]:
        return list(self._values)

    def content_hashes(self) -> np.ndarray:
        """Stable uint64 content hash per dictionary value (FNV-1a over
        utf-8), incrementally extended as the dictionary grows.

        Gathered through codes, this gives UDAs a dictionary-independent
        view of string identity — two agents (or two tables in a union)
        that encode the same string under different codes still agg into
        the same sketch bucket (ref: the reference hashes the string value
        itself via RowTuple/absl hash, src/carnot/exec/row_tuple.h)."""
        n = len(self._values)
        if len(self._hashes) < n:
            with self._lock:
                m = len(self._hashes)
                if m < n:
                    new = fnv1a64_batch(self._values[m:n])
                    self._hashes = np.concatenate([self._hashes, new])
        return self._hashes


def _fnv1a64(s: str) -> np.uint64:
    h = 0xCBF29CE484222325
    for b in s.encode("utf-8"):
        h = ((h ^ b) * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
    return np.uint64(h)


def fnv1a64_batch(strings) -> np.ndarray:
    """uint64 [n]: ``_fnv1a64`` of each string (the native batch when the
    host runtime loaded)."""
    if _native is not None:
        return _native.fnv1a64_batch(strings)
    return np.array([_fnv1a64(v) for v in strings], dtype=np.uint64)


@dataclass
class DictColumn:
    """A dictionary-encoded string column: int32 codes + shared dictionary."""

    codes: np.ndarray  # int32[n]
    dictionary: StringDictionary

    def __post_init__(self):
        self.codes = np.asarray(self.codes, dtype=np.int32)

    def __len__(self) -> int:
        return len(self.codes)

    def decode(self) -> np.ndarray:
        return self.dictionary.decode(self.codes)

    def take(self, indices) -> "DictColumn":
        return DictColumn(self.codes[indices], self.dictionary)

    def slice(self, start: int, stop: int) -> "DictColumn":
        return DictColumn(self.codes[start:stop], self.dictionary)


def concat_dict_columns(cols: list[DictColumn]) -> DictColumn:
    dicts = {id(c.dictionary) for c in cols}
    if len(dicts) != 1:
        # Re-encode into the first column's dictionary (rare: cross-table
        # unions). Codes are remapped through the string values.
        base = cols[0].dictionary
        parts = [cols[0].codes]
        for c in cols[1:]:
            parts.append(base.encode(c.decode()))
        return DictColumn(np.concatenate(parts), base)
    return DictColumn(np.concatenate([c.codes for c in cols]), cols[0].dictionary)
