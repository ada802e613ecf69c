"""The predicate-batched fold's two reductions (K16): per-slot masks from a
term table, and the sum family's segment sums over a slot axis.

Counterpart of the batched branch of the reference's scan body
(pixie_tpu/parallel/pipeline.py:5539-5600, built by ``_build_batched_fold``
:6655), which serves B concurrent queries with one scan of the staged
blocks: each query (a slot) has its conjunctive predicate terms in a
(B, T) table (==, !=, <, <=, >, >= against a threshold, op 6 IN-list
membership through a (B, T, L) LUT lane), every slot's mask is the AND of
its terms, and the state updates vmap over the slot axis. The reference
materializes (B, T, rows) gathers and a (B, T, L, rows) compare; here a
block is read once for every slot:

- ``slot_masks``: one uint32 of slot bits a row (bit s: the row passes the
  block mask and every term of slot s). H22 ``pred_slot_masks`` on a CUDA
  tensor, ``slot_masks_plain`` on a CPU one. H22 runs the table as
  ``compile_terms`` compiles it on the host: each distinct term once a row,
  with the slots that contain it (``need``), so that a row's bits are
  ``base ? slot_on & ~OR{need[u] : term u false} : 0``.
- ``batched_segment_sums``: for every slot, the per-group sums of R integer
  rows and F f64 rows (each as the fold staged it) over the rows whose bit
  s is set, plus the slot's presence (its row count) per group. H23
  ``batched_segment_sums`` on a CUDA tensor, ``batched_segment_sums_plain``
  on a CPU one.

The plain versions are the serial fold's own reductions applied slot by
slot (``segment_rows_sum_i64_plain`` and ``segment_sum_f64_plain`` under
each slot's mask), so on the CPU a batched fold adds the same rows in the
same order as each query folded alone: bit for bit the serial results.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pixie_tpu_torch.ops import kernels, segment
from pixie_tpu_torch.ops.segment import segment_rows_sum_i64_plain, segment_sum_f64_plain

# H22's limits: a row's slot bits are one uint32; a slot's terms and the
# batch's distinct term columns sit in the kernel's shared memory and
# parameter block.
MAX_SLOTS = kernels.PRED_MAX_SLOTS
MAX_TERMS = kernels.PRED_MAX_TERMS
MAX_COLS = kernels.PRED_MAX_COLS

# H22's program (``compile_terms``): the words of one distinct term, its op
# codes, the forms of its membership lists and the shared-memory budget of
# the lists (batch_kernels.cu kProgWords, the Code and ListForm enums,
# kListSharedWords).
PROG_WORDS = kernels.PRED_PROG_WORDS
CODE_IN = 6  # int stack, op 6: membership; 0-5 int compares; 8 + op float compares
CODE_FLOAT = 8
LIST_GLOBAL, LIST_SORTED, LIST_BITMAP = 0, 1, 2
LIST_FORMS = ("global", "sorted", "bitmap")
LIST_SHARED_WORDS = kernels.PRED_LIST_SHARED_WORDS
BITMAP_MAX_SPAN = 1 << 16  # bits of the widest bitmap list

# Fields of one term row (int64 each): the column's index in
# ``TermTable.columns``, the stack (0 int64, 1 float64), the op (0 ==, 1 !=,
# 2 <, 3 <=, 4 >, 5 >=, 6 IN; -1 an inactive pad term), the int64 threshold,
# the f64 threshold's bits, and the offset and length of its sorted member
# list in ``TermTable.lut``.
TERM_WORDS = 7


def _pow2(n: int) -> int:
    c = 1
    while c < n:
        c <<= 1
    return c


@dataclasses.dataclass
class TermProgram:
    """H22's form of a term table: its distinct active terms, sorted by
    column (``terms`` int64 [U, PROG_WORDS]: the column, the code (0-5 an
    int compare, 6 IN, 8 + op a float compare), the threshold (int64, or the
    f64's bits), the list's form, word offset in ``lists``, length (members,
    or the bitmap's span in bits) and lowest member, and ``need``, the
    uint32 of the slots that hold the term), and their distinct membership
    lists in ``lists`` (int64 words; the first ``shared_words`` go to
    shared memory: bitmaps of span <= BITMAP_MAX_SPAN and sorted lists while
    they fit LIST_SHARED_WORDS, the rest stay sorted in global memory).
    ``forms`` names each distinct list's form, in ``lists``' order."""

    terms: torch.Tensor
    lists: torch.Tensor
    shared_words: int
    forms: list

    @property
    def num_terms(self) -> int:
        return self.terms.shape[0]

    def to(self, device) -> "TermProgram":
        return dataclasses.replace(self, terms=self.terms.to(device), lists=self.lists.to(device))


@dataclasses.dataclass
class TermTable:
    """One batch's predicate terms as data: ``terms`` int64 [B * T,
    TERM_WORDS] (slot s's term t at row s * T + t), ``lut`` int64
    [B * T * L] (term (s, t)'s members from offset (s * T + t) * L), the
    distinct term ``columns`` and ``slot_on``, a bit per real slot. B, T and
    L are padded to powers of two as the reference pads them
    (pixie_tpu/parallel/pipeline.py:6902-6936). ``prog`` is the table as
    H22 runs it (``compile_terms``)."""

    columns: list
    terms: torch.Tensor
    lut: torch.Tensor
    B: int
    T: int
    L: int
    slot_on: int
    prog: TermProgram = None  # H22's form of the table, filled by build_term_table

    def to(self, device) -> "TermTable":
        return dataclasses.replace(
            self, terms=self.terms.to(device), lut=self.lut.to(device),
            prog=self.prog.to(device),
        )


def fits(slot_terms: list) -> bool:
    """Whether one term table can hold these slots' terms."""
    cols = {t[1] for terms in slot_terms for t in terms}
    return (
        len(slot_terms) <= MAX_SLOTS
        and all(len(terms) <= MAX_TERMS for terms in slot_terms)
        and len(cols) <= MAX_COLS
    )


def split_batch(slot_terms: list) -> list:
    """The slots in runs of consecutive indices whose terms fit one term
    table each (``fits``): every run is one scan."""
    runs, cur = [], []
    for s, terms in enumerate(slot_terms):
        if cur and not fits([slot_terms[i] for i in cur] + [terms]):
            runs.append(cur)
            cur = []
        cur.append(s)
    if cur:
        runs.append(cur)
    return runs


def build_term_table(slot_terms: list, block_dtypes: dict) -> TermTable:
    """The term table of ``slot_terms`` (one list of normalized terms
    ``(stack, column, op, int_thr, flt_thr, in_vals)`` a slot) on the host.
    ``block_dtypes`` maps each staged column to its numpy dtype: a term's
    stack must be its column's (int64 for int, bool and code blocks,
    float64 for float blocks), else ValueError."""
    if not fits(slot_terms):
        raise ValueError(
            f"term table: {len(slot_terms)} slots (at most {MAX_SLOTS}), at most "
            f"{MAX_TERMS} terms a slot and {MAX_COLS} distinct columns"
        )
    columns = sorted({t[1] for terms in slot_terms for t in terms})
    col_idx = {c: i for i, c in enumerate(columns)}
    B = _pow2(len(slot_terms))
    T = _pow2(max([len(terms) for terms in slot_terms] + [1]))
    L = _pow2(max([len(t[5]) for terms in slot_terms for t in terms] + [1]))
    terms_np = np.zeros((B * T, TERM_WORDS), np.int64)
    terms_np[:, 2] = -1
    lut = np.zeros(B * T * L, np.int64)
    slot_on = 0
    for s, terms in enumerate(slot_terms):
        slot_on |= 1 << s
        for t, (stack, col, op, thr_i, thr_f, in_vals) in enumerate(terms):
            is_float = np.dtype(block_dtypes[col]).kind == "f"
            if (stack == "f") != is_float:
                raise ValueError(f"term on {col}: stack {stack!r} against a "
                                 f"{np.dtype(block_dtypes[col])} block")
            row = s * T + t
            members = np.unique(np.asarray(in_vals, np.int64))
            lut[row * L : row * L + len(members)] = members
            terms_np[row] = (
                col_idx[col], int(stack == "f"), op, thr_i,
                np.float64(thr_f).view(np.int64), row * L, len(members),
            )
    table = TermTable(
        columns=columns, terms=torch.from_numpy(terms_np), lut=torch.from_numpy(lut),
        B=B, T=T, L=L, slot_on=slot_on,
    )
    table.prog = compile_terms(table)
    return table


def _code(stack: int, op: int) -> int:
    """A term's code as the plain version evaluates it (``_cmp``: an op
    past 4 compares >=; op 6 tests membership on the int stack only)."""
    if stack:
        return CODE_FLOAT + min(op, 5)
    return CODE_IN if op == 6 else min(op, 5)


def compile_terms(table: TermTable) -> TermProgram:
    """The distinct active terms of ``table`` (a term of a slot in
    ``slot_on`` whose op is not -1) with the slots that hold each, sorted
    by column, and their distinct membership lists laid out by form (see
    ``TermProgram``). Two terms are one when their column, code and
    threshold bits or member lists are equal."""
    rows = table.terms.cpu().numpy()
    lut = table.lut.cpu().numpy()
    index: dict = {}  # the term's key -> [column, code, threshold, list key, need]
    for s in range(table.B):
        if not (table.slot_on >> s) & 1:
            continue
        for col, stack, op, thr_i, thr_f, off, ln in rows[s * table.T : (s + 1) * table.T]:
            if op < 0:
                continue
            code = _code(int(stack), int(op))
            members = tuple(lut[off : off + ln].tolist()) if code == CODE_IN else None
            thr = 0 if members is not None else int(thr_f if stack else thr_i)
            key = (int(col), code, thr, members)
            if key not in index:
                index[key] = [int(col), code, thr, members, 0]
            index[key][4] |= 1 << s
    entries = sorted(index.values(), key=lambda e: e[0])  # stable: first-seen order a column
    lists: dict = {}  # members -> (form, members)
    for e in entries:
        if e[3] is not None and e[3] not in lists:
            lists[e[3]] = None
    budget = LIST_SHARED_WORDS
    for members in lists:  # bitmaps and sorted lists into shared memory while they fit
        span = members[-1] - members[0] + 1 if members else 0
        bitmap_words = -(-span // 64)
        if members and span <= BITMAP_MAX_SPAN and bitmap_words <= budget:
            lists[members], budget = LIST_BITMAP, budget - bitmap_words
        elif len(members) <= budget:
            lists[members], budget = LIST_SORTED, budget - len(members)
        else:
            lists[members] = LIST_GLOBAL
    words: list = []
    place: dict = {}  # members -> (form, word offset, length, lowest member)
    for shared in (True, False):
        for members, form in lists.items():
            if (form != LIST_GLOBAL) != shared:
                continue
            if form == LIST_BITMAP:
                span = members[-1] - members[0] + 1
                bitmap = np.zeros(-(-span // 64), np.uint64)
                at = np.asarray(members, np.int64) - members[0]
                np.bitwise_or.at(bitmap, at >> 6, np.uint64(1) << (at & 63).astype(np.uint64))
                place[members] = (form, len(words), span, members[0])
                words.extend(bitmap.view(np.int64).tolist())
            else:
                place[members] = (form, len(words), len(members),
                                  members[0] if members else 0)
                words.extend(members)
        if shared:
            shared_words = len(words)
    terms = np.zeros((len(entries), PROG_WORDS), np.int64)
    for u, (col, code, thr, members, need) in enumerate(entries):
        form, off, length, lo = place[members] if members is not None else (0, 0, 0, 0)
        terms[u] = (col, code, thr, form, off, length, lo, need)
    return TermProgram(
        terms=torch.from_numpy(terms), lists=torch.from_numpy(np.asarray(words, np.int64)),
        shared_words=shared_words, forms=[LIST_FORMS[f] for f in lists.values()],
    )


def _cmp(op: int, v: torch.Tensor, thr) -> torch.Tensor:
    if op == 0:
        return v == thr
    if op == 1:
        return v != thr
    if op == 2:
        return v < thr
    if op == 3:
        return v <= thr
    if op == 4:
        return v > thr
    return v >= thr


def _widen(col: torch.Tensor, offset: int) -> torch.Tensor:
    """A term column as its stack holds it: a float block as float64 (exact
    from f32), any other block as int64 plus its frame-of-reference offset
    (wrapping, as the serial fold widens it)."""
    if col.dtype.is_floating_point:
        return col.to(torch.float64)
    return col.to(torch.int64) + offset


def slot_masks_plain(
    cols: list, offsets: list, base: torch.Tensor, table: TermTable
) -> torch.Tensor:
    """Plain version of H22: int32 [n] holding each row's uint32 slot bits.
    Bit s is set where ``base`` holds, s is a real slot and every active
    term of slot s holds, compared as torch compares (IEEE: NaN is unequal
    to everything, -0.0 == +0.0)."""
    vals = [_widen(c, int(o)) for c, o in zip(cols, offsets)]
    terms = table.terms.cpu().numpy()
    lut = table.lut.to(base.device)
    bits = torch.zeros(base.shape[0], dtype=torch.int64, device=base.device)
    for s in range(table.B):
        if not (table.slot_on >> s) & 1:
            continue
        ok = base.clone()
        for col, stack, op, thr_i, thr_f, off, ln in terms[s * table.T : (s + 1) * table.T]:
            if op < 0:
                continue
            v = vals[col]
            if stack:
                ok &= _cmp(int(op), v, float(np.int64(thr_f).view(np.float64)))
            elif op == 6:
                ok &= torch.isin(v, lut[off : off + ln])
            else:
                ok &= _cmp(int(op), v, int(thr_i))
        bits |= ok.to(torch.int64) << s
    # The uint32 bit pattern as int32 (torch has no uint32 arithmetic).
    return torch.where(bits >= 1 << 31, bits - (1 << 32), bits).to(torch.int32)


def slot_masks(
    cols: list, offsets: list, base: torch.Tensor, table: TermTable
) -> torch.Tensor:
    """int32 [n]: each row's uint32 slot bits (``slot_masks_plain``'s
    contract). ``cols`` are ``table.columns``' blocks as staged (uint8,
    uint16, int32 or int64 with ``offsets``, bool, f32, f64). H22 on CUDA
    runs ``table.prog``."""
    if base.is_cuda:
        prog = table.prog
        return kernels.pred_slot_masks(
            [c.contiguous() for c in cols], [int(o) for o in offsets], base.contiguous(),
            prog.terms, prog.lists, prog.shared_words, table.slot_on,
        )
    return slot_masks_plain(cols, offsets, base, table)


def _stack(rows, dtype: torch.dtype, n: int, device) -> torch.Tensor:
    """[R, n] of ``dtype``: a tensor of rows as it is, or each staged row (a
    tensor or a ``segment.Narrow``) widened (its value plus its offset)."""
    if isinstance(rows, torch.Tensor):
        return rows
    rows = list(rows)
    if not rows:
        return torch.empty((0, n), dtype=dtype, device=device)
    return torch.stack([segment.widen(r).to(dtype) for r in rows])


def batched_segment_sums_plain(
    irows, frows, gids: torch.Tensor, bits: torch.Tensor, B: int, num_segments: int,
) -> tuple:
    """Plain version of H23: (int64 [B, R + 1, S], f64 [B, F, S]). For slot
    s: row r < R of the int64 block is integer row r's per-segment sum over
    the rows whose bit s is set (mod 2^64), row R their count; the f64
    block holds the f64 rows' sums. ``irows`` and ``frows`` as
    ``batched_segment_sums`` takes them, widened. Each slot is the serial
    reductions under the slot's mask."""
    n, device = gids.shape[0], gids.device
    irows = _stack(irows, torch.int64, n, device)
    frows = _stack(frows, torch.float64, n, device)
    R, F = irows.shape[0], frows.shape[0]
    out_i = torch.zeros((B, R + 1, num_segments), dtype=torch.int64, device=device)
    out_f = torch.zeros((B, F, num_segments), dtype=torch.float64, device=device)
    for s in range(B):
        m = slot_mask(bits, s)
        out_i[s] = segment_rows_sum_i64_plain(irows, gids, m, num_segments)
        for f in range(F):
            out_f[s, f] = segment_sum_f64_plain(frows[f], gids, m, num_segments)
    return out_i, out_f


def _staged_pairs(rows, kinds, wide: torch.dtype) -> list:
    """(tensor, offset) of each row as H23 reads it: a tensor of rows by
    rows; a ``segment.Narrow`` as it lies with its offset; a dtype H23 does
    not read as ``wide``."""
    pairs = []
    for r in rows:
        if isinstance(r, segment.Narrow):
            pairs.append((r.values.contiguous(), r.offset))
        elif r.dtype in kinds:
            pairs.append((r.contiguous(), 0))
        else:
            pairs.append((r.to(wide).contiguous(), 0))
    return pairs


def batched_segment_sums(
    irows, frows, gids: torch.Tensor, bits: torch.Tensor, B: int, num_segments: int,
) -> tuple:
    """(int64 [B, R + 1, S], f64 [B, F, S]): the sum family of B slots in
    one pass over the rows (``batched_segment_sums_plain``'s contract).
    ``irows``: integer rows, an int64 [R, n] tensor or R staged rows (an
    integer or bool tensor, or a ``segment.Narrow``); ``frows``: f64 rows,
    an f64 [F, n] tensor or F rows (f64, or an integer, bool or narrowed
    row summed as f64). H23 on CUDA reads each row where it lies; in its
    slot lane (``kernels.h23_lane``) the f64 sums are the same bits every
    run."""
    gids = gids.to(torch.int32)
    if gids.is_cuda:
        return kernels.batched_segment_sums(
            _staged_pairs(irows, kernels.SUM_ROW_KINDS, torch.int64),
            _staged_pairs(frows, kernels.H2_KINDS, torch.float64),
            gids.contiguous(), bits.contiguous(), B, num_segments,
        )
    return batched_segment_sums_plain(irows, frows, gids, bits, B, num_segments)


def slot_mask(bits: torch.Tensor, s: int) -> torch.Tensor:
    """Slot ``s``'s bool mask from the slot bits."""
    return ((bits >> s) & 1).to(torch.bool)


def term_columns(staged, table: TermTable, blk: int) -> tuple:
    """(blocks as staged, offsets) of the table's columns in block ``blk``."""
    cols = [staged.blocks[c][0, blk] for c in table.columns]
    return cols, [int(staged.narrow_offsets.get(c, 0)) for c in table.columns]

