"""Sketch UDAs of the port: ``quantiles`` (log histogram),
``quantiles_tdigest``, ``approx_count_distinct`` (HyperLogLog) and
``count_min``.

Counterpart of pixie_tpu/udf/builtins/sketch_ops.py, with the same merge
kinds (PSUM, TREE, PMAX, PSUM) and output formats. Quantile finalize emits
the JSON string {"p01":..,"p10":..,"p25":..,"p50":..,"p75":..,"p90":..,
"p99":..} (``.6g``) with ST_QUANTILES semantics, so
`px.pluck_float64(col, 'p50')` keeps working downstream; count-min emits
{"total":..,"depth":4,"width":8192,"max_est":..}.

The STRING overloads of approx_count_distinct and count_min take each
string's content hash (``string_args="hash"``): the device fold gathers it
through a per-dictionary LUT (``arghash:<col>``), the host AggNode from the
dictionary's ``content_hashes``; both then hash it as an int64 value.
"""

from __future__ import annotations

import numpy as np
import torch

from pixie_tpu_torch.ops import countmin, histogram, hll, tdigest
from pixie_tpu_torch.types import DataType, SemanticType
from pixie_tpu_torch.udf.registry import Registry
from pixie_tpu_torch.udf.udf import UDA, MergeKind

F = DataType.FLOAT64
I = DataType.INT64
S = DataType.STRING

QUANTILE_KEYS = ("p01", "p10", "p25", "p50", "p75", "p90", "p99")
QUANTILE_QS = (0.01, 0.10, 0.25, 0.50, 0.75, 0.90, 0.99)


def _quantile_semantic(sems):
    if sems and sems[0] in (
        SemanticType.ST_DURATION_NS,
        SemanticType.ST_TIME_NS,
    ):
        return SemanticType.ST_DURATION_NS_QUANTILES
    return SemanticType.ST_QUANTILES


def _format_quantiles(qv: np.ndarray) -> np.ndarray:
    """[G, 7] quantile values -> JSON strings (host finalize)."""
    out = np.empty(qv.shape[0], dtype=object)
    for g in range(qv.shape[0]):
        out[g] = (
            "{"
            + ",".join(
                f'"{k}":{float(qv[g, i]):.6g}' for i, k in enumerate(QUANTILE_KEYS)
            )
            + "}"
        )
    return out


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def register(r: Registry) -> None:
    r.register_uda(
        UDA(
            name="quantiles",
            arg_types=(F,),
            out_type=S,
            init=lambda g, device: histogram.init(g, device),
            update=lambda st, gids, col, mask=None: histogram.update(
                st, gids, col, mask
            ),
            merge=histogram.merge,
            finalize=lambda st: _format_quantiles(
                _to_numpy(histogram.quantile_values(st, QUANTILE_QS))
            ),
            device_finalize=lambda st: histogram.quantile_values(
                st, QUANTILE_QS
            ),
            format_output=_format_quantiles,
            merge_kind=MergeKind.PSUM,
            out_semantic=_quantile_semantic,
            host_finalize=True,
            stage_f32_ok=True,  # log-bin assignment is way coarser than f32
            doc=(
                "Approximate p01..p99 via a log-binned histogram sketch "
                "(DDSketch-style; ~1.4% relative error; psum-mergeable)."
            ),
        )
    )

    r.register_uda(
        UDA(
            name="quantiles_tdigest",
            arg_types=(F,),
            out_type=S,
            init=lambda g, device: tdigest.init(g, device),
            update=lambda st, gids, col, mask=None: tdigest.update(
                st, gids, col, mask
            ),
            merge=tdigest.merge,
            finalize=lambda st: _format_quantiles(
                _to_numpy(tdigest.quantile_values(st, QUANTILE_QS))
            ),
            device_finalize=lambda st: tdigest.quantile_values(st, QUANTILE_QS),
            format_output=_format_quantiles,
            merge_kind=MergeKind.TREE,
            out_semantic=_quantile_semantic,
            host_finalize=True,
            stage_f32_ok=True,  # centroid means/weights are f32 already
            doc="Approximate p01..p99 via a static-shape merging t-digest.",
        )
    )

    for t in (I, F, S):  # strings arrive as their content hashes
        r.register_uda(
            UDA(
                name="approx_count_distinct",
                arg_types=(t,),
                out_type=I,
                init=lambda g, device: hll.init(g, device),
                update=lambda st, gids, col, mask=None: hll.update(
                    st, gids, col, mask
                ),
                merge=hll.merge,
                narrow_args=True,  # H5 hashes a narrowed column as staged
                # The int-dictionary cell lane: the pipeline routes only
                # INT64 columns here, so the LUT hashes as the row path's
                # values do.
                cell_update=hll.cell_update,
                finalize=hll.estimate_rounded,
                merge_kind=MergeKind.PMAX,
                doc=(
                    "Approximate distinct count via HyperLogLog (2048 "
                    "registers, ~2.3% error; pmax-mergeable)."
                ),
            )
        )

    for t in (I, S):
        r.register_uda(_countmin_uda(t))


def _countmin_uda(arg_t) -> UDA:
    return UDA(
        name="count_min",
        arg_types=(arg_t,),
        out_type=S,
        init=lambda g, device: {
            "cm": countmin.init(g, device),
            "total": torch.zeros((g,), dtype=torch.int64, device=device),
        },
        update=_countmin_update,
        merge=lambda a, b: {
            "cm": countmin.merge(a["cm"], b["cm"]),
            "total": a["total"] + b["total"],
        },
        cell_update=_countmin_cell_update,
        narrow_args=arg_t == I,  # H6 hashes a narrowed column as staged
        finalize=lambda st: _format_cm_totals(
            _to_numpy(_countmin_totals(st))
        ),
        device_finalize=_countmin_totals,
        format_output=_format_cm_totals,
        merge_kind=MergeKind.PSUM,
        host_finalize=True,
        doc=(
            "Count-min frequency sketch (4x8192; psum-mergeable). "
            "Finalize emits sketch metadata JSON."
        ),
    )


def _countmin_update(st, gids, col, mask=None) -> dict:
    cm, total = countmin.update_counted(st["cm"], st["total"], gids, col, mask)
    return {"cm": cm, "total": total}


def _countmin_cell_update(st, hist, lut) -> dict:
    cm, total = countmin.cell_update_counted(st["cm"], st["total"], hist, lut)
    return {"cm": cm, "total": total}


def _countmin_totals(st) -> torch.Tensor:
    """int64 [G, 2]: (total, max_est), max_est the largest cell of the
    group's sketch (0 for an empty group)."""
    cm = st["cm"]
    return torch.stack([st["total"], cm.reshape(cm.shape[0], -1).amax(dim=1)], dim=1)


def _format_cm_totals(arr) -> np.ndarray:
    """[G, 2] (total, max_est) -> metadata JSON (depth/width are static)."""
    arr = np.asarray(arr)
    out = np.empty(arr.shape[0], dtype=object)
    for g in range(arr.shape[0]):
        out[g] = (
            f'{{"total":{int(arr[g, 0])},"depth":{countmin.DEFAULT_DEPTH},'
            f'"width":{countmin.DEFAULT_WIDTH},"max_est":{int(arr[g, 1])}}}'
        )
    return out
