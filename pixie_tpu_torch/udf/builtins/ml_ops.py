"""ML UDAs and UDFs: reservoir sampling, streaming k-means, k-means
prediction, the SentencePiece stand-in and the transformer embedding (ref:
pixie_tpu/udf/builtins/ml_ops.py; Pixie's ml_ops.h).

``reservoir_sample`` is a device UDA: its state is [G, 64] values and
priorities plus [G] counts on the fold's device (H25 and H26 on the card),
merged as a tree, finalized on the host into JSON. ``kmeans`` parses JSON
embeddings, so it is a host UDA (``string_args="values"`` keeps it off the
device lanes) whose state stays on the CPU (``host_state``: it is updated
row by row); only its finalize moves the [G, 128, 64] samples to the
engine's device, where Lloyd's runs (H27). ``kmeans_predict``,
``sentencepiece`` and ``transformer`` are HOST scalars; ``transformer``
embeds all of a batch's documents (or dictionary values) through one
forward on the engine's device (H28).
"""

from __future__ import annotations

import json

import numpy as np
import torch

from pixie_tpu_torch.ops import hashing, ml
from pixie_tpu_torch.table.column import fnv1a64_batch
from pixie_tpu_torch.types import DataType
from pixie_tpu_torch.udf.registry import Registry
from pixie_tpu_torch.udf.udf import UDA, Executor, MergeKind, ScalarUDF

F = DataType.FLOAT64
I = DataType.INT64
S = DataType.STRING

KMEANS_SAMPLE = 128  # per-group reservoir feeding Lloyd's
KMEANS_MAX_D = 64  # reference KMeansUDA default dimensionality
EMPTY_MODEL = '{"k":0,"centers":[]}'


def register(r: Registry) -> None:
    def reservoir_uda(arg_t):
        dtype = torch.int64 if arg_t == I else torch.float64
        return UDA(
            name="reservoir_sample",
            arg_types=(arg_t,),
            out_type=S,
            init=lambda g, device: ml.reservoir_init(g, device, dtype=dtype),
            update=lambda st, gids, col, mask=None: ml.reservoir_update(st, gids, col, mask),
            merge=ml.reservoir_merge,
            finalize=ml.reservoir_finalize,
            merge_kind=MergeKind.TREE,
            host_finalize=True,
            doc="Uniform sample of up to 64 values per group (ml_ops.h:145 "
            "ReservoirSampleUDA; priority-reservoir re-design, device-resident).",
        )

    for t in (I, F):
        r.register_uda(reservoir_uda(t))

    r.register_uda(
        UDA(
            name="kmeans",
            arg_types=(S, I),
            out_type=S,
            init=km_init,
            update=km_update,
            merge=km_merge,
            finalize=km_finalize,
            merge_kind=MergeKind.TREE,
            host_finalize=True,
            string_args="values",
            host_state=True,
            doc="Streaming k-means over JSON float-array embeddings (ml_ops.h:88 "
            "KMeansUDA): reservoir-sampled points, Lloyd's at finalize, JSON "
            "centers out.",
        )
    )
    r.register_scalar(
        ScalarUDF(
            "kmeans_predict",
            (S, S),
            I,
            kmeans_predict,
            Executor.HOST,
            dict_compatible=False,
            doc="Nearest kmeans-center index for a JSON embedding (ml_ops.h "
            "KMeansUDF::Transform).",
        )
    )
    r.register_scalar(
        ScalarUDF(
            "transformer",
            (S,),
            S,
            transformer_udf,
            Executor.HOST,
            dict_compatible=True,
            needs_device=True,
            doc="Sentence embedding from JSON token ids via the pooled "
            "transformer executor on the engine's device (ml_ops.h "
            "TransformerUDF, transformer_executor.h; model_pool.h borrow-pool "
            "semantics).",
        )
    )
    r.register_scalar(
        ScalarUDF(
            "sentencepiece",
            (S,),
            S,
            sentencepiece_udf,
            Executor.HOST,
            dict_compatible=True,
            doc="string -> JSON token ids (ml_ops.h SentencePieceUDF contract; "
            "hash-bucketed subwords stand in for the /sentencepiece.proto "
            "asset that does not ship in-tree).",
        )
    )


# -- kmeans: host UDA over JSON embedding strings ---------------------------------
def km_init(g: int, device=None) -> dict:
    """The state on ``device``: the AggNode passes the CPU (``host_state``),
    where ``km_update`` mutates it through numpy views."""
    return {
        "pts": torch.zeros((g, KMEANS_SAMPLE, KMEANS_MAX_D), dtype=torch.float32, device=device),
        "pri": torch.full((g, KMEANS_SAMPLE), -torch.inf, dtype=torch.float64, device=device),
        "count": torch.zeros(g, dtype=torch.int64, device=device),
        "k": torch.full((g,), -1, dtype=torch.int64, device=device),
        "d": torch.full((g,), -1, dtype=torch.int64, device=device),
    }


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def km_update(st: dict, gids, emb_col, k_col, mask=None) -> dict:
    """Reservoir-sample each row's embedding into its group, in place (the
    AggNode rebinds its state to the return value and nothing else aliases
    it). A row's priority mixes the FNV-1a hash of its text with hash64 of
    its stream index (count counts every row, like the reference's Update
    which increments before parsing)."""
    view = {key: v.numpy() for key, v in st.items()}  # CPU tensors: shared memory
    embs = np.atleast_1d(np.asarray(emb_col, dtype=object))
    gids = _np(gids)
    ks = _np(k_col)
    mask = None if mask is None else _np(mask)
    n = len(embs)
    salt = int(view["count"].sum())
    idx_h = hashing.hash64(torch.arange(salt, salt + n, dtype=torch.int64)).numpy().view(np.uint64)
    text_h = fnv1a64_batch([str(e) for e in embs])
    pri = ((text_h ^ idx_h) >> np.uint64(11)).astype(np.float64) / float(1 << 53)
    for i in range(n):
        if mask is not None and not mask[i]:
            continue
        g = int(gids[i])
        view["count"][g] += 1
        try:
            vec = np.asarray(json.loads(embs[i]), np.float32)
        except (ValueError, TypeError):
            continue
        d = min(len(vec), KMEANS_MAX_D)
        if view["k"][g] == -1:
            view["k"][g] = int(ks[i]) if np.ndim(ks) else int(ks)
            view["d"][g] = d
        slot = int(np.argmin(view["pri"][g]))
        if pri[i] > view["pri"][g][slot]:
            view["pri"][g][slot] = pri[i]
            view["pts"][g][slot] = 0.0
            view["pts"][g][slot, :d] = vec[:d]
    return st


def km_merge(a: dict, b: dict) -> dict:
    pts, pri = ml.topk_by_priority(a["pts"], b["pts"], a["pri"], b["pri"], KMEANS_SAMPLE)
    return {
        "pts": pts,
        "pri": pri,
        "count": a["count"] + b["count"],
        "k": torch.where(a["k"] >= 0, a["k"], b["k"]),
        "d": torch.where(a["d"] >= 0, a["d"], b["d"]),
    }


def km_finalize(st: dict, device) -> np.ndarray:
    """[G] JSON models {"k": k, "centers": [[...d floats]...]}: one Lloyd run
    per distinct k over the groups that asked for it, on ``device``."""
    pts = _np(st["pts"])
    pri = _np(st["pri"])
    karr = _np(st["k"])
    darr = _np(st["d"])
    out = np.full(pts.shape[0], EMPTY_MODEL, dtype=object)
    w = np.isfinite(pri).astype(np.float32)
    for k in np.unique(karr[karr > 0]):
        sel = np.nonzero(karr == k)[0]
        centers = ml.kmeans_fit(
            torch.from_numpy(np.ascontiguousarray(pts[sel])).to(device),
            torch.from_numpy(np.ascontiguousarray(w[sel])).to(device),
            int(k),
        ).cpu().numpy()
        for j, g in enumerate(sel):
            d = int(darr[g])
            out[g] = json.dumps({
                "k": int(k),
                "centers": [[round(float(x), 6) for x in c] for c in centers[j][:, :d]],
            })
    return out


# -- scalar UDFs -----------------------------------------------------------------
def kmeans_predict(emb, model_json) -> np.ndarray:
    """Nearest-center index of each JSON embedding under its JSON model; -1
    for a malformed or empty model or embedding."""
    embs = np.atleast_1d(np.asarray(emb, dtype=object))
    models = np.atleast_1d(np.asarray(model_json, dtype=object))
    out = np.empty(len(embs), np.int64)
    cache: dict = {}
    for i in range(len(embs)):
        m = models[i] if len(models) > 1 else models[0]
        if m not in cache:
            try:
                cache[m] = np.asarray(json.loads(m)["centers"], np.float32)
            except (ValueError, TypeError, KeyError):
                cache[m] = None  # malformed model: the same -1 sentinel
        centers = cache[m]
        if centers is None or centers.size == 0:
            out[i] = -1
            continue
        try:
            vec = np.asarray(json.loads(embs[i]), np.float32)
        except (ValueError, TypeError):
            out[i] = -1
            continue
        d = min(vec.shape[0], centers.shape[1])
        if d == 0:  # '[]' parses but carries no information
            out[i] = -1
            continue
        out[i] = ml.kmeans_assign(vec[:d], centers[:, :d])
    return out


def transformer_udf(docs, device=None) -> np.ndarray:
    """The embedding JSON of each document, all through one forward of a
    pooled executor on ``device`` (the engine's)."""
    from pixie_tpu_torch.ops.transformer import default_pool

    arr = np.atleast_1d(np.asarray(docs, dtype=object))
    out = np.empty(len(arr), dtype=object)
    with default_pool().get(device=device) as ex:
        out[:] = ex.execute_batch([str(d) for d in arr])
    return out


def sentencepiece_udf(texts) -> np.ndarray:
    from pixie_tpu_torch.ops.transformer import tokenize

    arr = np.atleast_1d(np.asarray(texts, dtype=object))
    out = np.empty(len(arr), dtype=object)
    for i, t in enumerate(arr):
        out[i] = tokenize(str(t))
    return out
