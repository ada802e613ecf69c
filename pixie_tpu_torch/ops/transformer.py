"""Transformer sentence-embedding executor and model pool (ref:
pixie_tpu/ops/transformer.py; Pixie's transformer_executor.h and
model_pool.h).

A JSON token-id array (at most 64 tokens) becomes a unit-norm embedding of
64 floats, serialized as JSON: a 2-layer encoder (d 64, 4 heads, MLP 256,
vocabulary 32768) with the reference's deterministic seeded weights
(``_init_params``, numpy: the same arrays from the same seed), and
``params_from_reference`` carries the reference's own parameter pytree
across. ``TransformerEncoder`` holds the weights on an explicit device; its
forward is H28 (``kernels.encoder_forward``: the documents' real rows packed
into tiles of whole documents, both layers in one launch) on the card and
``encoder_forward_plain`` on the CPU. The plain version multiplies per
document (``torch.bmm`` over the documents), so a document's embedding does
not depend on the batch it rides in.

``tokenize`` stands in for SentencePiece with hash-bucketed 4-character
shingles. ``ModelPool`` lends executors keyed by type and device.
"""

from __future__ import annotations

import json
import math
import threading
from typing import Optional

import numpy as np
import torch

from pixie_tpu_torch.device import resolve_device
from pixie_tpu_torch.ops import kernels
from pixie_tpu_torch.table.column import _fnv1a64

MAX_LENGTH = 64  # ref: transformer_executor.h max_length_
VOCAB = 32768
D_MODEL = 64
N_HEADS = 4
N_LAYERS = 2
D_FF = 4 * D_MODEL
LAYER_KEYS = ("wq", "wk", "wv", "wo", "w1", "w2", "ln1", "ln2")


def _init_params(seed: int = 0) -> dict:
    """The reference's seeded weights, as numpy arrays (the same draws in the
    same order)."""
    rng = np.random.default_rng(seed)

    def w(*shape):
        return rng.normal(0, 1.0 / math.sqrt(shape[-1]), shape).astype(np.float32)

    params = {"embed": w(VOCAB, D_MODEL), "pos": w(MAX_LENGTH, D_MODEL), "layers": []}
    for _ in range(N_LAYERS):
        params["layers"].append({
            "wq": w(D_MODEL, D_MODEL),
            "wk": w(D_MODEL, D_MODEL),
            "wv": w(D_MODEL, D_MODEL),
            "wo": w(D_MODEL, D_MODEL),
            "w1": w(D_MODEL, D_FF),
            "w2": w(D_FF, D_MODEL),
            "ln1": np.ones(D_MODEL, np.float32),
            "ln2": np.ones(D_MODEL, np.float32),
        })
    return params


def params_from_reference(params: dict) -> dict:
    """The port's weights from the reference's parameter pytree (its arrays
    as numpy or anything ``np.asarray`` takes): float32 numpy arrays in the
    same structure, which ``TransformerEncoder`` and ``load_params`` take."""
    return {
        "embed": np.asarray(params["embed"], np.float32),
        "pos": np.asarray(params["pos"], np.float32),
        "layers": [
            {key: np.asarray(lp[key], np.float32) for key in LAYER_KEYS}
            for lp in params["layers"]
        ],
    }


def pack_layer(lp: dict) -> np.ndarray:
    """One layer's weights as the flat f32 vector H28 reads: wq, wk, wv, wo,
    w1, w2, ln1, ln2, each row-major."""
    return np.concatenate([np.asarray(lp[key], np.float32).reshape(-1) for key in LAYER_KEYS])


class TransformerEncoder(torch.nn.Module):
    """The encoder's weights on ``device``: ``embed`` [V, 64], ``pos`` [64,
    64] and ``layers`` [n_layers, pack_layer's length]."""

    def __init__(self, params: dict, device):
        super().__init__()
        self.device = torch.device(device)
        self.register_buffer("embed", torch.from_numpy(np.array(params["embed"], np.float32)))
        self.register_buffer("pos", torch.from_numpy(np.array(params["pos"], np.float32)))
        self.register_buffer(
            "layers", torch.from_numpy(np.stack([pack_layer(lp) for lp in params["layers"]]))
        )
        self.to(self.device)

    def forward(self, ids: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
        """f32 [B, 64] embeddings of ``ids`` int32 [B, 64] (shifted, pad 0)
        with ``lens`` int32 [B] real tokens each: H28 on the card, else the
        plain version."""
        if ids.is_cuda:
            return kernels.encoder_forward(
                ids.contiguous(), lens.contiguous(), self.embed, self.pos, self.layers
            )
        return encoder_forward_plain(ids, lens, self.embed, self.pos, self.layers)


def _unpack(layer: torch.Tensor) -> dict:
    out, off = {}, 0
    shapes = {"wq": (D_MODEL, D_MODEL), "wk": (D_MODEL, D_MODEL), "wv": (D_MODEL, D_MODEL),
              "wo": (D_MODEL, D_MODEL), "w1": (D_MODEL, D_FF), "w2": (D_FF, D_MODEL),
              "ln1": (D_MODEL,), "ln2": (D_MODEL,)}
    for key in LAYER_KEYS:
        n = math.prod(shapes[key])
        out[key] = layer[off:off + n].reshape(shapes[key])
        off += n
    return out


def encoder_forward_plain(ids: torch.Tensor, lens: torch.Tensor, embed: torch.Tensor,
                          pos: torch.Tensor, layers: torch.Tensor) -> torch.Tensor:
    """Plain version of H28, on any device, with the reference's formulas.
    Every product is a ``torch.bmm`` of one document's (or one head's)
    matrix, so a document's result does not depend on the batch. On the
    card it needs ``torch.backends.cuda.matmul.allow_tf32`` False (the
    default), or it is no f32 reference."""
    B = ids.shape[0]
    dev = embed.device
    ids = ids.to(device=dev, dtype=torch.int64)
    mask = torch.arange(MAX_LENGTH, device=dev)[None, :] < lens.to(dev)[:, None]  # [B, L]
    bias = torch.where(mask, 0.0, -1e9).to(torch.float32)[:, None, :]  # [B, 1, L]
    x = embed[ids] + pos[None]  # [B, L, D]
    scale = math.sqrt(D_MODEL)
    dh = D_MODEL // N_HEADS

    def mm(a, w):  # a [B, L, K] @ w [K, N], one document at a time
        return torch.bmm(a, w.expand(a.shape[0], *w.shape))

    def heads(t):  # [B, L, D] -> [B * H, L, dh]
        return t.reshape(B, MAX_LENGTH, N_HEADS, dh).permute(0, 2, 1, 3).reshape(-1, MAX_LENGTH, dh)

    for layer in layers:
        lp = _unpack(layer)
        h = x * lp["ln1"] / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + 1e-6) * scale
        q, k, v = heads(mm(h, lp["wq"])), heads(mm(h, lp["wk"])), heads(mm(h, lp["wv"]))
        scores = torch.bmm(q, k.transpose(1, 2)) / math.sqrt(dh)
        scores = scores.reshape(B, N_HEADS, MAX_LENGTH, MAX_LENGTH) + bias[:, None]
        att = torch.softmax(scores, dim=-1).reshape(-1, MAX_LENGTH, MAX_LENGTH)
        ctxv = torch.bmm(att, v).reshape(B, N_HEADS, MAX_LENGTH, dh).permute(0, 2, 1, 3)
        x = x + mm(ctxv.reshape(B, MAX_LENGTH, D_MODEL), lp["wo"])
        h2 = x * lp["ln2"] / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + 1e-6) * scale
        x = x + mm(torch.relu(mm(h2, lp["w1"])), lp["w2"])
    m = mask.to(torch.float32)[:, None, :]  # [B, 1, L]
    pooled = torch.bmm(m, x)[:, 0] / torch.clamp(m.sum(dim=2), min=1.0)
    return pooled / (torch.linalg.vector_norm(pooled, dim=-1, keepdim=True) + 1e-6)


def parse_doc(doc) -> Optional[list]:
    """A document's token ids (truncated to 64), or None where the reference
    returns "": not JSON, not a non-empty list of ints."""
    try:
        ids = json.loads(doc)
    except (ValueError, TypeError):
        return None
    if not isinstance(ids, list) or not ids or not all(isinstance(i, int) for i in ids):
        return None
    return ids[:MAX_LENGTH]


class TransformerExecutor:
    """Execute(json_token_ids) -> json embedding floats (ref interface), on
    ``device`` (None: the card)."""

    TYPE = "transformer"

    def __init__(self, params: Optional[dict] = None, seed: int = 0, device=None):
        self.device = resolve_device(device)
        self.params = params if params is not None else _init_params(seed)
        self.model = TransformerEncoder(self.params, self.device)

    def load_params(self, params: dict) -> None:
        """Drop in trained weights (``_init_params``'s structure)."""
        self.params = params
        self.model = TransformerEncoder(params, self.device)

    def execute_batch(self, docs) -> list:
        """The embedding JSON of each document, all of them through one
        forward (one H28 launch on the card); equal, document by document,
        to ``execute``."""
        parsed = [parse_doc(d) for d in docs]
        good = [i for i, p in enumerate(parsed) if p is not None]
        out = [""] * len(parsed)
        if not good:
            return out
        arr = np.zeros((len(good), MAX_LENGTH), np.int32)
        lens = np.zeros(len(good), np.int32)
        for row, i in enumerate(good):
            ids = parsed[i]
            arr[row, : len(ids)] = [(t + 1) % VOCAB for t in ids]  # pad id 0
            lens[row] = len(ids)
        emb = self.model(
            torch.from_numpy(arr).to(self.device), torch.from_numpy(lens).to(self.device)
        ).cpu().numpy()
        for row, i in enumerate(good):
            out[i] = json.dumps([round(float(v), 6) for v in emb[row]])
        return out

    def execute(self, doc: str) -> str:
        """JSON token ids -> JSON embedding (ref: Execute(doc, out)); "" on a
        malformed document."""
        return self.execute_batch([doc])[0]


def tokenize(text: str, vocab: int = VOCAB) -> str:
    """string -> JSON token ids (ref: SentencePieceUDF's contract): 4-char
    shingles of each whitespace-separated word, FNV-1a bucketed."""
    out: list[int] = []
    for word in text.split():
        for i in range(0, max(len(word), 1), 4):
            piece = word[i : i + 4]
            out.append(int(_fnv1a64(piece) % np.uint64(vocab - 2)) + 1)
            if len(out) >= MAX_LENGTH:
                return json.dumps(out)
    return json.dumps(out)


class ModelPool:
    """Borrow-pool of executors keyed by model type and device (ref:
    model_pool.h): get() lends an idle executor or builds one, and the
    context manager returns it."""

    def __init__(self):
        self._lock = threading.Lock()
        self._idle: dict[tuple, list] = {}
        self._built: dict[tuple, int] = {}

    class _Borrow:
        def __init__(self, pool, key, executor):
            self._pool, self._key, self.executor = pool, key, executor

        def __enter__(self):
            return self.executor

        def __exit__(self, *exc):
            with self._pool._lock:
                self._pool._idle.setdefault(self._key, []).append(self.executor)
            return False

    def get(self, executor_cls=TransformerExecutor, device=None, **kwargs):
        dev = resolve_device(device)
        key = (executor_cls.TYPE, str(dev))
        with self._lock:
            idle = self._idle.get(key)
            if idle:
                return self._Borrow(self, key, idle.pop())
            self._built[key] = self._built.get(key, 0) + 1
        return self._Borrow(self, key, executor_cls(device=dev, **kwargs))


_default_pool: Optional[ModelPool] = None
_default_pool_lock = threading.Lock()


def default_pool() -> ModelPool:
    global _default_pool
    with _default_pool_lock:
        if _default_pool is None:
            _default_pool = ModelPool()
        return _default_pool
