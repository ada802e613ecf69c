"""The transformer UDF's encoder in the port (pixie_tpu_torch/ops/
transformer.py) against the reference's (pixie_tpu/ops/transformer.py) on
the CPU.

Contracts. ``_init_params(seed)`` arrays equal; ``tokenize`` string-equal;
each embedding component within 1e-5 absolute of the reference's (both are
unit vectors; the JSON rounds to 6 decimals, so parsed floats are compared,
never strings); the reference's error cases give ""; the batched UDF (one
forward over all of a batch's documents) string-equal to the per-document
``execute``; the pool reuses executors per (type, device).
"""

import json

import numpy as np
import pytest
import torch

from pixie_tpu.engine import Carnot as RefCarnot
from pixie_tpu.ops import transformer as ref_tr
from pixie_tpu.types import DataType as RefDT, Relation as RefRelation
from pixie_tpu_torch.engine import Carnot
from pixie_tpu_torch.ops import kernels
from pixie_tpu_torch.ops import transformer as tr
from pixie_tpu_torch.parallel import DeviceExecutor
from pixie_tpu_torch.types import DataType, Relation

# Two intra-op threads: the CPU tests share the host with the reference's
# timing-sensitive tests under several workers.
torch.set_num_threads(2)

ATOL = 1e-5


@pytest.fixture(scope="module")
def executors():
    return ref_tr.TransformerExecutor(), tr.TransformerExecutor(device="cpu")


def _docs() -> list:
    rng = np.random.default_rng(5)
    docs = [json.dumps(rng.integers(0, tr.VOCAB + 100, n).tolist()) for n in (1, 17, 64, 3)]
    return docs + ["[1, 2, 3]", json.dumps(list(range(500))), "[32767, 0, 9]"]


def _close(a: str, b: str) -> None:
    va, vb = np.asarray(json.loads(a)), np.asarray(json.loads(b))
    assert va.shape == vb.shape == (64,)
    np.testing.assert_allclose(va, vb, rtol=0, atol=ATOL)


def test_init_params_equal_across_packages():
    want, got = ref_tr._init_params(0), tr._init_params(0)
    np.testing.assert_array_equal(got["embed"], np.asarray(want["embed"]))
    np.testing.assert_array_equal(got["pos"], np.asarray(want["pos"]))
    assert len(got["layers"]) == len(want["layers"]) == tr.N_LAYERS
    for g, w in zip(got["layers"], want["layers"]):
        assert sorted(g) == sorted(w)
        for key in w:
            np.testing.assert_array_equal(g[key], np.asarray(w[key]), err_msg=key)


def test_execute_matches_reference(executors):
    ref, port = executors
    for doc in _docs():
        _close(port.execute(doc), ref.execute(doc))
    emb = np.asarray(json.loads(port.execute("[1, 2, 3]")))
    assert abs(np.linalg.norm(emb) - 1.0) < 1e-3
    assert port.execute("[1, 2, 3]") != port.execute("[4, 5, 6]")


@pytest.mark.parametrize("doc", ["not json", "[]", '["a"]', "{}", "[1.5]", "null"])
def test_error_cases_give_empty(executors, doc):
    ref, port = executors
    assert port.execute(doc) == ref.execute(doc) == ""


def test_truncation_at_64_tokens(executors):
    ref, port = executors
    long = port.execute(json.dumps(list(range(500))))
    assert long == port.execute(json.dumps(list(range(64))))
    _close(long, ref.execute(json.dumps(list(range(500)))))


def test_params_from_reference_gives_the_same_forward(executors):
    ref, port = executors
    seeded = ref_tr._init_params(3)
    ex = tr.TransformerExecutor(params=tr.params_from_reference(seeded), device="cpu")
    ref3 = ref_tr.TransformerExecutor(params=seeded)
    for doc in _docs()[:4]:
        _close(ex.execute(doc), ref3.execute(doc))
    ex.load_params(tr.params_from_reference(ref_tr._init_params(0)))
    assert ex.execute("[7, 8]") == port.execute("[7, 8]")


def test_batched_forward_equals_per_document(executors):
    _, port = executors
    rng = np.random.default_rng(6)
    docs = [json.dumps(rng.integers(0, 40000, rng.integers(1, 90)).tolist()) for _ in range(40)]
    docs[7] = "not json"
    batch = port.execute_batch(docs)
    assert batch == [port.execute(d) for d in docs]
    assert batch[7] == ""


def test_encoder_plain_is_batch_invariant():
    """One document's embedding does not depend on the batch it rides in:
    the same bits alone, first, and last of a batch."""
    model = tr.TransformerEncoder(tr._init_params(0), "cpu")
    rng = np.random.default_rng(8)
    ids = torch.from_numpy(rng.integers(0, tr.VOCAB, (9, 64)).astype(np.int32))
    lens = torch.from_numpy(rng.integers(1, 65, 9).astype(np.int32))
    ids[torch.arange(64)[None, :] >= lens[:, None]] = 0
    full = model(ids, lens)
    for i in (0, 8):
        one = model(ids[i : i + 1], lens[i : i + 1])
        assert torch.equal(one[0], full[i])


def test_reference_embedding_ignores_pad_ids(executors):
    """The premise of H28's packed rows: the reference's own forward (its
    jitted function, JAX on the CPU) gives the same embedding, bit for bit,
    whatever ids the pad positions hold (a pad key's weight is exactly 0, a
    pad row never reaches the pool)."""
    import jax.numpy as jnp

    ref, _ = executors
    rng = np.random.default_rng(9)
    for n in (1, 17, 63, 64):
        arr = np.zeros(tr.MAX_LENGTH, np.int32)
        arr[:n] = rng.integers(1, tr.VOCAB, n)
        mask = np.arange(tr.MAX_LENGTH) < n
        want = np.asarray(ref._jitted(ref.params, jnp.asarray(arr), jnp.asarray(mask)))
        other = arr.copy()
        other[n:] = rng.integers(0, tr.VOCAB, tr.MAX_LENGTH - n)
        got = np.asarray(ref._jitted(ref.params, jnp.asarray(other), jnp.asarray(mask)))
        np.testing.assert_array_equal(got, want, err_msg=f"{n} tokens")


def _trimmed_forward(ids: np.ndarray, n: int, params: dict) -> np.ndarray:
    """One document through the reference's formulas over its ``n`` real
    rows only (no pad rows, no key bias), in f32 torch ops on the CPU."""
    x = torch.from_numpy(params["embed"][ids[:n]] + params["pos"][:n])
    dh = tr.D_MODEL // tr.N_HEADS
    for lp in params["layers"]:
        w = {k: torch.from_numpy(v) for k, v in lp.items()}
        h = x * w["ln1"] / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + 1e-6) * 8.0
        q, k, v = (
            (h @ w[key]).reshape(n, tr.N_HEADS, dh).permute(1, 0, 2) for key in ("wq", "wk", "wv")
        )
        att = torch.softmax(q @ k.transpose(1, 2) / 4.0, dim=-1)
        x = x + (att @ v).permute(1, 0, 2).reshape(n, tr.D_MODEL) @ w["wo"]
        h2 = x * w["ln2"] / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + 1e-6) * 8.0
        x = x + torch.relu(h2 @ w["w1"]) @ w["w2"]
    pooled = x.mean(dim=0)
    return (pooled / (torch.linalg.vector_norm(pooled) + 1e-6)).numpy()


def test_plain_encoder_over_trimmed_rows_equals_padded():
    """The port's plain version over a document's real rows only equals its
    padded [B, 64] result within 1e-6 (f32 sums in another order), at
    every length 1..64 and with other ids in the pad positions."""
    params = tr._init_params(0)
    model = tr.TransformerEncoder(params, "cpu")
    rng = np.random.default_rng(10)
    lens = np.arange(1, 65, dtype=np.int32)
    ids = rng.integers(1, tr.VOCAB, (64, 64)).astype(np.int32)
    padded = ids.copy()
    padded[np.arange(64)[None, :] >= lens[:, None]] = 0
    want = model(torch.from_numpy(padded), torch.from_numpy(lens)).numpy()
    other = model(torch.from_numpy(ids), torch.from_numpy(lens)).numpy()
    np.testing.assert_allclose(other, want, rtol=0, atol=1e-6)
    for i, n in enumerate(lens):
        np.testing.assert_allclose(_trimmed_forward(ids[i], int(n), params), want[i],
                                   rtol=0, atol=1e-6, err_msg=f"{n} tokens")


def test_tokenize_string_equal():
    for text in ("GET /api/v1/users failed with 500", "", "a", "x" * 400,
                 "error connecting to db", " ".join(f"w{i}" for i in range(100))):
        assert tr.tokenize(text) == ref_tr.tokenize(text)


def test_pool_reuses_executors_per_device():
    pool = tr.ModelPool()
    with pool.get(device="cpu") as a:
        pass
    with pool.get(device="cpu") as b:
        assert b is a  # reused, not rebuilt
    with pool.get(device="cpu") as c:
        with pool.get(device="cpu") as d:
            assert d is not c  # both lent at once
    assert pool._built == {("transformer", "cpu"): 2}
    assert a.device.type == "cpu" and a.model.embed.device.type == "cpu"


def _logs(pkg: str, executor: bool):
    dt = RefDT if pkg == "ref" else DataType
    if pkg == "ref":
        c = RefCarnot()
    else:
        c = Carnot(device_executor=DeviceExecutor(device="cpu") if executor else None,
                   device="cpu")
    rel = (RefRelation if pkg == "ref" else Relation).of(("time_", dt.TIME64NS),
                                                         ("msg", dt.STRING))
    t = c.table_store.create_table("logs", rel)
    msgs = ["error connecting to db", "error connecting to db", "request ok", "request ok",
            "GET /api/v1/users/42 took 31 ms", ""]
    t.write_pydict({"time_": np.arange(len(msgs)) * 1000, "msg": np.array(msgs, dtype=object)})
    t.compact()
    t.stop()
    return c


@pytest.mark.parametrize("executor", [False, True])
def test_sentencepiece_and_transformer_through_pxl(executor):
    query = ("df = px.DataFrame(table='logs')\n"
             "df.tokens = px.sentencepiece(df.msg)\n"
             "df.emb = px.transformer(df.tokens)\n"
             "px.display(df[['msg', 'tokens', 'emb']], 'out')\n")
    kernels.reset_launches()
    got = _logs("port", executor).execute_query(query).table("out")
    want = _logs("ref", False).execute_query(query).table("out")
    assert got["msg"] == want["msg"] and got["tokens"] == want["tokens"]
    for g, w in zip(got["emb"], want["emb"]):
        if w == "":
            assert g == ""  # the empty message: no tokens
            continue
        _close(g, w)
    embs = got["emb"]
    assert embs[0] == embs[1] and embs[2] == embs[3] and embs[0] != embs[2]
    assert all(v == 0 for v in kernels.LAUNCHES.values())  # the plain version ran
