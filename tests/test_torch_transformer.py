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
