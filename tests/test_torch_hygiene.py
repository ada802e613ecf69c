"""The port stands alone: it imports neither JAX nor the reference package,
its entry points need a CUDA device unless the caller asks for the CPU, and
its kernels are neither built nor loaded at import."""

import os
import pathlib
import re
import subprocess
import sys

import pytest
import torch

import pixie_tpu_torch
from pixie_tpu_torch.device import NoCudaDeviceError, resolve_device
from pixie_tpu_torch.parallel import DeviceExecutor

# Two intra-op threads: the CPU tests share the host with the reference's
# timing-sensitive tests under several workers.
torch.set_num_threads(2)

PKG = pathlib.Path(pixie_tpu_torch.__file__).parent
REPO = PKG.parent

_CHILD = r"""
import sys
import numpy as np
import pixie_tpu_torch
from pixie_tpu_torch.engine import Carnot
from pixie_tpu_torch.interop import table_from_columns
from pixie_tpu_torch.ops import batched, kernels, merge, ml, transformer
from pixie_tpu_torch.distributed import MeshConfig
from pixie_tpu_torch.parallel import DeviceExecutor
from pixie_tpu_torch.udf.builtins import ml_ops
from pixie_tpu_torch.serving import ResidencyPool, ResidentRing, SharedScanCoordinator
from pixie_tpu_torch.serving.resident import ResidentIngestManager
from pixie_tpu_torch.types import DataType, Relation

c = Carnot(device_executor=DeviceExecutor(device="cpu"))
rel = Relation.of(("service", DataType.STRING), ("latency", DataType.FLOAT64))
table_from_columns(c.table_store, "t", rel, {
    "service": np.array(["a", "b", "a"], dtype=object),
    "latency": np.array([1.0, 2.0, 3.0]),
})
r = c.execute_query(
    "df = px.DataFrame(table='t')\n"
    "s = df.groupby(['service']).agg(q=('latency', px.quantiles), m=('latency', px.mean))\n"
    "px.display(s, 'o')\n"
)
assert r.table("o")["m"] == [2.0, 2.0], r.table("o")
r = c.execute_query(
    "df = px.DataFrame(table='t')\n"
    "df.tokens = px.sentencepiece(df.service)\n"
    "df.emb = px.transformer(df.tokens)\n"
    "s = df.groupby(['service']).agg(r=('latency', px.reservoir_sample))\n"
    "px.display(s, 'o')\n"
)
assert len(r.table("o")["r"]) == 2, r.table("o")
m = Carnot(device_executor=DeviceExecutor(mesh_config=MeshConfig.parse("hosts:2,d:1", 2),
                                          devices=["cpu", "cpu"]))
table_from_columns(m.table_store, "t", rel, {
    "service": np.array(["a", "b", "a"], dtype=object),
    "latency": np.array([1.0, 2.0, 3.0]),
})
r = m.execute_query(
    "df = px.DataFrame(table='t')\n"
    "s = df.groupby(['service']).agg(m=('latency', px.max), n=('latency', px.count))\n"
    "px.display(s, 'o')\n"
)
assert r.table("o")["m"] == [3.0, 2.0] and r.table("o")["n"] == [2, 1], r.table("o")
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
             or m == "pixie_tpu" or m.startswith("pixie_tpu."))
assert not bad, bad
assert kernels._lib is None  # nothing built or loaded on the CPU
print("OK")
"""


def test_import_and_cpu_query_load_no_jax_or_reference():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO)
    out = subprocess.run(
        [sys.executable, "-c", _CHILD],
        capture_output=True, text=True, timeout=120, env=env, cwd=str(REPO),
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("OK")


def test_sources_never_import_jax_or_the_reference():
    pat_jax = re.compile(r"^\s*(import jax|from jax)", re.M)
    pat_ref = re.compile(r"\bpixie_tpu\.")
    files = sorted(PKG.rglob("*.py"))
    assert len(files) > 30
    for new in ("serving/__init__.py", "serving/shared_scan.py", "ops/batched.py",
                "serving/residency.py", "serving/resident.py", "ops/ml.py",
                "ops/transformer.py", "udf/builtins/ml_ops.py", "distributed/__init__.py",
                "distributed/mesh.py", "ops/merge.py"):
        assert PKG / new in files, new
    for f in files:
        text = f.read_text()
        assert "import jax" not in text, f
        assert not pat_jax.search(text), f
        assert not pat_ref.search(text), f  # pixie_tpu_torch. does not match


def test_default_device_needs_cuda():
    if torch.cuda.is_available():
        assert DeviceExecutor().device.type == "cuda"
        return
    with pytest.raises(NoCudaDeviceError):
        DeviceExecutor()
    with pytest.raises(NoCudaDeviceError):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"


def test_chip_smoke_never_imports_jax_or_the_reference():
    text = (REPO / "chip_smoke.py").read_text()
    assert not re.search(r"^\s*(import jax|from jax)", text, re.M)
    assert not re.search(r"^\s*(import pixie_tpu\b|from pixie_tpu[ .])", text, re.M)
    for kernel in ("reservoir_priority", "reservoir_topk", "reservoir_topk_rows", "kmeans_fit",
                   "encoder_forward", "merge_states", "countmin_query", "hash_columns", "clz64"):
        assert f'"{kernel}"' in text, kernel
