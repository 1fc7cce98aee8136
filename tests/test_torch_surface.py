"""The port's surface against the JAX package's: the subpackage exports,
``cluster_starts``, the tracing helpers, ``VectorIndex.stage_queries`` and
the demo (examples/demo_torch.py), on the same numpy inputs."""

import ast
import importlib
import json
import logging
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import vector_indexer_tpu as jvx
from vector_indexer_tpu.storage.layout import build_layout as jax_build_layout
from vector_indexer_tpu.storage.layout import cluster_starts as jax_cluster_starts
from vector_indexer_tpu.utils import generate_test_vectors as jax_generate_test_vectors
from vector_indexer_tpu.utils import tracing as jtracing
from vector_indexer_tpu_torch import bindings
from vector_indexer_tpu_torch.storage.layout import build_layout, cluster_starts
from vector_indexer_tpu_torch.utils import tracing

ROOT = Path(__file__).resolve().parent.parent
SUBPACKAGES = ["utils", "storage", "models", "ops", "index"]


def _reference_all(sub: str) -> list:
    """The reference subpackage's ``__all__``, read without importing it."""
    tree = ast.parse((ROOT / "vector_indexer_tpu" / sub / "__init__.py").read_text())
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "__all__" for t in node.targets):
            return ast.literal_eval(node.value)
    raise AssertionError(f"no __all__ in vector_indexer_tpu/{sub}/__init__.py")


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_subpackage_exports_match_reference(sub):
    names = _reference_all(sub)
    mod = importlib.import_module(f"vector_indexer_tpu_torch.{sub}")
    assert mod.__all__ == names
    scope = {}
    exec(f"from vector_indexer_tpu_torch.{sub} import {', '.join(names)}", scope)
    for name in names:
        assert scope[name] is getattr(mod, name)
        assert getattr(scope[name], "__module__", "").startswith(f"vector_indexer_tpu_torch.{sub}")
    with pytest.raises(AttributeError):
        getattr(mod, "not_a_name")


def test_subpackage_imports_build_nothing():
    code = (
        "import sys, torch\n"
        + "".join(f"import vector_indexer_tpu_torch.{s}\n" for s in SUBPACKAGES)
        + "print(sorted(m for m in sys.modules if m.endswith(('kernels.build', 'native.shardio'))),"
        " torch.cuda.is_initialized())\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().splitlines()[-1] == "[] False"


def test_cluster_starts_matches_reference(rng):
    n, d, k = 600, 8, 13
    xb = rng.normal(size=(n, d)).astype(np.float32)
    labels = rng.integers(0, k, size=n)
    labels[labels == 4] = 5  # an empty list
    order = rng.permutation(k)
    ref = jax_build_layout(xb, labels, k, cluster_order=order)
    port = build_layout(torch.as_tensor(xb), labels, k, cluster_order=order)
    starts = cluster_starts(port)
    assert isinstance(starts, np.ndarray) and starts.shape == (k,)
    np.testing.assert_array_equal(starts, np.asarray(jax_cluster_starts(ref)))
    np.testing.assert_array_equal(starts, port.offsets[:-1])


def test_progress_logs_at_total_like_reference(caplog):
    lines = {}
    for mod in (tracing, jtracing):
        caplog.clear()
        with caplog.at_level(logging.INFO, logger=mod.log.name):
            p = mod.progress(3, "vectors", every=1e9)
            p.update()
            p.update()
            assert not caplog.records  # not yet: neither `every` nor `total` reached
            p.update()
        (rec,) = caplog.records
        assert rec.name == mod.log.name
        lines[mod] = re.sub(r"\(\d+/s", "(N/s", rec.getMessage())
    assert lines[tracing] == lines[jtracing] == "vectors: 3/3 (N/s, ETA 0.0s)"


def test_enable_console_logging_attaches_one_handler():
    log = tracing.log
    handlers, level = list(log.handlers), log.level
    try:
        for _ in range(3):
            tracing.enable_console_logging(logging.DEBUG)
        added = [h for h in log.handlers if h not in handlers]
        assert len([h for h in log.handlers if isinstance(h, logging.StreamHandler)]) == 1
        assert len(added) <= 1 and log.level == logging.DEBUG
        assert log.name == "vector_indexer_tpu_torch"
    finally:
        log.handlers[:] = handlers
        log.setLevel(level)


def test_device_profiler_writes_a_chrome_trace(tmp_path):
    logdir = tmp_path / "prof"
    cm = tracing.device_profiler(logdir)
    assert not logdir.exists()  # nothing happens until it is entered
    with cm as path:
        torch.mm(torch.ones(8, 8), torch.ones(8, 8))
    assert path.parent == logdir and path.name.endswith(".pt.trace.json")
    trace = json.loads(path.read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "aten::mm" in names


def test_staged_device_queries(tmp_path):
    # Counterpart of tests/test_api.py::test_staged_device_queries: staged
    # queries give search_sync's results, padded to a multiple of pad_to.
    g = np.random.default_rng(3)
    xb = g.normal(size=(300, 8)).astype(np.float32)
    index = bindings.build(xb, work_dir=str(tmp_path / "port"), device="cpu")
    ref = jvx.build(xb, work_dir=str(tmp_path / "ref"))
    xq = xb[:16]
    D1, I1 = index.search_sync(xq, 4, 8)
    for pad_to in (512, 5, 1):
        xq_dev = index.stage_queries(xq, pad_to=pad_to)
        assert xq_dev.dtype == torch.float32 and xq_dev.device == index.index.device
        assert xq_dev.shape[0] % pad_to == 0 and xq_dev.shape[0] - 16 < pad_to
        np.testing.assert_array_equal(xq_dev.numpy(), np.asarray(ref.stage_queries(xq, pad_to)))
        assert index.index._queries_on_device(xq_dev).data_ptr() == xq_dev.data_ptr()  # no copy
        Dd, rows = index.search_device(xq_dev, 4, 8)
        I2 = index.rows_to_external(rows[:16])
        np.testing.assert_array_equal(I1, I2)
        np.testing.assert_allclose(D1, Dd[:16].numpy(), rtol=1e-5, atol=1e-6)
    one = index.stage_queries(xq[3])  # a single (d,) query
    assert tuple(one.shape) == (512, 8)


def _run_demo(work: Path):
    res = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "demo_torch.py"), "--cpu", "--count", "3000",
         "--dim", "16", "--work-dir", str(work)],
        cwd=work.parent, capture_output=True, text=True, timeout=300,
    )
    assert res.returncode == 0, res.stderr
    ids = [int(m) for m in re.findall(r"external_id=(\d+)", res.stdout)]
    assert len(ids) == 10  # the default k
    return res.stdout, ids


def test_demo_builds_then_loads(tmp_path):
    work = tmp_path / "w"
    out1, ids1 = _run_demo(work)
    assert "generating 3000 x 16 test vectors..." in out1 and "building index..." in out1
    out2, ids2 = _run_demo(work)
    assert "loaded existing index" in out2 and "building" not in out2
    assert ids1 == ids2
    ref = tmp_path / "ref_vectors.bin"
    jax_generate_test_vectors(str(ref), 3000, 16, seed=42)
    assert (work / "test_vectors_3000.bin").read_bytes() == ref.read_bytes()
