"""Faults of the port against the reference, each held by a test: no
docstring promises a CPU fallback of the device default, and a stream
table built with another chunk than the index's own is searched with slots
re-sized to its blocks, as the reference re-sizes them."""

import ast
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import CPU, reference_arrays, stream_table_arrays

import vector_indexer_tpu_torch
from vector_indexer_tpu.index import IvfIndex as JaxIndex
from vector_indexer_tpu.ops.pallas import block_stream as jbs
from vector_indexer_tpu.storage import VectorStore
from vector_indexer_tpu_torch.convert import (
    index_from_reference_arrays,
    stream_table_from_reference_arrays,
)
from vector_indexer_tpu_torch.index import dispatch as tdispatch
from vector_indexer_tpu_torch.ops import block_stream as tbs

PACKAGE = pathlib.Path(vector_indexer_tpu_torch.__file__).resolve().parent
# Phrases of the device default that the package dropped: None means the
# card, and the CPU runs only when asked for.
FALLBACK_PHRASES = ("else the cpu", "if present", "falls back to the cpu",
                    "fall back to the cpu", "otherwise the cpu")


def _docstrings(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef, ast.AsyncFunctionDef)):
            doc = ast.get_docstring(node)
            if doc:
                yield node, " ".join(doc.lower().split())


@pytest.mark.parametrize("path", sorted(PACKAGE.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(PACKAGE)))
def test_no_docstring_promises_a_cpu_fallback(path):
    for node, doc in _docstrings(path):
        for phrase in FALLBACK_PHRASES:
            assert phrase not in doc, (path.name, getattr(node, "name", "<module>"), phrase)


def test_bindings_docstring_names_the_device_default():
    doc = " ".join(ast.get_docstring(ast.parse((PACKAGE / "bindings.py").read_text())).split())
    assert "``cuda:0``" in doc and 'device="cpu"' in doc


@pytest.fixture(scope="module")
def skewed_pair():
    """One dense blob cut into ~10 large lists, plus 120 far lists of 100
    rows: the bf16 table's own chunk is 256 (chunk 512 would waste more than
    35% on the small lists), and a chunk-512 table needs fewer slots per
    query than the 256 sizing gives."""
    g = np.random.default_rng(5)
    d = 16
    blob = g.normal(0, 1, (12000, d)).astype(np.float32)
    far = g.normal(0, 30, (120, d)).astype(np.float32)
    small = np.concatenate([c + g.normal(0, 0.3, (100, d)).astype(np.float32) for c in far])
    data = np.concatenate([blob, small])
    store = VectorStore(external_ids=np.arange(len(data), dtype=np.uint64), vectors=data)
    ref = JaxIndex.fit(store, seed=1, nlist=130, max_iters=10)
    ours = index_from_reference_arrays(reference_arrays(ref), device=CPU)
    q = g.normal(0, 0.3, (32, d)).astype(np.float32)
    return ref, ours, q


def test_stream_table_of_another_chunk_is_resized(skewed_pair):
    ref, ours, q = skewed_pair
    k, n_probe = 100, 6
    lengths = np.asarray(ours.layout.lengths)
    assert tbs.pick_chunk(lengths, ours.dimension, 2) == 256
    # The sizing this test is about: the chunk-512 table needs fewer slots
    # than the Decision (sized for 256) gives, so the two sizings differ.
    dec = tdispatch.resolve(ours, len(q), n_probe, k=k, method="stream")
    resized = tdispatch.stream_params(lengths, ours.dimension, 2, len(q), n_probe, chunk=512)
    assert dec.chunk == 256 and resized[1] < dec.t_fixed

    jt = jbs.build_stream_table(ref.layout, ref.centroids, jnp.bfloat16, chunk=512)
    ref._stream_tables[jnp.dtype(jnp.bfloat16)] = jt
    ours._stream_tables[torch.bfloat16] = stream_table_from_reference_arrays(
        stream_table_arrays(jt), device=CPU)
    D, R = ours.search_batch_device(q, k, n_probe, method="stream")
    rD, rR = ref.search_batch_device(q, k, n_probe, method="stream")
    D, R, rD, rR = D.numpy(), R.numpy(), np.asarray(rD), np.asarray(rR)
    np.testing.assert_array_equal(np.sort(R, 1), np.sort(rR, 1))
    scale = np.max(np.where(np.isfinite(rD), np.abs(rD), 0), axis=1, keepdims=True)
    assert np.array_equal(np.isfinite(D), np.isfinite(rD))
    fin = np.isfinite(rD)
    assert np.all(np.abs(D - rD)[fin] <= (1e-5 * (np.abs(rD) + scale))[fin])
