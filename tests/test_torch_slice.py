"""The ported slice end to end: fit with the JAX reference and convert,
then the stream and fused-dense searches of both packages on the same
state; the port alone through build -> load -> search; and the on-disk
format shared by both packages."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import CPU, reference_arrays, set_overlap, t

from benchmarks.datasets import clustered
from vector_indexer_tpu.index.ivf import IvfIndex as JaxIndex
from vector_indexer_tpu.index.ivf import _ivf_search_dense_fused_program, load_index_from
from vector_indexer_tpu.ops.pallas.flat_sweep import plan_fused as jax_plan_fused
from vector_indexer_tpu.storage import VectorStore
from vector_indexer_tpu_torch import bindings
from vector_indexer_tpu_torch.convert import index_from_reference_arrays
from vector_indexer_tpu_torch.device import resolve_device
from vector_indexer_tpu_torch.index import programs
from vector_indexer_tpu_torch.index.dispatch import resolve
from vector_indexer_tpu_torch.ops.topk import brute_force_topk

N, D, NQ, NLIST = 8192, 128, 32, 64


@pytest.fixture(scope="module")
def corpus():
    return clustered(N, D, NQ, seed=3, ncent=40)


@pytest.fixture(scope="module")
def pair(corpus):
    xb, _ = corpus
    store = VectorStore(external_ids=np.arange(N, dtype=np.uint64), vectors=xb)
    ref = JaxIndex.fit(store, seed=42, nlist=NLIST)
    return ref, index_from_reference_arrays(reference_arrays(ref), device=CPU)


def test_convert_carries_the_state(pair):
    ref, ours = pair
    assert ours.num_clusters == ref.num_clusters and ours.num_shards == ref.num_shards
    np.testing.assert_array_equal(ours.layout.vectors.numpy(), np.asarray(ref.layout.vectors))
    np.testing.assert_array_equal(ours.layout.perm, ref.layout.perm)
    got = ours.search(np.asarray(ref.layout.vectors)[0], 1, 4)
    assert got and got[0][0] == int(ref.layout.perm[0])


@pytest.mark.parametrize("n_probe", [2, 6])
def test_stream_search_matches(pair, corpus, n_probe):
    ref, ours = pair
    _, xq = corpus
    k = 10
    rD, rI = ref.search_batch(xq, k, n_probe, method="stream")
    D, I = ours.search_batch(xq, k, n_probe, method="stream")
    same = set_overlap(I, rI) == 1.0
    assert same.mean() >= 0.99
    np.testing.assert_allclose(D[same], rD[same], rtol=1e-4)


@pytest.mark.parametrize("n_probe", [3, 12])
def test_dense_fused_program_matches(pair, corpus, n_probe):
    ref, ours = pair
    _, xq = corpus
    k = 10
    n_pad = ours.layout.vectors.shape[0]
    w, q_tile, C = jax_plan_fused(n_pad, D, NQ, k)
    run_starts_b, c_ord_j, c_sq_j = ref._run_tables()
    rD, rR = _ivf_search_dense_fused_program(
        jnp.asarray(xq), c_ord_j, c_sq_j, ref.layout.vectors, ref.layout.row_norms,
        run_starts_b, jnp.int32(n_probe), k=k, q_tile=q_tile, w=w, c_groups=C,
        metric="l2", precision="highest", interpret=True,
    )
    block_run, c_ord, c_sq_ord = ours._run_tables()
    Dp, Rp = programs.dense_fused_program(
        t(xq), c_ord, c_sq_ord, ours.layout.vectors, ours.layout.row_norms, block_run,
        n_probe, k=k, w=w, c_groups=C, metric="l2",
    )
    rD, rR = np.asarray(rD)[:NQ], np.asarray(rR)[:NQ]
    assert set_overlap(Rp.numpy(), rR).min() == 1.0
    np.testing.assert_allclose(Dp.numpy(), rD, rtol=1e-5, atol=1e-5 * np.abs(rD).max())


def test_auto_search_matches_reference_dense(pair, corpus):
    """'auto' at this size is the plain dense program; the reference's
    exact dense program on the same state returns the same sets."""
    ref, ours = pair
    _, xq = corpus
    assert resolve(ours, NQ, 8, k=10).program == "dense_torch"
    D, I = ours.search_batch(xq, 10, 8)
    rD, rI = ref.search_batch(xq, 10, 8, method="dense_exact")
    assert set_overlap(I, rI).min() == 1.0
    # Both expand |q|^2 - 2 q.x + |x|^2 in f32: the error scales with the
    # terms (~|q|^2 + |x|^2), not with the distance that survives.
    terms = np.sum(xq * xq, 1)[:, None] + np.asarray(ref.layout.row_norms)[: ref.layout.rows_used].max()
    assert np.all(np.abs(D - rD) <= 2e-6 * terms)


@pytest.fixture(scope="module")
def built(corpus, tmp_path_factory):
    xb, _ = corpus
    wd = tmp_path_factory.mktemp("port_index")
    bindings.build(xb, str(wd), device="cpu")
    return wd, bindings.load(str(wd / "index"), str(wd / "shards"), D, device="cpu")


def test_port_build_load_search(corpus, built):
    xb, xq = corpus
    _, vi = built
    D, I = vi.search_sync(xb[:16], 5, 8)
    np.testing.assert_array_equal(I[:, 0], np.arange(16))  # self-hit
    assert D.shape == (16, 5) and np.isfinite(D).all()
    n_probe = vi.nlist  # every list: the largest n_probe
    _, gt = brute_force_topk(t(xq), t(xb), 10)
    _, I = vi.search_sync(xq, 10, n_probe)
    assert set_overlap(I, gt.numpy()).mean() >= 0.95
    res = vi.indexer.search_sync(
        vi.indexer.search_request(xb[11]).with_k(3).with_include_vectors(True)
    )
    assert res[0].external_id == 11
    np.testing.assert_array_equal(res[0].vector, xb[11])


def test_port_index_loads_in_the_reference(corpus, built):
    """The on-disk format is shared: the reference reads what the port
    wrote and lays out the same table."""
    wd, vi = built
    ref = load_index_from(str(wd / "index"), str(wd / "shards"))
    np.testing.assert_array_equal(np.asarray(ref.centroids), vi.index.centroids)
    np.testing.assert_array_equal(ref.layout.perm, vi.index.layout.perm)
    np.testing.assert_array_equal(np.asarray(ref.layout.vectors), vi.index.layout.vectors.numpy())


def test_reference_index_loads_in_the_port(pair, tmp_path):
    ref, ours = pair
    ref.save_to(str(tmp_path / "index"), str(tmp_path / "shards"))
    vi = bindings.load(str(tmp_path / "index"), str(tmp_path / "shards"), D, device="cpu")
    np.testing.assert_array_equal(vi.index.layout.perm, ref.layout.perm)
    np.testing.assert_array_equal(vi.index.layout.vectors.numpy(), np.asarray(ref.layout.vectors))
    np.testing.assert_array_equal(vi.index.layout.offsets, np.asarray(ref.layout.offsets))


def test_missing_shard_degrades(corpus, built, tmp_path):
    import shutil

    wd, _ = built
    shutil.copytree(wd, tmp_path / "c")
    (tmp_path / "c" / "shards" / "shard_0.bin").unlink()
    vi = bindings.load(str(tmp_path / "c" / "index"), str(tmp_path / "c" / "shards"), D, device="cpu")
    _, xq = corpus
    D_, I = vi.search_sync(xq, 10, 8)
    assert I.shape == (NQ, 10) and (I >= -1).all()


def test_search_rejects_bad_queries(built):
    _, vi = built
    with pytest.raises(ValueError):
        vi.search_sync(np.zeros((2, D + 1), np.float32), 5, 4)
    with pytest.raises(ValueError):
        vi.search_sync(np.zeros((2, D), np.float32), 0, 4)


def test_absent_card_is_refused_not_replaced(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        bindings.load("no_index", "no_shards", D, device="cuda")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        resolve_device(None)
    assert resolve_device("cpu").type == "cpu"


@pytest.mark.parametrize("metric", ["ip", "cosine"])
def test_port_similarity_metrics(corpus, tmp_path, metric):
    xb, _ = corpus
    xb = xb[:2048]
    vi = bindings.build(xb, str(tmp_path), metric=metric, device="cpu")
    D, I = vi.search_sync(xb[:8], 5, 8)
    unit = xb / np.linalg.norm(xb, axis=1, keepdims=True)
    base = unit if metric == "cosine" else xb
    exact = -(base[:8] @ base.T)  # negated similarity, ascending = best
    np.testing.assert_array_equal(I[:, 0], np.argmin(exact, axis=1))
    np.testing.assert_allclose(D[:, 0], exact.min(axis=1), rtol=1e-5, atol=1e-4)
