"""Port sharded search (parallel/sharded.py) vs the JAX reference on the
same index: the per-device tables array by array, and the 1-D searcher's
three bodies against the reference's ShardedSearcher on its 8-device
virtual CPU mesh (the port's mesh: eight CPU entries)."""

import numpy as np
import pytest
import torch
from conftest import make_gaussian_clusters
from torch_parity import CPU, reference_arrays

from vector_indexer_tpu.index import IvfIndex as JaxIvfIndex
from vector_indexer_tpu.parallel import ShardedSearcher as JaxSharded
from vector_indexer_tpu.parallel import make_shard_mesh as jax_mesh
from vector_indexer_tpu.parallel import sharded as jsh
from vector_indexer_tpu.storage import VectorStore as JaxVectorStore
from vector_indexer_tpu_torch.convert import index_from_reference_arrays
from vector_indexer_tpu_torch.parallel import Mesh, ShardedSearcher, make_shard_mesh
from vector_indexer_tpu_torch.parallel import sharded as tsh

RTOL, ATOL = 1e-3, 5e-4  # the reference's own cross-path tolerance (test_parallel.py)


def _fit_both(data, **kw):
    store = JaxVectorStore(external_ids=np.arange(len(data), dtype=np.uint64), vectors=data)
    ref = JaxIvfIndex.fit(store, seed=42, **kw)
    arrays = reference_arrays(ref)
    arrays["spill"] = ref.spill
    return ref, index_from_reference_arrays(arrays, device="cpu")


def cpu_mesh(n: int) -> Mesh:
    return Mesh([CPU] * n, ("shards",))


@pytest.fixture(scope="module")
def built():
    data, _, _ = make_gaussian_clusters(12, 120, 24, spread=0.4, separation=8.0)
    ref, ours = _fit_both(data)
    return ref, ours, data


def off_data(data, n: int, seed: int = 0):
    """Queries near the first n data points but not on them: at a (near-)
    zero distance the norm expansion's f32 cancellation (~1e-5 of |q|^2 +
    |x|^2, two matmul orders) exceeds an absolute 5e-4, and that noise is
    not what these tests compare."""
    g = np.random.default_rng(seed)
    return (data[:n] + 0.3 * g.standard_normal(data[:n].shape)).astype(np.float32)


def _same_sets(I1, I2):
    return all(set(a.tolist()) == set(b.tolist()) for a, b in zip(I1, I2))


@pytest.mark.parametrize("n_dev", [1, 2, 8])
def test_local_tables_match_reference(built, n_dev):
    ref, ours, _ = built
    a = jsh.build_local_tables(ref, n_dev)
    b = tsh.build_local_tables(ours, n_dev)
    for name in ("local_vecs", "local_norms", "local_cent", "local_csq", "local_run_starts_b",
                 "local_lengths", "local_perm", "shard_to_dev", "cents", "c_sq"):
        np.testing.assert_array_equal(getattr(b, name), np.asarray(getattr(a, name)), name)
    real = b.local_cid >= 0
    np.testing.assert_array_equal(real, b.local_lengths > 0)
    np.testing.assert_array_equal(b.cents[b.local_cid[real]], b.local_cent[real])


@pytest.mark.parametrize("n_dev", [1, 2, 8])
@pytest.mark.parametrize("dtype", ["bfloat16", "int8", "float32"])
def test_local_stream_tables_match_reference(built, n_dev, dtype):
    import jax.numpy as jnp

    ref, ours, _ = built
    a = jsh.build_local_stream_tables(jsh.build_local_tables(ref, n_dev), getattr(jnp, dtype))
    b = tsh.build_local_stream_tables(tsh.build_local_tables(ours, n_dev), getattr(torch, dtype))
    assert (a["m_pad"], a["chunk"]) == (b["m_pad"], b["chunk"])
    for name in ("snorms", "sto_local", "sblk0", "slen", "blk_cid", "scales"):
        np.testing.assert_array_equal(b[name], np.asarray(a[name]), name)
    va, vb = np.asarray(a["svecs"]), b["svecs"]
    if dtype == "bfloat16":  # compare the 16-bit patterns
        np.testing.assert_array_equal(vb.view(torch.int16).numpy(), va.view(np.int16))
    else:
        np.testing.assert_array_equal(vb.numpy(), va)


def test_row_conservation(built):
    _, ours, _ = built
    s = ShardedSearcher(ours, cpu_mesh(8))
    ids = s.local_perm[s.local_perm >= 0]
    assert len(ids) == ours.layout.n and len(np.unique(ids)) == ours.layout.n


@pytest.mark.parametrize("n_dev", [1, 2, 8])
@pytest.mark.parametrize("method", ["dense", "stream", "auto"])
def test_sharded_matches_reference(built, n_dev, method):
    """Each body against the reference's same body on the same mesh size:
    the global-threshold probing (ties included) is the same on both sides,
    so the result sets are; the stream body's kernel distances (bf16 rows,
    no re-rank) agree within the reference's tolerance."""
    ref, ours, data = built
    s_ref = JaxSharded(ref, jax_mesh(n_dev), method=method)
    s_ours = ShardedSearcher(ours, cpu_mesh(n_dev), method=method)
    q = off_data(data, 32)
    for n_probe in (3, 6, ours.num_clusters):
        D1, I1 = s_ref.search_batch(q, 10, n_probe)
        D2, I2 = s_ours.search_batch(q, 10, n_probe)
        assert _same_sets(I1, I2), (method, n_probe)
        np.testing.assert_allclose(D2, D1, rtol=RTOL, atol=ATOL)
    if method == "auto":
        assert s_ours.last_method == tsh.choose_local_body(ours, s_ours._host_tables,
                                                           ours.num_clusters, 32)


@pytest.mark.parametrize("n_dev", [2, 8])
def test_sharded_int8_stream_reranks(built, n_dev):
    """int8 local stream tables: both packages re-rank the 4x shortlist
    exactly from the local f32 rows, so they return the dense body's sets
    and exact distances."""
    ref, ours, data = built
    ref.stream_dtype, ours.stream_dtype = np.int8, torch.int8
    try:
        s_ref = JaxSharded(ref, jax_mesh(n_dev), method="stream")
        s_ours = ShardedSearcher(ours, cpu_mesh(n_dev), method="stream")
        dense = ShardedSearcher(ours, cpu_mesh(n_dev), method="dense")
        q = off_data(data, 32)
        D1, I1 = s_ref.search_batch(q, 10, 6)
        D2, I2 = s_ours.search_batch(q, 10, 6)
        D3, I3 = dense.search_batch(q, 10, 6)
    finally:
        import jax.numpy as jnp

        ref.stream_dtype, ours.stream_dtype = jnp.bfloat16, torch.bfloat16
    assert _same_sets(I1, I2) and _same_sets(I2, I3)
    np.testing.assert_allclose(D2, D1, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(D2, D3, rtol=RTOL, atol=ATOL)


def test_sharded_self_hits_and_order(built):
    _, ours, data = built
    for method in ("dense", "stream"):
        s = ShardedSearcher(ours, cpu_mesh(4), method=method)
        D, I = s.search_batch(data[:16], 5, 3)
        assert (I[:, 0] == np.arange(16)).all(), method
        assert (np.diff(D, axis=1) >= -1e-6).all(), method


def test_sharded_dense_fused_matches_reference():
    """K3's masked sweep (its plain version here) per device at d 128, where
    both packages' plan gates accept: the leading results equal the
    reference's fused body's (plane tail loss only, as in the reference's
    own fused-vs-dense test)."""
    rng = np.random.default_rng(5)
    n, d, k = 6000, 128, 10
    centers = rng.normal(0, 6.0, size=(12, d)).astype(np.float32)
    data = (centers[rng.integers(0, 12, n)] + rng.normal(0, 0.4, (n, d))).astype(np.float32)
    ref, ours = _fit_both(data)
    s_ref = JaxSharded(ref, jax_mesh(2), method="dense_fused")
    s_ours = ShardedSearcher(ours, cpu_mesh(2), method="dense_fused")
    rows_local = s_ours._host_tables.local_vecs.shape[1]
    assert tsh.plan_fused(rows_local, d, 24, k) is not None  # the K3 body runs
    q = data[:24] + 0.01
    for n_probe in (4, ours.num_clusters):
        D1, I1 = s_ref.search_batch(q, k, n_probe)
        D2, I2 = s_ours.search_batch(q, k, n_probe)
        np.testing.assert_array_equal(I1[:, 0], I2[:, 0])
        for a, b, da, db in zip(I1, I2, D1, D2):
            shared = set(a.tolist()) & set(b.tolist())
            assert len(shared) >= k - 2
            for r in shared:
                # The reference's interpret-mode '3pass' sweep accumulates
                # in bf16 (its own test allows 3e-2).
                np.testing.assert_allclose(da[list(a).index(r)], db[list(b).index(r)],
                                           rtol=1e-3, atol=3e-2)


@pytest.mark.parametrize("metric", ["ip", "cosine"])
def test_sharded_metric_parity(metric):
    data, _, _ = make_gaussian_clusters(10, 120, 24, spread=0.5, separation=6.0)
    data = data + 2.0  # break norm uniformity so ip != l2 ranking
    ref, ours = _fit_both(data, metric=metric)
    q = data[:24] * 1.7  # un-normalized queries exercise the cosine path
    for method in ("dense", "stream"):
        D1, I1 = JaxSharded(ref, jax_mesh(4), method=method).search_batch(q, 8, ours.num_clusters)
        D2, I2 = ShardedSearcher(ours, cpu_mesh(4), method=method).search_batch(
            q, 8, ours.num_clusters)
        assert _same_sets(I1, I2), method
        np.testing.assert_allclose(D2, D1, rtol=RTOL, atol=ATOL)


def test_sharded_spill_dedup(built):
    """A spilled index: the two copies of a vector may sit on different
    devices; the merged result never repeats an id and equals the
    reference's sets."""
    _, _, data = built
    ref, ours = _fit_both(data, spill=1)
    assert ours.spill == 1
    for method in ("dense", "stream"):
        D1, I1 = JaxSharded(ref, jax_mesh(4), method=method).search_batch(
            data[:24], 10, ours.num_clusters)
        D2, I2 = ShardedSearcher(ours, cpu_mesh(4), method=method).search_batch(
            data[:24], 10, ours.num_clusters)
        for row in I2:
            real = row[row >= 0]
            assert len(set(real.tolist())) == len(real), method
        assert (I2[:, 0] == np.arange(24)).all(), method
        assert _same_sets(I1, I2), method
        if method == "dense":
            # The stream body's distance is to the stored point c + r^ of
            # the copy that survives, whose cell rounding decides: ids only.
            np.testing.assert_allclose(D2, D1, rtol=RTOL, atol=ATOL)


def test_sharded_errors(built):
    _, ours, _ = built
    s = ShardedSearcher(ours, cpu_mesh(2))
    with pytest.raises(ValueError):
        s.search_batch(np.zeros((2, 24), np.float32), 0, 1)
    with pytest.raises(ValueError):
        s.search_batch(np.zeros((2, 24), np.float32), 1, 0)
    with pytest.raises(ValueError, match="dimension"):
        s.search_batch(np.zeros((2, 7), np.float32), 1, 1)
    with pytest.raises(ValueError, match="method"):
        ShardedSearcher(ours, cpu_mesh(2), method="gather")
    with pytest.raises(ValueError, match="axis"):
        ShardedSearcher(ours, cpu_mesh(2), axis="queries")
    with pytest.raises(ValueError):
        Mesh([CPU] * 4, ("a", "b"))


def test_make_shard_mesh_needs_cards(monkeypatch):
    """make_shard_mesh takes CUDA cards only: with fewer than asked (none
    here) it raises instead of falling back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ValueError):
        make_shard_mesh()
    with pytest.raises(ValueError):
        make_shard_mesh(2)
