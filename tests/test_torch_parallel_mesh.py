"""Port 2-D and multi-host searchers, the merge's bytes, and the
data-parallel Lloyd vs the JAX reference (8 virtual CPU devices there,
eight CPU mesh entries here)."""

import numpy as np
import pytest
import torch
from conftest import make_gaussian_clusters
from torch_parity import CPU, reference_arrays, t

from vector_indexer_tpu.index import IvfIndex as JaxIvfIndex
from vector_indexer_tpu.models import kmeans as jk
from vector_indexer_tpu.parallel import MultiHostSearcher as JaxMultiHost
from vector_indexer_tpu.parallel import Sharded2DSearcher as Jax2D
from vector_indexer_tpu.parallel import ShardedSearcher as JaxSharded
from vector_indexer_tpu.parallel import make_mesh_2d as jax_mesh_2d
from vector_indexer_tpu.parallel import make_mesh_hosts as jax_mesh_hosts
from vector_indexer_tpu.parallel import make_shard_mesh as jax_mesh
from vector_indexer_tpu.parallel import run_kmeans_lloyd_dp as jax_dp
from vector_indexer_tpu.storage import VectorStore as JaxVectorStore
from vector_indexer_tpu_torch.convert import index_from_reference_arrays
from vector_indexer_tpu_torch.index.ivf import IvfIndex
from vector_indexer_tpu_torch.models import kmeans as tk
from vector_indexer_tpu_torch.parallel import (
    Mesh,
    MultiHostSearcher,
    Sharded2DSearcher,
    ShardedSearcher,
    run_kmeans_lloyd_dp,
)
from vector_indexer_tpu_torch.parallel.dp_kmeans import _Slices
from vector_indexer_tpu_torch.storage.vector_store import VectorStore

RTOL, ATOL = 1e-3, 5e-4


def grid(rows: int, cols: int, names) -> Mesh:
    return Mesh(np.array([CPU] * (rows * cols), dtype=object).reshape(rows, cols), names)


def _same_sets(I1, I2):
    return all(set(a.tolist()) == set(b.tolist()) for a, b in zip(I1, I2))


@pytest.fixture(scope="module")
def built():
    data, _, _ = make_gaussian_clusters(12, 120, 24, spread=0.4, separation=8.0)
    store = JaxVectorStore(external_ids=np.arange(len(data), dtype=np.uint64), vectors=data)
    ref = JaxIvfIndex.fit(store, seed=42)
    ours = index_from_reference_arrays(reference_arrays(ref), device="cpu")
    q = (data[:40] + 0.3 * np.random.default_rng(0).standard_normal(data[:40].shape)).astype(
        np.float32)  # off the data points (see test_torch_parallel.off_data)
    return ref, ours, q


@pytest.mark.parametrize("qs", [(2, 4), (4, 2)])
@pytest.mark.parametrize("method", ["dense", "stream"])
def test_2d_matches_reference(built, qs, method):
    ref, ours, q = built
    Q, S = qs
    D1, I1 = Jax2D(ref, jax_mesh_2d(Q, S), method=method).search_batch(q, 10, 6)
    s = Sharded2DSearcher(ours, grid(Q, S, ("queries", "shards")), method=method)
    D2, I2 = s.search_batch(q, 10, 6)
    assert _same_sets(I1, I2)
    np.testing.assert_allclose(D2, D1, rtol=RTOL, atol=ATOL)
    # Each query slice merges over the shard axis only.
    per = -(-len(q) // Q)
    lists = sum(1 for qi in range(Q) if len(q[qi * per:]) > 0)
    assert s.last_merge_bytes["shards"] % lists == 0


def test_2d_dense_fused_matches_dense():
    rng = np.random.default_rng(7)
    n, d, k = 6000, 128, 10
    centers = rng.normal(0, 6.0, size=(12, d)).astype(np.float32)
    data = (centers[rng.integers(0, 12, n)] + rng.normal(0, 0.4, (n, d))).astype(np.float32)
    store = VectorStore(external_ids=np.arange(n, dtype=np.uint64), vectors=data)
    idx = IvfIndex.fit(store, seed=42, device="cpu")
    mesh = grid(2, 2, ("queries", "shards"))
    q = data[:16] + 0.01
    D1, I1 = Sharded2DSearcher(idx, mesh, method="dense").search_batch(q, k, 6)
    s = Sharded2DSearcher(idx, mesh, method="dense_fused")
    D2, I2 = s.search_batch(q, k, 6)
    assert s.last_method == "dense_fused"
    np.testing.assert_array_equal(I1[:, 0], I2[:, 0])
    for a, b in zip(I1, I2):
        assert len(set(a.tolist()) & set(b.tolist())) >= k - 2


@pytest.mark.parametrize("hs", [(2, 4), (4, 2), (2, 2), (1, 8)])
def test_multihost_matches_reference(built, hs):
    ref, ours, q = built
    H, S = hs
    D1, I1 = JaxMultiHost(ref, jax_mesh_hosts(H, S), method="dense").search_batch(
        q, 10, ours.num_clusters)
    mh = MultiHostSearcher(ours, grid(H, S, ("hosts", "shards")), method="dense")
    D2, I2 = mh.search_batch(q, 10, ours.num_clusters)
    assert _same_sets(I1, I2)
    np.testing.assert_allclose(D2, D1, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("method", ["stream", "dense"])
def test_multihost_matches_flat_sharded(built, method):
    """The hierarchical merge re-associates the flat merge (min is
    associative): the 1-D searcher's sets and distances, and the
    reference's multi-host ones."""
    ref, ours, q = built
    mh = MultiHostSearcher(ours, grid(2, 4, ("hosts", "shards")), method=method)
    flat = ShardedSearcher(ours, Mesh([CPU] * 8, ("shards",)), method=method)
    for n_probe in (3, ours.num_clusters):
        D1, I1 = flat.search_batch(q, 8, n_probe)
        D2, I2 = mh.search_batch(q, 8, n_probe)
        assert _same_sets(I1, I2)
        np.testing.assert_allclose(D2, D1, rtol=1e-6, atol=1e-6)
        D3, I3 = JaxMultiHost(ref, jax_mesh_hosts(2, 4), method=method).search_batch(q, 8, n_probe)
        assert _same_sets(I3, I2)


def test_multihost_row_conservation_and_spill():
    data, _, _ = make_gaussian_clusters(10, 80, 16, spread=0.5, separation=6.0)
    store = VectorStore(external_ids=np.arange(len(data), dtype=np.uint64), vectors=data)
    sp = IvfIndex.fit(store, seed=42, spill=1, device="cpu")
    mh = MultiHostSearcher(sp, grid(2, 4, ("hosts", "shards")), method="dense")
    ids = mh.local_perm[mh.local_perm >= 0]
    assert len(ids) == 2 * len(data) and len(np.unique(ids)) == len(data)  # each id twice
    _, I = mh.search_batch(data[:24], 10, sp.num_clusters)
    for row in I:
        real = row[row >= 0]
        assert len(set(real.tolist())) == len(real)
    assert (I[:, 0] == np.arange(24)).all()


@pytest.mark.parametrize("S", [2, 4])
def test_hier_merge_bytes_s_fold_below_flat(built, S):
    """The counterpart of the reference's merge-byte test: each stage's
    list is one (nq, kk) D / row / owner triple (12 B an entry); stage 2
    gathers only the H host lists, so the bytes crossing hosts are S-fold
    below a flat merge's over the same H*S devices, and independent of S."""
    _, ours, q = built
    H, nq, k = 2, 16, 5
    mh = MultiHostSearcher(ours, grid(H, S, ("hosts", "shards")), method="dense")
    mh.search_batch(q[:nq], k, 4)
    unit = nq * k * 12
    assert mh.last_merge_bytes == {"shards": H * (S - 1) * unit, "hosts": (H - 1) * unit}
    flat = ShardedSearcher(ours, Mesh([CPU] * (H * S), ("shards",)), method="dense")
    flat.search_batch(q[:nq], k, 4)
    assert flat.last_merge_bytes == {"shards": (H * S - 1) * unit}
    # A flat merge onto host 0's first device receives the lists of the
    # (H - 1) * S devices on other hosts.
    flat_cross = flat.last_merge_bytes["shards"] // (H * S - 1) * (H - 1) * S
    assert flat_cross == S * mh.last_merge_bytes["hosts"]


def test_dp_kmeans_quality_vs_reference():
    data, _, _ = make_gaussian_clusters(6, 200, 16, spread=0.3, separation=9.0)
    dp = run_kmeans_lloyd_dp(data, 6, 50, Mesh([CPU] * 8, ("shards",)), seed=3)
    single = tk.run_kmeans_lloyd(t(data), 6, 50, seed=3)
    ref = jax_dp(data, k=6, max_iters=50, mesh=jax_mesh(8), seed=3)
    i_dp = tk.compute_inertia(t(data), dp.centroids, dp.labels)
    assert i_dp <= 1.2 * tk.compute_inertia(t(data), single.centroids, single.labels)
    assert i_dp <= 1.2 * jk.compute_inertia(data, ref.centroids, ref.labels)
    lbl = dp.labels.numpy()
    assert lbl.shape == (len(data),) and lbl.min() >= 0 and lbl.max() < 6
    # Same init (the sample gathered from the slices), no empty cell: the
    # single-device run's centroids and labels.
    np.testing.assert_allclose(dp.centroids.numpy(), single.centroids.numpy(), atol=1e-4)
    np.testing.assert_array_equal(lbl, single.labels.numpy())


@pytest.mark.parametrize("n_dev", [3, 8])
def test_dp_stats_and_init_equal_single_device(n_dev):
    """One iteration's statistics summed over the slices equal the
    single-device sweep's and the reference's one-hot statistics, and the
    k-means++ init gathered from the slices (sampled path) equals the
    single-device init."""
    data = np.random.default_rng(1).normal(size=(1001, 8)).astype(np.float32)
    sl = _Slices(data, [CPU] * n_dev)
    init = tk.init_from_rows(sl.rows, sl.n, 12, 5, CPU, sample_threshold=300)
    np.testing.assert_array_equal(
        init.numpy(), tk.kmeans_plus_plus_init(t(data), 12, seed=5, sample_threshold=300).numpy())
    parts = [tk.lloyd_stats(p, init, 12, 64) for p in sl.parts]
    sums = sum(p[0] for p in parts)
    counts = sum(p[1] for p in parts)
    s1, c1 = tk.lloyd_stats(t(data), init, 12, 256)
    lbl, _ = jk.assign_points(data, init.numpy(), method="dense")
    s2, c2 = jk._segment_stats(data, lbl, 12)
    np.testing.assert_array_equal(counts.numpy(), c1.numpy())
    np.testing.assert_array_equal(counts.numpy(), np.asarray(c2))
    np.testing.assert_allclose(sums.numpy(), s1.numpy(), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(sums.numpy(), np.asarray(s2), rtol=1e-5, atol=1e-4)


def test_dp_kmeans_replicated_repair():
    """Few distinct points and a large k empty cells every iteration: the
    repair takes rows by GLOBAL id from their owning slice, so the final
    per-slice labels are optimal for the one returned centroid table."""
    base = np.random.default_rng(0).normal(size=(12, 16)).astype(np.float32)
    data = np.repeat(base, 40, axis=0)
    res = run_kmeans_lloyd_dp(data, 32, 10, Mesh([CPU] * 8, ("shards",)), seed=7)
    cents = res.centroids.numpy()
    d2 = ((data[:, None, :] - cents[None]) ** 2).sum(-1)
    got = d2[np.arange(len(data)), res.labels.numpy()]
    np.testing.assert_allclose(got, d2.min(1), rtol=1e-5, atol=1e-5)
    # Every repaired row is a data point.
    assert all(np.any(np.all(np.isclose(base, c), axis=1)) for c in cents[np.unique(
        res.labels.numpy())])


def test_mesh_parallel_fit_quality():
    data, _, _ = make_gaussian_clusters(8, 150, 16, spread=0.4, separation=8.0)
    store = VectorStore(external_ids=np.arange(len(data), dtype=np.uint64), vectors=data)
    idx_dp = IvfIndex.fit(store, seed=11, mesh=Mesh([CPU] * 8, ("shards",)), device="cpu")
    idx_1 = IvfIndex.fit(store, seed=11, device="cpu")
    assert int(np.asarray(idx_dp.layout.lengths).sum()) == len(data)

    def inertia(idx):
        lay = idx.layout
        lbl = np.empty(len(data), np.int64)
        for c in range(idx.num_clusters):
            s, m = int(lay.offsets[c]), int(lay.lengths[c])
            lbl[lay.perm[s : s + m]] = c
        return float(((data - idx.centroids[lbl]) ** 2).sum())

    assert inertia(idx_dp) <= 1.2 * inertia(idx_1)
    _, I = idx_dp.search_batch(data[:32], 5, idx_dp.num_clusters)
    assert (I[:, 0] == np.arange(32)).all()
