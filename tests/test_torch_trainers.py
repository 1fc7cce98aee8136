"""Port mini-batch and balanced trainers vs the JAX reference: the
deterministic pieces on shared inputs (the biased assignment, the loops
from a shared init where no random draw fires), the seeded trainers by the
reference tests' own bounds, and IvfIndex.fit's trainer options and
guards."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import make_gaussian_clusters
from torch_parity import CPU, near_tie_ok, t

from vector_indexer_tpu.index import IvfIndex as JaxIvfIndex
from vector_indexer_tpu.models import kmeans as jk
from vector_indexer_tpu.storage import VectorStore as JaxVectorStore
from vector_indexer_tpu_torch.index.ivf import IvfIndex
from vector_indexer_tpu_torch.models import kmeans as tk
from vector_indexer_tpu_torch.parallel import Mesh
from vector_indexer_tpu_torch.storage.vector_store import VectorStore


def _store(data, cls=VectorStore):
    return cls(external_ids=np.arange(len(data), dtype=np.uint64), vectors=data)


def _inertia(data, res):
    return tk.compute_inertia(t(data), res.centroids, res.labels)


def _skew(labels, k):
    counts = np.bincount(np.asarray(labels), minlength=k)
    return counts.max() / max(counts.mean(), 1e-9), counts


@pytest.mark.parametrize("scale", [0.0, 0.5, 3.0])
def test_assign_dense_biased_matches_reference(scale):
    g = np.random.default_rng(4)
    x = g.normal(size=(700, 12)).astype(np.float32)
    c = g.normal(size=(40, 12)).astype(np.float32)
    bias = (scale * g.normal(size=40)).astype(np.float32)
    lo, do = tk._assign_dense_biased(t(x), t(c), t(bias), chunk=256)
    lr, dr = jk._assign_dense_biased(jnp.asarray(x), jnp.asarray(c), jnp.asarray(bias), chunk=256)
    lo, lr = lo.numpy(), np.asarray(lr)
    d64 = ((x[:, None, :].astype(np.float64) - c[None].astype(np.float64)) ** 2).sum(-1)
    assert near_tie_ok(lo, lr, lambda i, j: d64[i, j] + bias[j]) <= 2
    # TRUE (unbiased) squared distance of the chosen cell.
    np.testing.assert_allclose(do.numpy(), d64[np.arange(len(x)), lo], rtol=1e-5, atol=1e-4)
    same = lo == lr
    np.testing.assert_allclose(do.numpy()[same], np.asarray(dr)[same], rtol=1e-5, atol=1e-4)


def test_balanced_loop_matches_from_shared_init():
    """From an init with no empty cell and no clone-split (the seeded draws
    never fire), the penalized loop is deterministic: the centroids and the
    trained penalty equal the reference's."""
    data, _, centers = make_gaussian_clusters(6, 150, 8, spread=1.0, separation=3.0, seed=2)
    init = (centers + np.random.default_rng(0).normal(0, 0.2, centers.shape)).astype(np.float32)
    ours, pen, it, conv = tk._balanced_loop(t(data), t(init), tk.make_generator(CPU, 1), 6, 8,
                                            0.0, 256, 1.0)
    ref, rpen, rit, _ = jk._lloyd_loop_balanced(
        jnp.asarray(data), jnp.asarray(init), jax.random.PRNGKey(1), 6, 8,
        jnp.float32(0.0), 256, jnp.float32(1.0))
    assert it == int(rit) == 8 and not conv
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-4)
    np.testing.assert_allclose(pen.numpy(), np.asarray(rpen), atol=1e-3)


def test_mini_batch_loop_matches_with_whole_batches():
    """batch_size = n draws every point each step (without replacement), so
    the per-cluster eta = 1/count updates are deterministic: the centroids
    equal the reference's."""
    data, _, centers = make_gaussian_clusters(5, 60, 8, spread=0.5, separation=6.0, seed=3)
    init = (centers + np.random.default_rng(1).normal(0, 0.3, centers.shape)).astype(np.float32)
    n = len(data)
    ours, it, _ = tk._mini_batch_loop(t(data), t(init), tk.make_generator(CPU, 1), 5, 6, 0.0, n)
    ref, rit, _ = jk._mini_batch_loop(jnp.asarray(data), jnp.asarray(init),
                                      jax.random.PRNGKey(1), 5, 6, jnp.float32(0.0), n)
    assert it == int(rit) == 6
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-4)


def test_mini_batch_quality_vs_full_batch():
    """The reference's bound, inertia <= 1.5x full-batch Lloyd's, over
    seeds: a 40-point batch over 8 blobs can miss a blob on the first step,
    whose centroid is then re-seeded elsewhere (cumulative count 0), so
    both packages miss the bound on some seeds; the port must hold it as
    often as the reference does."""
    data, _, _ = make_gaussian_clusters(8, 200, 16, spread=0.5, separation=6.0)
    full = _inertia(data, tk.run_kmeans_lloyd(t(data), 8, 100))
    ours, ref = [], []
    for seed in range(8):
        ours.append(_inertia(data, tk.run_kmeans_mini_batch(t(data), 8, 100, seed=seed)) / full)
        r = jk.run_kmeans_mini_batch(data, k=8, max_iters=100, seed=seed)
        ref.append(jk.compute_inertia(data, r.centroids, r.labels) / full)
    assert np.median(ours) <= 1.5
    assert sum(x <= 1.5 for x in ours) >= sum(x <= 1.5 for x in ref) - 2, (ours, ref)


def test_mini_batch_k200_assignment_optimal():
    data = np.random.default_rng(42).normal(size=(2000, 8)).astype(np.float32)
    res = tk.run_kmeans_mini_batch(t(data), 200, 30)
    c = res.centroids.numpy().astype(np.float64)
    d2 = ((data[:, None, :].astype(np.float64) - c[None]) ** 2).sum(-1)
    lbl = res.labels.numpy()
    np.testing.assert_allclose(d2[np.arange(len(data)), lbl], d2.min(1), rtol=1e-5, atol=1e-5)


def test_refine_iters_improves_balance():
    data = np.random.default_rng(11).normal(size=(5000, 16)).astype(np.float32)
    base = tk.run_kmeans_mini_batch(t(data), 50, 30, seed=4)
    ref = tk.run_kmeans_mini_batch(t(data), 50, 30, seed=4, refine_iters=5)
    assert _inertia(data, ref) <= 1.01 * _inertia(data, base)
    assert np.bincount(ref.labels.numpy(), minlength=50).max() <= \
        np.bincount(base.labels.numpy(), minlength=50).max()


def test_mini_batch_deterministic_and_sampled_batches():
    data = np.random.default_rng(42).normal(size=(500, 8)).astype(np.float32)
    a = tk.run_kmeans_mini_batch(t(data), 10, 20, seed=7)
    b = tk.run_kmeans_mini_batch(t(data), 10, 20, seed=7)
    np.testing.assert_array_equal(a.labels.numpy(), b.labels.numpy())
    np.testing.assert_array_equal(a.centroids.numpy(), b.centroids.numpy())
    # n >= 16 * batch: randint draws; stability across seeds as in the reference.
    data, _, _ = make_gaussian_clusters(6, 150, 8, spread=0.3, separation=8.0)
    inertias = [_inertia(data, tk.run_kmeans_mini_batch(t(data), 6, 100, seed=s, batch_size=32))
                for s in (1, 2, 3)]
    assert max(inertias) / min(inertias) < 1.2


def test_balanced_reduces_skew_isotropic():
    data = np.random.default_rng(0).standard_normal((6000, 16)).astype(np.float32)
    base = tk.run_kmeans_lloyd(t(data), 32, 25, seed=42)
    bal = tk.run_kmeans_balanced(t(data), 32, 25, balance=1.0, seed=42)
    r_base, _ = _skew(base.labels, 32)
    r_bal, counts = _skew(bal.labels, 32)
    assert counts.sum() == len(data)
    assert r_bal <= r_base + 1e-6 and r_bal < 1.7, (r_bal, r_base)
    assert _inertia(data, bal) <= 1.5 * _inertia(data, base)


def test_balanced_splits_point_mass():
    g = np.random.default_rng(0)
    tight = 0.05 * g.standard_normal((3000, 16)).astype(np.float32)
    wide = 4.0 * g.standard_normal((3000, 16)).astype(np.float32) + 8.0
    data = np.vstack([tight, wide]).astype(np.float32)
    base = tk.run_kmeans_lloyd(t(data), 32, 60, seed=42)
    bal = tk.run_kmeans_balanced(t(data), 32, 60, balance=1.0, seed=42)
    r_base, _ = _skew(base.labels, 32)
    r_bal, counts = _skew(bal.labels, 32)
    assert counts.sum() == len(data)
    assert r_base > 8  # the failure mode is present
    assert r_bal < 4, (r_bal, r_base)


def test_balanced_on_clustered_corpus_like_reference():
    """On the smoke's corpus family (benchmarks/datasets.py::clustered, ~4
    cells per blob, 20 passes as at 1M) the balanced trainer trades
    inertia for skew and leaves cells empty; the port does so as the
    reference does (same algorithm, other generators)."""
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location(
        "datasets", Path(__file__).resolve().parents[1] / "benchmarks" / "datasets.py")
    ds = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ds)
    xb, _ = ds.clustered(20_000, 128, 10, seed=42)
    k = 284  # calculate_num_clusters(20_000)
    lloyd = tk.run_kmeans_lloyd(t(xb), k, 20, seed=42)
    base = _inertia(xb, lloyd)
    ours = tk.run_kmeans_balanced(t(xb), k, 20, seed=42)
    ref = jk.run_kmeans_balanced(xb, k, 20, seed=42)
    r_ours = _inertia(xb, ours) / base
    r_ref = jk.compute_inertia(xb, ref.centroids, ref.labels) / base

    def lists(labels):  # the posting lists fit() keeps: max / mean of the non-empty
        c = np.bincount(np.asarray(labels), minlength=k)
        return c[c > 0].max() / c[c > 0].mean(), int((c == 0).sum())

    (s_base, _), (s_ours, e_ours), (s_ref, e_ref) = (
        lists(lloyd.labels), lists(ours.labels), lists(ref.labels))
    assert s_ours < s_base and s_ref < s_base, (s_ours, s_ref, s_base)
    assert e_ours > 0 and e_ref > 0
    assert abs(r_ours - r_ref) <= 0.3, (r_ours, r_ref)


def test_fit_balanced_trainer_end_to_end():
    data = np.random.default_rng(3).standard_normal((5000, 24)).astype(np.float32)
    idx = IvfIndex.fit(_store(data), seed=42, trainer="balanced", device="cpu")
    lengths = np.asarray(idx.layout.lengths)
    assert lengths.sum() == len(data)
    assert lengths.max() / lengths.mean() < 2.0
    D, I = idx.search_batch(data[:16], 5, 8)
    assert (I[:, 0] == np.arange(16)).all() and D[:, 0].max() < 1e-3


@pytest.mark.parametrize("metric", ["l2", "cosine"])
def test_fit_mini_batch_trainer_end_to_end(metric):
    data, _, _ = make_gaussian_clusters(10, 150, 16, spread=0.4, separation=6.0)
    idx = IvfIndex.fit(_store(data), seed=42, trainer="mini_batch", metric=metric, device="cpu")
    assert int(np.asarray(idx.layout.lengths).sum()) == len(data)
    if metric == "cosine":  # spherical training: unit centroids
        np.testing.assert_allclose(np.linalg.norm(idx.centroids, axis=1), 1.0, atol=1e-4)
    _, I = idx.search_batch(data[:16], 5, idx.num_clusters)
    assert (I[:, 0] == np.arange(16)).all()


def test_fit_guards_match_reference():
    data, _, _ = make_gaussian_clusters(4, 50, 8)
    mesh = Mesh([CPU] * 2, ("shards",))
    cases = [
        dict(trainer="mini_batch", train_sample=100),
        dict(trainer="balanced", train_sample=100),
        dict(resident="host", trainer="mini_batch"),
        dict(trainer="nope"),
    ]
    for kw in cases:
        with pytest.raises(ValueError):
            IvfIndex.fit(_store(data), device="cpu", **kw)
        with pytest.raises(ValueError):
            JaxIvfIndex.fit(_store(data, JaxVectorStore), **kw)
    with pytest.raises(ValueError, match="mesh-parallel"):
        IvfIndex.fit(_store(data), mesh=mesh, trainer="mini_batch", device="cpu")
    with pytest.raises(ValueError, match="train_sample"):
        IvfIndex.fit(_store(data), mesh=mesh, train_sample=100, device="cpu")
    with pytest.raises(ValueError, match="resident='host'"):
        IvfIndex.fit(_store(data), mesh=mesh, resident="host", spill=1, device="cpu")
