"""Port k-means vs the JAX reference: Lloyd from a shared init, blob
recovery and inertia, k-means++ statistics, assignment routes."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import make_gaussian_clusters
from torch_parity import CPU, t

from vector_indexer_tpu.models import kmeans as jk
from vector_indexer_tpu_torch.models import kmeans as tk


@pytest.fixture(scope="module")
def blobs():
    data, labels, centers = make_gaussian_clusters(8, 200, 16, spread=0.5, seed=11)
    return data, labels, centers


@pytest.mark.parametrize("spherical", [False, True])
def test_lloyd_loop_matches_from_shared_init(blobs, spherical):
    data, _, centers = blobs
    if spherical:
        data = data / np.linalg.norm(data, axis=1, keepdims=True)
        centers = centers / np.linalg.norm(centers, axis=1, keepdims=True)
    # The init is near the true centers, so no cluster empties and the
    # (framework-specific) empty-cluster draw never fires.
    noise = 0.02 if spherical else 0.3  # unit-sphere blobs are ~15x tighter
    init = (centers + np.random.default_rng(0).normal(0, noise, centers.shape)).astype(np.float32)
    k = init.shape[0]
    ours, it, conv = tk._lloyd_loop(
        t(data), t(init), tk.make_generator(CPU, 1), k, 7, 0.0, 256, spherical=spherical
    )
    ref, rit, _ = jk._lloyd_loop(
        jnp.asarray(data), jnp.asarray(init), jax.random.PRNGKey(1), k, 7,
        jnp.float32(0.0), 256, spherical=spherical,
    )
    assert it == int(rit) == 7 and not conv
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-4)
    lo, _ = tk.assign_points(t(data), ours)
    lr, _ = jk.assign_points(jnp.asarray(data), ref)
    np.testing.assert_array_equal(lo.numpy(), np.asarray(lr))


def test_lloyd_stops_on_tolerance(blobs):
    data, _, centers = blobs
    c, it, conv = tk._lloyd_loop(
        t(data), t(centers), tk.make_generator(CPU, 1), 8, 100, 1e-4, 256
    )
    assert conv and it < 100


def test_run_kmeans_lloyd_recovers_blobs(blobs):
    data, labels, _ = blobs
    res = tk.run_kmeans_lloyd(t(data), 8, 50, seed=42)
    ref = jk.run_kmeans_lloyd(jnp.asarray(data), 8, 50, seed=42)
    got = res.labels.numpy()
    # Each true blob maps to exactly one cluster (a bijection).
    pairs = set(zip(labels.tolist(), got.tolist()))
    assert len(pairs) == 8 and len({p[1] for p in pairs}) == 8
    ours_inertia = tk.compute_inertia(t(data), res.centroids, res.labels)
    ref_inertia = jk.compute_inertia(data, ref.centroids, ref.labels)
    assert ours_inertia <= 1.10 * ref_inertia


def test_compute_inertia_matches(blobs):
    data, labels, centers = blobs
    ours = tk.compute_inertia(t(data), t(centers), t(labels))
    ref = jk.compute_inertia(data, centers, labels)
    assert ours == pytest.approx(ref, rel=1e-5)


@pytest.mark.parametrize("k,n_sample", [(8, None), (200, 1000)])
def test_kmeans_pp_statistics(blobs, k, n_sample):
    """The generators differ by design, so the draws are compared by what
    k-means++ promises: distinct data points, spread over the blobs."""
    data, labels, _ = blobs
    kw = {} if n_sample is None else {"sample_threshold": n_sample}
    ours = tk.kmeans_plus_plus_init(t(data), k, seed=5, **kw).numpy()
    ref = np.asarray(jk.kmeans_plus_plus_init(data, k, seed=5, **kw))
    for init in (ours, ref):
        assert init.shape == (k, data.shape[1])
        hit = [np.flatnonzero(np.all(data == row, axis=1)) for row in init]
        assert all(len(h) for h in hit)  # every centroid is a data point
        blobs_hit = {int(labels[h[0]]) for h in hit}
        assert len(blobs_hit) == 8  # D^2 weighting reaches every blob
    if k == 8:  # one per blob, in both frameworks
        assert len({tuple(r) for r in ours}) == 8


def test_kmeans_pp_more_centroids_than_points():
    x = np.arange(12, dtype=np.float32).reshape(4, 3)
    out = tk.kmeans_plus_plus_init(t(x), 6).numpy()
    np.testing.assert_array_equal(out, np.asarray(jk.kmeans_plus_plus_init(x, 6)))


def test_assign_routes_agree():
    g = np.random.default_rng(9)
    c = g.normal(0, 3, (600, 32)).astype(np.float32)
    x = (c[g.integers(0, 600, 2000)] + g.normal(0, 1, (2000, 32))).astype(np.float32)
    ld, dd = tk.assign_points(t(x), t(c), method="dense")
    lk, dk = tk.assign_points(t(x), t(c), method="kernel")
    np.testing.assert_array_equal(ld.numpy(), lk.numpy())
    np.testing.assert_allclose(dd.numpy(), dk.numpy(), rtol=1e-5, atol=1e-3)
    lr, _ = jk.assign_points(jnp.asarray(x), jnp.asarray(c), method="dense")
    np.testing.assert_array_equal(ld.numpy(), np.asarray(lr))


def test_unported_trainers_raise():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tk.run_kmeans_mini_batch(torch.zeros(4, 2), 2, 1)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tk.run_kmeans_lloyd_host(torch.zeros(4, 2), 2, 1)
