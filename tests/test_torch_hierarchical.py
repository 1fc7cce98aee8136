"""Hierarchical assignment (k > 8192): the port's deterministic half
``_assign_hierarchical`` vs the reference's ``_assign_hierarchical_jit``
from one shared meta table and meta centroids (made with numpy: the two
packages' seeded meta Lloyd runs draw different numbers), ``auto``
routing past k = 8192, and a build at nlist 8193."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import t

from vector_indexer_tpu.models import kmeans as jk
from vector_indexer_tpu_torch.index.ivf import IvfIndex
from vector_indexer_tpu_torch.models import kmeans as tk
from vector_indexer_tpu_torch.storage.vector_store import VectorStore


def _shared_inputs(n, k, d, seed):
    """Points near random centroids, a meta clustering of the centroids
    (nearest of meta_k centroids drawn from them) and its padded member
    table, all in numpy."""
    g = np.random.default_rng(seed)
    cent = g.normal(0, 4, (k, d)).astype(np.float32)
    x = (cent[g.integers(0, k, n)] + g.normal(0, 1, (n, d))).astype(np.float32)
    meta_k = max(2, min(int(np.sqrt(k)), k // 2))
    meta = cent[g.choice(k, meta_k, replace=False)]
    lbl = ((cent[:, None, :] - meta[None]) ** 2).sum(-1).argmin(1)
    counts = np.bincount(lbl, minlength=meta_k)
    table = np.full((meta_k, counts.max()), -1, np.int32)
    fill = np.zeros(meta_k, np.int64)
    for cid, m in enumerate(lbl):
        table[m, fill[m]] = cid
        fill[m] += 1
    return x, cent, meta, table, lbl


@pytest.mark.parametrize("n,k,d", [(1500, 8500, 8), (900, 9001, 16)])
def test_hierarchical_matches_reference(n, k, d):
    x, cent, meta, table, _ = _shared_inputs(n, k, d, seed=k)
    probes, chunk = 3, 512
    lo, do = tk._assign_hierarchical(t(x), t(cent), t(meta), t(table), probes=probes,
                                     chunk=chunk)
    lr, dr = jk._assign_hierarchical_jit(jnp.asarray(x), jnp.asarray(cent), jnp.asarray(meta),
                                         jnp.asarray(table), probes=probes, chunk=chunk)
    np.testing.assert_array_equal(lo.numpy(), np.asarray(lr))
    # Within 1e-5 of the terms |x|^2 + |c|^2 the distance is summed from
    # (the two packages sum the cross term in another order).
    terms = (x ** 2).sum(1) + (cent[lo.numpy()] ** 2).sum(1)
    assert np.all(np.abs(do.numpy() - np.asarray(dr)) <= 1e-5 * terms)
    assert lo.dtype == torch.int32 and do.dtype == torch.float32


def test_member_table_matches_the_reference_layout():
    """Ids ascending within each group, -1 holes, g_max the largest group."""
    _, _, _, table, lbl = _shared_inputs(10, 300, 4, seed=1)
    got = tk.member_table(t(lbl), table.shape[0]).numpy()
    np.testing.assert_array_equal(got, table)


def test_hierarchical_mostly_exact():
    """The two-level assignment probes 3 meta groups: on clustered points
    most labels are the exact argmin's, and every distance is the distance
    to the label it returns."""
    x, cent, _, _, _ = _shared_inputs(1200, 8200, 8, seed=3)
    lh, dh = tk.assign_points_hierarchical(t(x), t(cent), chunk=512)
    ld, _ = tk.assign_points(t(x), t(cent), method="dense")
    assert (lh == ld).float().mean() >= 0.9
    exact = ((x - cent[lh.numpy()]) ** 2).sum(1)
    np.testing.assert_allclose(dh.numpy(), exact, rtol=1e-4, atol=1e-3)


def test_auto_routes_past_8192(monkeypatch):
    calls = []
    real = tk.assign_points_hierarchical

    def spy(data, centroids, **kw):
        calls.append(centroids.shape[0])
        return real(data, centroids, **kw)

    monkeypatch.setattr(tk, "assign_points_hierarchical", spy)
    x, cent, _, _, _ = _shared_inputs(300, 8193, 4, seed=4)
    labels, dists = tk.assign_points(t(x), t(cent))
    assert calls == [8193]
    assert labels.shape == (300,) and bool(torch.isfinite(dists).all())
    tk.assign_points(t(x), t(cent[:8192]))
    assert calls == [8193]  # k = 8192 stays on the dense / kernel route


def test_fit_at_nlist_8193():
    g = np.random.default_rng(6)
    xb = g.normal(size=(9000, 4)).astype(np.float32)
    store = VectorStore(external_ids=np.arange(len(xb), dtype=np.uint64), vectors=xb)
    idx = IvfIndex.fit(store, seed=1, nlist=8193, max_iters=2, device="cpu")
    assert idx.num_clusters >= 1 and idx.layout.n == len(xb)
    D, R = idx.search_batch_device(xb[:5], 1, 8)
    assert bool(torch.isfinite(D).all())
