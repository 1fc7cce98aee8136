"""K3 (fused sweep, top-2-per-lane planes): the port's plain version vs the
reference kernel (interpret mode, precision='highest')."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import t

from vector_indexer_tpu.ops.pallas import flat_sweep as jfs
from vector_indexer_tpu_torch.kernels import build as kb
from vector_indexer_tpu_torch.ops import flat_sweep as tfs


def _inputs(n, nq, d, seed, sentinel_every=37):
    g = np.random.default_rng(seed)
    centers = g.normal(0, 3, (32, d)).astype(np.float32)
    x = (centers[g.integers(0, 32, n)] + g.normal(0, 1, (n, d))).astype(np.float32)
    x[::sentinel_every] = 0.0  # layout gap rows: zero vector, sentinel norm
    norms = np.sum(x.astype(np.float64) ** 2, 1).astype(np.float32)
    norms[::sentinel_every] = 1e30
    q = (centers[g.integers(0, 32, nq)] + g.normal(0, 1, (nq, d))).astype(np.float32)
    return q, x, norms


def _f64_vals(q, x, norms, metric):
    cross = q.astype(np.float64) @ x.astype(np.float64).T
    if metric == "l2":
        return norms[None, :].astype(np.float64) - 2 * cross
    return np.where(norms >= 1e29, norms, 0.0)[None, :] - cross


@pytest.mark.parametrize("masked", [False, True], ids=["flat", "masked"])
@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("n,w,c_groups", [(5000, 8, 4), (9000, 8, 8)])
def test_plane_matches_reference_kernel(masked, metric, n, w, c_groups):
    nq, d = 16, 128
    q, x, norms = _inputs(n, nq, d, seed=n + w)
    NB = jfs.S * w
    mcols = -(-n // NB) * NB // jfs.MASK_ALIGN
    mask = None
    if masked:
        mask = np.random.default_rng(1).random((nq, mcols)) < 0.3
    kb.reset_launch_counts()
    vals, rows = tfs.flat_sweep_topk_plane(
        t(q), t(x), t(norms), None if mask is None else t(mask),
        metric=metric, w=w, c_groups=c_groups,
    )
    assert kb.launch_counts()["flat_sweep_topk_plane"] == 0  # CPU: plain version
    rvals, rrows = jfs.flat_sweep_topk_plane(
        jnp.asarray(q), jnp.asarray(x), jnp.asarray(norms),
        None if mask is None else jnp.asarray(mask, jnp.float32),
        metric=metric, w=w, c_groups=c_groups, q_tile=8, precision="highest",
        interpret=True,
    )
    vals, rows = vals.numpy(), rows.numpy()
    rvals, rrows = np.asarray(rvals), np.asarray(rrows)
    assert vals.shape == rvals.shape == (nq, 2 * c_groups * tfs.S)
    fin = np.isfinite(rvals)
    assert np.array_equal(np.isfinite(vals), fin)
    # rtol 1e-5 of the terms' scale (vals are |x|^2 - 2 q.x, which can
    # cancel to near zero; f32 sums in either order err relative to |x|^2).
    exact = _f64_vals(q, x, norms, metric)
    real_rows = norms < 1e29
    scale = np.abs(exact[:, real_rows]).max(axis=1, keepdims=True)
    tol = 1e-5 * scale
    sent = rvals >= 1e29  # sentinel-row survivors: 1e30-ish on both sides
    np.testing.assert_allclose(vals[sent], rvals[sent], rtol=1e-6)
    ok = fin & ~sent
    assert np.all(np.abs(vals[ok] - rvals[ok]) <= np.broadcast_to(tol, vals.shape)[ok])
    # Rows agree except where the two picks are a tie within that tolerance.
    diff = np.argwhere(rows != rrows)
    for i, j in diff:
        a, b = rows[i, j], rrows[i, j]
        assert a >= 0 and b >= 0
        assert abs(exact[i, a] - exact[i, b]) <= 2 * tol[i, 0]
    assert len(diff) <= 2
    if masked:
        blocks = mask[np.arange(nq)[:, None], np.maximum(rows, 0) // 8]
        assert blocks[rows >= 0].all()  # unprobed rows never surface


def test_true_nearest_is_never_lost():
    q, x, norms = _inputs(6000, 8, 128, seed=3, sentinel_every=10**9)
    vals, rows = tfs.flat_sweep_topk_plane(t(q), t(x), t(norms), w=16, c_groups=8)
    best = np.argmin(_f64_vals(q, x, norms, "l2"), axis=1)
    top = rows.numpy()[np.arange(8), np.argmin(vals.numpy(), axis=1)]
    np.testing.assert_array_equal(top, best)


@pytest.mark.parametrize("n", [1000, 50_000, 262_144, 10**6])
@pytest.mark.parametrize("k", [1, 10, 100])
def test_plan_matches_reference(n, k):
    for nq in (1, 100, 1000):
        assert tfs.plan_fused(n, 128, nq, k) == jfs.plan_fused(n, 128, nq, k)
    assert tfs.pick_window(n, k) == jfs.pick_window(n, k)
    assert tfs.pick_groups(n, 8, k) == jfs.pick_groups(n, 8, k)


def test_rejects_short_mask():
    q, x, norms = _inputs(3000, 4, 128, seed=4)
    with pytest.raises(ValueError):
        tfs.flat_sweep_topk_plane(t(q), t(x), t(norms), torch.ones(4, 10, dtype=torch.bool), w=8)
