"""The flat and int8 slice vs the JAX reference: the int8 quantizers, the
int8 / int8x1 modes of K3 and K7 (``flat_sweep_minreduce``) against the
reference kernels in interpret mode, and the flat, fused-flat and int8
search programs on the same index, through the port's dispatch and its
bindings."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import CPU, reference_arrays, reference_search, set_overlap, t

from benchmarks.datasets import clustered
from vector_indexer_tpu.index.ivf import IvfIndex as JaxIndex
from vector_indexer_tpu.ops.pallas import flat_sweep as jfs
from vector_indexer_tpu.storage import VectorStore
from vector_indexer_tpu_torch import bindings
from vector_indexer_tpu_torch.api import VectorIndexer, VectorIndexerConfig
from vector_indexer_tpu_torch.convert import (
    index_from_reference_arrays,
    sweep_int8_tables_from_reference_arrays,
)
from vector_indexer_tpu_torch.index import programs
from vector_indexer_tpu_torch.index.dispatch import resolve
from vector_indexer_tpu_torch.kernels import build as kb
from vector_indexer_tpu_torch.ops import flat_sweep as tfs


def _table(n, d, seed):
    """Rows at scales 0.1-30 (log-uniform), every 37th a zero gap row."""
    g = np.random.default_rng(seed)
    scale = np.exp(g.uniform(np.log(0.1), np.log(30.0), (n, 1)))
    x = (g.normal(size=(n, d)) * scale).astype(np.float32)
    x[::37] = 0.0
    return x


@pytest.mark.parametrize("d", [128, 96])
def test_quantize_table_int8_matches_reference(d):
    """Array-equal codes and scales: the port reproduces the reference's
    arithmetic as XLA evaluates it (x * float32(1/127); one rounding of
    v - x8 * s)."""
    x = _table(20_000, d, seed=d)
    ours = [a.numpy() for a in tfs.quantize_table_int8(t(x))]
    ref = [np.asarray(a) for a in jfs.quantize_table_int8(jnp.asarray(x))]
    for a, b in zip(ours, ref):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@jax.jit
def _reference_query_quantization(q):
    """The reference kernel's in-kernel query quantization
    (ops/pallas/flat_sweep.py:224-234), evaluated by XLA as the kernel is."""
    sq = jnp.maximum(jnp.max(jnp.abs(q), axis=1, keepdims=True), 1e-30) / 127.0
    inv = 1.0 / sq
    q8 = jnp.round(q * inv).astype(jnp.int8)
    qr = q - q8.astype(jnp.float32) * sq
    qr8 = jnp.round(qr * (inv * float(jfs.SHIFT))).astype(jnp.int8)
    return q8, qr8, sq[:, 0]


def test_quantize_queries_int8_matches_reference():
    q = _table(8192, 128, seed=5) + np.random.default_rng(6).normal(size=(8192, 128)).astype(np.float32)
    ours = [a.numpy() for a in tfs.quantize_queries_int8(t(q))]
    ref = [np.asarray(a) for a in _reference_query_quantization(jnp.asarray(q))]
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a, b)


def _sweep_inputs(n, nq, d, seed):
    g = np.random.default_rng(seed)
    centers = g.normal(0, 3, (32, d)).astype(np.float32)
    x = (centers[g.integers(0, 32, n)] + g.normal(0, 1, (n, d))).astype(np.float32)
    x[::37] = 0.0  # layout gap rows: zero vector, sentinel norm
    norms = np.sum(x.astype(np.float64) ** 2, 1).astype(np.float32)
    norms[::37] = 1e30
    q = (centers[g.integers(0, 32, nq)] + g.normal(0, 1, (nq, d))).astype(np.float32)
    return q, x, norms


def _mask(nq, n, w, seed):
    NB = tfs.S * w
    return np.random.default_rng(seed).random((nq, -(-n // NB) * NB // tfs.MASK_ALIGN)) < 0.3


@pytest.mark.parametrize("masked", [False, True], ids=["flat", "masked"])
@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("precision", ["int8", "int8x1"])
def test_int8_plane_matches_reference_kernel(precision, metric, masked):
    """Fed the reference's x8 / r8 / sx (through convert), the int8 planes
    are bit-equal: the integer dots are exact on both sides and the
    epilogue ((float)t * row_mul) * sq is the same two f32 products in the
    same order, so the value bound is 0 ulp. Rows are equal wherever the
    two values are not an exact tie."""
    n, nq, d, w, C = 5000, 16, 128, 8, 4
    q, x, norms = _sweep_inputs(n, nq, d, seed=21)
    x8, r8, sx = jfs.quantize_table_int8(jnp.asarray(x))
    tx8, tr8, tsx = sweep_int8_tables_from_reference_arrays(x8, r8, sx, device=CPU)
    mask = _mask(nq, n, w, seed=2) if masked else None
    kb.reset_launch_counts()
    vals, rows = tfs.flat_sweep_topk_plane(
        t(q), tx8, t(norms), None if mask is None else t(mask), tr8, tsx,
        metric=metric, w=w, c_groups=C, precision=precision)
    assert kb.launch_counts()[f"flat_sweep_topk_plane[{precision}]"] == 0  # CPU: plain
    rvals, rrows = (np.asarray(a) for a in jfs.flat_sweep_topk_plane(
        jnp.asarray(q), x8, jnp.asarray(norms),
        None if mask is None else jnp.asarray(mask, jnp.float32),
        r8 if precision == "int8" else None, sx, metric=metric, w=w, c_groups=C, q_tile=8,
        precision=precision, interpret=True))
    vals, rows = vals.numpy(), rows.numpy()
    assert vals.shape == (nq, 2 * C * tfs.S)
    np.testing.assert_array_equal(vals, rvals)
    tie = vals == rvals  # every entry: a differing row is an exact tie
    assert np.all((rows == rrows) | tie)
    if masked:
        blocks = mask[np.arange(nq)[:, None], np.maximum(rows, 0) // 8]
        assert blocks[rows >= 0].all()


def test_int8_plane_error_band():
    """The int8 values track the exact f32 distances within the reference's
    own bands (tests/test_flat_sweep.py: 0.05 'int8', 1.5 'int8x1' at unit
    scale, d 128), and the true nearest row survives."""
    q, x, norms = _sweep_inputs(4000, 8, 128, seed=22)
    tabs = tfs.quantize_table_int8(t(x))
    exact = norms[None, :].astype(np.float64) - 2.0 * (q.astype(np.float64) @ x.astype(np.float64).T)
    for prec, band in (("int8", 0.05 * 9), ("int8x1", 1.5 * 9)):  # rows here have |x|~3x unit
        vals, rows = tfs.flat_sweep_topk_plane(t(q), tabs[0], t(norms), None, tabs[1], tabs[2],
                                               w=8, c_groups=4, precision=prec)
        vals, rows = vals.numpy(), rows.numpy()
        fin = np.isfinite(vals) & (vals < 1e29)
        err = np.abs(vals[fin] - exact[np.nonzero(fin)[0], rows[fin]])
        assert err.max() <= band, (prec, err.max())


def test_int8_sweep_rejects_bad_operands():
    q, x, norms = _sweep_inputs(2000, 4, 128, seed=23)
    x8, r8, sx = tfs.quantize_table_int8(t(x))
    with pytest.raises(TypeError):  # 'int8' needs the residual table
        tfs.flat_sweep_topk_plane(t(q), x8, t(norms), None, None, sx, precision="int8")
    with pytest.raises(TypeError):  # an int8 mode needs an int8 table
        tfs.flat_sweep_topk_plane(t(q), t(x), t(norms), None, r8, sx, precision="int8x1")
    with pytest.raises(ValueError):
        tfs.flat_sweep_topk_plane(t(q), t(x), t(norms), precision="3pass")
    wide = torch.zeros((8, 4096), dtype=torch.int8)
    with pytest.raises(ValueError):  # the int32 accumulator bound
        tfs.flat_sweep_topk_plane(torch.zeros(1, 4096), wide, torch.zeros(8), None, wide,
                                  torch.ones(8), precision="int8")


@pytest.mark.parametrize("masked", [False, True], ids=["flat", "masked"])
@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("n,w", [(5000, 8), (9000, 16)])
def test_minreduce_matches_reference_kernel(masked, metric, n, w):
    """K7's plain version: values within 1e-5 of the terms' scale (f32 dots
    summed in other orders); rows equal except where the two picks are a
    tie within that tolerance; tail and masked lanes +inf in both."""
    nq, d = 16, 128
    q, x, norms = _sweep_inputs(n, nq, d, seed=n + w)
    mask = _mask(nq, n, w, seed=3) if masked else None
    kb.reset_launch_counts()
    vals, rows = tfs.flat_sweep_minreduce(t(q), t(x), t(norms),
                                          None if mask is None else t(mask), metric=metric, w=w)
    assert kb.launch_counts()["flat_sweep_minreduce"] == 0
    rvals, rrows = (np.asarray(a) for a in jfs.flat_sweep_minreduce(
        jnp.asarray(q), jnp.asarray(x), jnp.asarray(norms),
        None if mask is None else jnp.asarray(mask, jnp.float32),
        metric=metric, w=w, q_tile=8, interpret=True))
    vals, rows = vals.numpy(), rows.numpy()
    assert vals.shape == rvals.shape == (nq, -(-n // (tfs.S * w)) * tfs.S)
    fin = np.isfinite(rvals)
    np.testing.assert_array_equal(np.isfinite(vals), fin)
    cross = q.astype(np.float64) @ x.astype(np.float64).T
    exact = norms[None, :] - 2 * cross if metric == "l2" else np.where(norms >= 1e29, norms, 0.0)[None, :] - cross
    scale = np.abs(exact[:, norms < 1e29]).max(axis=1, keepdims=True)
    tol = np.broadcast_to(1e-5 * scale, vals.shape)
    sent = rvals >= 1e29
    np.testing.assert_allclose(vals[sent], rvals[sent], rtol=1e-6)
    ok = fin & ~sent
    assert np.all(np.abs(vals[ok] - rvals[ok]) <= tol[ok])
    diff = np.argwhere(rows != rrows)
    for i, j in diff:
        assert fin[i, j] and abs(exact[i, rows[i, j]] - exact[i, rrows[i, j]]) <= 2 * tol[i, j]


# ---------------------------------------------------------------------------
# Programs on one index (the reference's programs called directly)
# ---------------------------------------------------------------------------

N, D, NQ, NLIST, K = 8192, 128, 16, 64, 10


@pytest.fixture(scope="module")
def pair():
    xb, xq = clustered(N, D, NQ, seed=7, ncent=40)
    store = VectorStore(external_ids=np.arange(N, dtype=np.uint64), vectors=xb)
    ref = JaxIndex.fit(store, seed=42, nlist=NLIST)
    return ref, index_from_reference_arrays(reference_arrays(ref), device=CPU), xq


# method -> (program the port resolves it to at n = 8192, k = 10)
PROGRAMS = {
    "flat": "flat_torch", "flat_exact": "flat_torch", "flat_fused": "flat_torch",
    "flat_int8": "flat_fused", "flat_int8x1": "flat_fused",
    "dense_int8": "dense_fused", "dense_int8x1": "dense_fused",
}


@pytest.mark.parametrize("method", list(PROGRAMS))
def test_flat_and_int8_programs_match(pair, method):
    """Through the port's dispatch and the reference's program on the same
    state: equal sets on every query; distances within 2e-6 of |q|^2 +
    max|x|^2 (f32 expansions summed in other orders; the int8 planes are
    bit-equal, |q|^2 is added after). At n <= 50k 'flat' and 'flat_fused'
    take the plain exact program in both packages."""
    ref, ours, xq = pair
    dec = resolve(ours, NQ, 4, k=K, method=method)
    assert dec.program == PROGRAMS[method]
    assert dec.precision == {"x1": "int8x1", "t8": "int8"}.get(method[-2:], "highest")
    kb.reset_launch_counts()
    D_, R = (a.numpy() for a in ours.search_batch_device(xq, K, 4, method=method))
    assert sum(kb.launch_counts().values()) == 0
    rD, rR = reference_search(ref, dec.program, xq, K, 4, dec.precision)
    assert set_overlap(R, rR).min() == 1.0
    terms = np.sum(xq * xq, 1)[:, None] + np.asarray(ref.layout.row_norms)[: ref.layout.rows_used].max()
    assert np.all(np.abs(D_ - rD) <= 2e-6 * terms)


@pytest.mark.parametrize("precision", ["highest", "int8"])
def test_flat_fused_program_matches(pair, precision):
    """The fused flat program itself (what 'flat' / 'flat_fused' run above
    50k rows), f32 and int8, against the reference's."""
    ref, ours, xq = pair
    lay = ours.layout
    w, _, C = tfs.plan_fused(lay.vectors.shape[0], D, NQ, K, precision=precision)
    tabs = (lay.vectors, None, None) if precision == "highest" else ours.tables().sweep_int8
    D_, R = (a.numpy() for a in programs.flat_fused_program(
        t(xq), tabs[0], lay.row_norms, tabs[1], tabs[2], k=K, w=w, c_groups=C, metric="l2",
        precision=precision))
    rD, rR = reference_search(ref, "flat_fused", xq, K, 0, precision)
    assert set_overlap(R, rR).min() == 1.0
    np.testing.assert_allclose(D_, rD, rtol=1e-5, atol=1e-5 * np.abs(rD).max())


def test_sweep_int8_tables_equal_the_reference(pair):
    ref, ours, _ = pair
    for a, b in zip(ours.tables().sweep_int8, jfs.quantize_table_int8(ref.layout.vectors)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


NEW_METHODS = ["flat", "flat_exact", "flat_fused", "flat_int8", "flat_int8x1", "dense_int8",
               "dense_int8x1", "gather", "gather_dma"]


@pytest.mark.parametrize("method", NEW_METHODS)
def test_bindings_search_sync_serves_each_method(pair, method):
    """``VectorIndex.search_sync(method=...)`` returns the reference
    program's sets as external ids, with its distances."""
    ref, ours, xq = pair
    vi = bindings.VectorIndex(VectorIndexer(VectorIndexerConfig(D).with_device("cpu"), _index=ours))
    D_, I = vi.search_sync(xq, K, 4, method=method)
    dec = resolve(ours, NQ, 4, k=K, method=method)
    rD, rR = reference_search(ref, dec.program, xq, K, 4, dec.precision)
    rI = np.where(rR >= 0, ref.layout.perm[np.maximum(rR, 0)], -1)  # external id = row index
    assert set_overlap(I, rI).min() == 1.0
    np.testing.assert_allclose(D_, rD, rtol=1e-5, atol=1e-5 * np.abs(rD).max())
