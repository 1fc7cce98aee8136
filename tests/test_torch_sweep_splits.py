"""The redesigned fused sweep (K3) on the CPU: the merge of split folds
against the sequential fold, the dense program's query ordering against
arrival order and the reference, the 3xTF32 cross term's error against the
bound stated in csrc/flat_sweep.cu, and the kernel's sizing rules."""

import numpy as np
import pytest
import torch
from torch_parity import (CPU, reference_arrays, reference_search, set_overlap, split_bounds,
                          split_planes_reference, t, tensor_core_cross, tf32_rna)

from benchmarks.datasets import clustered
from vector_indexer_tpu.index.ivf import IvfIndex as JaxIndex
from vector_indexer_tpu.storage import VectorStore
from vector_indexer_tpu_torch.convert import index_from_reference_arrays
from vector_indexer_tpu_torch.index import programs
from vector_indexer_tpu_torch.ops import flat_sweep as fs

PRECISIONS = ["highest", "int8", "int8x1"]


def _inputs(n, nq, d, seed, sentinel_every=37):
    g = np.random.default_rng(seed)
    centers = g.normal(0, 3, (16, d)).astype(np.float32)
    x = (centers[g.integers(0, 16, n)] + g.normal(0, 1, (n, d))).astype(np.float32)
    x[::sentinel_every] = 0.0  # layout gap rows: zero vector, sentinel norm
    norms = np.sum(x.astype(np.float64) ** 2, 1).astype(np.float32)
    norms[::sentinel_every] = 1e30
    q = (centers[g.integers(0, 16, nq)] + g.normal(0, 1, (nq, d))).astype(np.float32)
    return q, x, norms


def _sweep_args(q, x, norms, mask, precision):
    if precision == "highest":
        return (t(q), t(x), t(norms), mask)
    x8, r8, sx = fs.quantize_table_int8(t(x))
    return (t(q), x8, t(norms), mask, r8 if precision == "int8" else None, sx)


@pytest.mark.parametrize("splits", [2, 5])
@pytest.mark.parametrize("masked", [False, True], ids=["flat", "masked"])
@pytest.mark.parametrize("precision", PRECISIONS)
def test_merged_split_folds_equal_the_sequential_fold(precision, masked, splits):
    q, x, norms = _inputs(9000, 12, 64, seed=splits)
    w, c_groups = 8, 2  # 9 steps: group 0 has 5, group 1 has 4 (some splits get none)
    mask = None
    if masked:
        mcols = -(-9000 // (fs.S * w)) * fs.S * w // fs.MASK_ALIGN
        mask = t(np.random.default_rng(7).random((12, mcols)) < 0.4)
    kw = dict(metric="l2", w=w, c_groups=c_groups, precision=precision)
    args = _sweep_args(q, x, norms, mask, precision)
    vals, rows = fs.flat_sweep_topk_plane_reference(*args, **kw)
    parts = split_planes_reference(*args, splits=splits, **kw)
    assert len(parts) == splits
    mv, mr = fs.merge_top2_planes(parts)
    assert torch.equal(mv, vals) and torch.equal(mr, rows)


@pytest.mark.parametrize("precision", ["highest", "int8"])
def test_merge_keeps_the_sequential_order_on_exact_ties(precision):
    """Every 128-row tile repeats the same rows, so each lane sees one value
    in every window of every step: best and second tie exactly, and the
    fold keeps the earlier row as best. The merged splits must too."""
    g = np.random.default_rng(0)
    base = g.normal(size=(fs.S, 32)).astype(np.float32)
    x = np.tile(base, (40, 1))  # 10 steps of w = 4 tiles
    norms = np.sum(x.astype(np.float64) ** 2, 1).astype(np.float32)
    q = g.normal(size=(6, 32)).astype(np.float32)
    kw = dict(metric="l2", w=4, c_groups=2, precision=precision)
    args = _sweep_args(q, x, norms, None, precision)
    vals, rows = fs.flat_sweep_topk_plane_reference(*args, **kw)
    cs = 2 * fs.S
    tie = vals[:, :cs] == vals[:, cs:]
    assert tie.all()  # crafted: every (group, lane) holds an exact tie
    assert (rows[:, :cs] < rows[:, cs:]).all()  # the earlier row stays best
    for splits in (2, 3, 5):
        mv, mr = fs.merge_top2_planes(split_planes_reference(*args, splits=splits, **kw))
        assert torch.equal(mv, vals) and torch.equal(mr, rows)


@pytest.fixture(scope="module")
def pair():
    xb, xq = clustered(8192, 128, 48, seed=5, ncent=40)
    store = VectorStore(external_ids=np.arange(len(xb), dtype=np.uint64), vectors=xb)
    ref = JaxIndex.fit(store, seed=42, nlist=64)
    return ref, index_from_reference_arrays(reference_arrays(ref), device=CPU), xq


@pytest.mark.parametrize("precision", PRECISIONS)
def test_query_order_changes_no_result(pair, precision):
    ref, ours, xq = pair
    k, n_probe = 10, 6
    lay = ours.layout
    w, _, c_groups = fs.plan_fused(lay.vectors.shape[0], 128, len(xq), k, precision=precision)
    block_run, c_ord, c_sq = ours.tables().runs
    if precision == "highest":
        x, resid, scales = lay.vectors, None, None
    else:
        x, resid, scales = ours.tables().sweep_int8
        resid = resid if precision == "int8" else None
    ordered = programs.dense_fused_program(
        t(xq), c_ord, c_sq, x, lay.row_norms, block_run, n_probe, resid, scales, k=k, w=w,
        c_groups=c_groups, metric="l2", precision=precision)
    # The same sweep over the queries in arrival order.
    s_ord, _ = programs._probe_sets(t(xq), c_ord, c_sq, n_probe)
    mcols = -(-lay.vectors.shape[0] // (fs.S * w)) * fs.S * w // fs.MASK_ALIGN
    vals, rows = fs.flat_sweep_topk_plane(
        t(xq), x, lay.row_norms, programs._sweep_mask(s_ord, block_run, mcols), resid, scales,
        metric="l2", w=w, c_groups=c_groups, precision=precision)
    arrival = programs._plane_topk(vals, rows, t(xq), k, "l2")
    assert torch.equal(ordered[0], arrival[0]) and torch.equal(ordered[1], arrival[1])
    _, rR = reference_search(ref, "dense_fused", xq, k, n_probe, precision)
    assert set_overlap(ordered[1].numpy(), rR).min() == 1.0


def test_nearest_probe_order_groups_queries():
    """The order the dense program sweeps in: queries sorted (stably) by
    their nearest cluster's run index."""
    g = np.random.default_rng(3)
    cent = t(g.normal(size=(5, 8)).astype(np.float32))
    q = cent[[3, 1, 3, 0, 1]] + 0.01 * t(g.normal(size=(5, 8)).astype(np.float32))
    s_ord, nearest = programs._probe_sets(q, cent, (cent * cent).sum(1), 2)
    assert nearest.tolist() == [3, 1, 3, 0, 1]
    assert torch.argsort(nearest, stable=True).tolist() == [3, 1, 4, 0, 2]
    assert s_ord.sum(1).tolist() == [2] * 5


@pytest.mark.parametrize("seed,d", [(0, 128), (1, 128), (2, 2048)])
def test_three_tf32_products_stay_inside_the_stated_bound(seed, d):
    q, x, _ = _inputs(300, 16, d, seed=seed, sentinel_every=10**9)
    qb, xb = tf32_rna(q), tf32_rna(x)
    qs, xs = tf32_rna(q - qb), tf32_rna(x - xb)  # q - qb is exact in f32
    assert np.array_equal(tf32_rna(qb), qb) and np.array_equal(tf32_rna(qs), qs)
    f64 = np.float64
    exact = q.astype(f64) @ x.astype(f64).T
    # The split alone: products of tf32 values are exact, summed in f64.
    split = qb.astype(f64) @ xb.astype(f64).T + qb.astype(f64) @ xs.astype(f64).T \
        + qs.astype(f64) @ xb.astype(f64).T
    mag = np.abs(q).astype(f64) @ np.abs(x).astype(f64).T  # sum_i |q_i||x_i|
    split_err = np.abs(split - exact)
    assert (split_err <= 3 * 2.0**-22 * (1 + 2.0**-10) * mag).all()
    assert split_err.max() > 0  # the split is not exact: the bound is what is tested
    # With the accumulation (csrc/flat_sweep.cu: chains of PROMOTE = 4 K
    # chunks, 128 dims): inside the stated total and inside the tolerance
    # the plain version is held to, 1e-5 of |x|^2 + 2|q||x| for the
    # distance |x|^2 - 2 q.x.
    err = np.abs(tensor_core_cross(qb, qs, xb, xs, 128).astype(f64) - exact)
    stated = 3 * 2.0**-22 * (1 + 2.0**-10) + 48 * 2.0**-23 + (d / 128) * 2.0**-24
    assert (err <= stated * mag).all()
    qn = np.linalg.norm(q.astype(f64), axis=1)[:, None]
    xn = np.linalg.norm(x.astype(f64), axis=1)[None, :]
    assert (2 * err <= 1e-5 * (xn * xn + 2 * qn * xn)).all()
    if d > 128:  # one chain over all of d errs more: why the kernel promotes
        chained = np.abs(tensor_core_cross(qb, qs, xb, xs, d).astype(f64) - exact)
        assert chained.max() > 2 * err.max()


def test_sweep_kernel_sizing():
    # Any d whose rows are whole 16-byte units (TMA), resident query tile or not.
    for d, prec in ((16, "highest"), (320, "highest"), (384, "highest"), (768, "highest"),
                    (4096, "highest"), (1280, "int8"), (2048, "int8"), (fs.INT8_MAX_D, "int8x1")):
        fs._kernel_rows_ok(d, prec)
    for d, prec in ((130, "highest"), (136, "int8"), (136, "int8x1"), (0, "highest")):
        with pytest.raises(ValueError, match="16-byte"):
            fs._kernel_rows_ok(d, prec)
    for nq, n, w, c in ((256, 269_848, 16, 8), (1000, 1_000_192, 32, 8), (5, 30_001, 16, 2),
                        (4096, 10**6, 32, 8), (1, 1000, 8, 1)):
        s = fs.sweep_splits(nq, n, w, c, 132)
        steps = -(-(-(-n // (fs.S * w))) // c)
        blocks = -(-nq // 64) * c
        assert 1 <= s <= max(1, steps)
        assert blocks * s >= min(2 * 132, blocks * steps)
    # The main path's shapes: 9 splits at nq 256 (32 blocks), 3 at nq 1000 (128).
    assert fs.sweep_splits(256, 1_015_384, 32, 8, 132) == 9
    assert fs.sweep_splits(1000, 1_015_384, 32, 8, 132) == 3


def test_split_bounds_cover_every_step_once():
    for n_steps in (0, 1, 5, 17):
        for splits in (1, 2, 3, 12):
            covered = [m for s in range(splits) for m in range(*split_bounds(n_steps, s, splits))]
            assert covered == list(range(n_steps))


def test_sweep_mask_is_the_block_mask_padded_with_unprobed_blocks():
    g = np.random.default_rng(4)
    s_ord = torch.as_tensor(g.random((7, 9)) < 0.4)
    block_run = torch.as_tensor(g.integers(-1, 9, 40))
    full = programs._sweep_mask(s_ord, block_run, 48)
    assert full.shape == (7, 48) and not full[:, 40:].any()
    assert torch.equal(full[:, :40], programs._expand_mask(s_ord, block_run))
