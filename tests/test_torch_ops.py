"""Port oracle layer vs the JAX reference: norms, distances, selection,
heuristics, shape quantization and the posting layout."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import t

from vector_indexer_tpu.ops import distance as jd
from vector_indexer_tpu.ops import gather as jg
from vector_indexer_tpu.ops import topk as jt
from vector_indexer_tpu.storage import layout as jl
from vector_indexer_tpu.utils import heuristics as jh
from vector_indexer_tpu_torch.ops import distance as td
from vector_indexer_tpu_torch.ops import gather as tg
from vector_indexer_tpu_torch.ops import topk as tt
from vector_indexer_tpu_torch.storage import layout as tl
from vector_indexer_tpu_torch.utils import heuristics as th


@pytest.mark.parametrize("d", [16, 128])
def test_sq_norms_match(d):
    x = np.random.default_rng(d).normal(0, 3, (257, d)).astype(np.float32)
    np.testing.assert_allclose(
        td.sq_norms(t(x)).numpy(), np.asarray(jd.sq_norms(jnp.asarray(x))), rtol=1e-6
    )


@pytest.mark.parametrize("d", [16, 128])
def test_pairwise_sq_l2_matches(d):
    g = np.random.default_rng(1 + d)
    x = g.normal(0, 2, (300, d)).astype(np.float32)
    c = g.normal(0, 2, (70, d)).astype(np.float32)
    ours = td.pairwise_sq_l2(t(x), t(c)).numpy()
    ref = np.asarray(jd.pairwise_sq_l2(jnp.asarray(x), jnp.asarray(c)))
    # f32 expansion |x|^2 - 2x.c + |c|^2: both sides sum in f32 in their
    # own order; the error scales with the terms (~|x|^2), not the result.
    scale = (np.sum(x * x, 1)[:, None] + np.sum(c * c, 1)[None, :])
    assert np.all(np.abs(ours - ref) <= 1e-6 * scale + 1e-6)
    assert ours.min() >= 0.0


@pytest.mark.parametrize("n,k", [(50, 10), (1000, 100), (7, 10)])
def test_topk_smallest_matches(n, k):
    x = np.random.default_rng(n).normal(size=(5, n)).astype(np.float32)
    v, i = tt.topk_smallest(t(x), k)
    rv, ri = jt.topk_smallest(jnp.asarray(x), k)
    np.testing.assert_array_equal(v.numpy(), np.asarray(rv))
    np.testing.assert_array_equal(i.numpy(), np.asarray(ri))


def test_merge_topk_matches():
    g = np.random.default_rng(3)
    va, vb = (np.sort(g.normal(size=(4, 8)), 1).astype(np.float32) for _ in range(2))
    ia, ib = g.integers(0, 100, (4, 8)), g.integers(100, 200, (4, 8))
    v, i = tt.merge_topk(t(va), t(ia), t(vb), t(ib), 6)
    rv, ri = jt.merge_topk(jnp.asarray(va), jnp.asarray(ia), jnp.asarray(vb), jnp.asarray(ib), 6)
    np.testing.assert_array_equal(v.numpy(), np.asarray(rv))
    np.testing.assert_array_equal(i.numpy(), np.asarray(ri))


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_brute_force_topk_matches(metric):
    g = np.random.default_rng(4)
    db = g.normal(size=(3000, 32)).astype(np.float32)
    q = g.normal(size=(9, 32)).astype(np.float32)
    v, i = tt.brute_force_topk(t(q), t(db), 10, db_chunk=1024, metric=metric)
    rv, ri = jt.brute_force_topk(jnp.asarray(q), jnp.asarray(db), 10, db_chunk=1024, metric=metric)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ri))
    np.testing.assert_allclose(v.numpy(), np.asarray(rv), rtol=1e-5, atol=1e-4)


def test_brute_force_topk_skips_sentinel_rows():
    g = np.random.default_rng(5)
    db = g.normal(size=(100, 8)).astype(np.float32)
    norms = np.sum(db * db, 1).astype(np.float32)
    norms[:50] = 1e30
    _, i = tt.brute_force_topk(t(db[:3]), t(db), 5, db_row_norms=t(norms))
    assert (i.numpy() >= 50).all()


@pytest.mark.parametrize("n", [0, 1, 99, 9_999, 10_000, 99_999, 100_000, 999_999, 10**6])
def test_heuristics_match(n):
    assert th.calculate_num_clusters(n) == jh.calculate_num_clusters(n)
    assert th.calculate_max_iterations(n) == jh.calculate_max_iterations(n)
    assert th.num_shards_for(max(n, 1)) == jh.num_shards_for(max(n, 1))
    assert th.suggest_nlist(n) == jh.suggest_nlist(n)


def test_quantize_up_matches():
    for x in range(0, 5000, 7):
        assert tg.quantize_up(x) == jg.quantize_up(x)


def _layout_inputs(seed, n=600, d=24, kc=13, empty=()):
    g = np.random.default_rng(seed)
    x = g.normal(size=(n, d)).astype(np.float32)
    labels = g.integers(0, kc, n)
    for e in empty:
        labels[labels == e] = (e + 1) % kc
    order = g.permutation(kc)
    return x, labels, kc, order


@pytest.mark.parametrize("seed,empty", [(0, ()), (1, (3, 7))])
def test_build_layout_matches(seed, empty):
    x, labels, kc, order = _layout_inputs(seed, empty=empty)
    ours = tl.build_layout(t(x), labels, kc, order)
    ref = jl.build_layout(x, labels, kc, order)
    np.testing.assert_array_equal(ours.vectors.numpy(), np.asarray(ref.vectors))
    np.testing.assert_allclose(ours.row_norms.numpy(), np.asarray(ref.row_norms), rtol=1e-6)
    np.testing.assert_array_equal(ours.offsets, np.asarray(ref.offsets))
    np.testing.assert_array_equal(ours.lengths, np.asarray(ref.lengths))
    np.testing.assert_array_equal(ours.perm, ref.perm)
    assert (ours.n, ours.max_list_len, ours.rows_used) == (ref.n, ref.max_list_len, ref.rows_used)


def test_layout_invariants():
    x, labels, kc, order = _layout_inputs(2)
    lay = tl.build_layout(t(x), labels, kc, order)
    starts = lay.offsets[:-1]
    assert (starts % tl.ALIGN == 0).all()
    gap = np.ones(lay.vectors.shape[0], bool)
    gap[: lay.rows_used][lay.perm >= 0] = False
    assert (lay.row_norms.numpy()[gap] == tl.SENTINEL_NORM).all()
    assert (lay.vectors.numpy()[gap] == 0).all()
    # Tail pad past the last run, as in the reference.
    assert lay.vectors.shape[0] >= lay.rows_used + lay.max_list_len + 1
    real = lay.perm >= 0
    np.testing.assert_array_equal(lay.vectors.numpy()[: lay.rows_used][real], x[lay.perm[real]])
