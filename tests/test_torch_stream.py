"""Stream search (kernels K2/K4): the port's stream table, task grid and
``block_stream_search`` (plain versions) vs the JAX reference (Pallas in
interpret mode) on one converted index."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import make_gaussian_clusters
from torch_parity import CPU, reference_arrays, set_overlap, t

from vector_indexer_tpu.index import IvfIndex as JaxIndex
from vector_indexer_tpu.ops.pallas import block_stream as jbs
from vector_indexer_tpu.storage import VectorStore
from vector_indexer_tpu_torch.convert import index_from_reference_arrays
from vector_indexer_tpu_torch.kernels import build as kb
from vector_indexer_tpu_torch.ops import block_stream as tbs


@pytest.fixture(scope="module")
def pair():
    data, _, _ = make_gaussian_clusters(16, 400, 32, spread=0.4, separation=8.0, seed=7)
    store = VectorStore(external_ids=np.arange(len(data), dtype=np.uint64), vectors=data)
    ref = JaxIndex.fit(store, seed=42)
    ours = index_from_reference_arrays(reference_arrays(ref), device=CPU)
    return data, ref, ours, ref._stream_table(jnp.bfloat16), ours._stream_table()


def _probe(queries, centroids, n_probe):
    d2 = ((queries[:, None, :].astype(np.float64) - centroids[None]) ** 2).sum(-1)
    return np.argsort(d2, axis=1, kind="stable")[:, :n_probe].astype(np.int32)


def test_stream_table_matches(pair):
    _, _, _, jt, tt = pair
    assert tt.chunk == jt.chunk and tt.m_pad == jt.m_pad
    # bf16 residual rows bit-equal (both round to nearest even).
    np.testing.assert_array_equal(
        tt.vecs.view(torch.int16).numpy(),
        np.asarray(jt.vecs).view(np.int16),
    )
    np.testing.assert_allclose(tt.norms.numpy(), np.asarray(jt.norms), rtol=1e-6)
    for name in ("to_main", "sblk0", "lengths"):
        np.testing.assert_array_equal(getattr(tt, name).numpy(), np.asarray(getattr(jt, name)))
    np.testing.assert_array_equal(tt.cent.numpy(), np.asarray(jt.cent))


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("n_probe", [3, 9])
def test_task_grid_matches(pair, metric, n_probe):
    data, ref, ours, jt, tt = pair
    q = data[:20] + 0.01
    probe = _probe(q, ref.centroids, n_probe)
    t_fixed = tbs.per_query_slots(ours.layout.lengths, n_probe, chunk=tt.chunk)
    assert t_fixed == jbs.per_query_slots(np.asarray(ref.layout.lengths), n_probe, chunk=jt.chunk)
    blk, cid, nval, bias = tbs.build_task_grid(t(q), tt, t(probe).long(), t_fixed, metric)
    rblk, rcid, rnval, _, rbias = jbs.build_task_grid(
        jnp.asarray(q), jt, jnp.asarray(probe), t_fixed, metric
    )
    np.testing.assert_array_equal(blk.numpy(), np.asarray(rblk))
    np.testing.assert_array_equal(cid.numpy(), np.asarray(rcid))
    np.testing.assert_array_equal(nval.numpy(), np.asarray(rnval))
    np.testing.assert_allclose(bias.numpy(), np.asarray(rbias), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("fused", [False, True], ids=["K2", "K4"])
@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_block_stream_search_matches(pair, fused, metric):
    data, ref, ours, jt, tt = pair
    q = data[:24] + 0.01
    if metric == "ip":
        q = q / np.linalg.norm(q, axis=1, keepdims=True)
    n_probe, k = 4, 40
    probe = _probe(q, ref.centroids, n_probe)
    t_fixed = tbs.per_query_slots(ours.layout.lengths, n_probe, chunk=tt.chunk)
    kb.reset_launch_counts()
    D, R = tbs.block_stream_search(
        t(q), tt, t(probe).long(), k, t_fixed=t_fixed, metric=metric, fused=fused
    )
    assert sum(kb.launch_counts().values()) == 0  # CPU: plain versions
    rD, rR = jbs.block_stream_search(
        jnp.asarray(q), jt, jnp.asarray(probe), k, t_fixed=t_fixed, metric=metric,
        approx=False, fused=fused, interpret=True,
    )
    D, R, rD, rR = D.numpy(), R.numpy(), np.asarray(rD), np.asarray(rR)
    assert set_overlap(R, rR).min() == 1.0
    # rtol 1e-5 of each query's distance scale: the reference's bf16 hi/lo
    # query split leaves ~2^-17 |q-c||r| in its cross term, which is not
    # relative to a near-zero (self-match) distance.
    scale = np.max(np.where(np.isfinite(rD), np.abs(rD), 0), axis=1, keepdims=True)
    assert np.array_equal(np.isfinite(D), np.isfinite(rD))
    fin = np.isfinite(rD)
    assert np.all(np.abs(D - rD)[fin] <= (1e-5 * (np.abs(rD) + scale))[fin])


def test_fused_reference_matches_sequential_fold(pair):
    """K4's plain version keeps, per (group, lane), the best and second
    value over the slots that feed it: check that against a direct sort."""
    data, ref, ours, _, tt = pair
    q = data[:6] + 0.01
    probe = _probe(q, ref.centroids, 6)
    t_fixed = tbs.per_query_slots(ours.layout.lengths, 6, chunk=tt.chunk)
    blk, cid, nval, bias = tbs.build_task_grid(t(q), tt, t(probe).long(), t_fixed, "l2")
    G = tbs.pick_stream_groups(tt.chunk)
    plane, slots = tbs.stream_fused_plane(
        t(q), tt.cent, cid, blk, nval, bias, tt.vecs, tt.norms, chunk=tt.chunk,
        groups=G, metric="l2",
    )
    dist = tbs.stream_distances(
        t(q), tt.cent, cid, blk, bias, tt.vecs, tt.norms, chunk=tt.chunk, metric="l2"
    ).numpy()
    lane = np.arange(tt.chunk)
    dist = np.where(lane[None, None, :] < nval.numpy()[:, :, None], dist, np.inf)
    t_sub = t_fixed // tbs.FAN
    width = G * tt.chunk
    for g in range(G):
        slots_g = [f * t_sub + u for u in range(t_sub) for f in range(g, tbs.FAN, G)]
        vals = np.sort(dist[:, slots_g, :], axis=1)
        np.testing.assert_array_equal(plane.numpy()[:, g * tt.chunk:(g + 1) * tt.chunk], vals[:, 0])
        np.testing.assert_array_equal(
            plane.numpy()[:, width + g * tt.chunk: width + (g + 1) * tt.chunk], vals[:, 1]
        )
    assert ((slots.numpy() >= 0) == np.isfinite(plane.numpy())).all()


def test_fused_gate_matches_reference():
    for t_fixed in (16, 32, 48, 64, 96):
        for chunk in (256, 512, 1024):
            for k in (10, 100, 2000):
                ref = t_fixed * chunk >= jbs.FUSED_STREAM_MIN_ROWS and k <= jbs.pick_stream_groups(chunk) * chunk
                assert tbs.fused_engages(t_fixed, chunk, k) == ref
