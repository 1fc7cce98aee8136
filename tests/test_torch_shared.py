"""The shared stream (kernel K5): the port's ``block_stream_search_shared``
(plain K5 on the CPU) vs the JAX reference's (Pallas in interpret mode) on
one converted index and the same quantized tables, and 'auto' reaching the
shared stream on a device-resident index (it raised before K5 was ported)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import make_gaussian_clusters
from torch_parity import CPU, reference_arrays, set_overlap, stream_table_arrays, t

from vector_indexer_tpu.index import IvfIndex as JaxIndex
from vector_indexer_tpu.index import dispatch as jax_dispatch
from vector_indexer_tpu.ops.pallas import block_stream as jbs
from vector_indexer_tpu.storage import VectorStore
from vector_indexer_tpu_torch.convert import (
    index_from_reference_arrays,
    stream_table_from_reference_arrays,
)
from vector_indexer_tpu_torch.index import dispatch as tdispatch
from vector_indexer_tpu_torch.kernels import build as kb
from vector_indexer_tpu_torch.ops import block_stream as tbs

DTYPES = {"bf16": jnp.bfloat16, "int8": jnp.int8, "f32": jnp.float32}


@pytest.fixture(scope="module")
def pair():
    data, _, _ = make_gaussian_clusters(16, 400, 32, spread=0.4, separation=8.0, seed=7)
    store = VectorStore(external_ids=np.arange(len(data), dtype=np.uint64), vectors=data)
    ref = JaxIndex.fit(store, seed=42)
    ours = index_from_reference_arrays(reference_arrays(ref), device=CPU)
    return data, ref, ours


@pytest.fixture(scope="module")
def tables(pair):
    """Each table type, built once by the reference and carried across."""
    _, ref, _ = pair
    out = {}
    for name, dt in DTYPES.items():
        jt = ref._stream_table(dt)
        out[name] = (jt, stream_table_from_reference_arrays(stream_table_arrays(jt), device=CPU))
    return out


def _probe(queries, centroids, n_probe):
    d2 = ((queries[:, None, :].astype(np.float64) - centroids[None]) ** 2).sum(-1)
    return np.argsort(d2, axis=1, kind="stable")[:, :n_probe].astype(np.int32)


def _bound(q, probe, tt, metric):
    """Per-query bound on |port - reference| for a distance, beyond f32
    rounding. int8: the reference splits the query row into two int8
    passes, leaving <= s1/254 per component with s1 = max|q-c|/127, so its
    cross term is within scale_c * |x8|_1 * max|q-c| / 32258 of the exact
    one (x2 in the l2 distance). bf16: its hi/lo split is exact to
    ~2^-17 |q-c| |r| (taken as 1e-5 of the scale below). f32: 0."""
    if tt.dtype != torch.int8:
        return np.zeros(len(q))
    x1 = tt.vecs.to(torch.float32).abs().sum(1).view(-1, tt.chunk).max(1).values.numpy()
    blk_cid = tt.blk_cid.numpy()
    scales = tt.scales.numpy()
    cent = tt.cent.numpy()
    out = []
    for i, p in enumerate(probe):
        qv = q[i][None, :] - cent[p] if metric == "l2" else np.repeat(q[i][None, :], len(p), 0)
        blocks = np.isin(blk_cid, p)
        worst = max((scales[c] * x1[blocks & (blk_cid == c)].max(initial=0.0)
                     * np.abs(qv[j]).max()) for j, c in enumerate(p))
        out.append(worst / 32258.0 * (2.0 if metric == "l2" else 1.0))
    return np.asarray(out)


def _assert_close(D, R, rD, rR, bound):
    """Rank-wise distances within the bound plus 1e-5 of the query's
    distance scale (f32 rounding), and the two sets equal except for rows
    whose distance ties the k-th within that tolerance."""
    scale = np.max(np.where(np.isfinite(rD), np.abs(rD), 0), axis=1, keepdims=True)
    tol = bound[:, None] + 1e-5 * (np.abs(rD) + scale)
    assert np.array_equal(np.isfinite(D), np.isfinite(rD))
    fin = np.isfinite(rD)
    assert np.all(np.abs(D - rD)[fin] <= tol[fin])
    kth = np.where(np.isfinite(rD[:, -1]), rD[:, -1], np.inf)
    for i in np.flatnonzero(set_overlap(R, rR) < 1.0):
        only = np.setdiff1d(R[i], rR[i])
        dist = D[i][np.isin(R[i], only)]
        assert np.all(dist >= kth[i] - 2 * tol[i].max()), (i, dist, kth[i])


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("mode", ["bf16", "int8", "f32"])
@pytest.mark.parametrize("cap", ["budget", "dropping"])
def test_shared_search_matches(pair, tables, mode, metric, cap):
    """Same probes, slots and task budget on both sides; 'dropping' sizes
    t_cap to about half the tasks, so both must drop the same
    (worst-ranked) tasks."""
    data, ref, _ = pair
    jt, tt = tables[mode]
    q = data[::200][:24] + 0.01
    if metric == "ip":
        q = q / np.linalg.norm(q, axis=1, keepdims=True)
    n_probe, k = 5, 30
    probe = _probe(q, ref.centroids, n_probe)
    lengths = tt.lengths.numpy()
    t_fixed = tbs.per_query_slots(lengths, n_probe, chunk=tt.chunk)
    t_cap = tbs.shared_task_cap(lengths, n_probe, len(q), t_fixed, chunk=tt.chunk)
    if cap == "dropping":  # half the tasks (a multiple of the reference's 8-task step)
        blk, _, nval, _ = tbs.build_task_grid(t(q), tt, t(probe).long(), t_fixed, metric)
        n_tasks = int((tbs.build_shared_tasks(t(q), tt, blk, nval, t_cap, metric).blk >= 0).sum())
        t_cap = max(8, n_tasks // 2 // 8 * 8)
        assert t_cap < n_tasks
    kb.reset_launch_counts()
    D, R = tbs.block_stream_search_shared(
        t(q), tt, t(probe).long(), k, t_fixed=t_fixed, t_cap=t_cap, metric=metric
    )
    assert sum(kb.launch_counts().values()) == 0  # CPU: the plain K5
    rD, rR = jbs.block_stream_search_shared(
        jnp.asarray(q), jt, jnp.asarray(probe), k, t_fixed=t_fixed, t_cap=t_cap,
        metric=metric, approx=False, interpret=True,
    )
    _assert_close(D.numpy(), R.numpy(), np.asarray(rD), np.asarray(rR),
                  _bound(q, probe, tt, metric))


def test_shared_tasks_cover_every_pair(pair, tables):
    """With the default budget no pair is dropped, every task holds pairs of
    one block, and each pair's plane row scores that pair's own block."""
    data, ref, _ = pair
    _, tt = tables["bf16"]
    q = t(data[::100][:40] + 0.01)
    probe = t(_probe(q.numpy(), ref.centroids, 6)).long()
    lengths = tt.lengths.numpy()
    t_fixed = tbs.per_query_slots(lengths, 6, chunk=tt.chunk)
    t_cap = tbs.shared_task_cap(lengths, 6, 40, t_fixed, worst_case=True, chunk=tt.chunk)
    blk, _, nval, _ = tbs.build_task_grid(q, tt, probe, t_fixed, "l2")
    tasks = tbs.build_shared_tasks(q, tt, blk, nval, t_cap, "l2")
    valid = (nval > 0).reshape(-1)
    assert torch.equal(tasks.written, valid)
    task_of_pair = tasks.plane_row // tbs.Q_SHARE
    assert torch.equal(tasks.blk[task_of_pair][valid].long(), blk.reshape(-1)[valid])
    assert len(set(tasks.plane_row[valid].tolist())) == int(valid.sum())


def test_auto_serves_stream_shared(pair, monkeypatch):
    """'auto' upgrades to the shared stream at huge probed footprints; the
    gate (forced open here on a small index, at a batch small enough that
    the byte model prefers the stream to the dense sweep) must serve it and
    return the reference's sets."""
    data, ref, ours = pair
    q = data[:4] + 0.01
    for mod in (tdispatch, jax_dispatch):
        monkeypatch.setattr(mod, "SHARED_MIN_NQ", 1)
        monkeypatch.setattr(mod, "SHARED_MIN_PROBED_ROWS", 1)
    assert ours.choose_method(len(q), 2) == "stream_shared" == ref.choose_method(len(q), 2)
    D, I = ours.search_batch(q, 10, 2)
    rD, rI = ref.search_batch(q, 10, 2)
    assert set_overlap(I, rI).min() == 1.0
    np.testing.assert_array_equal(I[:, 0], np.arange(4))
    # bf16 distances: the reference's hi/lo split, ~2^-17 of |q-c||r|.
    np.testing.assert_allclose(D, rD, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("method", ["stream_shared", "stream_shared_exact", "stream_exact"])
def test_stream_methods_match_reference(pair, method):
    """The newly served explicit methods return the reference's sets."""
    data, ref, ours = pair
    q = data[::300][:16] + 0.01
    D, I = ours.search_batch(q, 10, 4, method=method)
    rD, rI = ref.search_batch(q, 10, 4, method=method)
    assert set_overlap(I, rI).min() == 1.0
    np.testing.assert_allclose(D, rD, rtol=1e-4, atol=1e-4)
