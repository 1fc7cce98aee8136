"""Offload serving and the int8 / f32 stream tables: the port (plain kernel
versions on the CPU) vs the JAX reference (Pallas in interpret mode) on the
same seeded inputs, at tests/test_int8_offload.py's size.

* (a) the int8 / f32 / bf16 stream-table builds, on the device and on the host;
* (b) K2 / K4 on int8 tables and K2 on f32 tables through
  ``block_stream_search``;
* (d) the correction table's device and host builds;
* (e) offload search in the three re-rank modes, entered through
  ``offload_main_table`` and ``load(resident='offload')``, with indexes
  saved by either package;
* (f) the offloaded dispatch branch; (g) the errors.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import make_gaussian_clusters
from torch_parity import (
    CPU,
    correction_table_arrays,
    reference_arrays,
    set_overlap,
    stream_table_arrays,
    t,
)

from vector_indexer_tpu.index import IvfIndex as JaxIndex
from vector_indexer_tpu.index import load_index_from as jax_load
from vector_indexer_tpu.ops import correction as jcorr
from vector_indexer_tpu.ops.pallas import block_stream as jbs
from vector_indexer_tpu.storage import VectorStore
from vector_indexer_tpu.storage.layout import PostingLayout as JaxLayout
from vector_indexer_tpu_torch import bindings
from vector_indexer_tpu_torch.convert import (
    index_from_reference_arrays,
    stream_table_from_reference_arrays,
)
from vector_indexer_tpu_torch.index import dispatch as tdispatch
from vector_indexer_tpu_torch.index.ivf import load_index_from
from vector_indexer_tpu_torch.kernels import build as kb
from vector_indexer_tpu_torch.ops import block_stream as tbs
from vector_indexer_tpu_torch.ops import correction as tcorr
from vector_indexer_tpu_torch.storage.layout import PostingLayout

TORCH = {"bf16": torch.bfloat16, "int8": torch.int8, "f32": torch.float32}
JAX = {"bf16": jnp.bfloat16, "int8": jnp.int8, "f32": jnp.float32}
RERANKS = ["host", "device", "none"]


def _store(data):
    return VectorStore(external_ids=np.arange(len(data), dtype=np.uint64), vectors=data)


@pytest.fixture(scope="module")
def pair():
    """test_int8_offload.py's corpus: 10 clusters x 150 points x 24 dims."""
    data, _, _ = make_gaussian_clusters(10, 150, 24, spread=0.4, separation=8.0)
    ref = JaxIndex.fit(_store(data), seed=42)
    return data, ref, index_from_reference_arrays(reference_arrays(ref), device=CPU)


def _host_layouts(ref):
    """The reference layout staged on the host, in both packages' types."""
    lay = ref.layout
    kw = dict(offsets=np.asarray(lay.offsets), lengths=np.asarray(lay.lengths),
              perm=lay.perm, n=lay.n, max_list_len=lay.max_list_len)
    vec, nrm = np.asarray(lay.vectors), np.asarray(lay.row_norms)
    return JaxLayout(vectors=vec, row_norms=nrm, **kw), PostingLayout(vectors=vec, row_norms=nrm, **kw)


# --- (a) the stream-table builds ---------------------------------------------


def _assert_tables_equal(tt, jt, max_ulp_norms):
    """Rows equal (int8 codes, bf16 bit patterns, f32 values), maps equal,
    scales equal (the same f32 ops), norms within ``max_ulp_norms`` ulp (the
    sums run in another order)."""
    assert tt.chunk == jt.chunk and tt.m_pad == jt.m_pad
    jv = np.asarray(jt.vecs)
    if tt.dtype == torch.bfloat16:
        np.testing.assert_array_equal(tt.vecs.view(torch.int16).numpy(), jv.view(np.int16))
    else:
        np.testing.assert_array_equal(tt.vecs.numpy(), jv)
    for name in ("to_main", "sblk0", "lengths", "blk_cid"):
        np.testing.assert_array_equal(getattr(tt, name).numpy(), np.asarray(getattr(jt, name)))
    np.testing.assert_array_equal(tt.scales.numpy(), np.asarray(jt.scales))
    np.testing.assert_array_max_ulp(tt.norms.numpy(), np.asarray(jt.norms), maxulp=max_ulp_norms)


@pytest.mark.parametrize("mode", ["int8", "f32"])
def test_device_table_build_matches(pair, mode):
    _, ref, ours = pair
    tt = tbs.build_stream_table(ours.layout, ours.centroids, TORCH[mode])
    jt = jbs.build_stream_table(ref.layout, ref.centroids, JAX[mode])
    # torch.sum and jnp.sum of 24 squares differ by at most a few ulp.
    _assert_tables_equal(tt, jt, max_ulp_norms=4)
    if mode == "int8":
        assert int(tt.vecs.abs().max()) <= 127


@pytest.mark.parametrize("mode", ["int8", "f32", "bf16"])
def test_host_table_build_matches(pair, mode):
    _, ref, _ = pair
    jlay, tlay = _host_layouts(ref)
    tt = tbs.build_stream_table_host(tlay, ref.centroids, TORCH[mode], device="cpu")
    jt = jbs.build_stream_table_host(jlay, ref.centroids, JAX[mode])
    # The same numpy arithmetic on both sides: the norms agree to 1 ulp.
    _assert_tables_equal(tt, jt, max_ulp_norms=1)


# --- (b) K2 / K4 int8 and K2 f32 ---------------------------------------------


def _probe(queries, centroids, n_probe):
    d2 = ((queries[:, None, :].astype(np.float64) - centroids[None]) ** 2).sum(-1)
    return np.argsort(d2, axis=1, kind="stable")[:, :n_probe].astype(np.int32)


def _int8_bound(q, probe, tt, metric):
    """Per-query bound on |port - reference| in a distance on an int8 table:
    the reference splits each query row into two int8 passes (s1 * q1 +
    s2 * q2, s1 = max|q-c| / 127), leaving <= s1 / 254 per component, so its
    cross term is within scale_c * |x8|_1 * max|q-c| / 32258 of the exact
    dot (twice that in the l2 distance). The port's cross term is exact up
    to f32 summation order."""
    x1 = tt.vecs.to(torch.float32).abs().sum(1).view(-1, tt.chunk).max(1).values.numpy()
    blk_cid, scales, cent = tt.blk_cid.numpy(), tt.scales.numpy(), tt.cent.numpy()
    out = []
    for i, p in enumerate(probe):
        qv = q[i][None, :] - cent[p] if metric == "l2" else np.repeat(q[i][None, :], len(p), 0)
        worst = max(scales[c] * x1[blk_cid == c].max(initial=0.0) * np.abs(qv[j]).max()
                    for j, c in enumerate(p))
        out.append(worst / 32258.0 * (2.0 if metric == "l2" else 1.0))
    return np.asarray(out)


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("kernel", ["K2-int8", "K4-int8", "K2-f32"])
def test_block_stream_search_quantized_matches(pair, kernel, metric):
    data, ref, _ = pair
    mode = kernel.split("-")[1]
    jt = ref._stream_table(JAX[mode])
    tt = stream_table_from_reference_arrays(stream_table_arrays(jt), device=CPU)
    q = data[::60][:24] + 0.01
    if metric == "ip":
        q = q / np.linalg.norm(q, axis=1, keepdims=True)
    n_probe, k = 4, 30
    probe = _probe(q, ref.centroids, n_probe)
    t_fixed = tbs.per_query_slots(tt.lengths.numpy(), n_probe, chunk=tt.chunk)
    fused = kernel.startswith("K4")
    kb.reset_launch_counts()
    D, R = tbs.block_stream_search(t(q), tt, t(probe).long(), k, t_fixed=t_fixed,
                                   metric=metric, fused=fused)
    assert sum(kb.launch_counts().values()) == 0  # CPU: plain versions
    rD, rR = jbs.block_stream_search(jnp.asarray(q), jt, jnp.asarray(probe), k,
                                     t_fixed=t_fixed, metric=metric, approx=False,
                                     fused=fused, interpret=True)
    D, R, rD, rR = D.numpy(), R.numpy(), np.asarray(rD), np.asarray(rR)
    bound = _int8_bound(q, probe, tt, metric) if mode == "int8" else np.zeros(len(q))
    # Plus f32 rounding: 1e-5 of each query's distance scale.
    scale = np.max(np.where(np.isfinite(rD), np.abs(rD), 0), axis=1, keepdims=True)
    tol = bound[:, None] + 1e-5 * (np.abs(rD) + scale)
    assert np.array_equal(np.isfinite(D), np.isfinite(rD))
    fin = np.isfinite(rD)
    assert np.all(np.abs(D - rD)[fin] <= tol[fin])  # rank by rank
    # Rows in only one set tie the k-th distance within the tolerance.
    for i in np.flatnonzero(set_overlap(R, rR) < 1.0):
        d_only = D[i][~np.isin(R[i], rR[i])]
        assert np.all(d_only >= rD[i, -1] - 2 * tol[i].max())


# --- (d) the correction table -------------------------------------------------


def test_correction_tables_match(pair):
    _, ref, ours = pair
    jt = ref._stream_table(jnp.int8)
    tt = stream_table_from_reference_arrays(stream_table_arrays(jt), device=CPU)
    jdev = correction_table_arrays(jcorr.build_correction_table(ref.layout, jt))
    tdev = tcorr.build_correction_table(ours.layout, tt)
    jlay, tlay = _host_layouts(ref)
    jhost = correction_table_arrays(jcorr.build_correction_table_host(jlay, jt))
    thost = tcorr.build_correction_table_host(tlay, tt)
    for got, want in ((tdev, jdev), (thost, jhost)):
        assert got.m_pad == want["m_pad"]
        # q2 = round(err / s2): equal codes except where err / s2 lands on a
        # rounding boundary after a last-bit difference in err.
        assert (got.q2.numpy() == want["q2"]).mean() > 0.999
        assert np.abs(got.q2.numpy().astype(int) - want["q2"]).max() <= 1
        np.testing.assert_array_max_ulp(got.scales2.numpy(), want["scales2"], maxulp=1)
        np.testing.assert_allclose(got.norms_abs.numpy(), want["norms_abs"], rtol=1e-6)
        np.testing.assert_array_equal(got.inv.numpy(), want["inv"])


# --- (e) offload search end to end --------------------------------------------


@pytest.fixture(scope="module")
def saved(pair, tmp_path_factory):
    """The reference index saved, and the reference's offload results for
    every re-rank mode (loaded with resident='offload')."""
    data, ref, _ = pair
    wd = tmp_path_factory.mktemp("offload")
    ref.save_to(str(wd / "index"), str(wd / "shards"))
    q = data[::50][:24] + 0.01
    want, want_main = {}, {}
    for rr in RERANKS:
        jo = jax_load(wd / "index", wd / "shards", resident="offload", offload_rerank=rr)
        want[rr] = jo.search_batch(q, 10, jo.num_clusters)
        jm = jax_load(wd / "index", wd / "shards")
        jm.offload_main_table(rerank=rr)
        want_main[rr] = jm.search_batch(q, 10, jm.num_clusters)
    return wd, q, want, want_main


def _check_offload_results(D, I, rD, rI, rr, q, data):
    """Equal sets, and rank-wise distances: 'host' (exact f32 from the host
    mirror) and 'device' (the two-layer reconstruction) are both norm
    expansions |q|^2 - 2 q.x + |x|^2 in f32, whose rounding scales with
    the terms: within 1e-5 * (|q|^2 + max|x|^2). 'none' returns int8 kernel
    distances, where the reference's two-pass int8 query split adds up to
    scale_c |x8|_1 max|q-c| / 32258 per cross term: within 1e-3 of the
    query's distance scale at this corpus's sizes."""
    assert set_overlap(I, rI).min() == 1.0
    if rr == "none":
        tol = 1e-3 * (np.abs(rD) + np.abs(rD).max(axis=1, keepdims=True))
    else:
        tol = 1e-5 * ((q * q).sum(1) + (data * data).sum(1).max())[:, None]
    assert np.all(np.abs(D - rD) <= tol)


@pytest.mark.parametrize("rr", RERANKS)
def test_offload_load_matches_reference(pair, saved, rr):
    """load(resident='offload') of a reference-saved index: the f32 table
    stays off the device; results equal the reference's."""
    wd, q, want, _ = saved
    if rr == "host":  # the bindings entry point, with its default re-rank
        ix = bindings.load(str(wd / "index"), str(wd / "shards"), q.shape[1],
                           resident="offload", device="cpu").index
    else:
        ix = load_index_from(wd / "index", wd / "shards", resident="offload", device="cpu",
                             offload_rerank=rr)
    assert ix.offloaded and ix.layout.vectors is None and ix.stream_dtype == torch.int8
    assert (ix._corr_table is not None) == (rr == "device")
    D, I = ix.search_batch(q, 10, ix.num_clusters)
    _check_offload_results(D, I, *want[rr], rr, q, pair[0])


@pytest.mark.parametrize("rr", RERANKS)
def test_offload_main_table_matches_reference(pair, saved, rr):
    """VectorIndex.offload (offload_main_table) on a device-resident load,
    against the reference's offload_main_table on the same load: the tables
    are built on the device on both sides."""
    data, _, _ = pair
    wd, q, _, want_main = saved
    vi = bindings.load(str(wd / "index"), str(wd / "shards"), q.shape[1], device="cpu")
    vi.search_sync(q, 10, 4)  # a bf16 stream table, which the offload frees
    vi.offload(rerank=rr)
    ix = vi.index
    assert ix.offloaded and ix.layout.vectors is None and list(ix._stream_tables) == [torch.int8]
    D, I = ix.search_batch(q, 10, ix.num_clusters)
    _check_offload_results(D, I, *want_main[rr], rr, q, data)
    # Result payloads come from the host mirror once the table is gone.
    hits = ix.search(q[0], 3, ix.num_clusters)
    np.testing.assert_array_equal(hits[0][2], data[hits[0][0]])


@pytest.mark.parametrize("rr", RERANKS)
def test_port_saved_index_offloads_in_reference(pair, tmp_path, rr):
    """The reverse: the port saves, both packages load it offloaded."""
    data, _, _ = pair
    vi = bindings.build(data, str(tmp_path), device="cpu")
    q = data[::50][:24] + 0.01
    ours = load_index_from(tmp_path / "index", tmp_path / "shards", resident="offload",
                           device="cpu", offload_rerank=rr)
    theirs = jax_load(tmp_path / "index", tmp_path / "shards", resident="offload",
                      offload_rerank=rr)
    D, I = ours.search_batch(q, 10, ours.num_clusters)
    rD, rI = theirs.search_batch(q, 10, theirs.num_clusters)
    _check_offload_results(D, I, rD, rI, rr, q, data)
    np.testing.assert_array_equal(I[:, 0], np.arange(0, 24 * 50, 50))  # self-hits
    assert vi.nlist == ours.num_clusters


# --- (f) the offloaded dispatch branch ---------------------------------------


def test_offload_dispatch_matches_reference(pair, monkeypatch):
    """choose_method on an offloaded index: the stream kernels only, the
    shared one only under a re-ranked mode, the same answers as the
    reference over a grid of (nq, n_probe)."""
    data, ref, _ = pair
    ref_off = JaxIndex.fit(_store(data), seed=42)
    ref_off.offload_main_table(rerank="host")
    ours = index_from_reference_arrays(reference_arrays(ref), device=CPU)
    ours.offload_main_table(rerank="host")
    from vector_indexer_tpu.index import dispatch as jdispatch

    for mod in (tdispatch, jdispatch):
        monkeypatch.setattr(mod, "SHARED_MIN_NQ", 8)
        monkeypatch.setattr(mod, "SHARED_MIN_PROBED_ROWS", 2048)
    for rr in RERANKS:
        ours._offload_rerank = ref_off._offload_rerank = rr
        for nq in (1, 7, 8, 500):
            for n_probe in (1, 4, 8, 38):
                got = ours.choose_method(nq, n_probe)
                assert got == ref_off.choose_method(nq, n_probe)
                assert got in ("stream", "stream_shared")
                assert got == "stream" or rr != "none"
    assert ours.choose_method(8, 38) == "stream"  # 'none' keeps the per-query kernel


@pytest.mark.parametrize("rr", ["host", "device"])
def test_offload_auto_serves_shared_under_rerank(pair, monkeypatch, rr):
    """Gate forced open: 'auto' takes the shared stream under a re-ranked
    mode and returns the per-query stream's sets."""
    data, ref, _ = pair
    ours = index_from_reference_arrays(reference_arrays(ref), device=CPU)
    ours.offload_main_table(rerank=rr)
    q = data[::90][:16] + 0.01
    Ds, Is = ours.search_batch(q, 8, ours.num_clusters, method="stream")
    monkeypatch.setattr(tdispatch, "SHARED_MIN_NQ", 1)
    monkeypatch.setattr(tdispatch, "SHARED_MIN_PROBED_ROWS", 1)
    assert ours.choose_method(len(q), ours.num_clusters) == "stream_shared"
    kb.reset_launch_counts()
    Dh, Ih = ours.search_batch(q, 8, ours.num_clusters)
    assert set_overlap(Is, Ih).min() == 1.0
    np.testing.assert_allclose(Ds, Dh, rtol=1e-5)


def test_offload_single_query_counts_as_one(pair, monkeypatch):
    """A single (d,) query reaches choose_method as nq = 1, not nq = d."""
    data, ref, _ = pair
    ours = index_from_reference_arrays(reference_arrays(ref), device=CPU)
    ours.offload_main_table(rerank="none")  # the direct device dispatch path
    monkeypatch.setattr(tdispatch, "SHARED_MIN_NQ", 4)  # d = 24 would pass
    monkeypatch.setattr(tdispatch, "SHARED_MIN_PROBED_ROWS", 1)
    seen = []
    orig = ours.choose_method
    monkeypatch.setattr(ours, "choose_method", lambda nq, p: (seen.append(nq), orig(nq, p))[1])
    D, I = ours.search_batch(data[0] + 0.01, 5, ours.num_clusters)
    assert seen == [1]
    assert I.shape == (1, 5) and I[0, 0] == 0


# --- (g) errors -----------------------------------------------------------------


def test_offload_errors(pair, tmp_path):
    data, ref, _ = pair
    ours = index_from_reference_arrays(reference_arrays(ref), device=CPU)
    with pytest.raises(ValueError, match="rerank"):
        ours.offload_main_table(rerank="gpu")
    with pytest.raises(RuntimeError, match="device-resident"):
        ours.offload_from_host()
    ours.offload_main_table()
    for method in ("dense", "stream_exact", "dense_exact", "stream_shared_exact"):
        with pytest.raises(RuntimeError, match="stream"):
            ours.search_batch_device(data[:4], 5, 2, method=method)
    D, I = ours.search_batch(data[:8], 5, ours.num_clusters, method="auto")
    np.testing.assert_array_equal(I[:, 0], np.arange(8))
    ref.save_to(str(tmp_path / "index"), str(tmp_path / "shards"))
    with pytest.raises(ValueError, match="rerank"):
        load_index_from(tmp_path / "index", tmp_path / "shards", resident="offload",
                        device="cpu", offload_rerank="gpu")
    host = load_index_from(tmp_path / "index", tmp_path / "shards", resident="host",
                           device="cpu")
    with pytest.raises(RuntimeError, match="host-resident"):
        host.offload_main_table()
    with pytest.raises(ValueError, match="resident"):
        load_index_from(tmp_path / "index", tmp_path / "shards", resident="disk", device="cpu")
