"""Spilled (SOAR) indexes in the port against the JAX reference, on the CPU.

* ``assign_spill_chunked`` labels on the same numpy inputs (near-ties
  aside);
* ``offload.dedup_topk`` against the reference's ``_dedup_topk`` on
  planted duplicates, at kk on both sides of the reference's 512 switch
  between its mask and sort branches;
* a reference index built with ``spill=1`` and carried across by
  ``convert``: the same result sets from the same programs;
* a spilled index saved by the reference and loaded by the port;
* the port's counterparts of tests/test_spill.py's behaviours, and the
  spilled offload modes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import make_gaussian_clusters
from torch_parity import CPU, near_tie_ok, reference_arrays, reference_search, t

from vector_indexer_tpu.index import IvfIndex as JaxIndex
from vector_indexer_tpu.index import load_index_from as jax_load
from vector_indexer_tpu.index.offload import _dedup_topk as jax_dedup_topk
from vector_indexer_tpu.ops.distance import assign_spill_chunked as jax_spill
from vector_indexer_tpu.storage import VectorStore
from vector_indexer_tpu_torch import bindings
from vector_indexer_tpu_torch.convert import index_from_reference_arrays
from vector_indexer_tpu_torch.index.ivf import IvfIndex, load_index_from
from vector_indexer_tpu_torch.index.offload import dedup_topk
from vector_indexer_tpu_torch.ops.distance import assign_spill_chunked


def _store(data):
    return VectorStore(external_ids=np.arange(len(data), dtype=np.uint64), vectors=data)


def _no_dups(I):
    return all(len(set(r[r >= 0].tolist())) == int((r >= 0).sum()) for r in I)


def _close(D, rD, q, data, rtol=1e-5):
    """Distances equal within rtol of the terms they are summed from
    (|q|^2 + max |x|^2): the two packages sum the f32 products in other
    orders, which moves a near-zero self-distance by ~1e-3 at d 128."""
    D, rD = np.asarray(D), np.asarray(rD)
    assert (np.isfinite(D) == np.isfinite(rD)).all()
    fin = np.isfinite(D)
    scale = (q * q).sum(1)[:, None] + float((data * data).sum(1).max())
    err = np.subtract(D, rD, out=np.zeros(D.shape), where=fin)
    assert (np.abs(err) <= rtol * scale).all()


def _fit(data, **kw):
    return IvfIndex.fit(_store(data), device="cpu", **kw)


@pytest.fixture(scope="module")
def spilled():
    """tests/test_spill.py's corpus: 4000 isotropic points, d 32."""
    data = np.random.default_rng(7).normal(0, 1, (4000, 32)).astype(np.float32)
    return _fit(data, seed=7, spill=1), data


# --- assign_spill_chunked ---------------------------------------------------------


@pytest.mark.parametrize("lam", [0.0, 1.0, 2.5])
def test_assign_spill_matches_reference(lam):
    g = np.random.default_rng(5)
    c = g.normal(0, 2, (48, 24)).astype(np.float32)
    x = (c[g.integers(0, 48, 3000)] + g.normal(0, 1, (3000, 24))).astype(np.float32)
    d = ((x[:, None, :] - c[None]) ** 2).sum(-1)
    lab = np.argmin(d, 1).astype(np.int32)
    ref = np.asarray(jax_spill(jnp.asarray(x), jnp.asarray(c), jnp.asarray(lab),
                               soar_lambda=lam, chunk=1024))
    got = assign_spill_chunked(t(x), t(c), t(lab), soar_lambda=lam, chunk=1024).numpy()
    assert got.dtype == np.int32 and (got != lab).all()
    x64, c64 = x.astype(np.float64), c.astype(np.float64)

    def soar(i, j):
        r = x64[i] - c64[lab[i]]
        dj = x64[i] - c64[j]
        return (dj @ dj) + lam * (dj @ r) ** 2 / max(r @ r, 1e-12)

    assert near_tie_ok(got, ref, soar, rel=1e-5) <= 3
    if lam == 0.0:  # the plain second-nearest cell
        d2 = d.copy()
        d2[np.arange(3000), lab] = np.inf
        assert near_tie_ok(got, np.argmin(d2, 1), soar, rel=1e-5) <= 3


# --- dedup_topk --------------------------------------------------------------------


@pytest.mark.parametrize("kk", [200, 1024])
def test_dedup_topk_matches_reference(kk):
    """Planted duplicates: a third of each row's candidates repeat an id
    seen earlier (a vector reached through both of its cells); some rows
    are -1 holes. The port's sort by id must give the reference's output
    exactly on both sides of the reference's switch (mask at kk <= 512,
    sort above)."""
    g = np.random.default_rng(kk)
    nq, n_ids, k = 6, 5 * kk, kk // 2
    # Rows [0, n) hold ids 0..n-1, rows [n, 2n) the same ids permuted: each
    # id has two rows, as a spilled vector has.
    second = g.permutation(n_ids)
    perm = np.concatenate([np.arange(n_ids), second])
    other = np.concatenate([n_ids + np.argsort(second), second])  # a row's partner row
    rows = np.stack([g.choice(2 * n_ids, kk, replace=False) for _ in range(nq)])
    for r in rows:  # positions b repeat the ids at earlier positions a
        a = g.choice(kk // 2, kk // 3, replace=False)
        b = kk // 2 + g.choice(kk // 2, kk // 3, replace=False)
        r[b] = other[r[a]]
    rows[:, -5:] = -1
    dv = np.sort(g.uniform(0, 10, (nq, kk)).astype(np.float32), axis=1)
    dv[rows < 0] = np.inf
    rD, rR = jax_dedup_topk(jnp.asarray(dv), jnp.asarray(rows.astype(np.int32)),
                            jnp.asarray(perm.astype(np.int32)), k=k)
    D, R = dedup_topk(t(dv), t(rows), t(perm), k)
    np.testing.assert_array_equal(D.numpy(), np.asarray(rD))
    np.testing.assert_array_equal(R.numpy(), np.asarray(rR))
    ids = np.where(R.numpy() >= 0, perm[np.maximum(R.numpy(), 0)], -1)
    assert _no_dups(ids)


# --- a reference-built spilled index in the port ------------------------------------


@pytest.fixture(scope="module")
def ref_pair():
    """A spilled reference index at d 128 (the fused routes' width) and the
    port's copy of it."""
    g = np.random.default_rng(21)
    c = g.normal(0, 3, (16, 128)).astype(np.float32)
    data = (c[g.integers(0, 16, 2400)] + g.normal(0, 1, (2400, 128))).astype(np.float32)
    ref = JaxIndex.fit(_store(data), seed=3, nlist=24, spill=1)
    arrays = dict(reference_arrays(ref), spill=ref.spill)
    return data, ref, index_from_reference_arrays(arrays, device=CPU)


def test_convert_carries_spill(ref_pair):
    data, ref, ours = ref_pair
    assert ours.spill == 1 and ours.layout.lengths.sum() == 2 * len(data)
    np.testing.assert_array_equal(ours.layout.perm, ref.layout.perm)


@pytest.mark.parametrize("method", ["gather", "dense_exact", "flat_exact"])
def test_spilled_search_matches_reference(ref_pair, method):
    data, ref, ours = ref_pair
    q = data[:24] + 0.05
    rD, rI = ref.search_batch(q, 10, 6, method=method)
    D, I = ours.search_batch(q, 10, 6, method=method)
    assert _no_dups(I) and _no_dups(rI)
    for a, b in zip(I, rI):
        assert set(a.tolist()) == set(b.tolist()), method
    _close(D, rD, q, data)


@pytest.mark.parametrize("method", ["dense_fused", "flat_fused"])
def test_spilled_fused_programs_match_reference(ref_pair, method):
    """The port widens to (1+spill)k, runs K3's plain version and drops
    repeated ids; the reference's same program at that width, then its own
    dedup, returns the same sets."""
    data, ref, ours = ref_pair
    q, k, n_probe = data[:16] + 0.05, 10, 6
    rD, rR = reference_search(ref, method, q, 2 * k, n_probe)
    rD, rR = jax_dedup_topk(jnp.asarray(rD), jnp.asarray(rR.astype(np.int32)),
                            ref._perm_dev_table()[: ref.layout.vectors.shape[0]], k=k)
    D, R = ours.search_batch_device(q, k, n_probe, method=method)
    rI, I = ours.rows_to_internal(np.asarray(rR)), ours.rows_to_internal(R.numpy())
    assert _no_dups(I)
    for a, b in zip(I, rI):
        assert set(a.tolist()) == set(b.tolist())
    _close(D.numpy(), rD, q, data)


def test_spilled_index_saved_by_reference_loads(ref_pair, tmp_path):
    data, ref, _ = ref_pair
    ref.save_to(str(tmp_path / "index"), str(tmp_path / "shards"))
    ours = load_index_from(tmp_path / "index", tmp_path / "shards", device="cpu")
    assert ours.spill == 1 and ours.layout.lengths.sum() == 2 * len(data)
    q = data[:16] + 0.05
    back = jax_load(str(tmp_path / "index"), str(tmp_path / "shards"))
    rD, rI = back.search_batch(q, 10, 5, method="gather")
    D, I = ours.search_batch(q, 10, 5, method="gather")
    for a, b in zip(I, rI):
        assert set(a.tolist()) == set(b.tolist())
    _close(D, rD, q, data)


# --- tests/test_spill.py's behaviours in the port -------------------------------


def test_spill_doubles_posting_rows(spilled):
    idx, data = spilled
    n = len(data)
    assert idx.layout.lengths.sum() == 2 * n and idx.layout.n == n
    perm = idx.layout.perm
    assert (np.bincount(perm[perm >= 0], minlength=n) == 2).all()


def test_spill_secondary_differs_from_primary(spilled):
    idx, data = spilled
    starts = idx.layout.offsets[:-1]
    cells = {}
    for c in range(idx.num_clusters):
        for iid in idx.layout.perm[starts[c] : starts[c] + idx.layout.lengths[c]]:
            cells.setdefault(int(iid), []).append(c)
    assert len(cells) == len(data)
    assert all(len(v) == 2 and v[0] != v[1] for v in cells.values())


@pytest.mark.parametrize("method", ["gather", "dense", "stream", "flat", "auto", "gather_dma",
                                    "stream_exact", "dense_fused", "flat_int8"])
def test_spill_no_duplicate_result_ids(spilled, method):
    idx, data = spilled
    D, I = idx.search_batch(data[:32], 10, idx.num_clusters, method=method)
    assert _no_dups(I), method
    assert (I[:, 0] == np.arange(32)).all(), method
    assert (D[:, 0] < 1e-3).all(), method


def test_spill_full_probe_matches_unspilled_exact():
    data = np.random.default_rng(11).normal(0, 1, (2000, 16)).astype(np.float32)
    base, sp = _fit(data, seed=11), _fit(data, seed=11, spill=1)
    q = data[:16] + 0.01
    Db, Ib = base.search_batch(q, 10, base.num_clusters, method="gather")
    Ds, Is = sp.search_batch(q, 10, sp.num_clusters, method="gather")
    np.testing.assert_array_equal(Ib, Is)
    np.testing.assert_allclose(Db, Ds, rtol=1e-5, atol=1e-5)


def test_spill_recall_at_fixed_nprobe(spilled):
    idx, data = spilled
    base = _fit(data, seed=7)
    q = np.random.default_rng(3).normal(0, 1, (128, 32)).astype(np.float32)
    gt = np.argmin(((q[:, None, :] - data[None]) ** 2).sum(-1), axis=1)
    n_probe = max(2, idx.num_clusters // 16)
    _, I0 = base.search_batch(q, 10, n_probe, method="gather")
    _, I1 = idx.search_batch(q, 10, n_probe, method="gather")
    r0, r1 = (I0 == gt[:, None]).any(1).mean(), (I1 == gt[:, None]).any(1).mean()
    assert r1 >= r0 + 0.05, (r0, r1)


def test_spill_persistence_roundtrip(spilled, tmp_path):
    idx, data = spilled
    idx.save_to(tmp_path / "index", tmp_path / "shards")
    loaded = load_index_from(tmp_path / "index", tmp_path / "shards", device="cpu")
    assert loaded.spill == 1 and loaded.layout.lengths.sum() == 2 * len(data)
    q = data[:16]
    Da, Ia = idx.search_batch(q, 5, 8)
    Db, Ib = loaded.search_batch(q, 5, 8)
    np.testing.assert_array_equal(Ia, Ib)
    np.testing.assert_allclose(Da, Db, rtol=1e-5, atol=1e-5)
    back = jax_load(str(tmp_path / "index"), str(tmp_path / "shards"))
    assert back.spill == 1  # the reference reads the port's file


def test_spill_wide_k_dedup_branch(spilled):
    """kk = 2k > 512 (the reference's sort branch); same contract."""
    idx, data = spilled
    D, I = idx.search_batch(data[:8], 300, idx.num_clusters)
    assert _no_dups(I) and (I[:, 0] == np.arange(8)).all()
    assert (np.diff(D[np.isfinite(D).all(1)], axis=1) >= -1e-6).all()


@pytest.mark.parametrize("metric", ["ip", "cosine"])
def test_spill_metrics_ip_cosine(metric):
    data = np.random.default_rng(13).normal(0, 1, (1500, 16)).astype(np.float32)
    idx = _fit(data, seed=13, metric=metric, spill=1)
    base = _fit(data, seed=13, metric=metric)
    _, I = idx.search_batch(data[:16], 5, idx.num_clusters)
    _, Ib = base.search_batch(data[:16], 5, base.num_clusters)
    for a, b in zip(I, Ib):
        assert set(a.tolist()) == set(b.tolist()), metric
    assert _no_dups(I)


def test_spill_clustered_data_consistency():
    data, _, _ = make_gaussian_clusters(10, 200, 24, spread=0.4, separation=8.0)
    idx = _fit(data, seed=5, spill=1)
    _, I = idx.search_batch(data[:32], 5, 4)
    assert (I[:, 0] == np.arange(32)).all()


def test_spill_through_bindings_and_config(tmp_path):
    data, _, _ = make_gaussian_clusters(6, 150, 16, spread=0.5, separation=6.0)
    vi = bindings.build(data, str(tmp_path), spill=1, device="cpu")
    assert vi.index.spill == 1 and vi.index.layout.lengths.sum() == 2 * len(data)
    vl = bindings.load(str(tmp_path / "index"), str(tmp_path / "shards"), 16, device="cpu")
    D, I = vl.search_sync(data[:10], 5, 3)
    assert (I[:, 0] == np.arange(10)).all() and _no_dups(I)
    with pytest.raises(ValueError, match="spill"):
        _fit(data, spill=2)


# --- spilled offload -----------------------------------------------------------------


@pytest.mark.parametrize("rerank", ["host", "device", "none"])
def test_spilled_offload_modes(spilled, tmp_path, rerank):
    """Offloaded spilled search returns no repeated id; the re-ranked modes
    return the device-resident exact sets, 'none' the self-hits."""
    idx, data = spilled
    idx.save_to(tmp_path / "index", tmp_path / "shards")
    o = load_index_from(tmp_path / "index", tmp_path / "shards", device="cpu",
                        resident="offload", offload_rerank=rerank)
    q = data[:24] + 0.01
    D, I = o.search_batch(q, 10, 8)
    assert _no_dups(I) and (I[:, 0] == np.arange(24)).all()
    if rerank != "none":
        De, Ie = idx.search_batch(q, 10, 8, method="gather")
        for a, b in zip(I, Ie):
            assert set(a.tolist()) == set(b.tolist())
        np.testing.assert_allclose(D, De, rtol=1e-4, atol=1e-4)
    # In place, from a device-resident load (int8 table built on the device).
    dev = load_index_from(tmp_path / "index", tmp_path / "shards", device="cpu")
    dev.offload_main_table(rerank=rerank)
    _, I2 = dev.search_batch(q, 10, 8)
    assert _no_dups(I2) and (I2[:, 0] == np.arange(24)).all()


def test_spilled_offload_matches_reference(spilled, tmp_path):
    """The same spilled files offloaded with the host re-rank in both
    packages: the same sets and exact distances."""
    idx, data = spilled
    idx.save_to(tmp_path / "index", tmp_path / "shards")
    ref = jax_load(str(tmp_path / "index"), str(tmp_path / "shards"), resident="offload")
    ours = load_index_from(tmp_path / "index", tmp_path / "shards", device="cpu",
                           resident="offload")
    q = data[:16] + 0.01
    rD, rI = ref.search_batch(q, 10, 6)
    D, I = ours.search_batch(q, 10, 6)
    assert _no_dups(I) and _no_dups(rI)
    for a, b in zip(I, rI):
        assert set(a.tolist()) == set(b.tolist())
    _close(D, rD, q, data)


def test_spilled_widened_decisions_match_reference(ref_pair):
    """The widened shortlist (kk = (1+spill)k) takes the reference's route
    and sizing at every method the port resolves like the reference."""
    from vector_indexer_tpu.index import dispatch as jd
    from vector_indexer_tpu_torch.index import dispatch as td

    _, ref, ours = ref_pair
    for method in ("stream", "stream_exact", "gather", "gather_dma"):
        for kk in (20, 200):
            a, b = td.resolve(ours, 64, 6, k=kk, method=method), \
                jd.resolve(ref, 64, 6, k=kk, method=method)
            assert (a.program, a.t_fixed, a.chunk, a.budget) == \
                (b.program, b.t_fixed, b.chunk, b.budget), (method, kk)
            if method != "gather_dma":  # K6 tiles its queries its own way
                assert a.q_tile == b.q_tile, (method, kk)
    assert ours.choose_method(64, 6) == ref.choose_method(64, 6)
    assert torch.equal(ours.tables().row_internal[: ref.layout.rows_used],
                       torch.as_tensor(ref.layout.perm))
