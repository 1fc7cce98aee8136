"""Host-resident staged serving and the host / sampled builds in the port,
against the JAX reference on the CPU.

* the same saved files loaded with ``resident='host'`` by both packages:
  equal staged sets in f32, and exact distances after the host re-rank in
  bf16 and int8;
* the tie-inclusive probe mask, the sampled trainers' sample and
  ``assign_points_host_chunked`` against the reference's;
* the port's counterparts of tests/test_staged.py's behaviours (guards,
  padding, staged bytes, ``to_host_resident``, the host fit).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import make_gaussian_clusters
from torch_parity import t

import vector_indexer_tpu.models.kmeans as jk
from vector_indexer_tpu.index import IvfIndex as JaxIndex
from vector_indexer_tpu.index.ivf import load_index_from as jax_load
from vector_indexer_tpu.index.staged import _coarse_probe_mask as jax_probe_mask
from vector_indexer_tpu.storage import VectorStore
from vector_indexer_tpu_torch import bindings
from vector_indexer_tpu_torch.index import dispatch as td
from vector_indexer_tpu_torch.index.ivf import IvfIndex, load_index_from
from vector_indexer_tpu_torch.index.staged import _coarse_probe_mask
from vector_indexer_tpu_torch.models import kmeans as tk
from vector_indexer_tpu_torch.storage.persist import load_index, save_index


def _store(data):
    return VectorStore(external_ids=np.arange(len(data), dtype=np.uint64), vectors=data)


def _sets_equal(a, b):
    return all(set(x.tolist()) == set(y.tolist()) for x, y in zip(a, b))


def _no_dups(I):
    return all(len(set(r[r >= 0].tolist())) == int((r >= 0).sum()) for r in I)


def _close(D, rD, q, data, rtol=1e-5):
    """Distances equal within rtol of the terms they are summed from
    (|q|^2 + max |x|^2): the staged sub-table, the whole table and the two
    packages' host norms sum the same f32 products in other orders."""
    D, rD = np.asarray(D), np.asarray(rD)
    assert (np.isfinite(D) == np.isfinite(rD)).all()
    scale = (q * q).sum(1)[:, None] + float((data * data).sum(1).max())
    err = np.subtract(D, rD, out=np.zeros(D.shape), where=np.isfinite(D))
    assert (np.abs(err) <= rtol * scale).all()


def _load(wd, resident="device"):
    return load_index_from(wd / "index", wd / "shards", resident=resident, device="cpu")


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """tests/test_staged.py's corpus, fitted and saved by the port."""
    wd = tmp_path_factory.mktemp("staged_idx")
    data, _, _ = make_gaussian_clusters(12, 130, 24, spread=0.4, separation=8.0)
    IvfIndex.fit(_store(data), seed=42, device="cpu").save_to(wd / "index", wd / "shards")
    return wd, data


@pytest.fixture(scope="module")
def ref_saved(tmp_path_factory):
    """A reference-built index (spilled and not) saved by the reference."""
    out = {}
    data, _, _ = make_gaussian_clusters(8, 120, 16, spread=0.6, separation=5.0)
    for spill in (0, 1):
        wd = tmp_path_factory.mktemp(f"ref_staged_{spill}")
        JaxIndex.fit(_store(data), seed=42, spill=spill).save_to(
            str(wd / "index"), str(wd / "shards"))
        out[spill] = wd
    return out, data


# --- parity with the reference -------------------------------------------------------


@pytest.mark.parametrize("spill", [0, 1])
@pytest.mark.parametrize("n_probe", [1, 3, 8])
def test_staged_f32_matches_reference(ref_saved, spill, n_probe):
    dirs, data = ref_saved
    wd = dirs[spill]
    ref = jax_load(str(wd / "index"), str(wd / "shards"), resident="host")
    ours = _load(wd, "host")
    assert ours.host_resident and ours.spill == spill
    q = data[:40] + 0.05
    rD, rI = ref.search_batch(q, 10, n_probe)
    D, I = ours.search_batch(q, 10, n_probe)
    assert _sets_equal(I, rI) and _no_dups(I)
    _close(D, rD, q, data)


@pytest.mark.parametrize("sd", ["bf16", "int8"])
def test_staged_quantized_matches_reference(ref_saved, sd):
    """bf16 / int8 staging: after the exact host re-rank both packages
    return exact distances of the same sets."""
    dirs, data = ref_saved
    wd = dirs[0]
    ref = jax_load(str(wd / "index"), str(wd / "shards"), resident="host")
    ours = _load(wd, "host")
    ref.stage_dtype = {"bf16": jnp.bfloat16, "int8": jnp.int8}[sd]
    ours.stage_dtype = {"bf16": torch.bfloat16, "int8": torch.int8}[sd]
    q = data[:32] + 0.05
    rD, rI = ref.search_batch(q, 10, 4)
    D, I = ours.search_batch(q, 10, 4)
    assert _sets_equal(I, rI)
    _close(D, rD, q, data)
    exact = ((data[np.maximum(I, 0)].astype(np.float64) - q[:, None, :]) ** 2).sum(-1)
    _close(D, exact, q, data)


def test_converted_host_index_matches_reference():
    """A reference index carried across by ``convert`` and moved to the host
    by ``to_host_resident`` serves staged search as the reference's own host-resident
    copy of it does."""
    from torch_parity import reference_arrays

    from vector_indexer_tpu_torch.convert import index_from_reference_arrays

    data, _, _ = make_gaussian_clusters(8, 120, 16, spread=0.6, separation=5.0)
    ref = JaxIndex.fit(_store(data), seed=42, spill=1)
    ours = index_from_reference_arrays(dict(reference_arrays(ref), spill=ref.spill),
                                       device="cpu")
    ours.to_host_resident()
    assert ours.host_resident and isinstance(ours.layout.vectors, np.ndarray)
    ref.to_host_resident()
    q = data[:24] + 0.05
    rD, rI = ref.search_batch(q, 10, 3)
    D, I = ours.search_batch(q, 10, 3)
    assert _sets_equal(I, rI) and _no_dups(I)
    _close(D, rD, q, data)


def test_probe_mask_ties_match_reference():
    """Duplicated centroids tie at the n_probe-th distance: the mask takes
    every tied cell, as the reference's does. Small integer coordinates
    make every product and sum exact, so the ties are exact in both
    packages whatever order their products sum in."""
    g = np.random.default_rng(4)
    c = g.integers(-4, 5, (20, 8)).astype(np.float32)
    c[10:] = c[:10]  # every centroid twice
    q = g.integers(-4, 5, (30, 8)).astype(np.float32)
    c_sq = (c * c).sum(1)
    for n_probe in (1, 3, 7, 20):
        ref = np.asarray(jax_probe_mask(jnp.asarray(q), jnp.asarray(c), jnp.asarray(c_sq),
                                        jnp.int32(n_probe)))
        got = _coarse_probe_mask(t(q), t(c), t(c_sq), n_probe).numpy()
        np.testing.assert_array_equal(got, ref)
        assert (got.sum(1) >= n_probe).all() and (got.sum(1) % 2 == 0).all()


def test_host_trainer_sample_matches_reference(monkeypatch):
    """run_kmeans_lloyd_host trains on the reference's rows: column 0 of
    the corpus holds the row index, and each package's Lloyd call records
    the rows it was given."""
    n, k, sample = 5000, 6, 1200
    data = np.random.default_rng(2).normal(0, 1, (n, 4)).astype(np.float32)
    data[:, 0] = np.arange(n)
    seen = {}

    class Stop(Exception):
        pass

    def grab(name):
        def fn(x, *a, **kw):
            seen[name] = np.asarray(x)[:, 0].astype(np.int64)
            raise Stop
        return fn

    monkeypatch.setattr(jk, "run_kmeans_lloyd", grab("ref"))
    monkeypatch.setattr(tk, "run_kmeans_lloyd", grab("port"))
    for fn in (lambda: jk.run_kmeans_lloyd_host(data, k, 3, sample, seed=17),
               lambda: tk.run_kmeans_lloyd_host(data, k, 3, sample, seed=17, device="cpu")):
        with pytest.raises(Stop):
            fn()
    assert len(seen["port"]) == sample
    np.testing.assert_array_equal(seen["port"], seen["ref"])
    np.testing.assert_array_equal(seen["port"], tk.training_sample(n, sample, 17))
    monkeypatch.undo()
    with pytest.raises(ValueError, match="train_sample"):
        tk.run_kmeans_lloyd_host(data, 50, 3, 20, device="cpu")


def test_assign_points_host_chunked_tail_padding():
    """2,500 rows in slices of 1,000 (the tail padded with zero rows): the
    labels of one assignment of the whole, and the reference's."""
    data, _, _ = make_gaussian_clusters(10, 250, 16, spread=0.5, separation=6.0)
    cent = data[::250][:7].copy()
    whole, _ = tk.assign_points(t(data), t(cent))
    got = tk.assign_points_host_chunked(data, cent, chunk_rows=1000, device="cpu")
    assert got.dtype == np.int32 and got.shape == (2500,)
    np.testing.assert_array_equal(got, whole.numpy())
    ref = jk.assign_points_host_chunked(data, cent, chunk_rows=1000)
    np.testing.assert_array_equal(got, np.asarray(ref))


def test_sampled_fit_matches_host_fit():
    """The device fit with train_sample and the host fit train on the same
    rows (the same centroids) and return the same sets."""
    data, _, _ = make_gaussian_clusters(40, 60, 12, spread=0.4, separation=8.0)
    hidx = IvfIndex.fit(_store(data), seed=42, resident="host", train_sample=1500,
                        device="cpu")
    didx = IvfIndex.fit(_store(data), seed=42, train_sample=1500, device="cpu")
    np.testing.assert_allclose(hidx.centroids, didx.centroids, rtol=1e-5, atol=1e-5)
    q = data[:16] + 0.01
    _, Ih = hidx.search_batch(q, 5, 6)
    _, Id = didx.search_batch(q, 5, 6)
    assert _sets_equal(Ih, Id)


# --- tests/test_staged.py's behaviours in the port -----------------------------------


def test_host_resident_layout_stays_on_host(saved):
    wd, _ = saved
    host = _load(wd, "host")
    assert host.host_resident and td.resolve(host, 8, 4).program == "staged"
    lay = host.layout
    for arr in (lay.vectors, lay.row_norms, lay.offsets, lay.lengths):
        assert isinstance(arr, np.ndarray)


@pytest.mark.parametrize("n_probe", [1, 3, 8])
def test_staged_matches_dense_exact(saved, n_probe):
    wd, data = saved
    dev, host = _load(wd), _load(wd, "host")
    q = data[:64] + 0.02
    Dd, Id = dev.search_batch(q, 10, n_probe, method="dense_exact")
    Ds, Is = host.search_batch(q, 10, n_probe)  # auto -> staged
    _close(Dd, Ds, q, data)
    assert _sets_equal(Id, Is)


def test_staged_explicit_method_and_guards(saved):
    wd, data = saved
    host = _load(wd, "host")
    D, I = host.search_batch(data[:8], 5, 4, method="staged")
    assert D.shape == (8, 5) and I.shape == (8, 5)
    with pytest.raises(RuntimeError):
        host.search_batch(data[:8], 5, 4, method="dense")
    with pytest.raises(RuntimeError, match="host-resident"):
        host.search_batch_device(data[:8], 5, 4)
    with pytest.raises(RuntimeError, match="resident='host'"):
        _load(wd).search_batch(data[:8], 5, 4, method="staged")


@pytest.mark.parametrize("metric", ["ip", "cosine"])
def test_staged_metric_parity(tmp_path, metric):
    data, _, _ = make_gaussian_clusters(8, 100, 16, spread=0.5, separation=6.0)
    IvfIndex.fit(_store(data), seed=42, metric=metric, device="cpu").save_to(
        tmp_path / "index", tmp_path / "shards")
    dev, host = _load(tmp_path), _load(tmp_path, "host")
    q = data[:32] * 1.3
    Dd, Id = dev.search_batch(q, 8, 4, method="dense_exact")
    Ds, Is = host.search_batch(q, 8, 4)
    np.testing.assert_allclose(Dd, Ds, rtol=1e-4, atol=5e-4)
    assert _sets_equal(Id, Is)


def test_staged_spill_dedup(tmp_path):
    data, _, _ = make_gaussian_clusters(8, 120, 16, spread=0.6, separation=5.0)
    IvfIndex.fit(_store(data), seed=42, spill=1, device="cpu").save_to(
        tmp_path / "index", tmp_path / "shards")
    dev, host = _load(tmp_path), _load(tmp_path, "host")
    assert host.spill == 1
    q = data[:40] + 0.05
    Dd, Id = dev.search_batch(q, 10, 4)
    Ds, Is = host.search_batch(q, 10, 4)
    assert _no_dups(Is) and _sets_equal(Id, Is)
    np.testing.assert_allclose(Dd, Ds, rtol=1e-4, atol=5e-4)


def test_to_host_resident_roundtrip(saved):
    wd, data = saved
    dev = _load(wd)
    q = data[:24] + 0.01
    Dd, Id = dev.search_batch(q, 10, 6, method="dense_exact")
    dev.search_batch(q, 10, 6, method="stream")  # builds a device stream table
    dev.to_host_resident()
    assert dev.host_resident and isinstance(dev.layout.vectors, np.ndarray)
    assert dev.tables().streams == {}
    Ds, Is = dev.search_batch(q, 10, 6)
    _close(Dd, Ds, q, data)
    assert _sets_equal(Id, Is)
    dev.to_host_resident(torch.bfloat16)
    assert dev.stage_dtype == torch.bfloat16
    _, Ib = dev.search_batch(q, 10, 6)
    assert _sets_equal(Id, Ib)
    off = _load(wd)
    off.offload_main_table()
    with pytest.raises(RuntimeError, match="offloaded"):
        off.to_host_resident()


def test_staged_padding_contract(saved):
    wd, data = saved
    host = _load(wd, "host")
    n = host.layout.n
    D, I = host.search_batch(data[:4], n + 7, host.num_clusters)
    assert D.shape == (4, n + 7)
    assert np.all(np.isinf(D[:, n:])) and np.all(I[:, n:] == -1)
    for row_d, row_i in zip(D, I):
        assert np.all(np.diff(row_d[row_i >= 0]) >= -1e-6)


def test_staged_bytes_grow_with_nprobe(saved):
    wd, data = saved
    host = _load(wd, "host")
    host.search_batch(data[:4], 5, 1)
    small = host._last_stage_bytes
    host.search_batch(data[:4], 5, host.num_clusters)
    big = host._last_stage_bytes
    assert small < big
    assert small < host.layout.vectors.shape[0] * host.dimension * 4 / 2


def test_staged_quantized_dtypes(saved):
    """bf16 / int8 staging: 2x / 4x smaller copies, and the exact host
    re-rank restores the f32 staging's sets and distances."""
    wd, data = saved
    host = _load(wd, "host")
    q = data[:32] + 0.02
    De, Ie = host.search_batch(q, 10, 6)
    f32_bytes = host._last_stage_bytes
    for sd, max_bytes in ((torch.bfloat16, f32_bytes * 0.6), (torch.int8, f32_bytes * 0.4)):
        host.stage_dtype = sd
        D, I = host.search_batch(q, 10, 6)
        assert _sets_equal(Ie, I), sd
        np.testing.assert_allclose(De, D, rtol=1e-4, atol=2e-3)
        assert host._last_stage_bytes <= max_bytes, (sd, host._last_stage_bytes, f32_bytes)
    host.stage_dtype = torch.float16
    with pytest.raises(ValueError, match="stage_dtype"):
        host.search_batch(q, 10, 6)


def test_staged_quantized_spill(tmp_path):
    data, _, _ = make_gaussian_clusters(8, 120, 16, spread=0.6, separation=5.0)
    IvfIndex.fit(_store(data), seed=42, spill=1, device="cpu").save_to(
        tmp_path / "index", tmp_path / "shards")
    host = _load(tmp_path, "host")
    host.stage_dtype = torch.int8
    q = data[:24] + 0.05
    D, I = host.search_batch(q, 10, 4)
    assert _no_dups(I)
    Dd, _ = _load(tmp_path).search_batch(q, 10, 4)
    np.testing.assert_allclose(Dd, D, rtol=1e-4, atol=5e-4)


def test_host_resident_rejects_offload(saved):
    wd, _ = saved
    with pytest.raises(RuntimeError, match="host-resident"):
        _load(wd, "host").offload_main_table()


def test_staged_single_query_convenience(saved):
    wd, data = saved
    hits = _load(wd, "host").search(data[7], 5, 4)
    assert hits and hits[0][0] == 7 and hits[0][1] < 1e-3
    assert np.allclose(hits[0][2], data[7])


def test_fit_host_resident_low_memory(tmp_path):
    """fit(resident='host'): the layout packs in host memory and the index
    serves, saves and reloads as a host-resident one; with a mesh too it
    packs in host memory; the invalid combinations are refused."""
    data, _, _ = make_gaussian_clusters(4000, 24, 12, spread=0.4, separation=8.0)
    store = _store(data)
    hidx = IvfIndex.fit(store, seed=42, resident="host", train_sample=1500, device="cpu")
    assert hidx.host_resident and isinstance(hidx.layout.vectors, np.ndarray)
    q = data[:16] + 0.01
    Dh, Ih = hidx.search_batch(q, 5, 6)
    save_index(hidx, tmp_path / "index", tmp_path / "shards")
    ridx = load_index(tmp_path / "index", tmp_path / "shards", resident="host", device="cpu")
    _, Ir = ridx.search_batch(q, 5, 6)
    assert _sets_equal(Ih, Ir)
    back = jax_load(str(tmp_path / "index"), str(tmp_path / "shards"), resident="host")
    _, Ij = back.search_batch(q, 5, 6)
    assert _sets_equal(Ih, Ij)  # the reference serves the port's files the same
    with pytest.raises(ValueError):
        IvfIndex.fit(store, seed=42, resident="host", spill=1, device="cpu")
    with pytest.raises(ValueError):
        IvfIndex.fit(store, seed=42, resident="nope", device="cpu")
    with pytest.raises(ValueError):
        IvfIndex.fit(store, seed=42, resident="host", trainer="balanced", device="cpu")
    # The reference's guards on the other trainers and the mesh fit.
    for trainer in ("mini_batch", "balanced"):
        with pytest.raises(ValueError, match="train_sample"):
            IvfIndex.fit(store, seed=42, trainer=trainer, train_sample=1500, device="cpu")
    from vector_indexer_tpu_torch.parallel import Mesh

    mesh = Mesh([torch.device("cpu")] * 2, ("shards",))
    midx = IvfIndex.fit(store, seed=42, mesh=mesh, resident="host", train_sample=1500,
                        device="cpu")
    assert midx.host_resident and isinstance(midx.layout.vectors, np.ndarray)
    assert int(np.asarray(midx.layout.lengths).sum()) == len(data)
    with pytest.raises(ValueError, match="resident='host'"):
        IvfIndex.fit(store, seed=42, mesh=mesh, resident="host", spill=1, device="cpu")
    with pytest.raises(ValueError, match="mesh-parallel"):
        IvfIndex.fit(store, seed=42, mesh=mesh, trainer="balanced", device="cpu")


def test_load_host_through_bindings_and_api(saved):
    from vector_indexer_tpu_torch.api import SearchRequest, VectorIndexer, VectorIndexerConfig

    wd, data = saved
    vi = bindings.load(str(wd / "index"), str(wd / "shards"), 24, resident="host",
                       device="cpu")
    assert vi.index.host_resident
    D, I = vi.search_sync(data[:10], 5, 3)
    assert (I[:, 0] == np.arange(10)).all()
    cfg = VectorIndexerConfig(24, device="cpu").with_index_dir(wd / "index") \
        .with_shards_dir(wd / "shards")
    ix = VectorIndexer.load(cfg, resident="host")
    res = ix.search_sync(SearchRequest(query=data[3], k=3, n_probe=2))
    assert res[0].external_id == 3


@pytest.mark.parametrize("sd", [torch.float32, torch.int8])
def test_concurrent_staged_searches_match_serial(saved, sd):
    """Concurrent awaits of ``bindings.VectorIndex.search`` on one
    host-resident index (each runs ``search_sync`` on the default thread
    pool, all sharing the index's staging buffer) return what each search
    returns alone."""
    import asyncio

    wd, data = saved
    vi = bindings.load(str(wd / "index"), str(wd / "shards"), 24, resident="host",
                       device="cpu")
    vi.index.stage_dtype = sd
    g = np.random.default_rng(5)
    jobs = [(data[g.choice(len(data), 40, replace=False)] + 0.05, 1 + i % 6)
            for i in range(24)]
    serial = [vi.search_sync(q, 10, p) for q, p in jobs]

    async def all_at_once():
        return await asyncio.gather(*(vi.search(q, 10, p) for q, p in jobs))

    for (D, I), (sD, sI) in zip(asyncio.run(all_at_once()), serial):
        np.testing.assert_array_equal(I, sI)
        np.testing.assert_array_equal(D, sD)
