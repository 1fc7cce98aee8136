"""A corpus that no one device holds: the mesh fit of a host corpus
(``IvfIndex.fit(mesh=, resident="host", train_sample=)``), each device's
slice packed straight from the host layout, and ``ShardedSearcher``'s
external-id answers, held to the benchmark's plain reference
(``portbench/reference.py``, float64) on four CPU mesh entries. No JAX here."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import datagen, reference  # noqa: E402
from portbench.harness import port_labels  # noqa: E402
from vector_indexer_tpu_torch.index.ivf import IvfIndex  # noqa: E402
from vector_indexer_tpu_torch.models import kmeans  # noqa: E402
from vector_indexer_tpu_torch.parallel import Mesh, ShardedSearcher  # noqa: E402
from vector_indexer_tpu_torch.parallel import dp_kmeans  # noqa: E402
from vector_indexer_tpu_torch.parallel import sharded as tsh  # noqa: E402
from vector_indexer_tpu_torch.storage import staging  # noqa: E402
from vector_indexer_tpu_torch.storage.layout import PostingLayout  # noqa: E402
from vector_indexer_tpu_torch.storage.vector_store import VectorStore  # noqa: E402
from vector_indexer_tpu_torch.utils import tracing  # noqa: E402

CPU = torch.device("cpu")
N, D, NLIST, SAMPLE = 8000, 16, 64, 3000
# The reference's own cross-path tolerance (tests/test_torch_parallel.py):
# the port's f32 norm expansion against float64.
RTOL, ATOL = 1e-3, 5e-4


def mesh4() -> Mesh:
    return Mesh([CPU] * 4, ("shards",))


def corpus(n=N, d=D, ncent=16, seed=7):
    xb, xq = datagen.clustered(n, d, 64, seed, CPU, ncent, 4.0)
    return xb.numpy(), xq.numpy()


def ext_ids(n):
    """External ids that are not the row numbers: a seeded permutation of
    a sparse id space."""
    return (np.random.default_rng(3).permutation(n).astype(np.uint64) * 7 + 1000)


def fit_host_mesh(xb, nlist=NLIST, sample=SAMPLE, ids=None):
    ids = np.arange(len(xb), dtype=np.uint64) if ids is None else ids
    return IvfIndex.fit(VectorStore(external_ids=ids, vectors=xb), seed=42, nlist=nlist,
                        mesh=mesh4(), resident="host", train_sample=sample, device="cpu")


@pytest.fixture(scope="module")
def built():
    xb, xq = corpus()
    ids = ext_ids(len(xb))
    return xb, xq, ids, fit_host_mesh(xb, ids=ids)


def test_mesh_host_fit_lists_are_the_exact_nearest_centroids(built):
    xb, _, _, idx = built
    assert idx.host_resident and isinstance(idx.layout.vectors, np.ndarray)
    ref = reference.assign(torch.as_tensor(xb), torch.as_tensor(idx.centroids), "l2",
                           torch.float64).numpy()
    # Every row is in its float64-nearest list of the (filtered) table.
    np.testing.assert_array_equal(port_labels(idx.layout, len(xb)), ref)


def test_mesh_host_fit_trains_on_the_host_trainers_rows(monkeypatch):
    xb, _ = corpus(n=3000)
    seen = []
    real = dp_kmeans._Slices

    def spy(data, devices):
        seen.append(np.array(data))
        return real(data, devices)

    monkeypatch.setattr(dp_kmeans, "_Slices", spy)
    fit_host_mesh(xb, nlist=32, sample=1200)
    assert len(seen) == 1
    np.testing.assert_array_equal(seen[0], xb[kmeans.training_sample(len(xb), 1200, 42)])


@pytest.mark.parametrize("n_dev", [1, 3, 4])
def test_host_assignment_splits_rows_over_devices(n_dev):
    xb, _ = corpus(n=5003)
    cents = torch.as_tensor(xb[:40].copy())
    got = dp_kmeans.assign_points_host(xb, cents, [CPU] * n_dev)
    ref = reference.assign(torch.as_tensor(xb), cents, "l2", torch.float64).numpy()
    np.testing.assert_array_equal(got, ref)


def test_on_each_gives_every_card_a_thread(monkeypatch):
    """On cards, each device's call runs in a thread of its own with its
    device current, and the results come back in device order; CPU entries
    run in turn on the caller's thread."""
    import contextlib
    import threading

    current = threading.local()

    @contextlib.contextmanager
    def fake_device(dev):
        current.dev = dev
        yield

    monkeypatch.setattr(tsh, "on_device", fake_device)
    assert dp_kmeans.on_each is tsh.on_each
    cards = [torch.device("cuda", i) for i in range(3)]
    together = threading.Barrier(3, timeout=30)  # passes only if all three run at once

    def call(j):
        together.wait()
        return j, current.dev, threading.get_ident()

    got = tsh.on_each(cards, call)
    assert [(j, dev) for j, dev, _ in got] == list(zip(range(3), cards))
    assert len({t for *_, t in got}) == 3
    got = tsh.on_each([CPU] * 2, lambda j: threading.get_ident())
    assert got == [threading.get_ident()] * 2


def test_on_each_runs_a_card_s_entries_in_turn_on_one_thread(monkeypatch):
    """Entries on the same card share that card's thread, in entry order;
    distinct cards still run at once; results come back in entry order."""
    import contextlib
    import threading

    monkeypatch.setattr(tsh, "on_device", lambda dev: contextlib.nullcontext())
    cards = [torch.device("cuda", i) for i in (0, 1, 0, 1, 0)]
    together = threading.Barrier(2, timeout=30)
    seen = []

    def call(j):
        if j < 2:
            together.wait()  # the first entry of each card: both threads at once
        seen.append(j)
        return j, threading.get_ident()

    got = tsh.on_each(cards, call)
    assert [j for j, _ in got] == list(range(5))
    by_card = {}
    for (j, t), dev in zip(got, cards):
        by_card.setdefault(dev, set()).add(t)
    assert all(len(t) == 1 for t in by_card.values()) and len(set.union(*by_card.values())) == 2
    assert [j for j in seen if cards[j].index == 0] == [0, 2, 4]


def _reference_answers(xb, xq, idx, n_probe, k):
    x = torch.as_tensor(xb)
    cents = torch.as_tensor(idx.centroids)
    labels = reference.assign(x, cents, "l2", torch.float64)
    d, i = reference.search_lists(torch.as_tensor(xq), x, labels, cents, n_probe, k, "l2",
                                  torch.float64)
    return d.numpy(), i.numpy()


@pytest.mark.parametrize("method", ["dense", "stream", "auto"])
@pytest.mark.parametrize("n_probe", [3, 12])
def test_sharded_answers_are_the_reference_top_k(built, method, n_probe):
    """External ids of the exact top-k over each query's n_probe nearest
    lists. dense: the same sets, distances within RTOL / ATOL (f32 norm
    expansion against float64). stream: the residual rows are bfloat16
    (8 significant bits), so each returned distance lies within 2e-2 of the
    neighbourhood's scale (the k-th distance) of its row's exact one, and
    the rows' exact distances within that of the reference's top-k (a
    near tie may swap)."""
    xb, xq, ids, idx = built
    k = 10
    ss = ShardedSearcher(idx, mesh4(), method=method)
    D, I = ss.search_batch(xq, k, n_probe)
    ref_d, ref_i = _reference_answers(xb, xq, idx, n_probe, k)
    np.testing.assert_array_equal(I >= 0, ref_i >= 0)
    want = np.where(ref_i >= 0, ids[np.maximum(ref_i, 0)].astype(np.int64), -1)
    if ss.last_method == "dense":
        assert all(set(a) == set(b) for a, b in zip(I.tolist(), want.tolist()))
        np.testing.assert_allclose(D, ref_d, rtol=RTOL, atol=ATOL)
    else:
        order = np.argsort(ids)
        rows = order[np.searchsorted(ids[order], I.astype(np.uint64))]
        exact = ((xq[:, None, :].astype(np.float64) - xb[rows]) ** 2).sum(-1)
        scale = ref_d[:, -1:]
        assert (np.abs(D - exact) <= 2e-2 * scale).all()
        assert (np.abs(np.sort(exact, axis=1) - ref_d) <= 2e-2 * scale).all()
        assert np.mean([len(set(a) & set(b)) for a, b in zip(I.tolist(), want.tolist())]) > 9


@pytest.mark.parametrize("method", ["dense", "stream"])
def test_sharded_serving_never_gathers_a_host_table(built, monkeypatch, method):
    """Each slice reads its rows from the corpus by the host layout's row
    map: the 2 x corpus-sized table is never made, and the answers are those
    of an index whose table was made."""
    xb, xq, ids, made = built
    assert isinstance(made.layout.vectors, np.ndarray)  # made: the first read gathers it
    idx = fit_host_mesh(xb, ids=ids)
    assert idx.layout._pending is not None
    monkeypatch.setattr(PostingLayout, "_make_table",
                        lambda self: pytest.fail("the host table was gathered"))
    D, I = ShardedSearcher(idx, mesh4(), method=method).search_batch(xq, 10, 6)
    want_d, want_i = ShardedSearcher(made, mesh4(), method=method).search_batch(xq, 10, 6)
    np.testing.assert_array_equal(I, want_i)
    np.testing.assert_array_equal(D, want_d)


def test_sharded_ids_are_the_host_resident_index_s(built):
    """The host-resident index's own (staged) search maps its rows to the
    same external ids."""
    xb, xq, ids, idx = built
    _, ext = ShardedSearcher(idx, mesh4(), method="dense").search_batch(xq, 5, 6)
    _, staged = idx.search_batch(xq, 5, 6, external=True)
    assert all(set(a) == set(b) for a, b in zip(ext.tolist(), staged.tolist()))
    assert np.isin(ext, ids.astype(np.int64)).all()


def test_sharded_dense_fused_answers_are_the_reference_top_k():
    """K3's masked sweep (its plain version here) at d 128, where the plan
    gate accepts: the reference's sets, distances within the fused sweep's
    3xTF32 products' tolerance (``test_torch_parallel``'s 3e-2 absolute)."""
    xb, xq = corpus(n=14000, d=128, ncent=12)
    idx = fit_host_mesh(xb, nlist=32, sample=3000)
    ss = ShardedSearcher(idx, mesh4(), method="dense_fused")
    assert tsh.plan_fused(ss._host_tables.local_vecs.shape[1], 128, len(xq), 10) is not None
    D, I = ss.search_batch(xq, 10, 4)
    ref_d, ref_i = _reference_answers(xb, xq, idx, 4, 10)
    np.testing.assert_array_equal(I[:, 0], ref_i[:, 0])
    assert all(len(set(a) & set(b)) >= 8 for a, b in zip(I.tolist(), ref_i.tolist()))
    np.testing.assert_allclose(D[:, 0], ref_d[:, 0], rtol=1e-3, atol=3e-2)


@pytest.mark.parametrize("layout", ["host", "tensor", "offloaded"])
def test_device_slices_equal_the_host_tables(built, layout):
    """Each slice's rows and norms are the host tables', whether they come
    from a host layout, a tensor layout, or, where an offloaded index freed
    its table, from the host mirror by ``perm``."""
    xb, _, _, idx = built
    host = tsh.build_local_tables(idx, 4)
    if layout != "host":  # the same index with its layout as a tensor
        lay = idx.layout
        idx = IvfIndex(idx.dimension, device="cpu")
        idx.__dict__.update(built[3].__dict__)
        idx.layout = type(lay)(torch.as_tensor(lay.vectors), torch.as_tensor(lay.row_norms),
                               lay.offsets, lay.lengths, lay.perm, lay.n, lay.max_list_len)
        idx.host_resident = False
        if layout == "offloaded":
            idx.offload_main_table()
            assert idx.layout.vectors is None
    ss = ShardedSearcher(idx, mesh4(), method="stream")
    for j in range(4):
        sl = ss._slices[(j, CPU)]
        np.testing.assert_array_equal(sl.vecs.numpy(), host.local_vecs[j])
        np.testing.assert_array_equal(sl.norms.numpy(), host.local_norms[j])
    np.testing.assert_array_equal(ss.local_perm, host.local_perm)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8, torch.float32])
def test_device_stream_tables_equal_the_host_tables(built, dtype):
    _, _, _, idx = built
    idx.stream_dtype = dtype
    try:
        host = tsh.build_local_stream_tables(tsh.build_local_tables(idx, 4), dtype)
        ss = ShardedSearcher(idx, mesh4(), method="stream")
        ss._stream_tables()
    finally:
        idx.stream_dtype = torch.bfloat16
    for j in range(4):
        st = ss._slices[(j, CPU)].stream
        assert (st.m_pad, st.chunk) == (host["m_pad"], host["chunk"])
        got = st.vecs.view(torch.int16) if dtype == torch.bfloat16 else st.vecs
        want = host["svecs"][j].view(torch.int16) if dtype == torch.bfloat16 else host["svecs"][j]
        assert torch.equal(got, want)
        np.testing.assert_array_equal(st.norms.numpy(), host["snorms"][j])
        np.testing.assert_array_equal(st.scales.numpy(), host["scales"][j])
        for mine, theirs in (("to_main", "sto_local"), ("sblk0", "sblk0"), ("lengths", "slen"),
                             ("blk_cid", "blk_cid")):
            np.testing.assert_array_equal(getattr(st, mine).numpy(), host[theirs][j])


@pytest.mark.parametrize("stage_rows", [8, 40, 1 << 20])
def test_staged_copy_equals_the_direct_copy(built, monkeypatch, stage_rows):
    """The staging path a card takes (run on the CPU here): buffers smaller
    than a run, than a cell, and larger than the slice."""
    _, _, _, idx = built
    t = tsh.plan_local_tables(idx, 4)
    monkeypatch.setattr(staging, "STAGE_BYTES", stage_rows * 4 * D)
    for j in range(4):
        direct, _ = tsh.pack_rows(idx, t, j, CPU)
        staged = torch.zeros_like(direct)
        tsh._staged_copy(staged, t.runs[j],
                         lambda lo, hi, out: tsh._layout_rows(idx, lo, hi, out))
        assert torch.equal(staged, direct)


class RowsMade(TorchDispatchMode):
    """The most rows of any 2-D tensor an operation allocated (views and
    wrappers of an input's memory are not allocations)."""

    def __init__(self):
        super().__init__()
        self.most = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        given = {a.untyped_storage().data_ptr() for a in torch.utils._pytree.tree_leaves(
            (args, kwargs)) if isinstance(a, torch.Tensor)}
        for t in out if isinstance(out, (tuple, list)) else (out,):
            if (isinstance(t, torch.Tensor) and t.dim() == 2
                    and t.untyped_storage().data_ptr() not in given):
                self.most = max(self.most, t.shape[0])
        return out


@pytest.mark.parametrize("method", ["dense", "stream"])
def test_no_device_tensor_holds_the_corpus(method):
    """The fit and the share-out (the slices' rows, their stream tables)
    make no tensor with as many rows as the corpus, which stays a host
    array: a slice holds about a quarter of the rows, and its stream table
    those rows with each list padded to whole chunks."""
    xb, xq = corpus()
    with RowsMade() as spy:
        idx = fit_host_mesh(xb)
        ss = ShardedSearcher(idx, mesh4(), method=method)
        if method == "stream":
            ss._stream_tables()
    assert 0 < spy.most < len(xb)
    assert ss._host_tables.local_vecs.shape[1] <= 0.4 * len(xb)
    assert ss.search_batch(xq, 10, 6)[1].min() >= 0


def test_spans_and_probed_rows_counter(built):
    xb, xq, _, idx = built
    tracing.reset_phases()
    ss = ShardedSearcher(idx, mesh4(), method="dense")
    ss.search_batch(xq, 10, 6)
    assert tracing.phase_report() == {} and tracing.counter_report() == {}
    with tracing.recording():
        ss = ShardedSearcher(idx, mesh4(), method="stream")
        ss.search_batch(xq, 10, 6)
        ss.search_batch(xq, 10, 6)
    ph = tracing.phase_report()
    assert ph["sharded.pack"]["count"] == 1 and ph["sharded.upload"]["count"] == 4
    assert ph["sharded.stream_table"]["count"] == 4
    for name in ("sharded.search", "sharded.enqueue", "sharded.merge", "sharded.to_host"):
        assert ph[name]["count"] == 2, name
    counts = tracing.counter_report()
    assert sorted(counts) == [f"sharded.probed_rows.{j}" for j in range(4)]
    # Each query probes its 6 nearest lists (no ties here), whichever card holds them.
    cents = torch.as_tensor(idx.centroids)
    probed = reference.probes(torch.as_tensor(xq), cents, 6, torch.float64).numpy()
    rows = np.asarray(idx.layout.lengths)[probed].sum()
    assert sum(counts.values()) == 2 * rows
    tracing.reset_phases()
    assert tracing.counter_report() == {}


def test_fit_assign_span(built):
    xb, _, _, _ = built
    tracing.reset_phases()
    with tracing.recording():
        fit_host_mesh(xb[:3000], nlist=16, sample=1000)
    ph = tracing.phase_report()
    assert ph["fit.assign"]["count"] == 1 and ph["fit.kmeans"]["count"] == 1
    assert ph["fit.assign"]["total_s"] <= ph["fit.kmeans"]["total_s"]
    tracing.reset_phases()


@pytest.mark.parametrize("d", [3, 7, 8, 24, 128, 129, 200, 1536])
def test_pairwise_row_sums_equal_numpy(d):
    g = np.random.default_rng(d)
    a = (g.standard_normal((3000, d)) * g.uniform(0.01, 100.0, (3000, 1))).astype(np.float32)
    want = (a.astype(np.float64) ** 2).sum(1)
    got = tsh.pairwise_row_sums(torch.from_numpy(a).double() ** 2).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tsh.sq_norms_f64(torch.from_numpy(a)).numpy(),
                                  want.astype(np.float32))
