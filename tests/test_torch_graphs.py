"""The graph cache of ``IvfIndex.search_batch`` (index/graphs.py), on the CPU.

A stand-in for ``CudaCapture`` makes a "graph" that runs the captured body
again on each replay, through the same static buffers, so the cache's logic
is held here: the first call of a shape is eager, the second captures, the
third replays; a capture that raises leaves the shape eager; the LRU bound;
a refit, new external ids, a new ``stream_dtype``, ``offload_main_table``
and ``to_host_resident`` drop the graphs, and a table built late does not; a CPU index with the real capture engages nothing; threads
sharing an index get their own answers; and a returned array survives the
next call. ``tests/test_torch_graphs_card.py`` holds the real graphs to the
eager path on a card."""

import sys
import threading

import numpy as np
import pytest
import torch
from conftest import make_gaussian_clusters

from vector_indexer_tpu_torch.api import VectorIndexer, VectorIndexerConfig
from vector_indexer_tpu_torch.bindings import VectorIndex
from vector_indexer_tpu_torch.index import graphs
from vector_indexer_tpu_torch.index.graphs import SearchGraphs
from vector_indexer_tpu_torch.index.ivf import IvfIndex
from vector_indexer_tpu_torch.storage.vector_store import VectorStore
from vector_indexer_tpu_torch.utils import tracing

K, N_PROBE = 5, 3
METHODS = ["auto", "stream", "stream_exact", "stream_shared", "dense", "flat", "gather",
           "gather_dma"]


class Rerun:
    """``CudaCapture``'s stand-in: engages on any device, and its graph runs
    the captured body again."""

    def __init__(self, fail: bool = False):
        self.fail = fail
        self.captures = 0
        self.replays = 0

    def engages(self, device):
        return True

    def host_buffer(self, shape, dtype):
        return torch.empty(shape, dtype=dtype)

    def capture(self, body, device):
        self.captures += 1
        if self.fail:
            raise RuntimeError("capture refused")
        body()

        def replay():
            self.replays += 1
            body()

        return replay

    def wait(self, device):
        pass


@pytest.fixture(scope="module")
def corpus():
    data, _, _ = make_gaussian_clusters(12, 100, 16, spread=0.5, separation=6.0)
    g = np.random.default_rng(7)
    return data, (data[g.choice(len(data), 64, replace=False)] + 0.05).astype(np.float32)


def _fit(data, metric="l2", ids=None):
    ids = np.arange(len(data), dtype=np.uint64) if ids is None else ids
    return IvfIndex.fit(VectorStore(external_ids=ids, vectors=data), seed=3, nlist=24,
                        metric=metric, device="cpu")


def _staged(idx, capture=None):
    idx._graphs = SearchGraphs(capture=capture or Rerun())
    return idx._graphs.capture


def _eager(idx, q, method="auto", external=False):
    return idx._search_host(q, K, N_PROBE, method, external)


def _same(a, b):
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])


@pytest.mark.parametrize("external", [False, True])
@pytest.mark.parametrize("metric", ["l2", "cosine"])
@pytest.mark.parametrize("method", METHODS)
def test_first_call_eager_second_captures_third_replays(corpus, method, metric, external):
    data, xq = corpus
    idx = _fit(data, metric)
    cap = _staged(idx)
    batches = [xq[i * 8:(i + 1) * 8] for i in range(4)]
    for i, q in enumerate(batches):
        got = idx.search_batch(q, K, N_PROBE, method, external=external)
        assert (cap.captures, cap.replays) == [(0, 0), (1, 1), (1, 2), (1, 3)][i]
        _same(got, _eager(idx, q, method, external))
    assert len(idx._graphs) == 1 and idx._graphs.captured() == 1


def test_counters_record_captures_and_replays(corpus):
    data, xq = corpus
    idx = _fit(data)
    _staged(idx)
    tracing.reset_phases()
    try:
        with tracing.recording():
            for _ in range(5):
                idx.search_batch(xq[:4], K, N_PROBE)
        counters = tracing.counter_report()
        phases = tracing.phase_report()
    finally:
        tracing.reset_phases()
    assert counters["search.graph.capture"] == 1
    assert counters["search.graph.replay"] == 4
    # Every call waits for its answer once (the stand-in's replays run the
    # body again, so its upload and program spans count twice).
    assert phases["search.to_host"]["count"] == 5
    assert phases["search.upload"]["count"] >= 5 and phases["search.program"]["count"] >= 5


def test_a_failed_capture_stays_eager(corpus, caplog):
    data, xq = corpus
    idx = _fit(data)
    cap = _staged(idx, Rerun(fail=True))
    for i in range(4):
        q = xq[i * 4:(i + 1) * 4]
        _same(idx.search_batch(q, K, N_PROBE), _eager(idx, q))
    assert cap.captures == 1 and cap.replays == 0
    assert idx._graphs.captured() == 0
    assert sum("stays eager" in r.getMessage() for r in caplog.records) == 1


def test_a_failed_capture_leaves_launch_counts_as_they_were(corpus, monkeypatch):
    data, xq = corpus
    idx = _fit(data)
    _staged(idx, Rerun(fail=True))
    counts = {"stream_distances[bf16]": 7}
    monkeypatch.setattr(graphs.kb, "launch_counts", lambda: dict(counts))
    added = []
    monkeypatch.setattr(graphs.kb, "add_launches", added.append)
    for _ in range(3):
        idx.search_batch(xq[:4], K, N_PROBE)
    assert added == [{}]


def test_replays_add_the_captured_launches(corpus, monkeypatch):
    data, xq = corpus
    idx = _fit(data)
    cap = _staged(idx)
    counts = {"stream_fused_plane[bf16]": 0}
    body_capture = cap.capture

    def capture(body, device):
        counts["stream_fused_plane[bf16]"] += 2  # the wrapper calls inside the capture
        return body_capture(body, device)

    cap.capture = capture
    monkeypatch.setattr(graphs.kb, "launch_counts", lambda: dict(counts))
    added = []
    monkeypatch.setattr(graphs.kb, "add_launches", added.append)
    for _ in range(4):
        idx.search_batch(xq[:4], K, N_PROBE)
    assert added == [{"stream_fused_plane[bf16]": -2}] + [{"stream_fused_plane[bf16]": 2}] * 3


def test_lru_bound(corpus):
    data, xq = corpus
    idx = _fit(data)
    _staged(idx)
    for nq in range(1, graphs.SLOTS + 3):
        for _ in range(2):
            _same(idx.search_batch(xq[:nq], K, N_PROBE), _eager(idx, xq[:nq]))
        assert len(idx._graphs) == min(nq, graphs.SLOTS)
    # The oldest shapes went first: nq 1 and 2 start over, eagerly.
    assert [key[0] for key in idx._graphs._shapes] == list(range(3, graphs.SLOTS + 3))


def test_new_external_ids_drop_the_graphs(corpus):
    data, xq = corpus
    idx = _fit(data)
    _staged(idx)
    for _ in range(3):
        idx.search_batch(xq[:4], K, N_PROBE, external=True)
    old = idx._graphs._shapes[(4, 16, K, N_PROBE, "auto", True)]
    idx.external_ids = np.arange(len(data), dtype=np.uint64)[::-1] + np.uint64(1000)
    d, ids = idx.search_batch(xq[:4], K, N_PROBE, external=True)
    assert old not in idx._graphs._shapes.values() and idx._graphs.captured() == 0
    _same((d, ids), _eager(idx, xq[:4], external=True))
    assert ids.min() >= 1000


def test_new_stream_dtype_captures_anew(corpus):
    """A shape captured on the bf16 stream table is not replayed once
    ``stream_dtype`` is int8: the next call runs eagerly (the int8 table
    and its exact re-rank), the one after captures that route."""
    data, xq = corpus
    idx = _fit(data)
    cap = _staged(idx)
    for _ in range(3):
        idx.search_batch(xq[:4], K, N_PROBE, "stream")
    assert (cap.captures, cap.replays) == (1, 2)
    idx.stream_dtype = torch.int8
    got = []
    for i in range(3):
        got.append(idx.search_batch(xq[:4], K, N_PROBE, "stream"))
        assert (cap.captures, cap.replays) == [(1, 2), (2, 3), (2, 4)][i]
    want = _eager(idx, xq[:4], "stream")
    for g in got:
        _same(g, want)
    assert torch.int8 in idx.tables().streams


def test_a_late_table_keeps_the_captured_graphs(corpus):
    """The first call of another method builds its own lazy tables (the
    gather's list tables, the dense sweep's run tables) in the same owner:
    the shape already captured keeps its graph and replays."""
    data, xq = corpus
    idx = _fit(data)
    cap = _staged(idx)
    for _ in range(2):
        idx.search_batch(xq[:4], K, N_PROBE, "stream")
    assert idx._graphs.captured() == 1
    for method in ("gather", "dense"):
        _same(idx.search_batch(xq[:4], K, N_PROBE, method), _eager(idx, xq[:4], method))
        assert idx._graphs.captured() == 1
    assert {"lists", "runs"} <= set(vars(idx.tables()))
    _same(idx.search_batch(xq[:4], K, N_PROBE, "stream"), _eager(idx, xq[:4], "stream"))
    assert (cap.captures, cap.replays) == (1, 2)


def test_offload_drops_the_graphs(corpus):
    data, xq = corpus
    idx = _fit(data)
    _staged(idx)
    for _ in range(3):
        idx.search_batch(xq[:4], K, N_PROBE)
    assert idx._graphs.captured() == 1
    idx.offload_main_table(rerank="none")
    assert len(idx._graphs) == 0 and idx._graphs._state is None
    ref = idx._search_host(xq[:4], K, N_PROBE, "auto", False)
    for _ in range(3):  # offloaded: never captured again
        _same(idx.search_batch(xq[:4], K, N_PROBE), ref)
    assert len(idx._graphs) == 0


def test_host_resident_drops_the_graphs(corpus):
    data, xq = corpus
    idx = _fit(data)
    _staged(idx)
    for _ in range(3):
        idx.search_batch(xq[:4], K, N_PROBE)
    want = idx.search_batch(xq[:4], K, N_PROBE)
    idx.to_host_resident()
    assert len(idx._graphs) == 0 and idx._graphs._state is None
    for _ in range(3):
        d, ids = idx.search_batch(xq[:4], K, N_PROBE)
        np.testing.assert_array_equal(ids, want[1])
    assert len(idx._graphs) == 0


def test_refit_drops_the_graphs(corpus, tmp_path):
    data, xq = corpus
    cfg = VectorIndexerConfig(16, device="cpu").with_index_dir(tmp_path / "i").with_shards_dir(
        tmp_path / "s")
    vi = VectorIndex(VectorIndexer(cfg).build_from_arrays(data))
    cap = _staged(vi.index)
    for _ in range(3):
        vi.search_sync(xq[:4], K, N_PROBE)
    assert cap.captures == 1
    old = vi.index._graphs
    vi.indexer.build_from_arrays(data[::-1].copy())
    assert vi.index._graphs is not old and len(vi.index._graphs) == 0
    cap2 = _staged(vi.index)
    d, ids = vi.search_sync(xq[:4], K, N_PROBE)  # a new layout: eager again
    assert cap2.captures == 0
    _same((d, ids), vi.index._search_host(xq[:4], K, N_PROBE, "auto", True))


def test_cpu_index_engages_nothing(corpus):
    data, xq = corpus
    idx = _fit(data)
    assert isinstance(idx._graphs.capture, graphs.CudaCapture)
    for _ in range(4):
        _same(idx.search_batch(xq[:8], K, N_PROBE), _eager(idx, xq[:8]))
    assert len(idx._graphs) == 0


def test_spilled_and_tensor_queries_stay_eager(corpus):
    data, xq = corpus
    spilled = IvfIndex.fit(VectorStore(external_ids=np.arange(len(data), dtype=np.uint64),
                                       vectors=data), seed=3, nlist=24, spill=1, device="cpu")
    plain = _fit(data)
    for idx, q in ((spilled, xq[:4]), (plain, torch.from_numpy(xq[:4]))):
        cap = _staged(idx)
        for _ in range(3):
            _same(idx.search_batch(q, K, N_PROBE), _eager(idx, q))
        assert cap.captures == 0


def test_threads_get_their_own_answers(corpus):
    data, xq = corpus
    idx = _fit(data)
    _staged(idx)
    batches = [xq[i * 8:(i + 1) * 8] for i in range(8)]
    want = [_eager(idx, q) for q in batches]
    idx.search_batch(batches[0], K, N_PROBE)  # seen once: the threads capture and replay
    errors = []

    def client(j):
        try:
            for r in range(12):
                i = (j + r) % len(batches)
                _same(idx.search_batch(batches[i], K, N_PROBE), want[i])
        except AssertionError as e:  # pragma: no cover - the failure's report
            errors.append(e)

    threads = [threading.Thread(target=client, args=(j,)) for j in range(6)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)  # switch often, so a missing lock shows
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert not errors
    assert idx._graphs.captured() == 1


def test_returned_arrays_survive_the_next_call(corpus):
    data, xq = corpus
    idx = _fit(data)
    _staged(idx)
    for _ in range(2):
        idx.search_batch(xq[:8], K, N_PROBE)
    d1, i1 = idx.search_batch(xq[:8], K, N_PROBE)
    keep = d1.copy(), i1.copy()
    d2, i2 = idx.search_batch(xq[8:16], K, N_PROBE)
    assert not np.array_equal(i1, i2)
    _same((d1, i1), keep)
    d1[:] = 0  # the caller owns what it got
    _same((d2, i2), _eager(idx, xq[8:16]))


def test_single_query_search_replays(corpus):
    data, xq = corpus
    idx = _fit(data)
    cap = _staged(idx)
    hits = [idx.search(xq[i], K, N_PROBE) for i in range(4)]
    assert cap.captures == 1 and cap.replays == 3
    for i, hit in enumerate(hits):
        d, ids = _eager(idx, xq[i:i + 1], external=False)
        assert [h[0] for h in hit] == [int(idx.external_ids[j]) for j in ids[0] if j >= 0]


def _variant(q, kind):
    if kind == "read_only":
        q = q.copy()
        q.setflags(write=False)
        return q
    if kind == "float64":
        return q.astype(np.float64)
    if kind == "strided":
        wide = np.zeros((q.shape[0], 2 * q.shape[1]), np.float32)
        wide[:, ::2] = q
        return wide[:, ::2]
    return q.tolist()


@pytest.mark.parametrize("kind", ["read_only", "float64", "strided", "list"])
def test_any_host_array_fills_the_buffer(corpus, kind):
    data, xq = corpus
    idx = _fit(data)
    cap = _staged(idx)
    for i in range(4):
        q = xq[i * 8:(i + 1) * 8]
        _same(idx.search_batch(_variant(q, kind), K, N_PROBE), _eager(idx, q))
    assert cap.replays == 3


def _replay_share_reader():
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "portbench" / "metrics" / "graph_replay_share.py"
    spec = importlib.util.spec_from_file_location("graph_replay_share", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("graphed", [True, False])
def test_graph_replay_share_reads_replays_over_calls(corpus, graphed):
    """The benchmark's per-layer metric over the public ``search_sync``:
    1.0 when every traced call replays, None where nothing replays (a
    port without the counter reads None the same way)."""
    data, xq = corpus
    idx = _fit(data)
    if graphed:
        _staged(idx)
    vi = VectorIndex(VectorIndexer(VectorIndexerConfig(16, device="cpu"), _index=idx))
    read = _replay_share_reader().read
    tracing.reset_phases()
    try:
        assert read({}) is None
        for _ in range(2):  # eager, then the capture: not traced
            vi.search_sync(xq[:4], K, N_PROBE)
        with tracing.recording():
            for _ in range(3):
                vi.search_sync(xq[:4], K, N_PROBE)
        assert read({}) == (1.0 if graphed else None)
    finally:
        tracing.reset_phases()
