"""The per-card graphs of the sharded searchers (parallel/graphs.py), on the CPU.

``test_torch_graphs.Rerun``, the stand-in for ``CudaCapture``, makes a
"graph" that runs the captured body again on each replay, through the same
static buffers, so the cache's logic is held here over four CPU mesh
entries: the first call of a shape is eager, the second captures one graph
per card, later calls replay them, and their answers equal the eager
searcher's in every body, external ids included; a capture that raises
leaves the shape eager and the launch counts as they were; each card's
probed rows count the same; the counters and the benchmark's reader of
them; the LRU bound; a new ``stream_dtype`` or metric drops the graphs;
threads sharing a searcher get their own answers; a returned array
survives the next call; and the 2-D and multi-host searchers replay too.
``tests/test_torch_graphs_card.py`` holds the real graphs to the eager path
on a card."""

import importlib.util
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch
from conftest import make_gaussian_clusters
from test_torch_graphs import Rerun

from vector_indexer_tpu_torch.index.ivf import IvfIndex
from vector_indexer_tpu_torch.parallel import (Mesh, MultiHostSearcher, Sharded2DSearcher,
                                               ShardedSearcher)
from vector_indexer_tpu_torch.parallel import graphs as pgraphs
from vector_indexer_tpu_torch.parallel.graphs import ShardGraphs
from vector_indexer_tpu_torch.storage.vector_store import VectorStore
from vector_indexer_tpu_torch.utils import tracing

CPU = torch.device("cpu")
K, N_PROBE, N_DEV = 5, 3, 4
BODIES = ["stream", "dense", "dense_fused"]


@pytest.fixture(scope="module")
def corpus():
    data, _, _ = make_gaussian_clusters(12, 100, 16, spread=0.5, separation=6.0)
    g = np.random.default_rng(5)
    xq = (data[g.choice(len(data), 64, replace=False)] + 0.05).astype(np.float32)
    # External ids that are not the row numbers.
    ids = (np.random.default_rng(3).permutation(len(data)).astype(np.uint64) * 7 + 1000)
    idx = IvfIndex.fit(VectorStore(external_ids=ids, vectors=data), seed=3, nlist=24,
                       device="cpu")
    return idx, xq


def mesh(n=N_DEV):
    return Mesh([CPU] * n, ("shards",))


def staged(idx, method="stream", capture=None):
    """A 1-D searcher whose graphs take the stand-in, and its stand-in."""
    ss = ShardedSearcher(idx, mesh(), method=method)
    ss._graphs = ShardGraphs(capture=capture or Rerun())
    return ss, ss._graphs.capture


def eager(idx, method="stream"):
    """A 1-D searcher whose real capture engages nothing on the CPU."""
    return ShardedSearcher(idx, mesh(), method=method)


def same(a, b):
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])


def batches(xq, n=4, rows=8):
    return [xq[i * rows:(i + 1) * rows] for i in range(n)]


@pytest.mark.parametrize("method", BODIES)
def test_first_call_eager_second_captures_third_replays(corpus, method):
    idx, xq = corpus
    ss, cap = staged(idx, method)
    ref = eager(idx, method)
    for i, q in enumerate(batches(xq)):
        got = ss.search_batch(q, K, N_PROBE)
        # one graph per card: four captured at the second call, four replays a call
        assert (cap.captures, cap.replays) == [(0, 0), (4, 4), (4, 8), (4, 12)][i]
        want = ref.search_batch(q, K, N_PROBE)
        same(got, want)
        assert got[1].min() >= 1000  # external ids
        assert ss.last_method == ref.last_method == method
    assert len(ss._graphs) == 1 and ss._graphs.captured() == 1
    assert len(ref._graphs) == 0


def test_params_run_once_per_shape(corpus, monkeypatch):
    idx, xq = corpus
    ss, _ = staged(idx)
    calls = []
    real = ss.params
    monkeypatch.setattr(ss, "params", lambda *a: calls.append(a) or real(*a))
    for q in batches(xq, 5):
        ss.search_batch(q, K, N_PROBE)
    assert len(calls) == 2  # the eager call and the capture


def test_a_failed_capture_stays_eager(corpus, caplog):
    idx, xq = corpus
    ss, cap = staged(idx, capture=Rerun(fail=True))
    ref = eager(idx)
    for q in batches(xq):
        same(ss.search_batch(q, K, N_PROBE), ref.search_batch(q, K, N_PROBE))
    assert cap.captures == 1 and cap.replays == 0
    assert ss._graphs.captured() == 0
    assert sum("stays eager" in r.getMessage() for r in caplog.records) == 1


def test_a_failed_capture_leaves_launch_counts_as_they_were(corpus, monkeypatch):
    idx, xq = corpus
    ss, cap = staged(idx, capture=Rerun(fail=True))
    counts = {"stream_fused_plane[bf16]": 0}
    body_capture = cap.capture

    def capture(body, device):
        counts["stream_fused_plane[bf16]"] += 2  # the wrapper calls before it raised
        return body_capture(body, device)

    cap.capture = capture
    monkeypatch.setattr(pgraphs.kb, "launch_counts", lambda: dict(counts))
    added = []
    monkeypatch.setattr(pgraphs.kb, "add_launches", added.append)
    for _ in range(3):
        ss.search_batch(xq[:4], K, N_PROBE)
    assert added == [{"stream_fused_plane[bf16]": -2}]


def test_replays_add_the_captured_launches(corpus, monkeypatch):
    idx, xq = corpus
    ss, cap = staged(idx)
    counts = {"stream_fused_plane[bf16]": 0}
    body_capture = cap.capture

    def capture(body, device):
        counts["stream_fused_plane[bf16]"] += 1  # one wrapper call a card
        return body_capture(body, device)

    cap.capture = capture
    monkeypatch.setattr(pgraphs.kb, "launch_counts", lambda: dict(counts))
    added = []
    monkeypatch.setattr(pgraphs.kb, "add_launches", added.append)
    for _ in range(4):
        ss.search_batch(xq[:4], K, N_PROBE)
    assert added == [{"stream_fused_plane[bf16]": -4}] + [{"stream_fused_plane[bf16]": 4}] * 3


def _recorded(searcher, qs):
    tracing.reset_phases()
    try:
        with tracing.recording():
            for q in qs:
                searcher.search_batch(q, K, N_PROBE)
        return tracing.counter_report(), tracing.phase_report()
    finally:
        tracing.reset_phases()


@pytest.mark.parametrize("method", BODIES)
def test_probed_rows_count_the_same_replayed_and_eager(corpus, method):
    idx, xq = corpus
    qs = batches(xq, 5)
    ss, cap = staged(idx, method)
    got, _ = _recorded(ss, qs)
    want, _ = _recorded(eager(idx, method), qs)
    assert cap.replays == 4 * 4
    rows = {n: v for n, v in want.items() if n.startswith("sharded.probed_rows.")}
    assert sorted(rows) == [f"sharded.probed_rows.{j}" for j in range(N_DEV)]
    assert sum(rows.values()) > 0
    assert {n: got[n] for n in rows} == rows


def test_counters_record_captures_and_replays(corpus):
    idx, xq = corpus
    ss, _ = staged(idx)
    counters, phases = _recorded(ss, batches(xq, 5))
    assert counters["sharded.graph.capture"] == 1
    assert counters["sharded.graph.replay"] == 4
    for name in ("sharded.search", "sharded.enqueue", "sharded.merge", "sharded.to_host"):
        assert phases[name]["count"] == 5, name
    counters, _ = _recorded(eager(idx), batches(xq, 3))
    assert "sharded.graph.replay" not in counters and "sharded.graph.capture" not in counters


def _share_reader():
    path = (Path(__file__).resolve().parents[1] / "portbench" / "metrics"
            / "shard_graph_replay_share.py")
    spec = importlib.util.spec_from_file_location("shard_graph_replay_share", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("graphed", [True, False])
def test_shard_graph_replay_share_reads_replays_over_calls(corpus, graphed):
    """The benchmark's per-layer metric: 1.0 when every traced call
    replays, None where nothing replays (a port without the counter reads
    None the same way)."""
    idx, xq = corpus
    ss = staged(idx)[0] if graphed else eager(idx)
    read = _share_reader().read
    tracing.reset_phases()
    try:
        assert read({}) is None
        for _ in range(2):  # eager, then the capture: not traced
            ss.search_batch(xq[:8], K, N_PROBE)
        with tracing.recording():
            for _ in range(3):
                ss.search_batch(xq[:8], K, N_PROBE)
        assert read({}) == (1.0 if graphed else None)
    finally:
        tracing.reset_phases()


def test_lru_bound(corpus):
    idx, xq = corpus
    ss, _ = staged(idx)
    ref = eager(idx)
    for nq in range(1, pgraphs.SLOTS + 3):
        for _ in range(2):
            same(ss.search_batch(xq[:nq], K, N_PROBE), ref.search_batch(xq[:nq], K, N_PROBE))
        assert len(ss._graphs) == min(nq, pgraphs.SLOTS)
    # The oldest shapes went first: nq 1 and 2 start over, eagerly.
    assert [key[0][0][3][0] for key in ss._graphs._shapes] == list(range(3, pgraphs.SLOTS + 3))


def test_new_stream_dtype_drops_the_graphs(corpus):
    """A shape captured on the bf16 stream tables is not replayed once
    ``stream_dtype`` is int8: the graphs go, the tables are rebuilt in int8
    and the answers are the int8 route's, re-ranked exactly."""
    idx, xq = corpus
    ss, cap = staged(idx)
    for q in batches(xq, 3):
        ss.search_batch(q, K, N_PROBE)
    idx.stream_dtype = torch.int8
    try:
        ref = eager(idx)
        for i, q in enumerate(batches(xq, 3)):
            same(ss.search_batch(q, K, N_PROBE), ref.search_batch(q, K, N_PROBE))
            assert ss._graphs.captured() == (0 if i == 0 else 1)
        assert all(sl.stream.vecs.dtype == torch.int8 for sl in ss._slices.values())
        assert cap.captures == 8
    finally:
        idx.stream_dtype = torch.bfloat16


def test_new_metric_drops_the_graphs(corpus):
    idx, xq = corpus
    ss, _ = staged(idx, "dense")
    for q in batches(xq, 3):
        ss.search_batch(q, K, N_PROBE)
    old = ss._graphs._shapes.copy()
    idx.metric = "ip"
    try:
        ref = eager(idx, "dense")
        got = ss.search_batch(xq[:8], K, N_PROBE)
        assert not set(old.values()) & set(ss._graphs._shapes.values())
        assert ss._graphs.captured() == 0
        same(got, ref.search_batch(xq[:8], K, N_PROBE))
        for q in batches(xq, 2):
            same(ss.search_batch(q, K, N_PROBE), ref.search_batch(q, K, N_PROBE))
    finally:
        idx.metric = "l2"


def test_threads_get_their_own_answers(corpus):
    """Threads sharing a searcher: the shape's lock covers the fill, the
    replays and the merge, so no thread reads another's static outputs."""
    idx, xq = corpus
    ss, _ = staged(idx)
    qs = batches(xq, 6)
    ref = eager(idx)
    want = [ref.search_batch(q, K, N_PROBE) for q in qs]
    ss.search_batch(qs[0], K, N_PROBE)  # seen once: the threads capture and replay
    errors = []

    def client(t):
        try:
            for r in range(6):
                i = (t + r) % len(qs)
                same(ss.search_batch(qs[i], K, N_PROBE), want[i])
        except AssertionError as e:  # pragma: no cover - the failure's report
            errors.append(e)

    threads = [threading.Thread(target=client, args=(t,)) for t in range(4)]
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
    assert ss._graphs.captured() == 1


def test_returned_arrays_survive_the_next_call(corpus):
    idx, xq = corpus
    ss, _ = staged(idx)
    for _ in range(2):
        ss.search_batch(xq[:8], K, N_PROBE)
    d1, i1 = ss.search_batch(xq[:8], K, N_PROBE)
    keep = d1.copy(), i1.copy()
    d2, i2 = ss.search_batch(xq[8:16], K, N_PROBE)
    assert not np.array_equal(i1, i2)
    same((d1, i1), keep)
    d1[:] = 0  # the caller owns what it got
    same((d2, i2), eager(idx).search_batch(xq[8:16], K, N_PROBE))


@pytest.mark.parametrize("kind", ["2d", "multihost"])
def test_grid_searchers_replay(corpus, kind):
    """The 2-D searcher (a pinned buffer per query slice) and the
    multi-host searcher (one for all) replay a graph per mesh entry and
    answer as their eager twins."""
    idx, xq = corpus
    grid = np.empty((2, 2), dtype=object)
    for i in range(4):
        grid[i // 2, i % 2] = CPU
    axes = ("queries", "shards") if kind == "2d" else ("hosts", "shards")
    cls = Sharded2DSearcher if kind == "2d" else MultiHostSearcher

    def make():
        return cls(idx, Mesh(grid, axes), method="stream")

    ss, ref = make(), make()
    ss._graphs = ShardGraphs(capture=Rerun())
    cap = ss._graphs.capture
    for q in batches(xq, 4, rows=9):
        same(ss.search_batch(q, K, N_PROBE), ref.search_batch(q, K, N_PROBE))
    assert cap.captures == 4 and cap.replays == 12
    assert len(ss._graphs._shapes[next(iter(ss._graphs._shapes))].hosts) == (
        2 if kind == "2d" else 1)
