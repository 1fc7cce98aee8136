"""Captured search graphs on a CUDA card (index/graphs.py): every replayed
(D, ids) equals the eager path's bit for bit, over replays with other
queries, on the stream route through K4 (d 128, nq 1), the stream route
through K2's split launch (d 1,536, nq 256, cosine) and the dense route
through K3 (``dense_fused``); each replay counts its kernels and, while
spans record, ``search.graph.replay``.

The same holds for the sharded searcher's per-card graphs
(parallel/graphs.py): a 1-D ``ShardedSearcher`` over mesh entries of one
card, on the stream body, against a twin that never captures.

Marked ``card``: they skip without one. On a card, from the root of the
repository (the tests' ``conftest.py`` imports JAX, which these do not
need): ``python -m pytest --noconftest -q tests/test_torch_graphs_card.py``.
"""

import numpy as np
import pytest
import torch

from vector_indexer_tpu_torch.index.ivf import IvfIndex
from vector_indexer_tpu_torch.index.graphs import CudaCapture
from vector_indexer_tpu_torch.kernels.build import launch_counts
from vector_indexer_tpu_torch.parallel import Mesh, ShardedSearcher
from vector_indexer_tpu_torch.storage.vector_store import VectorStore
from vector_indexer_tpu_torch.utils import tracing

pytestmark = pytest.mark.card

# route -> (n, d, nlist, metric, nq, k, n_probe, method, kernel counted)
ROUTES = {
    "k4_stream": (100_000, 128, 200, "l2", 1, 10, 32, "stream", "stream_fused_plane[bf16]"),
    "k2_split": (60_000, 1536, 240, "cosine", 256, 10, 8, "stream", "stream_distances[bf16]"),
    "k3_dense_fused": (100_000, 128, 400, "l2", 1000, 100, 128, "dense_fused",
                       "flat_sweep_topk_plane"),
}


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")


def _clustered(n, d, seed):
    g = np.random.default_rng(seed)
    centres = g.normal(0.0, 4.0, size=(n // 100, d)).astype(np.float32)
    x = centres[g.integers(0, len(centres), n)] + g.normal(size=(n, d)).astype(np.float32)
    return x.astype(np.float32), centres


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_replay_equals_eager_bit_for_bit(card, route):
    n, d, nlist, metric, nq, k, n_probe, method, kernel = ROUTES[route]
    x, centres = _clustered(n, d, seed=len(route))
    idx = IvfIndex.fit(VectorStore(external_ids=np.arange(n, dtype=np.uint64), vectors=x),
                       seed=42, nlist=nlist, metric=metric, device=card)
    g = np.random.default_rng(1)
    batches = [(x[g.integers(0, n, nq)] + 0.1 * g.normal(size=(nq, d))).astype(np.float32)
               for _ in range(5)]
    for i, q in enumerate(batches):
        before = launch_counts()[kernel]
        got = idx.search_batch(q, k, n_probe, method, external=True)
        ran = launch_counts()[kernel] - before
        want = idx._search_host(q, k, n_probe, method, True)  # the eager path
        assert ran > 0, f"call {i}: {kernel} did not run"
        assert launch_counts()[kernel] - before == 2 * ran  # replay and eager alike
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        assert idx._graphs.captured() == (0 if i == 0 else 1)
    assert (got[1] >= 0).all()


def test_replays_are_counted(card):
    n, d = 50_000, 128
    x, _ = _clustered(n, d, seed=3)
    idx = IvfIndex.fit(VectorStore(external_ids=np.arange(n, dtype=np.uint64), vectors=x),
                       seed=42, nlist=200, device=card)
    q = x[:1] + 0.1
    for _ in range(2):  # eager, then the capture and its first replay
        idx.search_batch(q, 10, 32)
    tracing.reset_phases()
    try:
        with tracing.recording():
            for _ in range(7):
                idx.search_batch(q, 10, 32)
        counters = tracing.counter_report()
    finally:
        tracing.reset_phases()
    assert counters.get("search.graph.replay") == 7
    assert "search.graph.capture" not in counters


class _Eager(CudaCapture):
    """A capture that engages no card: the searcher's eager twin."""

    def engages(self, device):
        return False


@pytest.mark.parametrize("entries", [2, 4])
def test_sharded_replay_equals_eager_bit_for_bit(card, entries):
    n, d, nq, k, n_probe = 200_000, 128, 1000, 10, 32
    x, _ = _clustered(n, d, seed=entries)
    idx = IvfIndex.fit(VectorStore(external_ids=np.arange(n, dtype=np.uint64) * 3 + 7,
                                   vectors=x), seed=42, nlist=400, device=card)
    mesh = Mesh([card] * entries, ("shards",))
    ss = ShardedSearcher(idx, mesh, method="stream")
    twin = ShardedSearcher(idx, mesh, method="stream")
    twin._graphs.capture = _Eager()
    g = np.random.default_rng(2)
    kernels = ("stream_fused_plane[bf16]", "stream_distances[bf16]")
    held = []  # blocks of the queries' size, taken after each call: no replay writes them
    for i in range(5):
        q = (x[g.integers(0, n, nq)] + 0.1 * g.normal(size=(nq, d))).astype(np.float32)
        before = launch_counts()
        got = ss.search_batch(q, k, n_probe)
        mid = launch_counts()
        torch.cuda.synchronize(card)
        assert all(bool((h == 0).all()) for h in held), i
        held += [torch.zeros((nq, d), device=card) for _ in range(4)]
        want = twin.search_batch(q, k, n_probe)
        after = launch_counts()
        ran = sum(mid[n_] - before[n_] for n_ in kernels)
        assert ran > 0 and ran == sum(after[n_] - mid[n_] for n_ in kernels), i
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        assert ss._graphs.captured() == (0 if i == 0 else 1)
    assert (got[1] >= 7).all() and len(twin._graphs) == 0
    q = x[:nq] + 0.1
    tracing.reset_phases()
    try:
        with tracing.recording():
            for _ in range(3):
                ss.search_batch(q, k, n_probe)
        counters = tracing.counter_report()
        with tracing.recording():
            for _ in range(3):
                twin.search_batch(q, k, n_probe)
        both = tracing.counter_report()
    finally:
        tracing.reset_phases()
    assert counters.get("sharded.graph.replay") == 3
    assert "sharded.graph.capture" not in counters
    for j in range(entries):  # each card's probed rows: replayed, then eager as much again
        name = f"sharded.probed_rows.{j}"
        assert counters[name] > 0 and both[name] == 2 * counters[name]
