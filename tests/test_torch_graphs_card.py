"""Captured search graphs on a CUDA card (index/graphs.py): every replayed
(D, ids) equals the eager path's bit for bit, over replays with other
queries, on the stream route through K4 (d 128, nq 1), the stream route
through K2's split launch (d 1,536, nq 256, cosine) and the dense route
through K3 (``dense_fused``); each replay counts its kernels and, while
spans record, ``search.graph.replay``.

Marked ``card``: they skip without one. On a card, from the root of the
repository (the tests' ``conftest.py`` imports JAX, which these do not
need): ``python -m pytest --noconftest -q tests/test_torch_graphs_card.py``.
"""

import numpy as np
import pytest
import torch

from vector_indexer_tpu_torch.index.ivf import IvfIndex
from vector_indexer_tpu_torch.kernels.build import launch_counts
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
