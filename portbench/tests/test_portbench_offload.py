"""The offloaded cell: its per-layer metrics, read from span registries and a
stand-in bench, and the cell run small on the CPU: the port passes its
comparison, answers that skip the exact re-rank fail it, a traced run reads
the span metrics, and a port without the host-layout table build fails at
the driver's import, before anything is drawn."""

import time
import types

import numpy as np
import pytest
import torch

from portbench import harness, reference, roofline
from vector_indexer_tpu_torch.index.ivf import IvfIndex
from vector_indexer_tpu_torch.ops import block_stream
from vector_indexer_tpu_torch.utils import tracing

from .conftest import SEED

CELL = "bigann100m.offload-np32"
CPU = torch.device("cpu")


def metric(name):
    return harness.load_module("metrics", name).read


@pytest.fixture(autouse=True)
def clean_registry():
    tracing.reset_phases()
    yield
    tracing.reset_phases()


def small(man, n=6000, batch=512):
    """The cell's configuration and mix at a CPU size: 512-query calls, so
    that every call is swept in two halves, each query probing 4 of 32
    lists."""
    cfg = dict(harness.config_of(man, "bigann100m-l2-offload"))
    cfg.update(n=n, nlist=32, query_pool=2 * batch, train_sample=2000,
               generator={"kind": "clustered", "ncent": 8, "spread": 4.0})
    tr = dict(harness.load_json(harness.HERE / "traffic" / "offload-np32.json"))
    tr.update(batch=batch, check_queries=batch, n_probe=4)
    return cfg, tr


def run_small(man, trace=False, seconds=0.5, **kw):
    cfg, tr = small(man)
    return harness.run_cell(man, CELL, SEED, seconds, trace, CPU, time.perf_counter(),
                            config=cfg, traffic=tr, **kw)


def _span(name, seconds):
    with tracing.recording():
        sp = tracing.trace(name)
        sp.__enter__()
        sp.t0 -= seconds  # a span of ``seconds`` on the host clock
        sp.__exit__(None, None, None)


@pytest.mark.parametrize("name,span", [("offload_rerank_ms_per_call", "offload.rerank"),
                                       ("offload_wait_ms_per_call", "offload.wait")])
def test_span_metrics(name, span):
    read = metric(name)
    assert read({}) is None
    _span(span, 0.004)
    assert read({}) is None  # no search span: nothing to divide by
    tracing.reset_phases()
    _span("search", 0.050)
    assert read({}) is None  # a search that is not offloaded opens no such span
    for _ in range(2):
        _span("search", 0.050)
        _span(span, 0.004)
        _span(span, 0.002)
    assert read({}) == pytest.approx(1e3 * 0.012 / 3, rel=0.05)


def _bench(lengths, centroids, pool, batch=1000, k=10, n_probe=2):
    b = types.SimpleNamespace(device=CPU, config={"metric": "l2"},
                              traffic={"batch": batch, "k": k, "n_probe": n_probe})
    b.index = types.SimpleNamespace(layout=types.SimpleNamespace(lengths=lengths),
                                    centroids=centroids)
    b.queries = lambda idx: torch.as_tensor(pool[np.asarray(idx)])
    return b


def test_sweep_roofline_counts_each_half_from_the_inputs():
    rng = np.random.default_rng(0)
    cent = rng.normal(size=(6, 4)).astype(np.float32) * 10
    pool = (cent[rng.integers(0, 6, 2000)] + rng.normal(size=(2000, 4))).astype(np.float32)
    lengths = np.array([100, 200, 300, 400, 500, 600])
    b = _bench(lengths, cent, pool)
    tr = {"device_events": 5, "busy_s": 0.01}
    want = 0.0
    for s in (0, 1000):
        for lo, hi in ((0, 500), (500, 1000)):
            q = torch.as_tensor(pool[s + lo:s + hi])
            probe = reference.probes(q, torch.as_tensor(cent), 2, torch.float32)
            ln = torch.as_tensor(lengths)
            want += roofline.search_bound(500, 4, 128, 6, int(ln[torch.unique(probe)].sum()),
                                          int(ln[probe].sum()), 1, "int8")["bound_s"]
    ctx = {"bench": b, "trace": tr, "window": {"traced_starts": [0, 1000]}}
    got = metric("offload_sweep_roofline")(ctx)
    assert got == pytest.approx(100.0 * want / 0.01)
    # One undivided sweep below the split's batch size.
    small_b = _bench(lengths, cent, pool, batch=200)
    q = torch.as_tensor(pool[:200])
    probe = reference.probes(q, torch.as_tensor(cent), 2, torch.float32)
    ln = torch.as_tensor(lengths)
    one = roofline.search_bound(200, 4, 128, 6, int(ln[torch.unique(probe)].sum()),
                                int(ln[probe].sum()), 1, "int8")["bound_s"]
    ctx = {"bench": small_b, "trace": tr, "window": {"traced_starts": [0]}}
    assert metric("offload_sweep_roofline")(ctx) == pytest.approx(100.0 * one / 0.01)


@pytest.mark.parametrize("ctx", [
    {"bench": None, "trace": {}, "window": {"traced_starts": [0]}},
    {"bench": None, "trace": {"device_events": 0, "busy_s": 0.0}, "window": {"traced_starts": [0]}},
    {"bench": None, "trace": {"device_events": 3, "busy_s": 0.1}, "window": {"traced_starts": []}},
])
def test_sweep_roofline_reads_none_without_a_trace(ctx):
    assert metric("offload_sweep_roofline")(ctx) is None


def test_the_port_passes(man):
    r = run_small(man)
    assert r["correct"], r["checks"]
    assert set(r["metrics"]) == {"qps", "recall_at_10", "setup_s"}
    assert r["device"]["count"] == 1


def test_a_traced_run_reads_the_offload_metrics(man):
    # A window of several calls, so that the trace starts even when the
    # host is slow (it starts at a step past 30% of the window).
    r = run_small(man, trace=True, seconds=3.0)
    assert r["correct"], r["checks"]
    # The CPU runs no device activity: the idle share and the roofline have nothing to read.
    assert set(r["metrics"]) == {"offload_rerank_ms_per_call", "offload_wait_ms_per_call"}
    assert r["metrics"]["offload_rerank_ms_per_call"]["value"] > 0


def test_skipping_the_exact_rerank_fails(man, monkeypatch):
    """The sweep's own int8 ranking in the re-rank's place ('none') reads a
    distance error above the cell's limit."""
    orig = IvfIndex.offload_from_host
    monkeypatch.setattr(IvfIndex, "offload_from_host",
                        lambda self, stream_dtype=None, rerank="host": orig(self, stream_dtype,
                                                                             "none"))
    r = run_small(man)
    assert not r["correct"]
    assert r["checks"]["dist_err"]["value"] > r["checks"]["dist_err"]["limit"]


def test_the_controls_fail_a_limit(man):
    r = run_small(man, control=True)
    limits = harness.load_json(harness.HERE / "cells" / f"{CELL}.json")["limits"]
    assert any(v > limits[k] for k, v in r["control"]["bf16"].items())
    assert r["control"]["int8_table"]["dist_err"] > limits["dist_err"]


def test_a_port_without_the_table_build_fails_at_import(man, monkeypatch):
    """The parent of the change that added the cell has no
    ``build_stream_table_from_rows``: the driver fails as it loads, before
    the corpus is drawn."""
    monkeypatch.delattr(block_stream, "build_stream_table_from_rows")
    drawn = []
    monkeypatch.setattr(harness.Bench, "draw", lambda self: drawn.append(1))
    cfg, tr = small(man)
    with pytest.raises(ImportError):
        harness.run_cell(man, CELL, SEED, 0.5, False, CPU, time.perf_counter(), config=cfg,
                         traffic=tr)
    assert not drawn
