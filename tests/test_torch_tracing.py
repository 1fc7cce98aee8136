"""The port's spans (``utils/tracing.trace``): recorded only while someone
reads them (``torch.profiler`` or ``recording()``), self time per thread,
host ranges in the profiler's trace around each stage of a search, the
synchronisation of ``sync`` spans, and the benchmark's two readers of the
spans (``portbench/metrics/host_ms_per_call.py``,
``device_wait_ms_per_call.py``)."""

import contextlib
import importlib.util
import logging
import threading
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from vector_indexer_tpu_torch.api import VectorIndexer, VectorIndexerConfig
from vector_indexer_tpu_torch.bindings import VectorIndex
from vector_indexer_tpu_torch.index.dispatch import resolve
from vector_indexer_tpu_torch.index.ivf import IvfIndex
from vector_indexer_tpu_torch.storage.vector_store import VectorStore
from vector_indexer_tpu_torch.utils import tracing

ROOT = Path(__file__).resolve().parent.parent
STAGES = ("search.upload", "search.dispatch", "search.program", "search.to_host",
          "search.id_map")


@pytest.fixture(autouse=True)
def clean_registry():
    tracing.reset_phases()
    yield
    tracing.reset_phases()


def _small_index():
    g = np.random.default_rng(7)
    xb = (g.normal(size=(40, 1, 128)) * 4 + g.normal(size=(40, 60, 128))).reshape(-1, 128)
    store = VectorStore(external_ids=np.arange(xb.shape[0], dtype=np.uint64) + 1000,
                        vectors=xb.astype(np.float32))
    index = IvfIndex.fit(store, seed=3, nlist=40, device="cpu")
    vi = VectorIndex(VectorIndexer(VectorIndexerConfig(128, device="cpu"), _index=index))
    return vi, g.normal(size=(5, 128)).astype(np.float32)


@pytest.fixture(scope="module")
def small_index():
    return _small_index()


class _Clock:
    """A per-thread fake ``perf_counter`` that a test moves by hand."""

    def __init__(self):
        self.local = threading.local()

    def __call__(self) -> float:
        return getattr(self.local, "now", 0.0)

    def advance(self, dt: float) -> None:
        self.local.now = self() + dt


def _metric(name):
    path = ROOT / "portbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_nothing_recorded_without_a_reader(small_index, caplog):
    vi, xq = small_index
    assert tracing.trace("search", level=logging.DEBUG) is tracing.trace("fit")  # the no-op
    with caplog.at_level(logging.WARNING, logger=tracing.log.name):
        with tracing.trace("fit.layout", sync=torch.device("cuda", 0), n=3):
            pass
        vi.search_sync(xq, 4, 8)
    assert tracing.phase_report() == {}
    assert not caplog.records


class _Counted:
    def __init__(self):
        self.n = 0

    def __format__(self, spec):
        self.n += 1
        return "v"


@pytest.mark.parametrize("level, emitted", [(logging.DEBUG, False), (logging.WARNING, True)])
def test_log_line_fields_formatted_only_when_emitted(caplog, level, emitted):
    field = _Counted()
    with caplog.at_level(logging.INFO, logger=tracing.log.name):
        with tracing.trace("save.shards", level=level, shards=field):
            pass
    assert (field.n > 0) == emitted  # each handler formats the line once
    assert [r.getMessage().split()[0] for r in caplog.records] == ["phase=save.shards"] * emitted
    if emitted:
        assert caplog.records[0].getMessage().endswith(" shards=v")
    assert tracing.phase_report() == {}  # a logged span is not recorded


def test_self_time_nests_per_thread(monkeypatch):
    clock = _Clock()
    monkeypatch.setattr(tracing.time, "perf_counter", clock)
    steps = threading.Barrier(2, timeout=30)

    def work():
        with tracing.trace("outer"):
            steps.wait()  # both threads have an outer span open
            clock.advance(1.0)
            with tracing.trace("inner"):
                steps.wait()  # both threads have an inner span open
                clock.advance(2.0)
            clock.advance(4.0)
        steps.wait()

    with tracing.recording():
        threads = [threading.Thread(target=work) for _ in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    rep = tracing.phase_report()
    assert rep["outer"] == {"total_s": 14.0, "self_s": 10.0, "count": 2, "mean_s": 7.0}
    assert rep["inner"] == {"total_s": 4.0, "self_s": 4.0, "count": 2, "mean_s": 2.0}


@pytest.mark.parametrize("reader", [None, "recording", "profiler", "log"])
def test_sync_span_synchronises_only_while_recording(monkeypatch, caplog, reader):
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize", calls.append)
    dev = torch.device("cuda", 0)
    with caplog.at_level(logging.DEBUG if reader == "log" else logging.WARNING,
                         logger=tracing.log.name):
        if reader == "recording":
            ctx = tracing.recording()
        elif reader == "profiler":
            ctx = profile(activities=[ProfilerActivity.CPU])
        else:
            ctx = contextlib.nullcontext()
        with ctx:
            with tracing.trace("stream_table.build", sync=dev):
                pass
            with tracing.trace("fit.layout", sync=torch.device("cpu")):
                pass
            with tracing.trace("fit"):
                pass
    recorded = reader in ("recording", "profiler")
    assert calls == ([dev] if recorded else [])
    assert sorted(tracing.phase_report()) == (["fit", "fit.layout", "stream_table.build"]
                                              if recorded else [])


def _host_ranges(prof):
    """[(start, end, name)] of the spans in the profiler's host events."""
    return [(int(e.start_ns()), int(e.start_ns()) + int(e.duration_ns()), e.name())
            for e in prof.profiler.kineto_results.events()
            if e.name() == "search" or e.name().startswith("search.")]


def _inside(child, parent) -> bool:
    return parent[0] <= child[0] and child[1] <= parent[1]


@pytest.mark.parametrize("method, probed", [
    ("stream", True), ("dense_fused", True), ("dense", True), ("gather", True),
    ("gather_dma", True), ("flat_fused", False), ("flat", False)])
def test_search_sync_spans_nest_in_the_profilers_trace(small_index, method, probed):
    vi, xq = small_index
    vi.search_sync(xq, 4, 8, method)  # lazy tables outside the trace
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        dist, ids = vi.search_sync(xq, 4, 8, method)
    assert (ids >= 1000).all() and np.isfinite(dist).all()  # external ids
    ranges = _host_ranges(prof)
    names = [r[2] for r in ranges]
    assert names.count("search") == 1
    (root,) = [r for r in ranges if r[2] == "search"]
    for stage in STAGES:
        assert names.count(stage) == 1, stage
    (program,) = [r for r in ranges if r[2] == "search.program"]
    inner = {"search.sweep", "search.select"} | ({"search.probe"} if probed else set())
    assert {n for n in names if n not in STAGES + ("search",)} == inner
    for r in ranges:
        assert _inside(r, root)
        if r[2] in inner:
            assert _inside(r, program)
    rep = tracing.phase_report()  # the profiler makes the spans record
    assert rep["search"]["count"] == 1 and rep["search.id_map"]["count"] == 1
    children = sum(rep[s]["total_s"] for s in STAGES)
    assert rep["search"]["self_s"] == pytest.approx(rep["search"]["total_s"] - children)
    assert resolve(vi.index, xq.shape[0], 8, k=4, method=method).method == method


@pytest.mark.parametrize("serving, host_mapped", [
    ("device", False), ("offload_none", False), ("offload_host", True),
    ("offload_device", True), ("staged", True)])
def test_id_map_host_counts_calls_mapped_on_the_host(serving, host_mapped):
    """A device-resident index maps ids on the device before the copy back;
    the staged and re-ranked paths give internal ids on the host and map
    them there, inside ``search.id_map.host``, once per call."""
    vi, xq = _small_index()
    if serving == "staged":
        vi.index.to_host_resident()
    elif serving != "device":
        vi.offload(rerank=serving.split("_")[1])
    vi.search_sync(xq, 4, 8)  # lazy tables outside the count
    with tracing.recording():
        for _ in range(3):
            dist, ids = vi.search_sync(xq, 4, 8)
    assert (ids >= 1000).all() and np.isfinite(dist).all()  # external ids
    rep = tracing.phase_report()
    assert rep["search"]["count"] == rep["search.id_map"]["count"] == 3
    assert rep.get("search.id_map.host", {}).get("count", 0) == 3 * host_mapped
    assert ("search.to_host" in rep) != host_mapped


def test_search_device_root_span(small_index):
    vi, xq = small_index
    with tracing.recording():
        dist, rows = vi.search_device(xq, 4, 8)
        ids = vi.rows_to_external(rows)
    rep = tracing.phase_report()
    assert rep["search"]["count"] == 1
    assert {"search.upload", "search.dispatch", "search.program"} <= set(rep)
    assert "search.to_host" not in rep and "search.id_map" not in rep
    np.testing.assert_array_equal(ids, vi.search_sync(xq, 4, 8)[1])


@pytest.mark.parametrize("phases, host_ms, wait_ms", [
    ({"search": {"total_s": 0.030, "count": 10},
      "search.to_host": {"total_s": 0.010, "count": 10}}, 2.0, 1.0),
    ({"search": {"total_s": 0.004, "count": 2}}, 2.0, 0.0),
    ({"fit.kmeans": {"total_s": 1.0, "count": 1}}, None, None),
    ({"search": {"total_s": 0.0, "count": 0}}, None, None),
])
def test_span_readers(monkeypatch, phases, host_ms, wait_ms):
    monkeypatch.setattr(tracing, "phase_report", lambda: phases)
    host = _metric("host_ms_per_call").read({})
    wait = _metric("device_wait_ms_per_call").read({})
    assert host == (None if host_ms is None else pytest.approx(host_ms))
    assert wait == (None if wait_ms is None else pytest.approx(wait_ms))
    if host is not None:
        root = phases["search"]
        assert host + wait == pytest.approx(1e3 * root["total_s"] / root["count"])


def test_span_readers_on_a_traced_search(small_index):
    vi, xq = small_index
    vi.search_sync(xq, 4, 8)
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(3):
            vi.search_sync(xq, 4, 8)
    rep = tracing.phase_report()
    assert rep["search"]["count"] == 3
    host = _metric("host_ms_per_call").read({})
    wait = _metric("device_wait_ms_per_call").read({})
    assert host > 0 and wait >= 0
    assert host + wait == pytest.approx(1e3 * rep["search"]["mean_s"])
