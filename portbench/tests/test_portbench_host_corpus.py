"""A corpus larger than one card: drawn to the host a chunk at a time with the
same bits as the draw on the card, ground truth streamed over several
devices (the CPU twice here), and every card in the result line."""

import copy
import time

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from portbench import datagen, devtrace, harness, reference

from .conftest import SEED, run_tiny, tiny

CPU = torch.device("cpu")


def test_host_draw_has_the_same_bits(monkeypatch):
    monkeypatch.setattr(datagen, "CHUNK_ROWS", 1000)  # 4,500 rows: the last chunk is short
    dev = datagen.clustered(4500, 8, 30, SEED, CPU, 7, 4.0)
    host = datagen.clustered(4500, 8, 30, SEED, CPU, 7, 4.0, host=True)
    assert all(torch.equal(a, b) for a, b in zip(dev, host))
    assert host[0].device.type == "cpu" and host[0].shape == (4500, 8)


class RowsSeen(TorchDispatchMode):
    """The most rows of any tensor an operation allocated (views and
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


@pytest.mark.parametrize("host,most", [(True, 1000), (False, 4500)])
def test_host_draw_makes_no_tensor_past_one_chunk(monkeypatch, host, most):
    monkeypatch.setattr(datagen, "CHUNK_ROWS", 1000)
    with RowsSeen() as spy:
        datagen.clustered(4500, 8, 30, SEED, CPU, 7, 4.0, host=host)
    assert spy.most == most  # the draw on the device makes the whole corpus at once


def _planted(metric):
    """A corpus with two rows copied across its halves (rows 0-3,000 and
    3,001-6,000), and queries that tie on them: query 0 is row 10 itself (a
    tie at ranks 1-2 with row 4,200), and the 10th nearest row of query
    ``t`` is copied over row 5,000 (a tie at the 10th place)."""
    xb, xq = datagen.clustered(6001, 16, 1500, SEED, CPU, 12, 4.0)  # two query blocks
    xb[4200] = xb[10]
    xq[0] = xb[10]
    top = reference.ground_truth(xb, xq, metric, 11)
    t = next(t for t in range(1, len(xq)) if top[t, 9] < 3000 and 5000 not in top[t])
    tenth = int(top[t, 9])
    xb[5000] = xb[tenth]
    return xb, xq, t, tenth


def _only_ties_differ(xb, got, ref):
    assert got.shape == ref.shape and got.dtype == torch.int64
    for i, p in (got != ref).nonzero().tolist():
        assert torch.equal(xb[got[i, p]], xb[ref[i, p]]), (i, p)


@pytest.mark.parametrize("metric", ["l2", "cosine"])
def test_streamed_ground_truth_matches_and_ties_go_low(metric):
    xb, xq, t, tenth = _planted(metric)
    ref = reference.ground_truth(xb, xq, metric, 10)
    for n_dev in (1, 2, 3):
        got = reference.ground_truth_streamed(xb, xq, metric, 10, [CPU] * n_dev)
        _only_ties_differ(xb, got, ref)
        assert got[0, :2].tolist() == [10, 4200]
    # Across the two halves, the tie at the 10th place goes to the lower id.
    assert got[t, 9].item() == tenth and 5000 not in got[t].tolist()
    assert ref[t, 9].item() in (tenth, 5000)


def test_lowest_breaks_ties_by_id():
    dist = torch.tensor([[2.0, 1.0, 1.0, 3.0, 1.0]])
    ids = torch.tensor([[4, 9, 7, 1, 8]])
    d, i = reference.lowest(dist, ids, 3)
    assert i.tolist() == [[7, 8, 9]] and d.tolist() == [[1.0, 1.0, 1.0]]


def _bench(man, host):
    cfg, tr = tiny(man, "sift1m.batch-np128", n=5000)
    cfg.update(nlist=32, generator={"kind": "clustered", "ncent": 10, "spread": 4.0})
    if host:
        cfg["corpus"] = "host"
    b = harness.Bench("sift1m.batch-np128", cfg, tr, SEED, 0.5, False, [CPU, CPU])
    b.draw()
    return b


def test_bench_draws_the_same_inputs_on_the_host(man, monkeypatch):
    monkeypatch.setattr(datagen, "CHUNK_ROWS", 1500)
    dev, host = _bench(man, False), _bench(man, True)
    assert (dev.xb == host.xb).all() and (dev.pool == host.pool).all()
    assert (dev.gt == host.gt).all()
    assert torch.equal(host.corpus_rows(100, 250), torch.as_tensor(host.xb[100:250]))
    assert host.corpus_rows(0, 7, CPU).shape == (7, 128)


@pytest.mark.parametrize("workload", ["sift1m.batch-np128", "sift1m.online-np32"])
def test_a_host_corpus_run_is_correct(man, workload):
    seconds = 2.0 if workload == "sift1m.online-np32" else 0.5
    cfg, tr = tiny(man, workload)
    cfg.update(corpus="host")
    host = harness.run_cell(man, workload, SEED, seconds, False, CPU, time.perf_counter(),
                            config=cfg, traffic=tr)
    dev = run_tiny(man, workload, seconds=seconds)
    assert host["correct"], host["checks"]
    assert set(host["metrics"]) == set(dev["metrics"]) and host["device"] == dev["device"]
    # The same exact top-10, the same index: a window's recall differs only
    # by which pool slices it reached.
    assert abs(host["metrics"]["recall_at_10"]["value"]
               - dev["metrics"]["recall_at_10"]["value"]) < 2.0


def test_one_card_keeps_the_device_keys(monkeypatch):
    peaks = {0: 5 << 30, 1: 9 << 30, 2: 7 << 30}
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda d: peaks[d.index])
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d: "NVIDIA H100 80GB HBM3")
    cards = [torch.device("cuda", i) for i in range(3)]
    assert harness.device_info(cards[:1]) == {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1,
        "memory_peak_bytes": 5 << 30}
    many = harness.device_info(cards)
    assert many["count"] == 3 and many["memory_peak_bytes"] == 9 << 30
    assert many["memory_peak_bytes_by_device"] == [5 << 30, 9 << 30, 7 << 30]
    assert harness.cell_devices(cards[0], 3) == cards
    assert harness.device_info([CPU]) == {"platform": "cpu", "kind": "cpu", "count": 1,
                                          "memory_peak_bytes": 0}
    summary = {"busy_s": 0.5, "window_s": 2.0, "busy_s_by_device": [0.5]}
    assert harness.trace_info(summary, 1) == {"busy_s": 0.5, "window_s": 2.0}
    summary = {"busy_s": 0.7, "window_s": 2.0, "busy_s_by_device": [0.5, 0.1]}
    assert harness.trace_info(summary, 2) == {"busy_s": 0.3, "window_s": 2.0,
                                              "busy_s_by_device": [0.5, 0.1]}


@pytest.mark.parametrize("trace", [False, True])
def test_a_two_card_cell_reports_both(man, trace):
    """A cell that asks for two chips, run on the CPU's two slots: both are
    counted, and a traced run reports each one's busy time."""
    two = copy.deepcopy(man)
    harness.cell_of(two, "sift1m.batch-np128")["chips"] = 2
    cfg, tr = tiny(man, "sift1m.batch-np128")
    cfg.update(corpus="host")
    r = harness.run_cell(two, "sift1m.batch-np128", SEED, 0.5, trace, CPU,
                         time.perf_counter(), config=cfg, traffic=tr)
    assert r["correct"], r["checks"]
    assert r["device"]["count"] == 2 and r["device"]["memory_peak_bytes_by_device"] == [0, 0]
    if trace:
        assert r["device"]["busy_s_by_device"] == [0.0, 0.0]
        assert set(r["device"]) >= {"busy_s", "window_s"}


def test_busy_time_per_card():
    ms = 1_000_000
    host = [(0, 100 * ms, "portbench.request", 1)]
    dev = [(30 * ms, 50 * ms, "k1", 0), (40 * ms, 60 * ms, "k2", 0),
           (45 * ms, 70 * ms, "k1", 1), (95 * ms, 120 * ms, "k3", 1)]  # clipped at 100
    s = devtrace.reduce(dev, host, n_devices=2)
    flat = devtrace.reduce([(a, b, n, 0) for a, b, n, _ in dev], host)
    assert s["busy_s"] == flat["busy_s"] == pytest.approx(0.045)  # the union, as on one card
    assert s["device_events"] == flat["device_events"] == 4
    assert s["idle_gaps"] == flat["idle_gaps"] and s["device_ops"] == flat["device_ops"]
    assert s["busy_s_by_device"] == pytest.approx([0.030, 0.030])
    assert devtrace.reduce(dev, host, n_devices=3)["busy_s_by_device"][2] == 0.0
