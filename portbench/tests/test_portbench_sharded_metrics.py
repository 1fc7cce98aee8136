"""The sharded cell's per-layer metrics, read from hand-made trace summaries,
span registries and counters, and the cell run small on the CPU's four
slots: the port passes its comparison, a broken answer fails it, and a
traced run reads the span and counter metrics."""

import numpy as np
import pytest
import torch

from portbench import harness, reference
from vector_indexer_tpu_torch.parallel import ShardedSearcher
from vector_indexer_tpu_torch.utils import tracing

from .conftest import run_tiny

CELL = "bigann200m.sharded-np32"


def metric(name):
    return harness.load_module("metrics", name).read


@pytest.fixture(autouse=True)
def clean_registry():
    tracing.reset_phases()
    yield
    tracing.reset_phases()


@pytest.mark.parametrize("summary,want", [
    ({}, None),
    ({"device_events": 0, "busy_s_by_device": [0.0, 0.0], "window_s": 2.0}, None),
    ({"device_events": 9, "busy_s_by_device": [1.5, 0.5, 1.0, 2.0], "window_s": 2.0}, 75.0),
    ({"device_events": 3, "busy_s_by_device": [2.0], "window_s": 2.0}, 0.0),
])
def test_idlest_card(summary, want):
    got = metric("device_idle_pct.cards")({"trace": summary})
    assert got == (None if want is None else pytest.approx(want))


def _span(name, seconds):
    with tracing.recording():
        sp = tracing.trace(name)
        sp.__enter__()
        sp.t0 -= seconds  # a span of ``seconds`` on the host clock
        sp.__exit__(None, None, None)


def test_host_ms_per_call():
    read = metric("shard_host_ms_per_call")
    assert read({}) is None
    _span("search", 0.5)  # a one-card search's spans are not the sharded ones
    assert read({}) is None
    for _ in range(2):
        _span("sharded.search", 0.010)
        _span("sharded.to_host", 0.004)
    assert read({}) == pytest.approx(6.0, rel=0.05)


def test_imbalance():
    read = metric("shard_imbalance")
    assert read({}) is None
    with tracing.recording():
        for j, rows in enumerate([0.0, 0.0]):
            tracing.count(f"sharded.probed_rows.{j}", torch.tensor(rows))
    assert read({}) is None  # nothing probed: no share to read
    tracing.reset_phases()
    with tracing.recording():
        for j, rows in enumerate([300.0, 100.0, 200.0, 200.0]):
            tracing.count(f"sharded.probed_rows.{j}", torch.tensor([rows / 2, rows / 2]))
        tracing.count("sharded.probed_rows.0", torch.tensor(100.0))
    assert read({}) == pytest.approx(400.0 / 225.0)


def test_counters_record_only_while_recording():
    tracing.count("sharded.probed_rows.0", torch.tensor(5.0))
    assert tracing.counter_report() == {} and metric("shard_imbalance")({}) is None


def test_a_port_without_counters_reads_none(monkeypatch):
    monkeypatch.delattr(tracing, "counter_report")
    assert metric("shard_imbalance")({}) is None


def test_the_port_passes(man):
    r = run_tiny(man, CELL, seconds=0.5, n=20000, nlist=64, ncent=16)
    assert r["correct"], r["checks"]
    assert r["device"]["count"] == 4 and len(r["device"]["memory_peak_bytes_by_device"]) == 4
    assert set(r["metrics"]) == {"qps", "recall_at_10", "setup_s"}


def test_a_traced_run_reads_the_sharded_metrics(man):
    r = run_tiny(man, CELL, seconds=0.5, trace=True, n=20000, nlist=64, ncent=16)
    assert r["correct"], r["checks"]
    # The CPU runs no device activity, so the idlest card's share has nothing to read.
    assert set(r["metrics"]) == {"shard_host_ms_per_call", "shard_imbalance"}
    assert r["metrics"]["shard_imbalance"]["value"] >= 1.0


def test_an_altered_answer_fails(man, monkeypatch):
    orig = ShardedSearcher.search_batch

    def altered(self, xq, k, n_probe):
        dist, ids = orig(self, xq, k, n_probe)
        ids = ids.copy()
        ids[-1, 0] = (ids[-1, 0] + 1) % 1000
        return dist, ids

    monkeypatch.setattr(ShardedSearcher, "search_batch", altered)
    r = run_tiny(man, CELL, seconds=0.5, n=20000, nlist=64, ncent=16)
    assert not r["correct"]


def test_the_controls_fail_a_limit(man):
    """The reference one precision below in the port's place fails at least
    one of the cell's limits (its lists, in bfloat16, differ)."""
    r = run_tiny(man, CELL, seconds=0.5, n=20000, nlist=64, ncent=16, control=True)
    limits = harness.load_json(harness.HERE / "cells" / f"{CELL}.json")["limits"]
    for kind, nums in r["control"].items():
        assert set(nums) == set(limits), kind
    assert any(v > limits[k] for k, v in r["control"]["bf16"].items())
    assert np.isfinite(list(r["control"]["int8_table"].values())).all()


def driver():
    return harness.load_module("drivers", "sharded_closed_loop")


@pytest.mark.parametrize("rows,nlist,d,block", [(5003, 64, 128, 1000), (777, 300, 7, 4096)])
def test_labels64_are_reference_assign_s_float64_lists(rows, nlist, d, block, monkeypatch):
    """The check's one-product float64 argmin gives ``reference.assign``'s
    float64 lists, in calls of any size."""
    drv = driver()
    monkeypatch.setattr(drv, "ASSIGN_ROWS", block)
    g = torch.Generator().manual_seed(rows)
    cents = torch.randn((nlist, d), generator=g) * 4.0
    x = cents[torch.randint(0, nlist, (rows,), generator=g)] + torch.randn((rows, d), generator=g)
    got = drv.labels64(x, drv.augmented(cents))
    want = reference.assign(x, cents, "l2", torch.float64)
    assert torch.equal(got, want)


def test_port_lists_are_harness_port_labels():
    """The lists of the port's layout worked out on a device equal the
    harness's numpy ``port_labels``, -1 where a row is in no list."""
    import types

    rng = np.random.default_rng(5)
    k, n = 37, 2000
    lengths = np.bincount(rng.integers(0, k, n - 11), minlength=k).astype(np.int32)
    sizes = -(-lengths // 8) * 8
    offsets = np.zeros(k + 1, np.int32)
    offsets[1:] = np.cumsum(sizes)
    perm = np.full(offsets[-1], -1, np.int64)
    ids = rng.permutation(n)[: n - 11]  # 11 rows in no list
    rows = np.concatenate([np.arange(s, s + m) for s, m in zip(offsets[:-1], lengths)])
    perm[rows] = ids
    lay = types.SimpleNamespace(lengths=lengths, offsets=offsets, perm=perm)
    got = driver().port_lists(lay, n, torch.device("cpu"))
    np.testing.assert_array_equal(got, harness.port_labels(lay, n))
    assert (got == -1).sum() == 11


def test_every_core_gives_the_block_every_core_and_restores():
    import os

    if not hasattr(os, "sched_setaffinity"):
        pytest.skip("no CPU affinity on this platform")
    had = os.sched_getaffinity(0)
    one = {max(had)}
    os.sched_setaffinity(0, one)
    try:
        with driver().every_core():
            inside = os.sched_getaffinity(0)
        assert os.sched_getaffinity(0) == one
        assert inside >= one and len(inside) >= len(had)
    finally:
        os.sched_setaffinity(0, had)
