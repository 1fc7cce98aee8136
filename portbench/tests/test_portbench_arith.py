"""The end-to-end arithmetic, recall, the union-based idle share and the
roofline counts, on hand-made inputs."""

import numpy as np
import pytest
import torch

from portbench import compare, datagen, devtrace, reference, roofline, stats


def test_one_stall_moves_qps_and_p95():
    steady = [0.002] * 20
    stalled = steady[:-1] + [0.2]
    assert stats.qps(20, sum(stalled)) < stats.qps(20, sum(steady))
    assert stats.p95_ms(stalled) > stats.p95_ms(steady) + 1.0
    assert stats.p95_ms(steady) == pytest.approx(2.0)


def test_recall_by_hand():
    gt = np.array([[1, 2, 3], [4, 5, 6]])
    ids = np.array([[3, 9, 1], [7, 8, 4]])
    assert stats.recall_at(ids, gt, 3).tolist() == pytest.approx([2 / 3, 1 / 3])
    assert stats.recall_at(ids, gt, 1).tolist() == [0.0, 0.0]


def test_spread_quartiles():
    assert stats.spread([1.0, 1.0, 1.0, 1.0]) == 0.0
    assert stats.spread([9.0, 10.0, 10.0, 11.0]) > 0


def test_idle_share_is_a_union():
    ms = 1_000_000
    host = [(0, 100 * ms, "portbench.request", 1), (10 * ms, 30 * ms, "aten::topk", 1),
            (60 * ms, 90 * ms, "cudaStreamSynchronize", 1), (0, 100 * ms, "other", 2)]
    dev = [(30 * ms, 50 * ms, "k1", 0), (40 * ms, 60 * ms, "k2", 0),  # overlap counts once
           (95 * ms, 120 * ms, "k3", 0)]  # clipped at the traced span's end
    s = devtrace.reduce(dev, host)
    assert s["window_s"] == pytest.approx(0.1)
    assert s["busy_s"] == pytest.approx(0.035)
    assert s["busy_s_by_device"] == [s["busy_s"]]
    assert s["device_events"] == 3 and s["steps"] == 1
    idle = dict((n, v) for n, v in s["idle_gaps"])
    assert idle["aten::topk"] == pytest.approx(0.03)  # 0-30 ms, midpoint inside topk
    assert idle["cudaStreamSynchronize"] == pytest.approx(0.035)  # 60-95 ms
    assert "other" not in idle  # another thread's ranges never label a gap


def test_search_bound_counts():
    # 2 queries, d 4, k 3, 5 centroids; 7 distinct probed rows, 10 (query, row)
    # pairs; bf16 rows.
    bd = roofline.search_bound(2, 4, 3, 5, 7, 10, 2, "bf16")
    nbytes = 7 * (4 * 2 + 4) + 5 * 4 * 4 + 2 * 4 * 4 + 2 * 3 * 12
    ops = 2.0 * 4 * (10 + 2 * 5)
    assert bd["bound_s"] == pytest.approx(max(nbytes / roofline.HBM_BYTES_S,
                                              ops / roofline.PEAK["bf16"]))
    assert bd["bound_by"] == "bytes"


def test_generator_reproducible_by_seed():
    a = datagen.clustered(1000, 8, 10, 2**31 + 3, "cpu", 5, 4.0)
    b = datagen.clustered(1000, 8, 10, 2**31 + 3, "cpu", 5, 4.0)
    c = datagen.clustered(1000, 8, 10, 2**31 + 4, "cpu", 5, 4.0)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0])
    assert a[0].shape == (1000, 8) and a[1].shape == (10, 8) and a[0].dtype == torch.float32


def test_topk_miss_by_hand():
    inf = float("inf")
    ref_d = torch.tensor([[1.0, 2.0, 3.0], [1.0, 2.0, inf]], dtype=torch.float64)
    sc = torch.ones(2, dtype=torch.float64)
    # Query 0: 1 and 3 found, 2 replaced by a farther row; query 1 (two
    # candidates): both found, the third answer row is past the candidates.
    got = torch.tensor([[1.0, 3.0, 4.0], [1.0, 2.0, inf]], dtype=torch.float64)
    assert compare.topk_miss(got, ref_d, sc) == pytest.approx((1 / 3 + 0) / 2)
    # A tie at the k-th counts either way; a whole answer cut after rank 1
    # misses the rest.
    tie = torch.tensor([[1.0, 2.0, 3.0 + 1e-12], [1.0, 2.0, inf]], dtype=torch.float64)
    assert compare.topk_miss(tie, ref_d, sc) == 0.0
    cut = torch.tensor([[1.0, 5.0, 6.0], [1.0, 5.0, inf]], dtype=torch.float64)
    assert compare.topk_miss(cut, ref_d, sc) == pytest.approx((2 / 3 + 1 / 2) / 2)


def test_int8_rows_by_hand():
    # Two lists: centroids 0 and 10; list 0's largest residual element is
    # 1.27, so its grid step is 0.01; list 1's is 2.54, a step of 0.02.
    x = torch.tensor([[1.27, -0.004], [0.5, 0.006], [12.54, 10.062]])
    labels = torch.tensor([0, 0, 1])
    c = torch.tensor([[0.0, 0.0], [10.0, 10.0]])
    scales = reference.int8_scales(x, labels, c, "l2")
    assert scales.tolist() == pytest.approx([0.01, 0.02])
    rows = reference.int8_rows(x, labels, c, scales, "l2", torch.float64)
    assert rows.flatten().tolist() == pytest.approx([1.27, 0.0, 0.5, 0.01, 12.54, 10.06])
    # Searching the int8 table reads those rows in place of the corpus.
    q = torch.tensor([[0.5, 0.01]])
    d, i = reference.search_lists(q, x, labels, c, 1, 2, "l2", torch.float64, table="int8")
    assert i.tolist() == [[1, 0]] and d[0, 0].item() == pytest.approx(0.0, abs=1e-12)
