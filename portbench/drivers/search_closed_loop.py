"""Closed-loop search: one client sends ``batch`` queries a call to the public
``VectorIndex.search_sync(xq, k, n_probe, method)`` and waits for the answer
before the next call.

Set-up builds the index once (``IvfIndex.fit``, no save) and warms the one
shape the mix sends. Calls take consecutive slices of the query pool in an
order drawn from the seed, cycling, until the window's seconds are spent.
The timed loop keeps, per call, its host-clock latency, its slice and a
copy of the first 10 ids of each answer, and the full answers of the calls
that run at instants drawn from the seed before the window (an instant
between two calls goes to the next). ``p95_ms``, ``recall_at_10`` and ``failed`` are worked out from
what was kept after the window, and the sampled answers are judged then.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench import compare, reference, stats
from portbench.harness import port_labels

WARM_CALLS = 5
TRACE_SECONDS = 3.0
TRACE_MIN_CALLS = 20


def setup(b) -> None:
    t = b.traffic
    b.index = b.build()
    b.state["vi"] = b.serving(b.index)
    pool = b.pool.shape[0]
    starts = np.arange(0, pool - t["batch"] + 1, t["batch"])
    b.state["order"] = starts[b.rng.permutation(len(starts))]
    for i in range(WARM_CALLS):
        s = b.state["order"][i % len(starts)]
        b.state["vi"].search_sync(b.pool[s:s + t["batch"]], t["k"], t["n_probe"], t["method"])


def window(b) -> dict:
    t, vi, order = b.traffic, b.state["vi"], b.state["order"]
    batch, k, n_probe, method = t["batch"], t["k"], t["n_probe"], t["method"]
    # Instants in the window whose next call's full answer is judged.
    keep_at = np.sort(b.rng.random(-(-t["check_queries"] // batch))) * b.seconds
    lat, top10, starts, sample = [], [], [], []
    tw = b.trace_window(TRACE_SECONDS, TRACE_MIN_CALLS)
    traced = []
    j = 0
    t0 = time.perf_counter()
    now = t0
    while now - t0 < b.seconds or tw.active:
        tw.step(now - t0)
        s = int(order[len(starts) % len(order)])
        if tw.active:
            traced.append(s)
        with tw.annotate("request"):
            c0 = time.perf_counter()
            dist, ids = vi.search_sync(b.pool[s:s + batch], k, n_probe, method)
            now = time.perf_counter()
        lat.append(now - c0)
        starts.append(s)
        top10.append(ids[:, :10].copy())
        if j < len(keep_at) and now - t0 > keep_at[j]:
            sample.append((s, dist, ids))
            j = int(np.searchsorted(keep_at, now - t0, side="right"))
    elapsed = now - t0
    tw.stop()
    calls = len(starts)
    e2e = {"qps": stats.qps(calls * batch, elapsed), "p95_ms": stats.p95_ms(lat)}
    if b.gt is not None:
        rec = [stats.recall_at(ids, b.gt[s:s + batch], 10) for s, ids in zip(starts, top10)]
        e2e["recall_at_10"] = float(np.concatenate(rec).mean() * 100.0)
    failed = sum(int((ids < 0).any(axis=1).sum()) for ids in top10)
    return {"e2e": e2e, "attempted": calls * batch, "failed": failed, "trace": tw.summary,
            "traced_starts": traced, "sample": sample, "requests": calls}


def release(b) -> None:
    """Keep what the comparison needs of the port's state (its centroid table
    and its lists), then drop the index."""
    b.state["centroids"] = np.array(b.index.centroids, dtype=np.float32)
    b.state["labels"] = port_labels(b.index.layout, b.xb.shape[0])
    b.state.pop("vi", None)
    b.index = None


def check_numbers(b, x, centroids, labels, starts, dist, ids, n_probe, k, metric) -> dict:
    """The comparison's numbers for answers to pool slices ``starts``."""
    batch = dist.shape[0] // len(starts)
    q_idx = np.concatenate([np.arange(s, s + batch) for s in starts])
    ref_labels = reference.assign(x, centroids, metric, torch.float64)
    nums = compare.answer_numbers(x, b.queries(q_idx), dist, ids, centroids, ref_labels,
                                n_probe, k, metric)
    nums["membership_diff"] = compare.membership_diff(ref_labels, labels)
    return nums


def check(b, win) -> dict:
    t, metric = b.traffic, b.config["metric"]
    x = b.corpus()
    centroids = torch.as_tensor(b.state["centroids"], device=b.device)
    labels = torch.as_tensor(b.state["labels"], device=b.device)
    sample = win["sample"]
    return check_numbers(b, x, centroids, labels, [s for s, _, _ in sample],
                         np.concatenate([d for _, d, _ in sample]),
                         np.concatenate([i for _, _, i in sample]), t["n_probe"], t["k"], metric)


def control(b, win) -> dict:
    """Each control's numbers (``compare.CONTROLS``) over the port's centroid
    table and the same sampled queries: the readings behind each limit;
    runs never call it."""
    t, metric = b.traffic, b.config["metric"]
    x = b.corpus()
    centroids = torch.as_tensor(b.state["centroids"], device=b.device)
    starts = [s for s, _, _ in win["sample"]]
    batch = win["sample"][0][1].shape[0]
    q = b.queries(np.concatenate([np.arange(s, s + batch) for s in starts]))
    out = {}
    for kind in compare.CONTROLS:
        labels, dist, ids = compare.control(x, q, centroids, t["n_probe"], t["k"], metric, kind)
        out[kind] = check_numbers(b, x, centroids, labels, starts, dist, ids, t["n_probe"],
                                  t["k"], metric)
    return out
