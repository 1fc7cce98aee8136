"""Back-to-back builds: each step is the port's ``IvfIndex.fit`` of the host
corpus (no save), then one ``search_sync`` of ``first_batch`` pool queries
at ``k`` / ``n_probe`` with ``method``, which builds the stream table it
reads lazily: the time from a corpus to its first answers.

Set-up runs one such step to build and warm every kernel the window runs.
Every step's centroid table, lists and first answers are kept on the host
and judged after the window. ``build_s`` is the window's seconds over its
completed steps. A traced run also reads the port's own phase spans
(``tracing.phase_report``) over the traced builds.
"""

from __future__ import annotations

import time
from types import SimpleNamespace

import numpy as np
import torch

from portbench import compare, reference, stats
from portbench.harness import free, port_labels
from vector_indexer_tpu_torch.utils import tracing

TRACE_SECONDS = 0.0
TRACE_MIN_BUILDS = 2


def _step(b, s: int):
    t = b.traffic
    index = b.build()
    dist, ids = b.serving(index).search_sync(b.pool[s:s + t["first_batch"]], t["k"],
                                             t["n_probe"], t["method"])
    return index, dist, ids


def setup(b) -> None:
    t = b.traffic
    starts = np.arange(0, b.pool.shape[0] - t["first_batch"] + 1, t["first_batch"])
    b.state["order"] = starts[b.rng.permutation(len(starts))]
    _step(b, int(b.state["order"][0]))
    free(b.device)


def window(b) -> dict:
    order = b.state["order"]
    tw = b.trace_window(TRACE_SECONDS, TRACE_MIN_BUILDS, on_start=tracing.reset_phases,
                        on_stop=tracing.phase_report)
    builds = []
    t0 = time.perf_counter()
    now = t0
    i = 0
    while now - t0 < b.seconds or tw.active:
        tw.step(now - t0)
        s = int(order[i % len(order)])
        with tw.annotate("build"):
            index, dist, ids = _step(b, s)
            now = time.perf_counter()
        lay = index.layout  # host arrays only: the device tables go with the index
        builds.append(dict(start=s, centroids=index.centroids, dist=dist, ids=ids,
                           lay=SimpleNamespace(offsets=lay.offsets, lengths=lay.lengths,
                                               perm=lay.perm)))
        del index, lay
        i += 1
    elapsed = now - t0
    tw.stop()
    failed = sum(int(((bd["ids"] < 0) | ~np.isfinite(bd["dist"])).any()) for bd in builds)
    return {"e2e": {"build_s": stats.per_step(elapsed, i)}, "attempted": i, "failed": failed,
            "trace": tw.summary, "phases": tw.at_stop, "builds": builds}


def release(b) -> None:
    b.index = None


def _judged(b, x, bd, labels, dist, ids) -> dict:
    t, metric = b.traffic, b.config["metric"]
    centroids = torch.as_tensor(bd["centroids"], device=b.device)
    ref_labels = reference.assign(x, centroids, metric, torch.float64)
    q_idx = np.arange(bd["start"], bd["start"] + t["first_batch"])
    nums = compare.answer_numbers(x, b.queries(q_idx), dist, ids, centroids, ref_labels,
                                  t["n_probe"], t["k"], metric)
    nums["membership_diff"] = compare.membership_diff(ref_labels, labels)
    nums["lloyd_shift"] = reference.lloyd_shift(x, centroids, ref_labels, metric)
    return nums


def check(b, win) -> dict:
    """Every build's numbers; the worst of each."""
    x = b.corpus()
    return compare.worst([
        _judged(b, x, bd, torch.as_tensor(port_labels(bd["lay"], x.shape[0]), device=b.device),
                bd["dist"], bd["ids"]) for bd in win["builds"]])


def control(b, win) -> dict:
    """Each control's numbers (``compare.CONTROLS``): every build's lists and
    first answers worked out by the control over that build's centroid
    table, the worst over the builds (the readings behind each limit; runs
    never call it)."""
    t, metric = b.traffic, b.config["metric"]
    x = b.corpus()
    out = {}
    for kind in compare.CONTROLS:
        nums = []
        for bd in win["builds"]:
            q = b.queries(np.arange(bd["start"], bd["start"] + t["first_batch"]))
            centroids = torch.as_tensor(bd["centroids"], device=b.device)
            labels, dist, ids = compare.control(x, q, centroids, t["n_probe"], t["k"], metric,
                                                kind)
            nums.append(_judged(b, x, bd, labels, dist, ids))
        out[kind] = compare.worst(nums)
    return out
