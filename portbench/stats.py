"""End-to-end arithmetic of a measured window, and the spread of a series.

``recall_at`` generalises the frozen ``benchmarks/harness.py::recall_at``
(true nearest neighbour within the first ``rank``) to the share of the exact
top-``rank`` found in the first ``rank`` returned ids.
"""

from __future__ import annotations

import statistics

import numpy as np


def qps(queries: int, seconds: float) -> float:
    """Queries answered over the window's seconds (all calls, all time)."""
    return queries / seconds


def p95_ms(latencies_s) -> float:
    """95th percentile (numpy's linear interpolation) of every request's
    latency, in ms."""
    return float(np.percentile(np.asarray(latencies_s, dtype=np.float64), 95.0) * 1e3)


def per_step(seconds: float, steps: int) -> float:
    """Window seconds per completed step (a build)."""
    return seconds / steps


def recall_at(ids: np.ndarray, gt: np.ndarray, rank: int) -> np.ndarray:
    """(nq,) share of each query's exact top-``rank`` (``gt``) found among its
    first ``rank`` returned ``ids``."""
    got = ids[:, :rank, None] == gt[:, None, :rank]
    return got.any(axis=1).sum(axis=1) / rank


def spread(values) -> float:
    """Distance between the first and third quartile (Python's
    ``statistics.quantiles(n=4)``) as a share of the median."""
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)
