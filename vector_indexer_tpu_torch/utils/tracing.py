"""Phase tracing: wall-clock per phase, plus an NVTX range on CUDA.

``trace(phase)`` times a block on the host clock, accumulates it in a
registry that ``phase_report`` reads, and logs it at INFO. When CUDA is
initialised the block is also pushed as an NVTX range, so a
``torch.profiler`` trace shows the phase around its kernels. The host clock
measures enqueue time unless the block ends in a synchronisation; phases
that must report device time synchronise themselves.
"""

from __future__ import annotations

import contextlib
import logging
import time
from collections import defaultdict
from typing import Dict, Iterator

import torch

log = logging.getLogger("vector_indexer_tpu_torch")

_PHASE_TOTALS: Dict[str, float] = defaultdict(float)
_PHASE_COUNTS: Dict[str, int] = defaultdict(int)


@contextlib.contextmanager
def trace(phase: str, **fields) -> Iterator[None]:
    """Wall-clock a phase; accumulates into the phase registry."""
    nvtx = torch.cuda.is_available() and torch.cuda.is_initialized()
    if nvtx:
        torch.cuda.nvtx.range_push(phase)
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        if nvtx:
            torch.cuda.nvtx.range_pop()
        _PHASE_TOTALS[phase] += dt
        _PHASE_COUNTS[phase] += 1
        extra = " ".join(f"{k}={v}" for k, v in fields.items())
        log.info("phase=%s wall=%.3fs %s", phase, dt, extra)


def phase_report() -> Dict[str, dict]:
    """{phase: {total_s, count, mean_s}} accumulated since process start."""
    return {
        p: {
            "total_s": _PHASE_TOTALS[p],
            "count": _PHASE_COUNTS[p],
            "mean_s": _PHASE_TOTALS[p] / max(_PHASE_COUNTS[p], 1),
        }
        for p in _PHASE_TOTALS
    }


def reset_phases() -> None:
    _PHASE_TOTALS.clear()
    _PHASE_COUNTS.clear()
