"""Tracing: the package logger, phase timers, progress lines and a device
profiler.

* ``enable_console_logging(level)`` attaches one stderr handler to the
  ``vector_indexer_tpu_torch`` logger, however often it is called.
* ``trace(phase)`` times a block on the host clock, accumulates it in a
  registry that ``phase_report`` reads, and logs it at INFO. When CUDA is
  initialised the block is also pushed as an NVTX range, so a
  ``torch.profiler`` trace shows the phase around its kernels. The host
  clock measures enqueue time unless the block ends in a synchronisation;
  phases that must report device time synchronise themselves.
* ``progress(total, label)`` logs rate / ETA lines for long host loops.
* ``device_profiler(logdir)`` records a block with ``torch.profiler`` (CPU
  activity, and CUDA activity when a card is present) and writes a Chrome
  trace under ``logdir`` that TensorBoard and Perfetto read.
"""

from __future__ import annotations

import contextlib
import logging
import os
import socket
import time
from collections import defaultdict
from pathlib import Path
from typing import Dict, Iterator

import torch

log = logging.getLogger("vector_indexer_tpu_torch")

_PHASE_TOTALS: Dict[str, float] = defaultdict(float)
_PHASE_COUNTS: Dict[str, int] = defaultdict(int)


def enable_console_logging(level: int = logging.INFO) -> None:
    """Attach a stderr handler to the package logger (idempotent)."""
    if not any(isinstance(h, logging.StreamHandler) for h in log.handlers):
        h = logging.StreamHandler()
        h.setFormatter(logging.Formatter("%(asctime)s %(name)s %(levelname)s %(message)s"))
        log.addHandler(h)
    log.setLevel(level)


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


class progress:
    """Rate / ETA reporter for host-side loops (parity with the original
    system's progress logging, kmeans.rs:528-580): logs at most every
    ``every`` seconds, and when ``total`` is reached."""

    def __init__(self, total: int, label: str, every: float = 5.0):
        self.total = total
        self.label = label
        self.every = every
        self.done = 0
        self.t0 = time.perf_counter()
        self._last = self.t0

    def update(self, n: int = 1) -> None:
        self.done += n
        now = time.perf_counter()
        if now - self._last >= self.every or self.done >= self.total:
            rate = self.done / max(now - self.t0, 1e-9)
            eta = (self.total - self.done) / max(rate, 1e-9)
            log.info("%s: %d/%d (%.0f/s, ETA %.1fs)", self.label, self.done, self.total,
                     rate, eta)
            self._last = now


@contextlib.contextmanager
def device_profiler(logdir) -> Iterator[Path]:
    """Record the block with ``torch.profiler``: CPU activity, and CUDA
    activity (every kernel on the card, those launched through ctypes
    included) when CUDA is available. On exit the card is synchronised and
    the trace is written under ``logdir`` as Chrome trace JSON named
    ``<host>_<pid>.<ns>.pt.trace.json`` (TensorBoard's profiler plugin and
    Perfetto read it). Yields that path."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(logdir, exist_ok=True)
    path = Path(logdir) / f"{socket.gethostname()}_{os.getpid()}.{time.time_ns()}.pt.trace.json"
    with profile(activities=activities) as prof:
        try:
            yield path
        finally:
            if cuda:
                torch.cuda.synchronize()
    prof.export_chrome_trace(str(path))
