"""Tracing: the package logger, spans, progress lines and a device profiler.

* ``enable_console_logging(level)`` attaches one stderr handler to the
  ``vector_indexer_tpu_torch`` logger, however often it is called.
* ``trace(phase, sync=None, level=INFO)`` is a span: a block of host work
  under a name. It records only while someone reads spans: while
  ``torch.profiler`` is recording, or inside a ``recording()`` block.
  A recorded span adds its host-clock duration to the registry that
  ``phase_report`` reads, and under the profiler it also opens a host-only
  range of its name in the profiler's trace (a ``RecordFunction`` of
  function scope, of which CUDA activity makes no device-side copy). That
  range shares the trace's clock with the device's kernels and copies, so
  each gap in the device's activity can be named by the innermost span open
  over it. The host clock measures enqueue time unless the block ends in a
  read; a span given ``sync=<device>`` synchronises that device before it
  ends, while recording only, so that it times the device work it
  enqueued. Without a reader ``trace`` returns a shared no-op context,
  unless the package logger is enabled for the span's ``level``: the span
  then times itself to log its line (its fields are formatted only then).
* ``progress(total, label)`` logs rate / ETA lines for long host loops.
* ``device_profiler(logdir)`` records a block with ``torch.profiler`` (CPU
  activity, and CUDA activity when a card is present) and writes a Chrome
  trace under ``logdir`` that TensorBoard and Perfetto read; the spans
  recorded inside it appear in that trace.
"""

from __future__ import annotations

import contextlib
import logging
import os
import socket
import threading
import time
from pathlib import Path
from typing import Dict, Iterator, List

import torch

log = logging.getLogger("vector_indexer_tpu_torch")

_PHASES: Dict[str, List] = {}  # phase -> [total_s, self_s, count]
_LOCK = threading.Lock()
_LOCAL = threading.local()  # ``stack``: the recorded spans open on this thread
_READERS = 0  # open recording() blocks, of any thread
_NOOP = contextlib.nullcontext()
_profiling = torch.autograd._profiler_enabled


def enable_console_logging(level: int = logging.INFO) -> None:
    """Attach a stderr handler to the package logger (idempotent)."""
    if not any(isinstance(h, logging.StreamHandler) for h in log.handlers):
        h = logging.StreamHandler()
        h.setFormatter(logging.Formatter("%(asctime)s %(name)s %(levelname)s %(message)s"))
        log.addHandler(h)
    log.setLevel(level)


class _Fields:
    """A span's fields, formatted only when its log line is emitted."""

    __slots__ = ("fields",)

    def __init__(self, fields):
        self.fields = fields

    def __str__(self) -> str:
        return " ".join(f"{k}={v}" for k, v in self.fields.items())


class _Span:
    __slots__ = ("name", "sync", "level", "fields", "record", "child", "range", "t0")

    def __init__(self, name, sync, level, fields, record):
        self.name, self.sync, self.level, self.fields, self.record = (
            name, sync, level, fields, record)

    def __enter__(self) -> None:
        if self.record:
            stack = getattr(_LOCAL, "stack", None)
            if stack is None:
                stack = _LOCAL.stack = []
            stack.append(self)
            self.child = 0.0
            self.range = (torch._C._profiler._RecordFunctionFast(self.name)
                          if _profiling() else None)
            if self.range is not None:
                self.range.__enter__()
        self.t0 = time.perf_counter()

    def __exit__(self, exc_type, exc, tb) -> None:
        if self.record and self.sync is not None and exc_type is None:
            dev = torch.device(self.sync)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        dt = time.perf_counter() - self.t0
        if self.record:
            if self.range is not None:
                self.range.__exit__(None, None, None)
            stack = _LOCAL.stack
            stack.pop()
            if stack:
                stack[-1].child += dt
            with _LOCK:
                acc = _PHASES.setdefault(self.name, [0.0, 0.0, 0])
                acc[0] += dt
                acc[1] += dt - self.child
                acc[2] += 1
        if log.isEnabledFor(self.level):
            log.log(self.level, "phase=%s wall=%.3fs %s", self.name, dt, _Fields(self.fields))


def trace(phase: str, sync=None, level: int = logging.INFO, **fields):
    """A span named ``phase`` (see the module docstring): ``with
    trace("fit.layout", sync=device, n=n): ...``. ``sync``: the device a
    recorded span synchronises before it ends (None: none); ``level``: the
    level of its log line; ``fields``: ``key=value`` pairs of that line."""
    if _READERS or _profiling():
        return _Span(phase, sync, level, fields, True)
    if log.isEnabledFor(level):
        return _Span(phase, None, level, fields, False)
    return _NOOP


@contextlib.contextmanager
def recording() -> Iterator[None]:
    """Record every span, of any thread, while the block runs, without a
    profiler: for whoever reads ``phase_report`` outside a trace."""
    global _READERS
    with _LOCK:
        _READERS += 1
    try:
        yield
    finally:
        with _LOCK:
            _READERS -= 1


def phase_report() -> Dict[str, dict]:
    """{phase: {total_s, self_s, count, mean_s}} of the spans recorded since
    the last ``reset_phases``: host-clock seconds in all, those less the
    seconds of the spans recorded inside them on the same thread, the
    number of spans, and seconds per span."""
    with _LOCK:
        return {
            p: {"total_s": total, "self_s": own, "count": count, "mean_s": total / count}
            for p, (total, own, count) in _PHASES.items()
        }


def reset_phases() -> None:
    with _LOCK:
        _PHASES.clear()


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
