"""A bounded device trace of part of a measured window, reduced in memory.

``TraceWindow`` starts ``torch.profiler`` (CPU and CUDA activity) at a call
boundary once the window has run ``start_s`` seconds, and stops it at the
first boundary ``length_s`` seconds and ``min_steps`` steps later. Each step
the traffic driver runs inside it sits in a ``record_function`` range of the
harness's own (``portbench.request``, ``portbench.build``), so idle gaps can
be labelled by what the host was doing. ``reduce`` turns the events into:

* ``window_s``: from the first traced step's start to the last one's end;
* ``busy_s``: the union of device activity intervals (kernels, copies,
  sets) inside it, so overlapping work counts once, on every card together;
* ``busy_s_by_device``: the same union on each card alone, in card order,
  so that the idlest of several cards shows (on one card, ``[busy_s]``);
* ``device_events``: how many device activities ran (each is one launch);
* ``device_ops``: the ten device operations with the most time;
* ``idle_gaps``: idle device time summed by the innermost host range open
  at each gap's midpoint, the ten largest.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import numpy as np
import torch

STEP_PREFIX = "portbench."
NAME_CHARS = 120  # kernel names are long templates: keep their heads


def _events(prof):
    """(device [(start, end, name, card)], host [(start, end, name, thread)])
    from the profiler's results, in ns. The device side holds every kernel,
    copy and set with the index of the card it ran on, and the span of each
    of the harness's own host ranges, which is left out: it is not work."""
    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        start = int(e.start_ns())
        end = start + int(e.duration_ns())
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if not e.name().startswith(STEP_PREFIX):
                dev.append((start, end, e.name(), int(e.device_index())))
        else:
            host.append((start, end, e.name(), e.start_thread_id()))
    return dev, host


def union(intervals):
    """Merged, sorted (start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def innermost(host, points):
    """For each point, the name of the innermost host range that covers it
    (ranges of one thread nest), or 'host idle'."""
    order = np.argsort(points)
    ranges = sorted(host, key=lambda h: (h[0], -h[1]))
    labels = [None] * len(points)
    stack, i = [], 0
    for j in order:
        p = points[j]
        while i < len(ranges) and ranges[i][0] <= p:
            while stack and stack[-1][1] <= ranges[i][0]:
                stack.pop()
            stack.append(ranges[i])
            i += 1
        while stack and stack[-1][1] < p:
            stack.pop()
        labels[j] = stack[-1][2] if stack else "host idle"
    return labels


def reduce(dev, host, n_devices: int = 1) -> dict:
    """The summary of one traced window (see the module docstring) over
    cards 0 to ``n_devices`` - 1."""
    steps = [h for h in host if h[2].startswith(STEP_PREFIX)]
    if not steps:
        return {}
    t0, t1 = min(h[0] for h in steps), max(h[1] for h in steps)
    thread = steps[0][3]
    dev = [(max(s, t0), min(e, t1), n, c) for s, e, n, c in dev if e > t0 and s < t1]
    merged = union([(s, e) for s, e, _, _ in dev])
    busy = sum(e - s for s, e in merged)
    by_device = [sum(e - s for s, e in union([(s, e) for s, e, _, c in dev if c == i])) / 1e9
                 for i in range(n_devices)]
    per_op = defaultdict(int)
    for s, e, n, _ in dev:
        per_op[n[:NAME_CHARS]] += e - s
    edges = [t0] + [v for iv in merged for v in iv] + [t1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
    own = [h for h in host if h[3] == thread]
    idle = defaultdict(int)
    for (s, e), name in zip(gaps, innermost(own, [(s + e) // 2 for s, e in gaps])):
        idle[name[:NAME_CHARS]] += e - s
    top = lambda d: [[n, v / 1e9] for n, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]
    return dict(window_s=(t1 - t0) / 1e9, busy_s=busy / 1e9, busy_s_by_device=by_device,
                device_events=len(dev), steps=len(steps), device_ops=top(per_op),
                idle_gaps=top(idle))


def idle_pct(summary: dict):
    """The traced span's idle share (%): 1 - busy / span; None where no
    device activity was traced."""
    if not summary or not summary["device_events"]:
        return None
    return 100.0 * (1.0 - summary["busy_s"] / summary["window_s"])


class TraceWindow:
    """Profile a bounded part of a window; ``step(elapsed)`` at each step
    boundary, ``annotate()`` around each step."""

    def __init__(self, enabled: bool, start_s: float, length_s: float, min_steps: int,
                 on_start=None, on_stop=None, n_devices: int = 1):
        self.enabled, self.start_s, self.length_s, self.min_steps = (
            enabled, start_s, length_s, min_steps)
        self.n_devices = n_devices
        self.on_start, self.on_stop = on_start, on_stop
        self.at_stop = None  # what ``on_stop`` returned
        self.prof = None
        self.t_on = None
        self.steps = 0
        self.done = False
        self.summary = {}

    @property
    def active(self) -> bool:
        return self.prof is not None

    def step(self, elapsed: float) -> None:
        if not self.enabled or self.done:
            return
        if self.prof is None and elapsed >= self.start_s:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            self.prof = profile(activities=acts)
            if self.on_start is not None:
                self.on_start()
            self.prof.__enter__()
            self.t_on = time.perf_counter()
        elif self.prof is not None and self.steps >= self.min_steps and (
                time.perf_counter() - self.t_on >= self.length_s):
            self.stop()

    def annotate(self, name: str):
        if self.prof is None:
            return contextlib.nullcontext()
        self.steps += 1
        return torch.profiler.record_function(STEP_PREFIX + name)

    def stop(self) -> None:
        """End the trace (also at the window's end) and reduce it."""
        if self.prof is None:
            return
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.prof.__exit__(None, None, None)
        if self.on_stop is not None:
            self.at_stop = self.on_stop()
        self.summary = reduce(*_events(self.prof), n_devices=self.n_devices)
        self.prof = None
        self.done = True
