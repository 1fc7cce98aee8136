"""One captured CUDA graph per card for each repeated call shape of a sharded
search (``_SlicedSearcher``: the 1-D, 2-D and multi-host searchers).

A call of a shape the searcher has answered before fills one pinned buffer
per distinct query batch and replays, on each job's card, a CUDA graph of
that job's part of the call: the copy of its queries from the pinned buffer
into the card's static query buffer, the whole ``DeviceSlice.search`` body
(coarse scan, global threshold, probes, task grid, K4 / K2 / K3, narrowing,
real-row mask) and the sum of the rows the card probed. The merge of the
partial lists and the copy back stay eager, after the replays. The same
kernels run in the same order on the same inputs as in the eager call, so
the answers are the eager ones bit for bit. One host thread then starts each
card with one launch in place of a few hundred, and ``params`` (the body,
the task-slot budget over every list length) runs once per shape.

* The first call of a shape runs eagerly (``_SlicedSearcher.run``), which
  builds each slice's lazy stream table; the second captures; later calls
  replay. A capture that raises is logged and leaves that shape eager for
  good.
* A shape is the jobs' (slice, card, query batch, rows), d, the width
  searched, n_probe, the per-card batch and the searcher's method. The
  graphs bind the searcher's slices and the index's ``stream_dtype`` and
  ``metric``: when any of them is a new object, every graph goes.
* At most ``SLOTS`` shapes per searcher, the least recently used first out.
* A lock per shape covers the fill, the replays, the merge and the copy
  back (``reduce``), which reads the graphs' static outputs before the next
  replay overwrites them.
* The host counts ``sharded.graph.capture`` and ``sharded.graph.replay``
  (``utils.tracing.count``, while spans record), each replay adds the
  captured kernels to ``kernels.build.launch_counts``, and each card's
  probed rows go to ``sharded.probed_rows.<slice>`` as in an eager call.
* ``index.graphs.CudaCapture`` is the seam to the cards; the CPU tests pass
  a stand-in with the same four methods.
"""

from __future__ import annotations

import logging
import threading
from collections import OrderedDict
from logging import DEBUG

import numpy as np
import torch

from ..index.graphs import CudaCapture
from ..kernels import build as kb
from ..utils import tracing
from ..utils.tracing import trace

log = logging.getLogger("vector_indexer_tpu_torch")

SLOTS = 4  # shapes per searcher: seen once, captured, or left eager
_ONE = torch.ones(())  # a counter's increment, summed on the host


class _Job:
    """One job's graph: its card, its counter, its static query buffer on
    the card (held here: the graph writes and reads it), its replay, and
    the static outputs its run leaves: ``res`` (D, rows) and ``probed``."""

    __slots__ = ("dev", "counter", "q_dev", "replay", "res", "probed")

    def __init__(self, dev, counter):
        self.dev, self.counter = dev, counter
        self.q_dev = self.replay = self.res = self.probed = None


class _Shape:
    """One call shape: once captured, its parameters, pinned query buffers
    and per-job graphs, or ``eager`` once a capture failed."""

    __slots__ = ("lock", "params", "hosts", "jobs", "launches", "eager")

    def __init__(self):
        self.lock = threading.Lock()
        self.jobs = None
        self.eager = False


def _batches(jobs):
    """(each job's query batch as an index into the call's distinct
    batches, the distinct batches in that order)."""
    seen: dict = {}
    groups = [seen.setdefault(id(q), len(seen)) for _, _, q in jobs]
    batches = list({id(q): q for _, _, q in jobs}.values())
    return groups, batches


class ShardGraphs:
    """The per-card graphs of one sharded searcher's repeated call shapes."""

    def __init__(self, capture=None):
        self.capture = CudaCapture() if capture is None else capture
        self._lock = threading.Lock()
        self._state = None  # the slices the graphs read, and what they bind
        self._shapes: OrderedDict = OrderedDict()

    def __len__(self) -> int:
        return len(self._shapes)

    def captured(self) -> int:
        """How many shapes hold graphs."""
        with self._lock:
            return sum(s.jobs is not None for s in self._shapes.values())

    def search(self, searcher, jobs, kk: int, n_probe: int, nq_local: int, reduce):
        """``reduce(searcher.run(jobs, kk, n_probe, nq_local))``, with the
        per-card part through the graphs of the call's shape where every
        job's card is one ``capture`` engages. ``jobs`` = [(slice j, device,
        queries (rows, d) float32 numpy)]; ``reduce(outs)`` merges the
        per-job (D, rows) and copies the result to the host."""

        def eager():
            return reduce(searcher.run(jobs, kk, n_probe, nq_local))

        if not all(self.capture.engages(dev) for _, dev, _ in jobs):
            return eager()
        groups, batches = _batches(jobs)
        key = (tuple((j, dev, g, q.shape) for (j, dev, q), g in zip(jobs, groups)), kk,
               n_probe, nq_local, searcher.method)
        state = (searcher._slices, searcher.index.stream_dtype, searcher.index.metric)
        with self._lock:
            if self._state is None or any(a is not b for a, b in zip(self._state, state)):
                self._shapes.clear()
                self._state = state
            shape = self._shapes.get(key)
            if shape is not None:
                self._shapes.move_to_end(key)
        if shape is None:
            out = eager()
            with self._lock:
                if key not in self._shapes:
                    self._shapes[key] = _Shape()
                    while len(self._shapes) > SLOTS:
                        self._shapes.popitem(last=False)
            return out
        with shape.lock:
            if shape.jobs is None and not shape.eager:
                self._capture(searcher, shape, jobs, groups, batches, kk, n_probe, nq_local)
            if not shape.eager:
                return reduce(self._replay(searcher, shape, batches))
        return eager()

    def _capture(self, searcher, shape: _Shape, jobs, groups, batches, kk: int, n_probe: int,
                 nq_local: int) -> None:
        """Capture one graph per job into ``shape``; on failure log it and
        leave the shape eager."""
        params = searcher.params(nq_local, kk, n_probe)
        hosts = [self.capture.host_buffer(q.shape, torch.float32) for q in batches]
        graphs = []
        before = kb.launch_counts()
        try:
            for (j, dev, _), g in zip(jobs, groups):
                job = _Job(dev, searcher._slices[(j, dev)].counter)
                body = self._body(searcher, job, j, hosts[g], kk, params)
                job.replay = self.capture.capture(body, dev)
                graphs.append(job)
        except Exception:
            log.warning("sharded search graph: capture of %d jobs, nq_local=%d d=%d kk=%d "
                        "n_probe=%d method=%s failed; this shape stays eager", len(jobs),
                        nq_local, jobs[0][2].shape[1], kk, n_probe, searcher.method,
                        exc_info=True)
            shape.eager = True
            return
        finally:
            # A capture launches nothing: its wrapper calls counted anyway.
            after = kb.launch_counts()
            launches = {n: c - before[n] for n, c in after.items() if c != before[n]}
            kb.add_launches({n: -c for n, c in launches.items()})
        shape.params, shape.hosts, shape.jobs, shape.launches = params, hosts, graphs, launches
        tracing.count("sharded.graph.capture", _ONE)

    @staticmethod
    def _body(searcher, job: _Job, j: int, host: torch.Tensor, kk: int, params):
        """What job ``j``'s graph runs: its queries from the pinned ``host``
        buffer into a static buffer on its card, the slice's search, and the
        rows it probed, summed on the card."""
        job.q_dev = torch.empty(tuple(host.shape), dtype=torch.float32, device=job.dev)

        def body():
            job.q_dev.copy_(host, non_blocking=True)
            job.probed = torch.zeros((), dtype=torch.float64, device=job.dev)
            job.res = searcher.search_job(j, job.dev, job.q_dev, kk, params, job.probed)

        return body

    def _replay(self, searcher, shape: _Shape, batches) -> list:
        searcher.last_method = shape.params[2]
        with trace("sharded.enqueue", level=DEBUG):
            for host, q in zip(shape.hosts, batches):
                # numpy's copy takes any host array (a cast, strides, read-only)
                np.copyto(host.numpy(), q, casting="unsafe")
            outs = []
            for job in shape.jobs:
                job.replay()
                tracing.count(job.counter, job.probed)  # while spans record
                outs.append(job.res)
        tracing.count("sharded.graph.replay", _ONE)
        kb.add_launches(shape.launches)
        return outs
