"""One captured CUDA graph per repeated call shape of ``IvfIndex.search_batch``.

A device-resident index answers a call of a shape it has answered before by
replaying a CUDA graph of the whole call: the copy of the queries from a
pinned buffer, the cosine normalisation, the program ``resolve`` picked,
the gather of layout rows to ids, and the copies of (D, ids) into pinned
buffers. The same kernels run in the same order on the same inputs as in
the eager call, so the answers are the eager ones bit for bit. The host
enqueues one graph in place of ~100 launches, and ``resolve``, ``_bind``
and the program's Python run once per shape.

* The first call of a shape runs eagerly, which builds every lazy table;
  the second captures; later calls replay. A capture that raises is logged
  and leaves that shape eager for good.
* A shape is (nq, d, k, n_probe, method, external). The graphs read the
  index's tables (``IvfIndex.tables()``) and bind its ``stream_dtype`` and
  ``metric``: when any of the three is replaced, every graph goes, and the
  mutators that free tables drop them first (``clear``).
* At most ``SLOTS`` shapes per index, the least recently used first out, so
  a caller whose nq keeps changing does not grow device memory.
* A lock per shape covers the fill, the replay and the copy-out; callers
  get copies of the pinned outputs, which the next replay overwrites.
* While spans record, the host counts ``search.graph.capture`` and
  ``search.graph.replay`` (``utils.tracing.count``), and each replay adds
  the captured kernels to ``kernels.build.launch_counts``.
* ``CudaCapture`` is the seam to the card; the CPU tests pass a stand-in
  with the same four methods.
"""

from __future__ import annotations

import logging
import threading
from collections import OrderedDict
from logging import DEBUG

import numpy as np
import torch

from ..kernels import build as kb
from ..utils import tracing
from ..utils.tracing import trace

log = logging.getLogger("vector_indexer_tpu_torch")

SLOTS = 4  # shapes per index: seen once, captured, or left eager
_ONE = torch.ones(())  # a counter's increment, summed on the host


class CudaCapture:
    """Capture and replay on a CUDA card."""

    def engages(self, device: torch.device) -> bool:
        return device.type == "cuda"

    def host_buffer(self, shape, dtype: torch.dtype) -> torch.Tensor:
        return torch.empty(shape, dtype=dtype, pin_memory=True)

    def capture(self, body, device: torch.device):
        """Record ``body``'s device work into a graph on a stream of its own
        (nothing runs); returns the call that replays it on ``device``'s
        current stream. Only this thread's CUDA calls are held to the
        capture's rules, so other threads may search meanwhile."""
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.device(device):
            with torch.cuda.graph(graph, stream=torch.cuda.Stream(device),
                                  capture_error_mode="thread_local"):
                body()

        def replay():
            with torch.cuda.device(device):
                graph.replay()

        return replay

    def wait(self, device: torch.device) -> None:
        torch.cuda.current_stream(device).synchronize()


class _Shape:
    """One call shape: what its eager call returned, then its graph and
    static buffers, or ``eager`` once a capture failed."""

    __slots__ = ("lock", "out", "replay", "state", "launches", "q_dev", "q_host", "d_host",
                 "i_host", "eager")

    def __init__(self, out):
        self.lock = threading.Lock()
        self.out = [(a.shape, torch.from_numpy(a[:0]).dtype) for a in out]
        self.replay = None
        self.eager = False


class SearchGraphs:
    """The graphs of one index's repeated ``search_batch`` shapes."""

    def __init__(self, capture=None):
        self.capture = CudaCapture() if capture is None else capture
        self._lock = threading.Lock()
        self._state = None  # the owner of the tables the graphs read, and what they bind
        self._shapes: OrderedDict = OrderedDict()

    def __len__(self) -> int:
        return len(self._shapes)

    def captured(self) -> int:
        """How many shapes hold a graph."""
        with self._lock:
            return sum(s.replay is not None for s in self._shapes.values())

    def clear(self) -> None:
        """Drop every graph and the tables they hold."""
        with self._lock:
            self._shapes.clear()
            self._state = None

    def search(self, index, queries, k: int, n_probe: int, method: str, external: bool,
               eager):
        """``eager()``'s (D, ids) for this call, through the graph of its
        shape where one applies: host (numpy) queries on a device-resident
        index (``IvfIndex._graphable``) on a device that ``capture``
        engages."""
        if not (self.capture.engages(index.device) and index._graphable()):
            if self._shapes:
                self.clear()
            return eager()
        if isinstance(queries, torch.Tensor):
            return eager()
        q = np.asarray(queries)
        if q.ndim == 1:
            q = q[None, :]
        if q.ndim != 2:
            return eager()
        key = (q.shape[0], q.shape[1], k, n_probe, method, external)
        state = (index.tables(), index.stream_dtype, index.metric)
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
                    self._shapes[key] = _Shape(out)
                    while len(self._shapes) > SLOTS:
                        self._shapes.popitem(last=False)
            return out
        with shape.lock:
            if shape.replay is None and not shape.eager:
                self._capture(index, shape, key)
            if not shape.eager:
                return self._replay(index.device, shape, q)
        return eager()

    def _capture(self, index, shape: _Shape, key) -> None:
        """Capture ``key``'s call into ``shape``; on failure log it and leave
        the shape eager."""
        nq, d, k, n_probe, method, external = key
        dev = index.device
        (d_shape, d_dtype), (i_shape, i_dtype) = shape.out
        with self._lock:
            state = self._state
        q_dev = torch.empty((nq, d), dtype=torch.float32, device=dev)
        q_host = self.capture.host_buffer((nq, d), torch.float32)
        d_host = self.capture.host_buffer(d_shape, d_dtype)
        i_host = self.capture.host_buffer(i_shape, i_dtype)

        def body():
            q_dev.copy_(q_host, non_blocking=True)
            dv, iv = index._search_ids_device(q_dev, k, n_probe, method, external)
            if dv.shape != d_host.shape or iv.shape != i_host.shape:
                raise RuntimeError(f"search graph: outputs {tuple(dv.shape)} / "
                                   f"{tuple(iv.shape)} differ from the eager call's")
            d_host.copy_(dv, non_blocking=True)
            i_host.copy_(iv, non_blocking=True)

        before = kb.launch_counts()
        try:
            replay = self.capture.capture(body, dev)
        except Exception:
            log.warning("search graph: capture of nq=%d d=%d k=%d n_probe=%d method=%s "
                        "failed; this shape stays eager", nq, d, k, n_probe, method,
                        exc_info=True)
            shape.eager = True
            return
        finally:
            # A capture launches nothing: its wrapper calls counted anyway.
            after = kb.launch_counts()
            launches = {n: c - before[n] for n, c in after.items() if c != before[n]}
            kb.add_launches({n: -c for n, c in launches.items()})
        shape.replay, shape.state, shape.launches = replay, state, launches
        shape.q_dev, shape.q_host, shape.d_host, shape.i_host = q_dev, q_host, d_host, i_host
        tracing.count("search.graph.capture", _ONE)

    def _replay(self, dev: torch.device, shape: _Shape, q: np.ndarray):
        with trace("search.upload", level=DEBUG):
            # numpy's copy takes any host array (a cast, strides, read-only)
            np.copyto(shape.q_host.numpy(), q, casting="unsafe")
        with trace("search.program", level=DEBUG):
            shape.replay()
        tracing.count("search.graph.replay", _ONE)
        kb.add_launches(shape.launches)
        with trace("search.to_host", level=DEBUG):
            self.capture.wait(dev)
            return shape.d_host.numpy().copy(), shape.i_host.numpy().copy()
