"""Closed-loop search of an index larger than its one card, offloaded: one
client sends ``batch`` queries a call to the public
``VectorIndex.search_sync(xq, k, n_probe, method)`` and waits for the answer
before the next call.

Set-up builds the index from the host corpus as a deployment with one card
builds it (``IvfIndex.fit(..., mesh=Mesh([card]), resident="host",
train_sample=)``: the card trains on the configuration's ``train_sample``
rows and assigns every row, and the layout stays in host memory), enters
offload serving (``offload_from_host(rerank=)``: the layout's rows pass
through the card, which keeps only their int8 residual codes, and the
float32 rows stay in host RAM for the re-rank), and warms the one shape.
The build and the offload run with the port's spans recording, and their
times go to standard error. The window is ``search_closed_loop``'s.

No card holds the corpus, so the check and the controls are
``sharded_closed_loop``'s, which work in blocks of host rows against
``reference.py``'s float64 lists and search. Set-up and the check run on
every core the machine gives the process, as that driver's do; the window
runs on ``run.py``'s one core.
"""

from __future__ import annotations

import sys
import time

import numpy as np

from portbench.harness import free, load_module
# A port that cannot build the offload table from a host layout's rows would
# build it in numpy for minutes; it fails here instead, before the draw.
from vector_indexer_tpu_torch.ops.block_stream import build_stream_table_from_rows  # noqa: F401
from vector_indexer_tpu_torch.utils import tracing

_closed = load_module("drivers", "search_closed_loop")
_sharded = load_module("drivers", "sharded_closed_loop")

WARM_CALLS = 5
window = _closed.window
check = _sharded.check
control = _sharded.control


def setup(b) -> None:
    with _sharded.every_core():
        _setup(b)


def _setup(b) -> None:
    from vector_indexer_tpu_torch.index.ivf import IvfIndex
    from vector_indexer_tpu_torch.parallel import Mesh
    from vector_indexer_tpu_torch.storage.vector_store import VectorStore

    t, c = b.traffic, b.config
    if c["metric"] != "l2":
        raise ValueError("offload_closed_loop judges L2 configurations")
    store = VectorStore(external_ids=np.arange(b.xb.shape[0], dtype=np.uint64), vectors=b.xb)
    pool = b.pool.shape[0]
    starts = np.arange(0, pool - t["batch"] + 1, t["batch"])
    b.state["order"] = starts[b.rng.permutation(len(starts))]
    with tracing.recording():
        t0 = time.perf_counter()
        b.index = IvfIndex.fit(store, seed=42, nlist=c["nlist"], metric=c["metric"],
                               mesh=Mesh([b.device], ("shards",)), resident="host",
                               train_sample=c["train_sample"], device=b.device)
        t1 = time.perf_counter()
        b.index.offload_from_host(rerank=t["rerank"])
        t2 = time.perf_counter()
        b.state["vi"] = b.serving(b.index)
        for i in range(WARM_CALLS):
            s = b.state["order"][i % len(starts)]
            b.state["vi"].search_sync(b.pool[s:s + t["batch"]], t["k"], t["n_probe"],
                                      t["method"])
        t3 = time.perf_counter()
    spans = {name: round(p["total_s"], 3) for name, p in tracing.phase_report().items()
             if name.startswith(("fit", "offload.table"))}
    print(f"offload setup: fit {t1 - t0:.3f} s, offload {t2 - t1:.3f} s, warm calls "
          f"{t3 - t2:.3f} s, route {b.index.choose_method(t['batch'], t['n_probe'])}; "
          f"spans {spans}", file=sys.stderr, flush=True)
    tracing.reset_phases()  # the window's traced calls alone fill the registry


def release(b) -> None:
    """Keep what the comparison needs of the port's state (its centroid table
    and its lists), dropping the index."""
    b.state["centroids"] = np.array(b.index.centroids, dtype=np.float32)
    lay = b.index.layout
    b.state.pop("vi", None)
    b.index = None
    free(*b.devices)
    b.state["labels"] = _sharded.port_lists(lay, b.xb.shape[0], b.device)
