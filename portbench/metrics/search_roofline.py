"""search_roofline: the least time the traced ``search_sync`` calls' work
could take on the card, over the device's busy time in them (%).

The work is counted from the inputs, not from the kernels: the benchmark
works out each traced call's probes itself (every query's ``n_probe``
nearest centroids of the built index, squared L2 as the port probes) and
takes the index's list lengths. Bytes: each distinct probed row once at the
element size of the table the resolved route reads, with its norm, plus the
centroids, the queries and the outputs; operations: 2 d per (query, probed
row) pair plus the coarse scan, at the peak of the table's precision
(``roofline.search_bound``). So it reads the same whatever kernel
implements the route."""

import numpy as np
import torch

from portbench import reference, roofline

# Fused sweep precision -> (bytes per element read: the int8 sweep reads codes
# and residual codes, precision of its products).
SWEEP = {"highest": (4, "f32"), "int8": (2, "int8"), "int8x1": (1, "int8")}
STREAM = {4: "f32", 2: "bf16", 1: "int8"}


def table_of(dec, stream_itemsize: int):
    """(bytes per element, precision) of the table the resolved route reads."""
    if dec.program in ("stream", "stream_shared"):
        item = 4 if dec.exact else stream_itemsize
        return item, STREAM[item]
    if dec.program.endswith("_fused"):
        return SWEEP[dec.precision]
    return 4, "f32"


def read(ctx):
    from vector_indexer_tpu_torch.index.dispatch import resolve

    b, tr = ctx["bench"], ctx["trace"]
    starts = ctx["window"].get("traced_starts")
    if not tr or not tr["device_events"] or not starts or b.index is None:
        return None
    t, index, metric = b.traffic, b.index, b.config["metric"]
    batch, k, n_probe = t["batch"], t["k"], t["n_probe"]
    dec = resolve(index, batch, n_probe, k=k, method=t["method"])
    row_bytes, precision = table_of(dec, torch.empty((), dtype=index.stream_dtype).element_size())
    lengths = torch.as_tensor(np.asarray(index.layout.lengths, np.int64), device=b.device)
    cent = torch.as_tensor(index.centroids, device=b.device)
    nlist, d = cent.shape
    total = 0.0
    for s in starts:
        q = reference.prepare(b.queries(np.arange(s, s + batch)), metric, torch.float32)
        if dec.program.startswith("flat"):
            distinct = int(lengths.sum())
            pairs = batch * distinct
        else:
            probe = reference.probes(q, cent, min(n_probe, nlist), torch.float32)
            distinct = int(lengths[torch.unique(probe)].sum())
            pairs = int(lengths[probe].sum())
        total += roofline.search_bound(batch, d, k, nlist, distinct, pairs, row_bytes,
                                       precision)["bound_s"]
    return 100.0 * total / tr["busy_s"]
