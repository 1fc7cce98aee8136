"""offload_sweep_roofline: the least time the traced calls' int8 sweeps could
take on the card, over the device's busy time in them (%).

The work is counted from the inputs, as ``search_roofline`` counts it, and
not from the kernels, so it reads the same whichever kernel the route takes
(K4, K2 or K5). An offloaded call sweeps its queries in halves of
``batch / 2`` (the port's split of a batch of 512 or more, so that the host
re-ranks one half while the card sweeps the other), each to a shortlist of
``kk`` rows (min(max(2k, 128), 4096)). Per half the benchmark works out each
query's ``n_probe`` nearest centroids of the built index (squared L2, as the
port probes): bytes are each distinct probed row once at 1 byte an element
with its 4-byte norm, plus the centroids, the queries and the shortlist;
operations are 2 d per (query, probed row) pair plus the coarse scan, at the
int8 peak (``roofline.search_bound``). The card's busy time also holds the
shortlists' copies back, so this is a share of everything the card did.
None where the trace holds no device activity or no traced call."""

import numpy as np
import torch

from portbench import reference, roofline

PIPELINE_MIN_NQ = 512  # the port's batch size from which a call is swept in two halves


def shortlist(k: int) -> int:
    return min(max(2 * k, 128), 4096)


def read(ctx):
    b, tr = ctx["bench"], ctx["trace"]
    starts = ctx["window"].get("traced_starts")
    if not tr or not tr["device_events"] or not tr["busy_s"] or not starts or b.index is None:
        return None
    t, index = b.traffic, b.index
    batch, k, n_probe = t["batch"], t["k"], t["n_probe"]
    pieces = 2 if batch >= PIPELINE_MIN_NQ else 1
    bounds = [(i * batch // pieces, (i + 1) * batch // pieces) for i in range(pieces)]
    lengths = torch.as_tensor(np.asarray(index.layout.lengths, np.int64), device=b.device)
    cent = torch.as_tensor(index.centroids, device=b.device)
    nlist, d = cent.shape
    total = 0.0
    for s in starts:
        for lo, hi in bounds:
            q = reference.prepare(b.queries(np.arange(s + lo, s + hi)), b.config["metric"],
                                  torch.float32)
            probe = reference.probes(q, cent, min(n_probe, nlist), torch.float32)
            distinct = int(lengths[torch.unique(probe)].sum())
            pairs = int(lengths[probe].sum())
            total += roofline.search_bound(hi - lo, d, shortlist(k), nlist, distinct, pairs, 1,
                                           "int8")["bound_s"]
    return 100.0 * total / tr["busy_s"]
