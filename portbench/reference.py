"""Plain reference of an IVF-Flat index's answers: torch only, nothing of the port.

The reference works out again, from the benchmark's own inputs, what the
port derives: each corpus vector's list (its nearest centroid), each query's
probed lists (its ``n_probe`` nearest centroids, squared L2 as the port
probes), and the exact top-k over the probed lists' vectors. The one thing
it takes from the port is the centroid table, the state that training
leaves: training itself is checked apart (``lloyd_shift``).

Every function takes ``dtype``: float64 is the reference. Its controls
compute the same one precision below what the configurations state:
bfloat16 for the float32 corpus and centroids, and an int8 residual table
(``table="int8"``) for the bfloat16 residual table the stream routes read.
Matrix products run with TF32 off. Work goes in blocks of rows, so that a
1M x 1,536 corpus fits beside nothing else.
"""

from __future__ import annotations

import contextlib

import torch

ROW_BLOCK = 1 << 16  # corpus rows per block
QUERY_BLOCK = 1024  # queries per block


@contextlib.contextmanager
def no_tf32():
    """Matrix products in full float32 (TF32 off) inside the block."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def prepare(x: torch.Tensor, metric: str, dtype) -> torch.Tensor:
    """Rows in ``dtype``; unit rows for cosine (the metric ranks them by inner
    product)."""
    x = x.to(dtype)
    if metric == "cosine":
        x = x / x.norm(dim=-1, keepdim=True).clamp_min(1e-12)
    return x


def sq_l2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(len a, len b) squared L2 distances by the norm expansion, in a's type."""
    return (a * a).sum(1, keepdim=True) - 2.0 * (a @ b.T) + (b * b).sum(1)[None, :]


def distances(q: torch.Tensor, x: torch.Tensor, metric: str) -> torch.Tensor:
    """Ranking distances (smaller is better): squared L2, or the negated inner
    product for ip and cosine (rows already prepared)."""
    return sq_l2(q, x) if metric == "l2" else -(q @ x.T)


def assign(x: torch.Tensor, centroids: torch.Tensor, metric: str, dtype) -> torch.Tensor:
    """(n,) int64 nearest centroid (squared L2) of every corpus row."""
    c = centroids.to(x.device, dtype)
    out = torch.empty(x.shape[0], dtype=torch.int64, device=x.device)
    with no_tf32():
        for s in range(0, x.shape[0], ROW_BLOCK):
            out[s:s + ROW_BLOCK] = sq_l2(prepare(x[s:s + ROW_BLOCK], metric, dtype), c).argmin(1)
    return out


def probes(q: torch.Tensor, centroids: torch.Tensor, n_probe: int, dtype) -> torch.Tensor:
    """(nq, n_probe) ids of each prepared query's nearest centroids."""
    c = centroids.to(q.device, dtype)
    with no_tf32():
        return sq_l2(q.to(dtype), c).topk(min(n_probe, c.shape[0]), dim=1, largest=False).indices


def blocked_topk(q: torch.Tensor, rows, n: int, k: int, metric: str, mask=None,
                 row_block: int = ROW_BLOCK):
    """Exact top-k of the prepared queries ``q`` over ``n`` corpus rows, taken
    in blocks: ``rows(s, e)`` gives rows s:e prepared in q's type, and
    ``mask(s, e)`` (optional) the (len q, e - s) candidates among them.
    Returns (distances (nq, k) float64 as computed in q's type, ids (nq, k)
    int64), ascending; -1 / +inf past the candidates."""
    best_d = torch.full((q.shape[0], 0), float("inf"), dtype=torch.float64, device=q.device)
    best_i = torch.zeros((q.shape[0], 0), dtype=torch.int64, device=q.device)
    for s in range(0, n, row_block):
        e = min(s + row_block, n)
        dist = distances(q, rows(s, e), metric)
        if mask is not None:
            dist.masked_fill_(~mask(s, e), float("inf"))
        bd, bi = dist.topk(min(k, e - s), dim=1, largest=False)
        best_d = torch.cat([best_d, bd.to(torch.float64)], 1)
        best_i = torch.cat([best_i, bi + s], 1)
        if best_d.shape[1] > k:
            best_d, pos = best_d.topk(k, dim=1, largest=False)
            best_i = best_i.gather(1, pos)
    best_d, pos = best_d.sort(dim=1)
    return best_d, torch.where(torch.isfinite(best_d), best_i.gather(1, pos), -1)


def ground_truth(xb: torch.Tensor, xq: torch.Tensor, metric: str, k: int) -> torch.Tensor:
    """(nq, k) ids of every query's exact top-k over the whole corpus, float32
    with TF32 off (recall's yardstick)."""
    out = []
    with no_tf32():
        for qs in range(0, xq.shape[0], QUERY_BLOCK):
            qb = prepare(xq[qs:qs + QUERY_BLOCK], metric, torch.float32)
            out.append(blocked_topk(qb, lambda s, e: prepare(xb[s:e], metric, torch.float32),
                                    xb.shape[0], k, metric, row_block=ROW_BLOCK * 4)[1])
    return torch.cat(out)


def lowest(dist: torch.Tensor, ids: torch.Tensor, k: int):
    """The k smallest of each row's candidates (``dist``, ``ids``, each
    (nq, m)) by (distance, id): of equal distances the lower id comes first."""
    ids, order = ids.sort(dim=1, stable=True)
    dist, pos = dist.gather(1, order).sort(dim=1, stable=True)
    return dist[:, :k], ids.gather(1, pos)[:, :k]


def ground_truth_streamed(xb: torch.Tensor, xq: torch.Tensor, metric: str, k: int,
                          devices) -> torch.Tensor:
    """``ground_truth`` of a host corpus ``xb`` (a CPU tensor) that no one
    device holds, in the same float32 arithmetic with TF32 off, reading the
    corpus once: row blocks are the outer loop, each of ``devices`` takes a
    disjoint range of rows and keeps a running top-k of every query, and the
    lists merge by (distance, row id), so that ties go to the lower id (inside
    one block, a tie at the k-th place goes as ``topk`` picks it: on a CUDA
    card, the first in row order). Returns (nq, k) ids on ``devices[0]``."""
    n, nd, block = xb.shape[0], len(devices), ROW_BLOCK * 4
    bounds = [n * i // nd for i in range(nd + 1)]
    qblocks = [range(qs, min(qs + QUERY_BLOCK, xq.shape[0]))
               for qs in range(0, xq.shape[0], QUERY_BLOCK)]
    with no_tf32():
        queries = [[prepare(xq[r.start:r.stop].to(dev), metric, torch.float32) for r in qblocks]
                   for dev in devices]
        best = [[(torch.empty((len(r), 0), device=dev),
                  torch.empty((len(r), 0), dtype=torch.int64, device=dev)) for r in qblocks]
                for dev in devices]
        for off in range(0, max(e - s for s, e in zip(bounds, bounds[1:])), block):
            for c, dev in enumerate(devices):  # one block a card, each card on its own range
                s = bounds[c] + off
                e = min(s + block, bounds[c + 1])
                if s >= e:
                    continue
                rows = prepare(xb[s:e].to(dev, non_blocking=True), metric, torch.float32)
                for j, qb in enumerate(queries[c]):
                    bd, bi = distances(qb, rows, metric).topk(min(k, e - s), dim=1,
                                                              largest=False)
                    bd0, bi0 = best[c][j]
                    best[c][j] = lowest(torch.cat([bd0, bd], 1), torch.cat([bi0, bi + s], 1), k)
    home = devices[0]
    out = []
    for j in range(len(qblocks)):
        dist = torch.cat([best[c][j][0].to(home) for c in range(nd)], 1)
        ids = torch.cat([best[c][j][1].to(home) for c in range(nd)], 1)
        out.append(lowest(dist, ids, k)[1])
    return torch.cat(out)


def int8_scales(x: torch.Tensor, labels: torch.Tensor, centroids: torch.Tensor,
                metric: str) -> torch.Tensor:
    """(nlist,) float32 scale of each list's int8 residual rows: the largest
    |x - c| element over the list, over 127 (symmetric, one scale a list)."""
    c = centroids.to(x.device, torch.float32)
    smax = torch.zeros(c.shape[0], dtype=torch.float32, device=x.device)
    for s in range(0, x.shape[0], ROW_BLOCK):
        lb = labels[s:s + ROW_BLOCK]
        r = prepare(x[s:s + ROW_BLOCK], metric, torch.float32) - c[lb]
        smax.scatter_reduce_(0, lb, r.abs().amax(dim=1), reduce="amax")
    return (smax / 127.0).clamp_min(1e-12)


def int8_rows(x: torch.Tensor, labels: torch.Tensor, centroids: torch.Tensor,
              scales: torch.Tensor, metric: str, dtype) -> torch.Tensor:
    """Corpus rows as an int8 residual table holds them: each list's centroid
    plus its residual rounded to the list's int8 grid (``int8_scales``)."""
    c = centroids.to(x.device, torch.float32)[labels]
    sc = scales[labels, None]
    q8 = ((prepare(x, metric, torch.float32) - c) / sc).round().clamp(-127, 127)
    return (c + q8 * sc).to(dtype)


def search_lists(q: torch.Tensor, x: torch.Tensor, labels: torch.Tensor,
                 centroids: torch.Tensor, n_probe: int, k: int, metric: str, dtype,
                 table: str = "exact"):
    """Exact top-k over the probed lists: (distances (nq, k) float64 as
    computed in ``dtype``, ids (nq, k) int64), ascending; -1 / +inf past the
    candidates. ``labels`` are the lists of the corpus rows. ``table``
    "int8" reads each row as an int8 residual table stores it
    (``int8_rows``) instead of the row itself."""
    if table == "int8":
        scales = int8_scales(x, labels, centroids, metric)
        rows = lambda s, e: int8_rows(x[s:e], labels[s:e], centroids, scales, metric, dtype)
    else:
        rows = lambda s, e: prepare(x[s:e], metric, dtype)
    dist_out, id_out = [], []
    with no_tf32():
        for qs in range(0, q.shape[0], QUERY_BLOCK):
            qb = prepare(q[qs:qs + QUERY_BLOCK], metric, dtype)
            probed = torch.zeros((qb.shape[0], centroids.shape[0]), dtype=torch.bool,
                                 device=q.device)
            probed.scatter_(1, probes(qb, centroids, n_probe, dtype), True)
            bd, bi = blocked_topk(qb, rows, x.shape[0], k, metric,
                                  mask=lambda s, e: probed[:, labels[s:e]])
            dist_out.append(bd)
            id_out.append(bi)
    return torch.cat(dist_out), torch.cat(id_out)


def exact(q: torch.Tensor, x: torch.Tensor, ids: torch.Tensor, metric: str) -> torch.Tensor:
    """(nq, k) float64 distance of each query to each of its ``ids`` (rows of
    the corpus; -1 gives +inf), by the direct difference for L2."""
    out = []
    for qs in range(0, q.shape[0], QUERY_BLOCK):
        qb = prepare(q[qs:qs + QUERY_BLOCK], metric, torch.float64)
        ib = ids[qs:qs + QUERY_BLOCK]
        rows = prepare(x[ib.clamp(0, x.shape[0] - 1)], metric, torch.float64)
        if metric == "l2":
            dist = ((rows - qb[:, None, :]) ** 2).sum(-1)
        else:
            dist = -(rows @ qb[:, :, None])[..., 0]
        out.append(torch.where(ib >= 0, dist, float("inf")))
    return torch.cat(out)


def scale(q: torch.Tensor, x: torch.Tensor, ref_dist: torch.Tensor, metric: str) -> torch.Tensor:
    """(nq,) float64 scale that distance errors are measured against: the
    reference's k-th distance for L2 (the neighbourhood's squared radius),
    |q| times the largest |x| for inner products (1 for cosine)."""
    if metric == "l2":
        finite = torch.where(torch.isfinite(ref_dist), ref_dist, 0.0)
        return finite.max(dim=1).values.clamp_min(1e-30)
    qn = prepare(q, metric, torch.float64).norm(dim=1)
    xmax = max(float(prepare(x[s:s + ROW_BLOCK], metric, torch.float64).norm(dim=1).max())
               for s in range(0, x.shape[0], ROW_BLOCK))
    return (qn * xmax).clamp_min(1e-30)


def lloyd_shift(x: torch.Tensor, centroids: torch.Tensor, labels: torch.Tensor,
                metric: str) -> float:
    """One more Lloyd step from the trained centroids, in float64: the root
    mean square move of the non-empty cells' means, over the root mean
    square distance of a row to its centroid. Near 0 for a trained table;
    a table left at its initial draw moves far."""
    c = centroids.to(x.device, torch.float64)
    sums = torch.zeros_like(c)
    counts = torch.zeros(c.shape[0], dtype=torch.float64, device=x.device)
    sq = 0.0
    for s in range(0, x.shape[0], ROW_BLOCK):
        xb = prepare(x[s:s + ROW_BLOCK], metric, torch.float64)
        lb = labels[s:s + ROW_BLOCK]
        sums.index_add_(0, lb, xb)
        counts.index_add_(0, lb, torch.ones_like(lb, dtype=torch.float64))
        sq += float(((xb - c[lb]) ** 2).sum())
    hit = counts > 0
    means = sums[hit] / counts[hit, None]
    if metric == "cosine":  # spherical k-means keeps its centroids on the sphere
        means = means / means.norm(dim=1, keepdim=True).clamp_min(1e-12)
    move = float(((means - c[hit]) ** 2).sum(1).mean())
    return (move / (sq / x.shape[0])) ** 0.5
