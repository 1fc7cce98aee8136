"""Smallest-k selection, top-k merge and the exact k-NN oracle."""

from __future__ import annotations

from typing import Optional

import torch

from .distance import sq_norms


def topk_smallest(dists: torch.Tensor, k: int):
    """Smallest-k along the last axis: (..., n) -> (vals, idx), each (..., k),
    ascending. If k > n the result is padded with +inf / -1 so callers always
    see (..., k) (the bindings' (D, I) contract)."""
    n = dists.shape[-1]
    kk = min(k, n)
    vals, idx = torch.topk(dists, kk, dim=-1, largest=False, sorted=True)
    if kk < k:
        shape = dists.shape[:-1] + (k - kk,)
        vals = torch.cat([vals, vals.new_full(shape, float("inf"))], dim=-1)
        idx = torch.cat([idx, idx.new_full(shape, -1)], dim=-1)
    return vals, idx


def merge_topk(vals_a, idx_a, vals_b, idx_b, k: int):
    """Merge two partial top-k streams (..., ka)/(..., kb) into top-k."""
    vals = torch.cat([vals_a, vals_b], dim=-1)
    idx = torch.cat([idx_a, idx_b], dim=-1)
    mvals, pos = topk_smallest(vals, k)
    midx = torch.gather(idx, -1, pos.clamp_min(0))
    return mvals, torch.where(pos < 0, torch.full_like(midx, -1), midx)


def brute_force_topk(
    queries: torch.Tensor,
    db: torch.Tensor,
    k: int,
    db_chunk: int = 65536,
    metric: str = "l2",
    db_row_norms: Optional[torch.Tensor] = None,
):
    """Exact k-NN oracle: (nq, d) x (n, d) -> (D (nq, k) f32, I (nq, k) i64).

    Streams the database in ``db_chunk`` rows with a running top-k merge, so
    peak memory is nq * db_chunk floats. ``metric`` 'ip' returns the negated
    inner product. ``db_row_norms`` is used only as a validity mask: rows
    with norm >= 1e29 (layout gap/tail sentinels) never appear."""
    nq = queries.shape[0]
    n = db.shape[0]
    q_sq = sq_norms(queries)
    best_v = queries.new_full((nq, k), float("inf"))
    best_i = torch.full((nq, k), -1, dtype=torch.int64, device=queries.device)
    for start in range(0, n, db_chunk):
        chunk = db[start : start + db_chunk]
        cross = torch.matmul(queries, chunk.T)
        if metric == "l2":
            dmat = (q_sq[:, None] - 2.0 * cross + sq_norms(chunk)[None, :]).clamp_min_(0.0)
        else:
            dmat = -cross
        if db_row_norms is not None:
            bad = db_row_norms[start : start + db_chunk] >= 1e29
            dmat = dmat.masked_fill(bad[None, :], float("inf"))
        v, i = topk_smallest(dmat, k)
        gi = torch.where(i >= 0, i + start, i)
        best_v, best_i = merge_topk(best_v, best_i, v, gi, k)
    return best_v, best_i
