"""The search programs an IvfIndex binds a dispatch ``Decision`` to.

Each takes device tensors and returns (D (nq, k) f32, layout rows (nq, k)
int64), padded with +inf / -1. Coarse probing is always L2 (the posting
lists were built by L2 assignment), whatever the ranking metric.

* ``stream_program`` - coarse top-n_probe, then the probed-blocks stream
  (kernels K2/K4) over the bf16 residual table, a widened shortlist ``kk``
  and an exact narrow to k (the reference's ``_ivf_search_stream_program``
  with its bf16 default, rerank=False);
* ``dense_fused_program`` - the block probe mask and the fused masked
  sweep (kernel K3), then a top-k over the fixed plane (the reference's
  ``_ivf_search_dense_fused_program``);
* ``dense_program`` - the plain masked full distance matrix + top-k, for
  small tables and odd d (the reference's ``_ivf_search_dense_program``).
"""

from __future__ import annotations

import torch

from ..ops.block_stream import block_stream_search
from ..ops.distance import score, sq_norms
from ..ops.flat_sweep import S, flat_sweep_topk_plane
from ..ops.topk import topk_smallest
from ..storage.layout import ALIGN, SENTINEL_THRESHOLD

# Queries per fused-sweep launch: bounds the (q, n/8) probe mask (~512 MB
# at n = 1M). The reference's q_tile from plan_fused sizes TPU VMEM and has
# no meaning for the port's kernel, which tiles queries itself.
SWEEP_Q_TILE = 4096


def _narrow(dvals, rows, k: int):
    """Exact top-k of a candidate plane, mapped back to its rows."""
    dv, order = topk_smallest(dvals, k)
    rsel = torch.gather(rows, 1, order.clamp_min(0))
    ok = (order >= 0) & torch.isfinite(dv)
    return dv, torch.where(ok, rsel, torch.full_like(rsel, -1))


def _probe(qt, centroids, c_sq, n_probe: int):
    dcoarse = score(qt, centroids, c_sq, sq_norms(qt), "l2")
    return torch.topk(dcoarse, n_probe, dim=1, largest=False, sorted=True).indices


def shortlist_k(k: int, t_fixed: int, chunk: int) -> int:
    """Width of the stream program's shortlist (the reference's bf16 rule,
    wide = 2). The in-sweep selection (K4's top-2-per-lane planes) is
    approximate; the exact narrow from this shortlist to k is not."""
    return min(max(2 * k, 64), t_fixed * chunk)


def stream_program(queries, centroids, c_sq, table, *, k: int, n_probe: int,
                   t_fixed: int, q_tile: int, metric: str):
    """Probed-blocks-only search over the bf16 stream table."""
    kk = shortlist_k(k, t_fixed, table.chunk)
    dv_parts, row_parts = [], []
    for s in range(0, queries.shape[0], q_tile):
        qt = queries[s : s + q_tile]
        probe = _probe(qt, centroids, c_sq, n_probe)
        dv, rows = block_stream_search(qt, table, probe, kk, t_fixed=t_fixed, metric=metric)
        dv_parts.append(dv)
        row_parts.append(rows)
    dvals = torch.cat(dv_parts)
    rows = torch.cat(row_parts)
    if metric == "l2":
        # Kernel distances are |q - (c + r^)|^2 from exact f32 pieces; the
        # three-term sum can leave ~-1e-5 on (near-)self matches.
        dvals = torch.where(torch.isfinite(dvals), dvals.clamp_min(0.0), dvals)
    return _narrow(dvals, rows, k)


def _block_mask(queries, centroids_ord, c_sq_ord, block_run, n_probe: int):
    """(q, n_blocks) bool probe mask over 8-row blocks. A cluster is probed
    when its coarse distance is <= the n_probe-th smallest (ties all
    probed); each block takes its run's membership. ``block_run`` maps a
    block to the last run starting at or before it (-1: none), which is what
    the reference's scattered run-start deltas + prefix sum evaluate to."""
    dcoarse = score(queries, centroids_ord, c_sq_ord, sq_norms(queries), "l2")
    thresh = torch.kthvalue(dcoarse, n_probe, dim=1, keepdim=True).values
    s_ord = dcoarse <= thresh  # (q, kc) in layout-run order
    mask = s_ord[:, block_run.clamp_min(0)]
    return mask & (block_run >= 0)[None, :]


def dense_fused_program(queries, centroids_ord, c_sq_ord, vectors, row_norms,
                        block_run, n_probe: int, *, k: int, w: int, c_groups: int,
                        metric: str):
    """Masked dense sweep through kernel K3; |q|^2 is added after the
    plane's top-k (it is constant per query)."""
    n_pad = vectors.shape[0]
    nb = n_pad // ALIGN
    NB = S * w
    mcols = -(-n_pad // NB) * NB // ALIGN
    dv_parts, row_parts = [], []
    for s in range(0, queries.shape[0], SWEEP_Q_TILE):
        qt = queries[s : s + SWEEP_Q_TILE]
        mask = torch.zeros((qt.shape[0], mcols), dtype=torch.bool, device=qt.device)
        mask[:, :nb] = _block_mask(qt, centroids_ord, c_sq_ord, block_run, n_probe)
        vals, rows = flat_sweep_topk_plane(
            qt, vectors, row_norms, mask, metric=metric, w=w, c_groups=c_groups
        )
        dv, pos = topk_smallest(vals, k)
        rsel = torch.gather(rows.long(), 1, pos.clamp_min(0))
        if metric == "l2":
            dv = (dv + sq_norms(qt)[:, None]).clamp_min(0.0)
        real = torch.isfinite(dv) & (dv < SENTINEL_THRESHOLD) & (pos >= 0)
        dv_parts.append(torch.where(real, dv, float("inf")))
        row_parts.append(torch.where(real, rsel, torch.full_like(rsel, -1)))
    return torch.cat(dv_parts), torch.cat(row_parts)


def dense_program(queries, centroids_ord, c_sq_ord, vectors, row_norms, block_run,
                  n_probe: int, *, k: int, q_tile: int, metric: str):
    """Plain masked dense search: full (q_tile, n) distance matrix, unprobed
    rows +inf, exact top-k; sentinel rows never count as results."""
    dv_parts, row_parts = [], []
    for s in range(0, queries.shape[0], q_tile):
        qt = queries[s : s + q_tile]
        mask = _block_mask(qt, centroids_ord, c_sq_ord, block_run, n_probe)
        dist = score(qt, vectors, row_norms, sq_norms(qt), metric)
        dist = torch.where(mask.repeat_interleave(ALIGN, dim=1), dist, float("inf"))
        dv, rows = topk_smallest(dist, k)
        real = torch.isfinite(dv) & (dv < SENTINEL_THRESHOLD)
        dv_parts.append(torch.where(real, dv, float("inf")))
        row_parts.append(torch.where(real, rows, torch.full_like(rows, -1)))
    return torch.cat(dv_parts), torch.cat(row_parts)
