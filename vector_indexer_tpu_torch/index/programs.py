"""The search programs an IvfIndex binds a dispatch ``Decision`` to.

Each takes device tensors and returns (D (nq, k) f32, layout rows (nq, k)
int64), padded with +inf / -1. Coarse probing is always L2 (the posting
lists were built by L2 assignment), whatever the ranking metric.

* ``stream_program`` - coarse top-n_probe, then the probed-blocks stream
  (kernels K2/K4, or K5 when shared) over the residual stream table, a
  widened shortlist ``kk``, and either an exact narrow to k over the
  kernel distances (bf16 and f32 tables, and offloaded int8 tables, whose
  re-rank happens elsewhere) or an exact f32 re-rank from the main table
  (int8 tables on a device-resident index): the reference's
  ``_ivf_search_stream_program`` with the defaults of its
  ``_stream_rerank_wanted``;
* ``dense_fused_program`` - the block probe mask and the fused masked
  sweep (kernel K3, f32 or int8), then a top-k over the fixed plane (the
  reference's ``_ivf_search_dense_fused_program``);
* ``dense_program`` - the plain masked full distance matrix + top-k, for
  small tables and odd d (the reference's ``_ivf_search_dense_program``);
* ``flat_fused_program`` - the unmasked fused sweep (K3, f32 or int8) and
  the plane's top-k (the reference's ``_flat_search_fused_program``);
* ``flat_program`` - the full distance matrix and an exact top-k (the
  reference's ``_flat_search_program``, whose ``approx_min_k`` has no
  Hopper counterpart; on the CPU the reference selects exactly too);
* ``gather_program`` - coarse top-n_probe, the packed candidate rows of
  the probed lists, a row gather and an exact f32 top-k (the reference's
  ``_ivf_search_program``, plain XLA there, plain PyTorch here);
* ``gather_dma_program`` - coarse top-n_probe, then kernel K6 writes the
  probed lists' distances to packed slots, and a top-k (the reference's
  ``gather_dma`` branch of ``search_batch_device``).

Three spans (``utils/tracing.trace``, at DEBUG) name the host's stages in
each query tile: ``search.probe`` (the coarse scan, the probe selection,
the probe mask), ``search.sweep`` (the task grid and the kernel launches,
or the distance matrix) and ``search.select`` (the top-k, narrow or
re-rank, and the return to arrival order; in ``stream_program`` once,
after its tiles).
"""

from __future__ import annotations

from logging import DEBUG

import torch

from ..ops.block_stream import block_stream_search, block_stream_search_shared
from ..ops.distance import score, sq_norms
from ..ops.flat_sweep import S, flat_sweep_topk_plane
from ..ops.gather import packed_candidate_rows
from ..ops.ivf_gather import ivf_gather_distances
from ..ops.topk import topk_smallest
from ..storage.layout import ALIGN, SENTINEL_THRESHOLD
from ..utils.tracing import trace

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


# Queries per exact re-rank: bounds the (queries, kk, d) candidate gather
# (~400 MB at kk = 200, d = 128).
RERANK_Q_TILE = 4096


def shortlist_k(k: int, t_fixed: int, chunk: int, wide: int = 2) -> int:
    """Width of the stream program's shortlist (the reference's rule: wide
    2 for bf16 and f32 tables, 4 for int8). The in-sweep selection (K4's
    top-2-per-lane planes) is approximate, and an int8 table's ranking is
    coarse; the exact narrow or re-rank from this shortlist to k is not."""
    return min(max(wide * k, 64 * (wide // 2)), t_fixed * chunk)


def exact_rerank(queries, rows, vectors, row_norms, k: int, metric: str):
    """Exact f32 re-rank of a shortlist of layout rows: recompute the
    candidates' distances from the f32 table and re-select the top k.
    rows < 0 pass through as +inf / -1; sentinel rows keep their >= 1e29
    penalty and never win."""
    rows0 = rows.clamp_min(0)
    cross = torch.matmul(vectors[rows0], queries[:, :, None])[..., 0]  # (q, kk)
    norms_sel = row_norms[rows0]
    if metric == "l2":
        exact = (sq_norms(queries)[:, None] - 2.0 * cross + norms_sel).clamp_min(0.0)
    else:
        exact = -cross + torch.where(norms_sel >= 1e29, norms_sel, torch.zeros_like(norms_sel))
    return _narrow(torch.where(rows >= 0, exact, float("inf")), rows, k)


def stream_program(queries, centroids, c_sq, table, *, k: int, n_probe: int,
                   t_fixed: int, q_tile: int, metric: str, approx: bool = True,
                   shared: bool = False, t_cap: int = 0, rerank_from=None, probe_fn=None):
    """Probed-blocks-only search over a stream table. ``shared`` runs K5
    (``t_cap`` tasks per query tile). ``rerank_from`` = (vectors,
    row_norms) of the f32 main table re-ranks the widened shortlist
    exactly, hoisted out of the sweep's tile loop into tiles of up to
    RERANK_Q_TILE queries; without it the kernel distances are narrowed
    to k. ``probe_fn(qt)`` -> (q, p) probe ids, nearest first, replaces the
    coarse top-n_probe (the sharded searchers pass their local probes)."""
    wide = 4 if table.dtype == torch.int8 else 2
    kk = shortlist_k(k, t_fixed, table.chunk, wide)
    dv_parts, row_parts = [], []
    for s in range(0, queries.shape[0], q_tile):
        qt = queries[s : s + q_tile]
        with trace("search.probe", level=DEBUG):
            probe = _probe(qt, centroids, c_sq, n_probe) if probe_fn is None else probe_fn(qt)
        with trace("search.sweep", level=DEBUG):
            if shared:
                dv, rows = block_stream_search_shared(
                    qt, table, probe, kk, t_fixed=t_fixed, t_cap=t_cap, metric=metric
                )
            else:
                dv, rows = block_stream_search(
                    qt, table, probe, kk, t_fixed=t_fixed, metric=metric, approx=approx
                )
        dv_parts.append(dv)
        row_parts.append(rows)
    with trace("search.select", level=DEBUG):
        dvals = torch.cat(dv_parts)
        rows = torch.cat(row_parts)
        if rerank_from is not None:
            vectors, row_norms = rerank_from
            rt = max(q_tile, RERANK_Q_TILE // q_tile * q_tile)
            parts = [exact_rerank(queries[s : s + rt], rows[s : s + rt], vectors, row_norms,
                                  k, metric) for s in range(0, queries.shape[0], rt)]
            return torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])
        if metric == "l2":
            # Kernel distances are |q - (c + r^)|^2 from exact f32 pieces; the
            # three-term sum can leave ~-1e-5 on (near-)self matches.
            dvals = torch.where(torch.isfinite(dvals), dvals.clamp_min(0.0), dvals)
        return _narrow(dvals, rows, k)


def _probe_sets(queries, centroids_ord, c_sq_ord, n_probe: int):
    """(q, kc) bool probe sets in layout-run order, and each query's nearest
    cluster (its run index). A cluster is probed when its coarse distance
    is <= the n_probe-th smallest (ties all probed)."""
    dcoarse = score(queries, centroids_ord, c_sq_ord, sq_norms(queries), "l2")
    thresh = torch.kthvalue(dcoarse, n_probe, dim=1, keepdim=True).values
    return dcoarse <= thresh, torch.argmin(dcoarse, dim=1)


def _expand_mask(s_ord, block_run):
    """(q, n_blocks) bool mask over 8-row blocks: each block takes its run's
    membership. ``block_run`` maps a block to the last run starting at or
    before it (-1: none), which is what the reference's scattered run-start
    deltas + prefix sum evaluate to."""
    return s_ord[:, block_run.clamp_min(0)] & (block_run >= 0)[None, :]


def _block_mask(queries, centroids_ord, c_sq_ord, block_run, n_probe: int):
    """(q, n_blocks) bool probe mask over 8-row blocks."""
    return _expand_mask(_probe_sets(queries, centroids_ord, c_sq_ord, n_probe)[0], block_run)


def _sweep_mask(s_ord, block_run, mcols: int):
    """``_expand_mask`` padded with unprobed blocks to ``mcols`` columns (the
    sweep's whole steps), built by one gather: blocks of no run and the
    padding read an appended all-False column."""
    kc = s_ord.shape[1]
    cols = torch.full((mcols,), kc, dtype=torch.long, device=s_ord.device)
    nb = block_run.shape[0]
    cols[:nb] = torch.where(block_run >= 0, block_run, kc)
    return torch.cat([s_ord, s_ord.new_zeros((s_ord.shape[0], 1))], dim=1)[:, cols]


def _plane_topk(vals, rows, qt, k: int, metric: str):
    """Top-k of a fused sweep's plane; |q|^2 is added after it (it is
    constant per query), and sentinel rows never count as results."""
    dv, pos = topk_smallest(vals, k)
    rsel = torch.gather(rows.long(), 1, pos.clamp_min(0))
    if metric == "l2":
        dv = (dv + sq_norms(qt)[:, None]).clamp_min(0.0)
    real = torch.isfinite(dv) & (dv < SENTINEL_THRESHOLD) & (pos >= 0)
    return torch.where(real, dv, float("inf")), torch.where(real, rsel, torch.full_like(rsel, -1))


def _real_topk(dist, k: int):
    """Exact top-k of a distance matrix; sentinel rows never count."""
    dv, rows = topk_smallest(dist, k)
    real = torch.isfinite(dv) & (dv < SENTINEL_THRESHOLD)
    return torch.where(real, dv, float("inf")), torch.where(real, rows, torch.full_like(rows, -1))


def _cat(parts):
    return torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])


def dense_fused_program(queries, centroids_ord, c_sq_ord, vectors, row_norms,
                        block_run, n_probe: int, vec_resid=None, scale_row=None, *, k: int,
                        w: int, c_groups: int, metric: str, precision: str = "highest",
                        probe_sets=None):
    """Masked dense sweep through kernel K3. ``precision`` 'int8' /
    'int8x1' sweeps the int8 codes ``vectors`` with ``scale_row`` (and
    ``vec_resid`` for 'int8'); norms stay the f32 table's.
    ``probe_sets(qt)`` -> (probe sets, nearest run) replaces
    ``_probe_sets`` (the sharded searchers' global threshold).

    Each launch sweeps its queries sorted by their nearest probe (stable),
    so that the queries of one 64-query kernel tile share probes and the
    kernel skips the table tiles none of them probes; the results are put
    back in arrival order. Each query's result depends only on its own row
    and mask, so the output is the same as in arrival order."""
    NB = S * w
    mcols = -(-vectors.shape[0] // NB) * NB // ALIGN
    parts = []
    for s in range(0, queries.shape[0], SWEEP_Q_TILE):
        qt = queries[s : s + SWEEP_Q_TILE]
        with trace("search.probe", level=DEBUG):
            s_ord, nearest = (_probe_sets(qt, centroids_ord, c_sq_ord, n_probe)
                              if probe_sets is None else probe_sets(qt))
            perm = torch.argsort(nearest, stable=True)
            qt, s_ord = qt[perm], s_ord[perm]
            mask = _sweep_mask(s_ord, block_run, mcols)
        with trace("search.sweep", level=DEBUG):
            vals, rows = flat_sweep_topk_plane(
                qt, vectors, row_norms, mask, vec_resid, scale_row, metric=metric, w=w,
                c_groups=c_groups, precision=precision,
            )
        with trace("search.select", level=DEBUG):
            dv, rv = _plane_topk(vals, rows, qt, k, metric)
            parts.append((dv.new_empty(dv.shape).index_copy_(0, perm, dv),  # arrival order
                          rv.new_empty(rv.shape).index_copy_(0, perm, rv)))
    return _cat(parts)


def flat_fused_program(queries, vectors, row_norms, vec_resid=None, scale_row=None, *,
                       k: int, w: int, c_groups: int, metric: str, precision: str = "highest"):
    """Exhaustive sweep through kernel K3 (no mask), then the plane's
    top-k; the int8 precisions as in ``dense_fused_program``."""
    parts = []
    for s in range(0, queries.shape[0], SWEEP_Q_TILE):
        qt = queries[s : s + SWEEP_Q_TILE]
        with trace("search.sweep", level=DEBUG):
            vals, rows = flat_sweep_topk_plane(
                qt, vectors, row_norms, None, vec_resid, scale_row, metric=metric, w=w,
                c_groups=c_groups, precision=precision,
            )
        with trace("search.select", level=DEBUG):
            parts.append(_plane_topk(vals, rows, qt, k, metric))
    return _cat(parts)


def dense_program(queries, centroids_ord, c_sq_ord, vectors, row_norms, block_run,
                  n_probe: int, *, k: int, q_tile: int, metric: str, probe_sets=None):
    """Plain masked dense search: full (q_tile, n) distance matrix, unprobed
    rows +inf, exact top-k; sentinel rows never count as results.
    ``probe_sets`` as in ``dense_fused_program``."""
    parts = []
    for s in range(0, queries.shape[0], q_tile):
        qt = queries[s : s + q_tile]
        with trace("search.probe", level=DEBUG):
            mask = (_block_mask(qt, centroids_ord, c_sq_ord, block_run, n_probe)
                    if probe_sets is None else _expand_mask(probe_sets(qt)[0], block_run))
        with trace("search.sweep", level=DEBUG):
            dist = score(qt, vectors, row_norms, sq_norms(qt), metric)
            dist = torch.where(mask.repeat_interleave(ALIGN, dim=1), dist, float("inf"))
        with trace("search.select", level=DEBUG):
            parts.append(_real_topk(dist, k))
    return _cat(parts)


def flat_program(queries, vectors, row_norms, *, k: int, q_tile: int, metric: str):
    """Plain exhaustive search: full (q_tile, n) distance matrix and an
    exact top-k; sentinel rows never count as results."""
    parts = []
    for s in range(0, queries.shape[0], q_tile):
        qt = queries[s : s + q_tile]
        with trace("search.sweep", level=DEBUG):
            dist = score(qt, vectors, row_norms, sq_norms(qt), metric)
        with trace("search.select", level=DEBUG):
            parts.append(_real_topk(dist, k))
    return _cat(parts)


def gather_program(queries, centroids, c_sq, vectors, row_norms, starts, lengths, *, k: int,
                   n_probe: int, budget: int, q_tile: int, metric: str):
    """Exact packed gather: per tile, the coarse top-n_probe, the probed
    lists' rows packed head to tail into ``budget`` slots, their exact f32
    distances, and an exact top-k. ``starts`` / ``lengths``: (nlist,) list
    start rows and lengths on the device."""
    pad_row = vectors.shape[0] - 1  # a zero tail row; invalid slots are +inf anyway
    parts = []
    for s in range(0, queries.shape[0], q_tile):
        qt = queries[s : s + q_tile]
        with trace("search.probe", level=DEBUG):
            probe = _probe(qt, centroids, c_sq, n_probe)
            rows, valid = packed_candidate_rows(starts[probe], lengths[probe], budget, pad_row)
        with trace("search.sweep", level=DEBUG):
            cross = torch.matmul(vectors[rows], qt[:, :, None])[..., 0]  # (q, budget)
            norms_sel = row_norms[rows]
            if metric == "l2":
                dist = (sq_norms(qt)[:, None] - 2.0 * cross + norms_sel).clamp_min(0.0)
            else:
                dist = -cross + torch.where(norms_sel >= 1e29, norms_sel,
                                            torch.zeros_like(norms_sel))
        with trace("search.select", level=DEBUG):
            parts.append(_narrow(torch.where(valid, dist, float("inf")), rows, k))
    return _cat(parts)


def gather_dma_program(queries, centroids, c_sq, vectors, starts, lengths, *, k: int,
                       n_probe: int, max_len: int, budget: int, q_tile: int, metric: str):
    """Range gather through kernel K6: per tile of ``q_tile`` queries (which
    bounds the (q_tile, budget_pad) slot planes), the coarse top-n_probe,
    K6's packed distances and an exact top-k."""
    parts = []
    for s in range(0, queries.shape[0], q_tile):
        qt = queries[s : s + q_tile]
        with trace("search.probe", level=DEBUG):
            probe = _probe(qt, centroids, c_sq, n_probe)
        with trace("search.sweep", level=DEBUG):
            dist, rows = ivf_gather_distances(qt, vectors, starts[probe], lengths[probe],
                                              max_len=max(1, max_len), budget=budget,
                                              metric=metric)
        with trace("search.select", level=DEBUG):
            parts.append(_narrow(dist, rows.long(), k))
    return _cat(parts)
