"""Offloaded (larger-than-device-memory) serving for IvfIndex, and the
shortlist epilogues that spilled indexes share.

Port of ``vector_indexer_tpu/index/offload.py``:

* the mode's entry points: ``offload_main_table`` (a device-resident index
  frees its f32 table) and ``offload_from_host`` (a host layout's rows go
  to the device a chunk at a time through pinned staging, which builds the
  compact table from them and keeps only it, so the f32 corpus never
  stays on the device);
* the three re-ranks of the widened shortlist that the int8 stream sweep
  (kernels K2/K4, or K5 at huge probed footprints) selects: 'host' (exact,
  from the host mirror), 'device' (against the two-layer int8
  reconstruction of ops/correction.py) and 'none' (the sweep's own
  ranking, through ``search_batch_device``);
* the spill epilogues: ``dedup_topk`` (device) and ``host_dedup_topk``
  drop the repeated ids of a spilled index's (1+spill)k-wide candidate
  lists, as do the offloaded re-ranks and the staged search.

This is the design point of an index bigger than device memory, with
device memory : host RAM in the role of RAM : disk.
"""

from __future__ import annotations

import logging
from logging import DEBUG

import numpy as np
import torch

from ..device import on_device
from ..ops.block_stream import build_stream_table_from_rows
from ..ops.correction import build_correction_table, build_correction_table_host
from ..ops.distance import sq_norms
from ..ops.topk import topk_smallest
from ..storage.staging import staged_rows
from ..utils import tracing
from ..utils.tracing import trace
from .tables import DeviceTables

log = logging.getLogger("vector_indexer_tpu_torch")

RERANKS = ("host", "device", "none")
# Shortlist width of the re-ranked modes: min(max(2k, 128), 4096). The
# reference measured at n = 1M clustered d = 128 that the exact top-100
# from a 2k int8-ranked shortlist equals the 4k one at n_probe 8-32.
_RERANK_MULT, _RERANK_MIN, _RERANK_MAX = 2, 128, 4096
# Batches of at least this many queries are split in two, so the host
# re-rank of the first half overlaps the device sweep of the second.
_PIPELINE_MIN_NQ = 512


def _smallest(dist, k: int):
    """Smallest k along dim 1 by a stable sort (equal distances keep their
    order, as the reference's top_k does), padded +inf / -1 past the
    width."""
    vals, order = torch.sort(dist, dim=1, stable=True)
    vals, order = vals[:, :k], order[:, :k]
    if order.shape[1] < k:
        pad = k - order.shape[1]
        vals = torch.cat([vals, vals.new_full((vals.shape[0], pad), float("inf"))], dim=1)
        order = torch.cat([order, order.new_full((order.shape[0], pad), -1)], dim=1)
    return vals, order


def dedup_topk(dvals, rows, perm_dev, k: int):
    """Drop repeated internal ids from a (nq, kk) distance-sorted candidate
    list of layout rows (a spilled index can return a vector from each of
    its cells), keep the first occurrence (the smaller distance) and select
    the top k in distance order. ``perm_dev`` maps layout rows to internal
    ids (``DeviceTables.row_internal``). A stable sort by id marks each
    id's later occurrences. -> (D (nq, k), layout rows (nq, k)), padded
    +inf / -1."""
    ids = torch.where(rows >= 0, perm_dev[rows.clamp_min(0)], -1)
    order = torch.argsort(ids, dim=1, stable=True)
    ids_s = torch.gather(ids, 1, order)
    dup_s = torch.zeros_like(ids_s, dtype=torch.bool)
    dup_s[:, 1:] = (ids_s[:, 1:] == ids_s[:, :-1]) & (ids_s[:, 1:] >= 0)
    dup = torch.empty_like(dup_s).scatter_(1, order, dup_s)
    dist = torch.where(dup | (rows < 0), float("inf"), dvals)
    dv, sel = _smallest(dist, k)
    rsel = torch.gather(rows, 1, sel.clamp_min(0))
    ok = (sel >= 0) & torch.isfinite(dv)
    return dv, torch.where(ok, rsel, torch.full_like(rsel, -1))


def host_dedup_topk(exact, internal, k: int):
    """Host twin of ``dedup_topk`` over internal ids: sort a (nq, kk)
    candidate list by distance, drop repeated ids (the first, smallest,
    stays), and keep the first k survivors, padded +inf / -1."""
    exact = np.where(internal >= 0, exact, np.inf)
    order = np.argsort(exact, axis=1, kind="stable")
    ids_o = np.take_along_axis(internal, order, axis=1)
    d_o = np.take_along_axis(exact, order, axis=1)
    oi = np.argsort(ids_o, axis=1, kind="stable")
    ids_s = np.take_along_axis(ids_o, oi, axis=1)
    dup_s = np.zeros_like(ids_s, bool)
    dup_s[:, 1:] = (ids_s[:, 1:] == ids_s[:, :-1]) & (ids_s[:, 1:] >= 0)
    dup = np.empty_like(dup_s)
    np.put_along_axis(dup, oi, dup_s, axis=1)
    keep = (~dup) & (ids_o >= 0) & np.isfinite(d_o)
    kw = min(k, exact.shape[1])
    sel = np.argsort(~keep, axis=1, kind="stable")[:, :kw]
    taken = np.take_along_axis(keep, sel, axis=1)
    D = np.where(taken, np.take_along_axis(d_o, sel, axis=1), np.inf).astype(np.float32)
    I = np.where(taken, np.take_along_axis(ids_o, sel, axis=1), -1)
    if kw < k:
        D = np.pad(D, ((0, 0), (0, k - kw)), constant_values=np.inf)
        I = np.pad(I, ((0, 0), (0, k - kw)), constant_values=-1)
    return D, I.astype(np.int64)


def _check(idx, rerank: str) -> None:
    if rerank not in RERANKS:
        raise ValueError("rerank must be 'host', 'device', or 'none'")
    if idx.layout is None:
        raise RuntimeError("index is empty: fit or load it first")
    if rerank == "host" and idx._host_data is None:
        raise RuntimeError("offload with rerank='host' requires the host mirror (fit/load create it)")


def offload_main_table(idx, stream_dtype=None, rerank: str = "host") -> None:
    """Free the f32 main table (and its norms) from the device and serve
    from a compact stream table (int8 by default: 4x fewer bytes than
    f32). ``rerank``: 'host' re-ranks the widened shortlist exactly from the
    host mirror; 'device' re-ranks it on the device against the two-layer
    reconstruction (+ d + 4 bytes per row; p99 relative distance error
    ~1e-5); 'none' returns the sweep's ranking (distances carry the int8
    quantization error). Afterwards only the stream methods serve.
    Irreversible on this object (reload to undo)."""
    _check(idx, rerank)
    if idx.host_resident:
        raise RuntimeError("index is host-resident (staged serving); offload needs a "
                           "device-resident layout: reload with resident='device' first")
    if not isinstance(idx.layout.vectors, torch.Tensor):
        raise RuntimeError("index is not device-resident; use offload_from_host()")
    dtype = torch.int8 if stream_dtype is None else stream_dtype
    st = idx.tables().stream(dtype)  # built BEFORE its f32 source goes
    lay = idx.layout
    norms = _by_internal(idx, lay.row_norms[: lay.rows_used]) if rerank == "host" else None
    _install(idx, dtype, st, rerank, "correction_table.build", build_correction_table, norms)


def offload_from_host(idx, stream_dtype=None, rerank: str = "host") -> None:
    """Enter offload serving from a HOST layout (a host fit, or
    ``load_index_from(..., resident='offload')``): the layout's rows go to
    the device a staging buffer at a time, which builds the stream table
    from them (``build_stream_table_from_rows``) and keeps only it, so the
    f32 table never stays on the device, and a host layout not yet gathered
    (``PostingLayout.rows_into``) is never gathered. The same pass gives
    the rows' norms that rerank='host' reads. rerank='device' builds its
    correction table on the host (``build_correction_table_host``). Same
    serving semantics as ``offload_main_table``."""
    _check(idx, rerank)
    lay = idx.layout
    if not lay.on_host:
        raise RuntimeError(
            "layout is device-resident; use offload_main_table() "
            "(offload_from_host is for host-staged layouts)"
        )
    dtype = torch.int8 if stream_dtype is None else stream_dtype
    dev = idx.device
    with trace("offload.table", sync=dev, dtype=str(dtype)), on_device(dev):
        cuda = dev.type == "cuda"
        chunks = staged_rows(lay.rows_used, lay.dim, lay.rows_into, cuda)
        st, row_sq = build_stream_table_from_rows(lay, idx.centroids, chunks, dtype, device=dev)
        norms = _by_internal(idx, row_sq) if rerank == "host" else None
    _install(idx, dtype, st, rerank, "correction_table.build_host", build_correction_table_host,
             norms)


def _by_internal(idx, row_sq: torch.Tensor) -> np.ndarray:
    """(n,) float32 |x|^2 by internal id, from ``row_sq`` (one a layout row,
    over the rows in use), copied back once."""
    sq = row_sq.cpu().numpy()
    perm = idx.layout.perm
    real = perm >= 0
    out = np.zeros(idx._host_data.shape[0], np.float32)
    out[perm[real]] = sq[real]
    return out


def _install(idx, dtype, st, rerank: str, corr_span: str, build_corr, host_norms) -> None:
    """Serve offloaded: a new owner holds only ``st``, ``host_norms`` and,
    for 'device', the correction table (offload exists to minimise device
    residency); then the f32 table goes, while ``st``'s to_main map still
    names its rows."""
    lay, corr = idx.layout, None
    if rerank == "device":
        with trace(corr_span, sync=idx.device):
            corr = build_corr(lay, st)
    idx._set_tables(DeviceTables(lay, idx.centroids, idx.external_ids, idx.device,
                                 rows=lay.table_shape[0], streams={dtype: st}, corr=corr,
                                 host_norms=host_norms))
    idx._offload_rerank = rerank
    idx.stream_dtype = dtype
    lay.vectors = None
    lay.row_norms = None
    idx.offloaded = True
    idx.host_resident = False
    log.info("offloaded: stream dtype %s, %d MB resident", dtype, st.nbytes >> 20)


def _shortlist(k: int) -> int:
    return min(max(_RERANK_MULT * k, _RERANK_MIN), _RERANK_MAX)


def search_offloaded(idx, queries, k: int, n_probe: int, method: str = "auto"):
    """rerank='host': a widened shortlist from the device sweep ((1+spill)
    times wider on a spilled index), re-ranked exactly from the host mirror
    (and de-duplicated when spilled). A batch of _PIPELINE_MIN_NQ queries or
    more is split in two, and both halves' sweeps are enqueued before the
    host waits for the first: each half's rows are copied to pinned host
    memory right behind its sweep, so the host re-ranks half 1 while the
    device sweeps half 2. The method is resolved once, at the full batch
    size, so the split cannot change the choice. Spans: ``offload.sweep``
    (a half's sweep and its copy back, enqueued), ``offload.wait`` (the
    host blocked on a half's shortlist), ``offload.rerank`` (a half's host
    re-rank); the counter ``offload.rerank_rows`` takes the rows gathered
    from the mirror."""
    queries = np.ascontiguousarray(queries, np.float32)
    if queries.ndim == 1:
        queries = queries[None, :]
    nq = queries.shape[0]
    kk = (1 + idx.spill) * _shortlist(k)
    if method == "auto":
        method = idx.choose_method(nq, n_probe)
    pieces = 2 if nq >= _PIPELINE_MIN_NQ else 1
    bounds = [(i * nq // pieces, (i + 1) * nq // pieces) for i in range(pieces)]
    pending = []
    for a, b in bounds:
        with trace("offload.sweep", level=DEBUG):
            _, rows = idx._search_rows(queries[a:b], kk, n_probe, method)
            pending.append(_copy_to_host(rows))
    outs = []
    for (a, b), p in zip(bounds, pending):
        with trace("offload.wait", level=DEBUG):
            rows = _wait(p)
        with trace("offload.rerank", level=DEBUG):
            outs.append(offload_rerank_piece(idx, queries[a:b], rows, k, idx.spill))
    if tracing.recording_now():
        tracing.count("offload.rerank_rows", torch.tensor(float(nq * kk)))
    return (np.concatenate([o[0] for o in outs], axis=0),
            np.concatenate([o[1] for o in outs], axis=0))


def _copy_to_host(t: torch.Tensor):
    """Enqueue a device -> host copy; returns what ``_wait`` needs."""
    if t.device.type != "cuda":
        return t, None
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(t.device))
    return host, done


def _wait(pending) -> np.ndarray:
    host, done = pending
    if done is not None:
        done.synchronize()
    return host.numpy()


def offload_rerank_piece(idx, queries, rows, k: int, spill: int = 0):
    """Host half of the rerank='host' search for one piece of the batch:
    exact f32 distances of the device shortlist from the host mirror, then
    the top k (without repeated ids when ``spill``)."""
    internal = idx.rows_to_internal(rows)
    q = queries
    if idx.metric == "cosine":
        q = q / np.maximum(np.linalg.norm(q, axis=1, keepdims=True), 1e-12)
    cand = idx._host_data[np.maximum(internal, 0)]  # (nq, kk, d)
    # One batched matmul streams the gathered block once.
    cross = np.matmul(cand, q[:, :, None])[..., 0]
    if idx.metric == "l2":
        norms = idx.tables().host_norms
        exact = np.maximum(
            (q * q).sum(1)[:, None] - 2.0 * cross + norms[np.maximum(internal, 0)], 0.0)
    else:
        exact = -cross
    if spill:
        return host_dedup_topk(exact, internal, k)
    return _host_topk(exact, internal, k)


def _host_topk(exact, internal, k: int):
    """Host top-k of a (nq, kk) candidate list: argpartition to the k head,
    then sort only the head. Padded +inf / -1."""
    exact = np.where(internal >= 0, exact, np.inf).astype(np.float32)
    kw = min(k, exact.shape[1])
    if kw < exact.shape[1]:
        part = np.argpartition(exact, kw - 1, axis=1)[:, :kw]
        o = np.argsort(np.take_along_axis(exact, part, axis=1), axis=1, kind="stable")
        sel = np.take_along_axis(part, o, axis=1)
    else:
        sel = np.argsort(exact, axis=1, kind="stable")
    D = np.take_along_axis(exact, sel, axis=1)
    I = np.where(np.isfinite(D), np.take_along_axis(internal, sel, axis=1), -1)
    if kw < k:
        D = np.pad(D, ((0, 0), (0, k - kw)), constant_values=np.inf)
        I = np.pad(I, ((0, 0), (0, k - kw)), constant_values=-1)
    return D, I.astype(np.int64)


def _corrected_rerank_program(queries, rows, st, corr, perm_dev=None, *, k: int, metric: str,
                              rr_tile: int):
    """Device half of rerank='device': re-rank the widened shortlist
    against x^ = c + s1 r8 + s2 q2, in query tiles of ``rr_tile`` (which
    bounds the (rr, kk, d) f32 reconstruction). With ``perm_dev`` (a
    spilled index) the list is sorted by corrected distance and repeated
    ids dropped (``dedup_topk``). -> (D, layout rows)."""
    parts = []
    for s in range(0, queries.shape[0], rr_tile):
        qt, rw = queries[s : s + rr_tile], rows[s : s + rr_tile]
        srow = corr.inv[rw.clamp_min(0)]
        cid = st.blk_cid[srow // st.chunk]
        xhat = st.vecs[srow].to(torch.float32).mul_(st.scales[cid][..., None])
        xhat += corr.q2[srow].to(torch.float32).mul_(corr.scales2[cid][..., None])
        xhat += st.cent[cid]
        cross = torch.matmul(xhat, qt[:, :, None])[..., 0]
        if metric == "l2":
            dist = (sq_norms(qt)[:, None] - 2.0 * cross + corr.norms_abs[srow]).clamp_min(0.0)
        else:
            dist = -cross
        parts.append(torch.where(rw < 0, float("inf"), dist))
    dist = torch.cat(parts)
    if perm_dev is not None:
        dv, order = _smallest(dist, dist.shape[1])
        rows_s = torch.where(order >= 0, torch.gather(rows, 1, order.clamp_min(0)), -1)
        return dedup_topk(dv, rows_s, perm_dev, k)
    dv, order = topk_smallest(dist, k)
    rsel = torch.gather(rows, 1, order.clamp_min(0))
    ok = (order >= 0) & torch.isfinite(dv)
    return dv, torch.where(ok, rsel, torch.full_like(rsel, -1))


def search_offloaded_device(idx, queries, k: int, n_probe: int, method: str = "auto"):
    """rerank='device': the widened shortlist from the device sweep,
    re-ranked on the device against the two-layer reconstruction (and
    de-duplicated when spilled); rows map
    to internal ids on the device too (``DeviceTables.row_internal``), so one small
    copy reaches the host."""
    q = idx._queries_on_device(queries)
    nq, d = q.shape
    kk = (1 + idx.spill) * _shortlist(k)
    if method == "auto":
        method = idx.choose_method(nq, n_probe)
    _, rows = idx._search_rows(q, kk, n_probe, method)
    # A query tile bounding the (rr, kk, d) f32 reconstruction to ~128 MB.
    rr = min(nq, max(1, (1 << 25) // max(kk * d, 1)))
    metric = idx.metric if idx.metric != "cosine" else "ip"
    tables = idx.tables()
    perm = tables.row_internal
    dv, rsel = _corrected_rerank_program(
        q, rows, tables.streams[idx.stream_dtype], tables.corr,
        perm if idx.spill else None, k=k, metric=metric, rr_tile=rr,
    )
    internal = perm[rsel]  # -1 (no result) reads the table's trailing -1
    return dv.cpu().numpy(), internal.cpu().numpy()
