"""Sharded IVF search over a device mesh (1-D: every device holds a slice of
the posting lists; queries and the centroid table are replicated).

Port of ``vector_indexer_tpu/parallel/sharded.py``. Whole shards (the
super-centroid groups of the layout, contiguous row ranges) are balanced
over the devices by row count (greedy LPT). The plan of the slices
(``plan_local_tables``) holds no rows: each device's rows are copied
straight from the posting layout onto that device (``pack_rows``: from a
host layout through two pinned staging buffers a card), so the host never
holds a device's table, and the residual stream tables are built on each
device from its rows (``slice_stream_table``); each card packs and builds
from a thread of its own (``on_each``). ``build_local_tables``
and ``build_local_stream_tables`` are the same tables stacked on the host,
the reference's arrays. Per device and per call:

1. the GLOBAL probe threshold: the n_probe-th smallest coarse distance over
   every centroid (replicated compute, no communication). A device probes
   each of its cells at or below it, ties included, so at a tie the mesh
   probes more cells than the single-device top-n_probe does;
2. one of three bodies over the device's slice, each the single-device
   program (``index/programs.py``) given the local probes:
   ``dense`` (the masked plain distance matrix, exact), ``dense_fused``
   (kernel K3's masked sweep at the ``plan_fused`` gate, else ``dense``)
   or ``stream`` (kernels K2 / K4 over a device-local residual stream
   table; unprobed slots go to a zero-length pad probe, cell kc_local);
3. the merge: every device's (nq, kk) partial list is gathered to the
   mesh's first device and one stable top-k over them, in device order,
   gives the result (the reference's ``all_gather`` + top-k, whose ties
   break the same way).

The per-device loop only enqueues work (no size read, ``.item()`` or copy
to the host), so distinct cards run their bodies at the same time; the
results reach the host once, after the merge. Each body runs with its
card as the current CUDA device (the kernels launch on the current one).
A repeated call shape replays each card's body as one captured CUDA graph
(``parallel/graphs.py``). Layout rows map to internal ids on the host, and
the 1-D searcher's to external ids; a spilled index searches (1+spill)k wide
and drops repeated ids there (``offload.host_dedup_topk``). While spans
record, each call adds the rows of the cells each device probes to the
counter ``sharded.probed_rows.<slice>``, on that device.
"""

from __future__ import annotations

import dataclasses
from concurrent.futures import ThreadPoolExecutor
from logging import DEBUG
from typing import Optional, Tuple

import numpy as np
import torch

from ..device import on_device
from ..index import programs
from ..index.dispatch import (choose_sweep_body, fused_sweep_fits, pick_q_tile,
                              stream_itemsize, stream_q_tile)
from ..index.offload import host_dedup_topk
from ..ops.block_stream import FAN, StreamTable, pick_chunk
from ..ops.distance import sq_norms
from ..ops.flat_sweep import plan_fused
from ..ops.gather import quantize_up
from ..storage.layout import ALIGN, SENTINEL_NORM, SENTINEL_THRESHOLD
from ..storage.staging import staged_rows
from ..utils import tracing
from ..utils.tracing import trace
from .graphs import ShardGraphs
from .mesh import Mesh

METHODS = ("auto", "dense", "dense_fused", "stream")
_TILE_BYTES = 256 << 20  # f32 rows per tile of the on-device norm and residual passes


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _round_up_arr(x, m):
    return ((x + m - 1) // m) * m


def on_each(devices: list, fn) -> list:
    """[fn(j) for each entry j of ``devices``] with ``devices[j]`` current.
    On cards, each distinct card's entries run in turn in a thread of its
    own: a thread that waits on its card (a copy back, a full launch queue,
    a host copy into its staging) leaves the others working, so the cards
    work at once. CPU entries run in turn on the caller's thread (threads
    would only contend for the cores their ops already use)."""

    def run(j):
        with on_device(devices[j]):
            return fn(j)

    if devices[0].type != "cuda":
        return [run(j) for j in range(len(devices))]
    groups: dict = {}
    for j, dev in enumerate(devices):
        groups.setdefault(dev, []).append(j)
    out = [None] * len(devices)

    def card(js):
        for j in js:
            out[j] = run(j)

    with ThreadPoolExecutor(len(groups)) as pool:
        list(pool.map(card, groups.values()))
    return out


def pairwise_row_sums(x: torch.Tensor) -> torch.Tensor:
    """Row sums of a 2-D tensor in the order of numpy's pairwise summation
    (``np.add.reduce`` along a contiguous last axis: eight running sums per
    block of up to 128 columns, halves past that), so that float64 sums
    equal numpy's bit for bit on any device."""
    m, n = x.shape
    if n < 8:
        out = torch.zeros(m, dtype=x.dtype, device=x.device)
        for i in range(n):
            out = out + x[:, i]
        return out
    if n <= 128:
        body = n - n % 8
        r = x[:, 0:8]
        for i in range(8, body, 8):
            r = r + x[:, i:i + 8]
        r = r[:, 0::2] + r[:, 1::2]
        r = r[:, 0::2] + r[:, 1::2]
        out = r[:, 0] + r[:, 1]
        for i in range(body, n):
            out = out + x[:, i]
        return out
    half = n // 2
    half -= half % 8
    return pairwise_row_sums(x[:, :half]) + pairwise_row_sums(x[:, half:])


def sq_norms_f64(x: torch.Tensor) -> torch.Tensor:
    """(m,) float32 squared norms of float32 rows, summed in float64 as
    ``(rows.astype(np.float64) ** 2).sum(1)`` sums them, then rounded."""
    return pairwise_row_sums(x.double() ** 2).float()


# ---------------------------------------------------------------------------
# The plan of the slices, and each device's rows and stream table
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class LocalTables:
    """Per-device tables (numpy), the reference's arrays, plus each local
    cell's global id and the runs that copy each device's rows from the
    layout. In a plan (``plan_local_tables``) ``local_vecs`` and
    ``local_norms`` are read-only zero-stride views that give only the
    tables' shape: each device packs its own rows (``pack_rows``)."""

    local_vecs: np.ndarray  # (n_dev, rows, d) f32, ALIGN-aligned runs
    local_norms: np.ndarray  # (n_dev, rows) f32; SENTINEL on pads
    local_cent: np.ndarray  # (n_dev, kc_local, d) f32; zeros on pads
    local_csq: np.ndarray  # (n_dev, kc_local) f32; +inf on pads
    local_run_starts_b: np.ndarray  # (n_dev, kc_local) i32 local run blocks
    local_lengths: np.ndarray  # (n_dev, kc_local) i32; 0 on pads
    local_perm: np.ndarray  # (n_dev, rows) i64 -> internal id; -1 pads
    shard_to_dev: np.ndarray  # (num_shards,) i64
    cents: np.ndarray  # (kc, d) f32 global centroid table
    c_sq: np.ndarray  # (kc,) f32
    local_cid: np.ndarray  # (n_dev, kc_local) i64 global cell id; -1 on pads
    runs: list  # per device [(layout row, local row, rows)], covering its filled rows


def plan_local_tables(index, n_dev: int) -> LocalTables:
    """Partition the posting layout over ``n_dev`` devices: whole shards
    balanced by row count (greedy LPT), each device's cells in shard order,
    each run ALIGN-aligned, and the copy runs of each device's rows (each
    cell's aligned run of the layout, consecutive ones merged). No row is
    read."""
    with trace("sharded.pack", n_dev=n_dev):
        return _plan_local_tables(index, n_dev)


def _plan_local_tables(index, n_dev: int) -> LocalTables:
    lay = index.layout
    if lay is None:
        raise RuntimeError("index has no posting layout")
    starts = np.asarray(lay.offsets)[:-1]
    lengths = np.asarray(lay.lengths)
    kc = len(lengths)
    c2s = np.asarray(index.centroids_to_shard)
    perm = lay.perm

    shard_rows = np.zeros(index.num_shards, np.int64)
    for c in range(kc):
        shard_rows[c2s[c]] += lengths[c]
    order = np.argsort(-shard_rows, kind="stable")
    dev_rows = np.zeros(n_dev, np.int64)
    shard_to_dev = np.zeros(index.num_shards, np.int64)
    for s in order:
        d_ = int(np.argmin(dev_rows))
        shard_to_dev[s] = d_
        dev_rows[d_] += shard_rows[s]

    dim = index.dimension
    cluster_order = np.argsort(c2s, kind="stable")
    dev_clusters = [[] for _ in range(n_dev)]
    for c in cluster_order:
        dev_clusters[int(shard_to_dev[c2s[c]])].append(int(c))

    rows_per_dev = max(
        (sum(_round_up(int(lengths[c]), ALIGN) for c in cl) for cl in dev_clusters), default=0
    )
    rows_per_dev = _round_up(max(rows_per_dev, ALIGN) + ALIGN, ALIGN)
    kc_local = max(max((len(cl) for cl in dev_clusters), default=1), 1)

    # Pad cells keep +inf coarse distance and start past the block grid, so
    # they are never probed.
    local_cent = np.zeros((n_dev, kc_local, dim), np.float32)
    local_csq = np.full((n_dev, kc_local), np.inf, np.float32)
    local_run_starts_b = np.full((n_dev, kc_local), rows_per_dev // ALIGN, np.int32)
    local_lengths = np.zeros((n_dev, kc_local), np.int32)
    local_perm = np.full((n_dev, rows_per_dev), -1, np.int64)
    local_cid = np.full((n_dev, kc_local), -1, np.int64)
    runs = [[] for _ in range(n_dev)]

    cents = np.ascontiguousarray(index.centroids, np.float32)
    for d_, cl in enumerate(dev_clusters):
        fill = 0
        for i, c in enumerate(cl):
            m = int(lengths[c])
            s = int(starts[c])
            local_run_starts_b[d_, i] = fill // ALIGN
            local_lengths[d_, i] = m
            local_cent[d_, i] = cents[c]
            local_csq[d_, i] = (cents[c].astype(np.float64) ** 2).sum()
            local_cid[d_, i] = c
            local_perm[d_, fill : fill + m] = perm[s : s + m]
            size = _round_up(m, ALIGN)
            if size:
                last = runs[d_][-1] if runs[d_] else None
                if last is not None and last[0] + last[2] == s and last[1] + last[2] == fill:
                    runs[d_][-1] = (last[0], last[1], last[2] + size)
                else:
                    runs[d_].append((s, fill, size))
            fill += size

    return LocalTables(
        local_vecs=np.broadcast_to(np.float32(0.0), (n_dev, rows_per_dev, dim)),
        local_norms=np.broadcast_to(SENTINEL_NORM, (n_dev, rows_per_dev)),
        local_cent=local_cent, local_csq=local_csq, local_run_starts_b=local_run_starts_b,
        local_lengths=local_lengths, local_perm=local_perm, shard_to_dev=shard_to_dev,
        cents=cents, c_sq=(cents.astype(np.float64) ** 2).sum(1).astype(np.float32),
        local_cid=local_cid, runs=runs,
    )


def _layout_rows(index, lo: int, hi: int, out: Optional[np.ndarray] = None):
    """Layout rows lo:hi, written into ``out`` (a host array) where given: a
    host layout's rows, read without gathering a table not yet gathered
    (``PostingLayout.rows_into``); a view of a device table; or, where an
    offloaded index freed the table, the host mirror's rows gathered by
    ``perm`` (zeros on gap rows)."""
    lay = index.layout
    if lay.on_host:
        out = np.empty((hi - lo, lay.dim), np.float32) if out is None else out
        lay.rows_into(lo, hi, out)
        return out
    if lay.vectors is not None:
        return lay.vectors[lo:hi]
    p = np.full(hi - lo, -1, np.int64)
    got = lay.perm[lo:hi]
    p[: len(got)] = got
    rows = index._host_data[np.maximum(p, 0)]
    rows[p < 0] = 0.0
    if out is None:
        return rows
    out[:] = rows
    return out


def _staged_copy(dst: torch.Tensor, runs, rows_into) -> None:
    """Copy host rows into ``dst`` by ``runs`` (sorted, covering ``dst``'s
    rows 0 to the last run's end), through two staging buffers, pinned for
    a card (``staged_rows``): ``rows_into(lo, hi, out)`` writes source rows
    lo:hi into a view of a buffer."""
    r = 0

    def fill(lo: int, hi: int, view: np.ndarray) -> None:
        nonlocal r
        while runs[r][1] + runs[r][2] <= lo:
            r += 1
        for s, t, m in runs[r:]:
            if t >= hi:
                break
            a, b = max(lo, t), min(hi, t + m)
            rows_into(s + a - t, s + b - t, view[a - lo : b - lo])

    end = runs[-1][1] + runs[-1][2]
    for lo, hi, buf in staged_rows(end, dst.shape[1], fill, dst.is_cuda):
        dst[lo:hi].copy_(buf, non_blocking=dst.is_cuda)


def pack_rows(index, tables: LocalTables, j: int, dev: torch.device):
    """Slice ``j``'s (rows (rows, d) f32, norms (rows,) f32) on ``dev``,
    copied straight from the posting layout by the plan's runs: a host
    layout's rows through pinned staging (``_staged_copy``; a host table
    not yet gathered is read from its source, and never gathered whole), a
    tensor layout tensor to tensor. Rows of no vector are zero with SENTINEL norms; the
    norms are ``sq_norms_f64``'s, as ``build_local_tables`` gives them."""
    _, rows, d = tables.local_vecs.shape
    runs = tables.runs[j]
    with on_device(dev):
        vecs = torch.zeros((rows, d), dtype=torch.float32, device=dev)
        lay = index.layout
        if runs and dev.type == "cuda" and (lay.on_host or lay.vectors is None):
            _staged_copy(vecs, runs, lambda lo, hi, out: _layout_rows(index, lo, hi, out))
        else:
            for s, t, m in runs:
                vecs[t : t + m].copy_(torch.as_tensor(_layout_rows(index, s, s + m)))
        real = torch.as_tensor(tables.local_perm[j] >= 0, device=dev)
        vecs.masked_fill_(~real[:, None], 0.0)
        norms = torch.full((rows,), float(SENTINEL_NORM), dtype=torch.float32, device=dev)
        end = runs[-1][1] + runs[-1][2] if runs else 0
        step = max(ALIGN, _TILE_BYTES // (4 * d))
        for lo in range(0, end, step):
            hi = min(lo + step, end)
            norms[lo:hi] = torch.where(real[lo:hi], sq_norms_f64(vecs[lo:hi]), norms[lo:hi])
    return vecs, norms


def build_local_tables(index, n_dev: int) -> LocalTables:
    """The per-device tables stacked on the host (the reference's arrays):
    ``plan_local_tables`` and every slice's ``pack_rows`` on the CPU."""
    with trace("sharded.build_local_tables", n_dev=n_dev):
        t = plan_local_tables(index, n_dev)
        packed = [pack_rows(index, t, j, torch.device("cpu")) for j in range(n_dev)]
        return dataclasses.replace(t, local_vecs=np.stack([v.numpy() for v, _ in packed]),
                                   local_norms=np.stack([n.numpy() for _, n in packed]))


def stream_shape(tables: LocalTables, dtype: torch.dtype) -> Tuple[int, int]:
    """(chunk, m_pad) shared by every device's stream table: the chunk
    ``pick_chunk`` gives over all local lists, and the stream rows of the
    fullest device, whole chunks a list."""
    d = tables.local_vecs.shape[2]
    chunk = pick_chunk(tables.local_lengths.reshape(-1), d, stream_itemsize(dtype))
    sizes = _round_up_arr(np.maximum(tables.local_lengths, 0), chunk)
    return chunk, _round_up(int(max(sizes.sum(axis=1).max(), chunk)), chunk)


def stream_maps(tables: LocalTables, j: int, chunk: int, m_pad: int,
                dev: torch.device) -> dict:
    """Slice ``j``'s stream-table maps, the per-row ones built on ``dev``:
    each stream row's local row (``sto_local``; pads -> the last, zero row)
    and local cell (``row_cell``; pads -> kc_local, the pad probe), per block
    its cell (``blk_cid``), and per cell (host numpy) its first block
    (``sblk0``) and length (``slen``). Lists lie in cell order, each from a
    chunk boundary."""
    rows = tables.local_vecs.shape[1]
    ln = np.maximum(tables.local_lengths[j], 0).astype(np.int64)
    kc = len(ln)
    sizes = _round_up_arr(ln, chunk)
    base = np.cumsum(sizes) - sizes
    sblk0 = np.zeros(kc + 1, np.int32)
    sblk0[:kc] = np.where(ln > 0, base // chunk, 0)
    slen = np.zeros(kc + 1, np.int32)
    slen[:kc] = ln

    def t(a):
        return torch.as_tensor(a, dtype=torch.int64, device=dev)

    def repeat(counts):  # each cell id, counts[c] times
        return torch.repeat_interleave(torch.arange(kc, device=dev), t(counts),
                                       output_size=int(counts.sum()))

    cell = repeat(ln)
    offs = torch.arange(cell.shape[0], device=dev) - t(np.cumsum(ln) - ln)[cell]
    pos = t(base)[cell] + offs
    sto = torch.full((m_pad,), rows - 1, dtype=torch.int64, device=dev)
    sto[pos] = t(tables.local_run_starts_b[j].astype(np.int64) * ALIGN)[cell] + offs
    row_cell = torch.full((m_pad,), kc, dtype=torch.int64, device=dev)
    row_cell[pos] = cell
    blk_cid = torch.zeros(m_pad // chunk, dtype=torch.int64, device=dev)
    nb = sizes // chunk
    blk_cid[: int(nb.sum())] = repeat(nb)
    return dict(sto_local=sto, row_cell=row_cell, sblk0=sblk0, slen=slen, blk_cid=blk_cid)


def slice_stream_table(vecs: torch.Tensor, cent_l: np.ndarray, maps: dict, dtype: torch.dtype,
                       chunk: int, m_pad: int) -> StreamTable:
    """One slice's chunk-aligned RESIDUAL stream table, built on ``vecs``'
    device from its rows (the multi-device twin of
    ``ops.block_stream.build_stream_table``), in tiles of rows. Cell slot
    kc_local is the zero-length pad probe that unprobed slots are redirected
    to (a zero centroid row). int8 rows are symmetric per-cell quantized
    (scale max|r| / 127, taken in float64); norms are those of the rows as
    stored, ``sq_norms_f64``'s."""
    dev, d = vecs.device, vecs.shape[1]
    kc = cent_l.shape[0]
    with on_device(dev):
        cent = torch.as_tensor(np.concatenate([cent_l, np.zeros((1, d), np.float32)]),
                               device=dev)
        sto, cell = maps["sto_local"], maps["row_cell"]
        real = cell < kc
        step = max(ALIGN, _TILE_BYTES // (4 * d))

        def residual(lo, hi):  # pad rows: the zero last row less the zero centroid
            return vecs[sto[lo:hi]].sub_(cent[cell[lo:hi]])

        scales = torch.ones(kc + 1, dtype=torch.float32, device=dev)
        int8 = dtype == torch.int8
        if int8:
            smax = torch.zeros(kc + 1, dtype=torch.float32, device=dev)
            for lo in range(0, m_pad, step):
                hi = min(lo + step, m_pad)
                smax.scatter_reduce_(0, cell[lo:hi], residual(lo, hi).abs().amax(dim=1),
                                     reduce="amax")
            has = torch.as_tensor(maps["slen"] > 0, device=dev)
            scales = torch.where(has, (smax.double() / 127.0).clamp_min(1e-12).float(), scales)
        out = torch.empty((m_pad, d), dtype=dtype, device=dev)
        norms = torch.empty(m_pad, dtype=torch.float32, device=dev)
        sentinel = torch.tensor(float(SENTINEL_NORM), device=dev)
        for lo in range(0, m_pad, step):
            hi = min(lo + step, m_pad)
            res = residual(lo, hi)
            if int8:
                s = scales[cell[lo:hi]][:, None]
                q8 = torch.round(res / s).clamp_(-127, 127)
                out[lo:hi] = q8.to(torch.int8)
                stored = q8.mul_(s)
            else:
                out[lo:hi] = res.to(dtype)
                stored = out[lo:hi].to(torch.float32)
            norms[lo:hi] = torch.where(real[lo:hi], sq_norms_f64(stored), sentinel)

        def i64(name):
            return torch.as_tensor(maps[name].astype(np.int64), device=dev)

        return StreamTable(vecs=out, norms=norms, to_main=sto, sblk0=i64("sblk0"),
                           lengths=i64("slen"), cent=cent, blk_cid=maps["blk_cid"],
                           scales=scales, m_pad=m_pad, chunk=chunk)


def build_local_stream_tables(tables: LocalTables, dtype: torch.dtype) -> dict:
    """Per-device chunk-aligned RESIDUAL stream tables stacked on the host
    (``slice_stream_table`` of every slice of ``build_local_tables``' rows
    on the CPU): arrays with a leading n_dev axis (``svecs`` a CPU tensor of
    ``dtype``, the rest numpy), the common ``m_pad`` and ``chunk``."""
    n_dev = tables.local_vecs.shape[0]
    with trace("sharded.build_stream_tables", n_dev=n_dev, dtype=str(dtype)):
        chunk, m_pad = stream_shape(tables, dtype)
        cpu = torch.device("cpu")
        sts = [slice_stream_table(torch.from_numpy(tables.local_vecs[j]), tables.local_cent[j],
                                  stream_maps(tables, j, chunk, m_pad, cpu), dtype, chunk, m_pad)
               for j in range(n_dev)]

        def stack(field):
            return np.stack([getattr(st, field).numpy() for st in sts])

        return dict(svecs=torch.stack([st.vecs for st in sts]), snorms=stack("norms"),
                    scales=stack("scales"), sto_local=stack("to_main"), sblk0=stack("sblk0"),
                    slen=stack("lengths"), blk_cid=stack("blk_cid"), m_pad=m_pad, chunk=chunk)


def stream_slots(local_lengths: np.ndarray, n_probe: int, chunk: int) -> int:
    """Per-device task-slot budget of the sharded stream body: a device
    sees only the globally probed cells it owns, so its expected task count
    takes GLOBAL probe likelihoods (n_probe * len / n_total) over its cells;
    the budget covers the busiest device at ~1.25x its expectation (capped
    by its n_probe longest lists), on the single-device grid."""
    ln = np.asarray(local_lengths, np.float64)  # (n_dev, kc_local)
    n_total = max(ln.sum(), 1.0)
    p = np.minimum(1.0, n_probe * ln / n_total)
    exp_d = (p * np.ceil(ln / chunk)).sum(axis=1).max()
    worst = 1
    for d_ in range(ln.shape[0]):
        top = np.sort(ln[d_])[::-1][:n_probe]
        worst = max(worst, int(np.ceil(top / chunk).sum()))
    t = max(min(worst, int(1.25 * exp_d) + 2), 1)
    return _round_up(quantize_up(t), FAN)


def choose_local_body(index, tables: LocalTables, n_probe: int, nq_local: int = 1024) -> str:
    """'dense' or 'stream': the single-device byte model
    (``dispatch.choose_sweep_body``) applied to one device's slice."""
    d = index.dimension
    itemsize = stream_itemsize(index.stream_dtype)
    lengths = np.asarray(tables.local_lengths).reshape(-1)
    chunk = pick_chunk(lengths, d, itemsize)
    return choose_sweep_body(lengths, tables.local_vecs.shape[1], d, itemsize, nq_local,
                             n_probe, chunk)


def normalize_queries(index, queries) -> np.ndarray:
    """(nq, d) f32 queries, checked; unit rows for a cosine index."""
    q = np.ascontiguousarray(queries, np.float32)
    if q.ndim == 1:
        q = q[None, :]
    if q.shape[1] != index.dimension:
        raise ValueError(
            f"query dimension mismatch: expected {index.dimension}, got {q.shape[1]}"
        )
    if index.metric == "cosine":
        q = (q / np.maximum(np.linalg.norm(q, axis=1, keepdims=True), 1e-12)).astype(np.float32)
    return q


# ---------------------------------------------------------------------------
# One device's slice and its search body
# ---------------------------------------------------------------------------


class DeviceSlice:
    """Slice ``j`` of the plan ``tables`` on ``dev``: the payload, packed
    from ``index``'s layout (``pack_rows``), the block -> local run map, the
    global centroid table and each local cell's column in the global coarse
    distances (pads read an appended +inf column). The stream table is built
    on first use (``slice_stream_table``)."""

    def __init__(self, index, tables: LocalTables, j: int, dev: torch.device):
        self.dev = dev
        self.j = j
        with trace("sharded.upload", sync=dev, slice=j, device=str(dev)):
            self.vecs, self.norms = pack_rows(index, tables, j, dev)
        nb = tables.local_vecs.shape[1] // ALIGN
        block_run = np.searchsorted(tables.local_run_starts_b[j], np.arange(nb), side="right") - 1
        self.block_run = torch.as_tensor(block_run.astype(np.int64), device=dev)
        self.cents = torch.as_tensor(tables.cents, device=dev)
        self.c_sq = torch.as_tensor(tables.c_sq, device=dev)
        kc = tables.cents.shape[0]
        cid = tables.local_cid[j]
        self.cid = torch.as_tensor(np.where(cid >= 0, cid, kc), device=dev)
        self.kc_local = cid.shape[0]
        self.lengths = torch.as_tensor(tables.local_lengths[j].astype(np.float64), device=dev)
        self.counter = f"sharded.probed_rows.{j}"
        self.stream: Optional[StreamTable] = None

    def coarse(self, qt, n_probe: int, probed=None):
        """(local coarse distances (q, kc_local), global threshold (q, 1)):
        L2 to every centroid (coarse probing is always L2), the n_probe-th
        smallest, and this device's cells' columns of the same matrix (so
        the local test reads the very values the threshold came from).
        ``probed`` (a float64 scalar on the device), where given, takes the
        rows of the cells this device probes."""
        dg = sq_norms(qt)[:, None] - 2.0 * torch.matmul(qt, self.cents.T) + self.c_sq[None, :]
        thresh = torch.kthvalue(dg, n_probe, dim=1, keepdim=True).values
        inf = torch.full((qt.shape[0], 1), float("inf"), device=qt.device)
        dl = torch.cat([dg, inf], dim=1)[:, self.cid]
        if probed is not None:
            probed.add_(torch.where(dl <= thresh, self.lengths, 0.0).sum())
        return dl, thresh

    def search(self, q, kk: int, n_probe: int, probe_bound: int, method: str, metric: str,
               plan=None, stream_args=None, probed=None):
        """This slice's (D (nq, kk), local rows (nq, kk) int32) for the
        queries ``q`` already on ``dev``: +inf / -1 where there is no
        result; ``probed`` as in ``coarse``. Only enqueues device work."""
        nq, d = q.shape

        def probe_sets(qt):
            dl, thresh = self.coarse(qt, n_probe, probed)
            return dl <= thresh, torch.argmin(dl, dim=1)

        if method == "stream":
            t_fixed, q_tile, rerank = stream_args
            pb_l = min(probe_bound, self.kc_local)

            def probe_fn(qt):
                dl, thresh = self.coarse(qt, n_probe, probed)
                pv, ploc = torch.topk(dl, pb_l, dim=1, largest=False, sorted=True)
                return torch.where(pv <= thresh, ploc, self.kc_local)

            dv, rows = programs.stream_program(
                q, None, None, self.stream, k=kk, n_probe=n_probe, t_fixed=t_fixed,
                q_tile=q_tile, metric=metric, rerank_from=(self.vecs, self.norms) if rerank
                else None, probe_fn=probe_fn,
            )
        elif plan is not None:
            w, _, c_groups = plan
            dv, rows = programs.dense_fused_program(
                q, None, None, self.vecs, self.norms, self.block_run, n_probe, k=kk, w=w,
                c_groups=c_groups, metric=metric, probe_sets=probe_sets,
            )
        else:
            rows_local = self.vecs.shape[0]
            dv, rows = programs.dense_program(
                q, None, None, self.vecs, self.norms, self.block_run, n_probe, k=kk,
                q_tile=pick_q_tile(nq, rows_local * 4 // d, d), metric=metric,
                probe_sets=probe_sets,
            )
        real = (rows >= 0) & torch.isfinite(dv) & (dv < SENTINEL_THRESHOLD)
        return (torch.where(real, dv, float("inf")),
                torch.where(real, rows, -1).to(torch.int32))


def merge(parts, k: int, root: torch.device):
    """Top-k over partial lists ``parts`` = [(D (nq, kk), rows, owner)]
    (int32 rows and owners, any devices), gathered to ``root`` in list
    order: one stable sort, so ties go to the earlier list. -> ((D, rows,
    owner) (nq, k) on root, bytes gathered from parts[1:])."""
    moved = sum(x.numel() * x.element_size() for p in parts[1:] for x in p)
    d, r, o = (torch.cat([p[i].to(root, non_blocking=True) for p in parts], dim=1)
               for i in range(3))
    dv, order = torch.sort(d, dim=1, stable=True)
    dv, order = dv[:, :k], order[:, :k]
    ok = torch.isfinite(dv)
    r = torch.where(ok, r.gather(1, order), -1)
    o = torch.where(ok, o.gather(1, order), -1)
    return (dv, r, o), moved


class _SlicedSearcher:
    """What the 1-D, 2-D and multi-host searchers share: the local tables
    of ``n_slices`` slices, one ``DeviceSlice`` per (device, slice) pair
    that holds it, the lazy stream tables, the per-call parameters, and the
    graphs of repeated call shapes (``_graphs``)."""

    def __init__(self, index, n_slices: int, placement, method: str):
        """``placement``: a list of (slice j, device) pairs."""
        if method not in METHODS:
            raise ValueError(f"unknown sharded search method: {method}")
        self.index = index
        self.method = method
        t = plan_local_tables(index, n_slices)
        self._host_tables = t
        self.shard_to_dev = t.shard_to_dev
        self.local_perm = t.local_perm
        self.last_merge_bytes: dict = {}
        self.last_method: Optional[str] = None  # the body of the last search
        pairs = list(dict.fromkeys(placement))
        built = on_each([dev for _, dev in pairs],
                        lambda i: DeviceSlice(index, t, pairs[i][0], pairs[i][1]))
        self._slices = dict(zip(pairs, built))
        self._graphs = ShardGraphs()

    def _stream_tables(self) -> None:
        """Build each slice's stream table in the index's ``stream_dtype``
        where it has none, or one of another dtype."""
        dtype = self.index.stream_dtype
        if any(sl.stream is None or sl.stream.vecs.dtype != dtype
               for sl in self._slices.values()):
            t = self._host_tables
            chunk, m_pad = stream_shape(t, dtype)
            pairs = list(self._slices)

            def build(i):
                j, dev = pairs[i]
                with trace("sharded.stream_table", sync=dev, slice=j, dtype=str(dtype)):
                    return slice_stream_table(self._slices[pairs[i]].vecs, t.local_cent[j],
                                              stream_maps(t, j, chunk, m_pad, dev), dtype,
                                              chunk, m_pad)

            for pair, st in zip(pairs, on_each([dev for _, dev in pairs], build)):
                self._slices[pair].stream = st

    def choose(self, nq_local: int, n_probe: int) -> str:
        if self.method != "auto":
            return self.method
        return choose_local_body(self.index, self._host_tables, n_probe, nq_local=nq_local)

    def params(self, nq_local: int, kk: int, n_probe: int):
        """(n_probe, probe_bound, method, fused plan, stream args) of one
        call, for a per-device batch of ``nq_local`` queries."""
        kc = self._host_tables.cents.shape[0]
        n_probe = min(n_probe, kc)
        probe_bound = min(quantize_up(max(n_probe, 1)), kc)
        method = self.choose(nq_local, n_probe)
        plan, stream_args = None, None
        d = self.index.dimension
        if method == "stream":
            self._stream_tables()
            chunk = next(iter(self._slices.values())).stream.chunk
            t_fixed = stream_slots(self._host_tables.local_lengths, probe_bound, chunk)
            q_tile = min(stream_q_tile(t_fixed), _round_up(nq_local, 8))
            stream_args = (t_fixed, q_tile, self.index.stream_dtype == torch.int8)
        elif method == "dense_fused" and fused_sweep_fits(d):
            # The single-device gate; no plan -> the plain dense body.
            plan = plan_fused(self._host_tables.local_vecs.shape[1], d, nq_local, kk)
        return n_probe, probe_bound, method, plan, stream_args

    @property
    def metric(self) -> str:
        """Ranking metric (cosine is ip over unit vectors)."""
        return self.index.metric if self.index.metric != "cosine" else "ip"

    def search_job(self, j: int, dev: torch.device, qd, kk: int, params, probed=None):
        """Slice ``j``'s (D, rows) on ``dev`` for the queries ``qd`` there,
        with ``params`` (``params()``'s tuple) and ``probed`` as in
        ``DeviceSlice.search``."""
        n_probe, probe_bound, method, plan, stream_args = params
        with on_device(dev):
            return self._slices[(j, dev)].search(qd, kk, n_probe, probe_bound, method,
                                                 self.metric, plan, stream_args, probed)

    def run(self, jobs, kk: int, n_probe: int, nq_local: int):
        """Run ``jobs`` = [(slice j, device, queries numpy)] -> [(D, rows)]
        on each job's device, all enqueued before any result is read: the
        eager call, which the graphs replace for a repeated shape
        (``ShardGraphs.search``)."""
        params = self.params(nq_local, kk, n_probe)
        self.last_method = params[2]
        # The queries go to the cards from pinned memory (a copy from
        # pageable memory would synchronise inside the loop).
        pin = any(dev.type == "cuda" for _, dev, _ in jobs)
        host = {}
        for _, _, q in jobs:
            if id(q) not in host:
                t = torch.tensor(q)  # a copy: the caller's array may be read-only
                host[id(q)] = t.pin_memory() if pin else t
        out = []
        recording = tracing.recording_now()
        with trace("sharded.enqueue", level=DEBUG):
            for j, dev, q in jobs:
                with on_device(dev):
                    qd = host[id(q)].to(dev, non_blocking=True)
                    probed = (torch.zeros((), dtype=torch.float64, device=dev) if recording
                              else None)
                    out.append(self.search_job(j, dev, qd, kk, params, probed))
                    if recording:
                        tracing.count(self._slices[(j, dev)].counter, probed)
        return out

    def finish(self, D, rows, owner, k: int,
               external: bool = False) -> Tuple[np.ndarray, np.ndarray]:
        """Host side of a search: the copy back, then (D, internal ids, or
        external ids with ``external``) cut to k, spilled indexes
        de-duplicated."""
        with trace("sharded.to_host", level=DEBUG):
            D = D.cpu().numpy()
            rows = rows.cpu().numpy()
            owner = owner.cpu().numpy()
        internal = np.where(
            rows >= 0, self.local_perm[np.clip(owner, 0, None), np.clip(rows, 0, None)], -1
        ).astype(np.int64)
        if getattr(self.index, "spill", 0):
            D, internal = host_dedup_topk(D, internal, D.shape[1])
        D, internal = D[:, :k], internal[:, :k]
        return D, self.index.internal_to_external(internal) if external else internal


def _check_k(k: int, n_probe: int) -> None:
    if k <= 0:
        raise ValueError("k must be > 0")
    if n_probe <= 0:
        raise ValueError("n_probe must be > 0")


def axis_devices(mesh: Mesh, axis: str) -> list:
    """The devices along ``axis`` (at position 0 of every other axis)."""
    if axis not in mesh.shape:
        raise ValueError(f"mesh has no axis {axis!r} (axes {mesh.axis_names})")
    ax = mesh.axis_names.index(axis)
    return list(np.moveaxis(mesh.devices, ax, 0).reshape(mesh.shape[axis], -1)[:, 0])


class ShardedSearcher(_SlicedSearcher):
    """Sharded search over the 1-D mesh axis ``axis``.

    ``method``: 'dense' (masked plain sweep of the local slice, exact),
    'dense_fused' (K3's masked sweep at the single-device gate, else
    'dense'), 'stream' (K2 / K4 over a local stream table, re-ranked
    exactly from the local f32 rows for int8 tables) or 'auto' (the
    single-device byte model on one device's slice: 'dense' or
    'stream')."""

    def __init__(self, index, mesh: Mesh, axis: str = "shards", method: str = "auto"):
        self.mesh = mesh
        self.axis = axis
        self.devices = axis_devices(mesh, axis)
        self.n_dev = len(self.devices)
        super().__init__(index, self.n_dev, list(enumerate(self.devices)), method)

    def search_batch(self, queries, k: int, n_probe: int) -> Tuple[np.ndarray, np.ndarray]:
        """(nq, d) -> (D (nq, k) f32, external ids (nq, k) int64), padded
        +inf / -1: the index's ``external_ids``, as
        ``IvfIndex.search_batch(external=True)`` maps them."""
        with trace("sharded.search", level=DEBUG):
            _check_k(k, n_probe)
            q = normalize_queries(self.index, queries)
            kk = (1 + getattr(self.index, "spill", 0)) * k

            def reduce(outs):
                with trace("sharded.merge", level=DEBUG):
                    parts = [(dv, rows, torch.full_like(rows, j))
                             for j, (dv, rows) in enumerate(outs)]
                    (D, rows, owner), moved = merge(parts, kk, self.devices[0])
                self.last_merge_bytes = {"shards": moved}
                return self.finish(D, rows, owner, k, external=True)

            return self._graphs.search(self, [(j, dev, q) for j, dev in enumerate(self.devices)],
                                       kk, n_probe, q.shape[0], reduce)
