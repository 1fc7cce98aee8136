"""Probed-blocks stream search: the stream table, its task grid, and
kernels K2 (per-task distance rows), K4 (fused top-2-per-lane planes) and
K5 (the block-major shared stream).

Port of ``vector_indexer_tpu/ops/pallas/block_stream.py``.

* A **stream table** re-packs the posting table so that every cluster
  starts at a ``chunk``-row-aligned base and stores RESIDUAL rows
  (vector - centroid) in bf16, int8 (symmetric per-cluster scale
  s_c = max|r| / 127, the offload table) or f32 (the ``stream_exact``
  table), with the f32 norms of the STORED (dequantized) rows. So
  |q-c|^2 - 2 (q-c).r^ + |r^|^2 is exactly |q - (c + r^)|^2: the search
  distance is exact to the quantized point.
* Each probed list becomes ceil(len / chunk) **tasks**; every query gets
  ``t_fixed`` task slots, nearest probes first (chunks past ``t_fixed`` are
  dropped, a recall trade sized by ``per_query_slots``).
* **K2** (``stream_distances``) scores every task's valid rows into an
  (nq, t_fixed, chunk) plane, lanes past a list's end +inf (given
  ``nval2d``), before a top-k. **K4** (``stream_fused_plane``) keeps the
  selection on chip and returns per-(group, lane) best/second planes with
  their slot ids; it engages once a query's task plane is wide
  (``fused_engages``), as in the reference.
* **K5** (``stream_shared_plane``, behind ``block_stream_search_shared``)
  inverts the (query, slot) pairs into block-major tasks of up to
  ``Q_SHARE`` queries, so that a block probed by many queries of a tile is
  read once per task instead of once per query.

The sizing constants (chunk target, FAN, the fused threshold, Q_SHARE, the
task-cap grain) are the reference's TPU-calibrated values, copied unchanged
until they are re-measured on the H100 (ROADMAP Queue 1 item 4). Each
kernel wrapper runs its plain PyTorch version on a CPU tensor and launches
its CUDA kernel on a CUDA tensor (or raises).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..kernels import build as kb
from .gather import quantize_up
from .topk import topk_smallest

CHUNK = 256  # default rows per task block
FAN = 16  # slots are grouped in FAN fans (fold order of K4; t_fixed % FAN == 0)
SMEM_TASK_CAP = 30_720  # per-tile task budget (sizes the query tile)
FUSED_STREAM_MIN_ROWS = 12 << 10  # probed rows/query where K4 engages
_TARGET_BLOCK_BYTES = 128 << 10
# f32 bytes of one residual tile of a table build (2^19 rows at d 128).
_TILE_BYTES = 1 << 28
# f32 bytes of the rows a build from arriving rows converts at a time: its
# device transient is a few such tiles, far below the f32 table it avoids.
_ROW_TILE_BYTES = 16 << 20


def pick_chunk(lengths_np, d: int, itemsize: int) -> int:
    """Per-table task-block rows: the smallest power of two reaching
    ~128 KB, unless padding lists to whole blocks would waste > 35%."""
    ln = np.asarray(lengths_np, np.float64)
    total = max(ln.sum(), 1.0)
    target = max(256, _TARGET_BLOCK_BYTES // max(d * itemsize, 1))
    best = 256
    for c in (512, 1024):
        if c > target:
            break
        waste = (np.ceil(ln / c) * c).sum() / total
        if waste <= 1.35:
            best = c
    return best


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


STREAM_DTYPES = (torch.bfloat16, torch.int8, torch.float32)
_SENTINEL = 1e30  # stored norm of pad rows: their distances stay >= 1e29


@dataclasses.dataclass
class StreamTable:
    """chunk-aligned residual re-pack of a PostingLayout."""

    vecs: torch.Tensor  # (m_pad, d) bf16 / int8 / f32 residual rows (x - centroid[c])
    norms: torch.Tensor  # (m_pad,) f32 |stored (dequantized) residual|^2; 1e30 on pads
    to_main: torch.Tensor  # (m_pad,) int64 stream row -> main layout row
    sblk0: torch.Tensor  # (kc,) int64 per-cluster start block
    lengths: torch.Tensor  # (kc,) int64 posting lengths
    cent: torch.Tensor  # (kc, d) f32 centroids (residual bases)
    blk_cid: torch.Tensor  # (m_pad / chunk,) int64 owning cluster per block
    scales: torch.Tensor  # (kc,) f32 per-cluster int8 dequant scale (1.0 otherwise)
    m_pad: int
    chunk: int = CHUNK

    @property
    def dtype(self) -> torch.dtype:
        return self.vecs.dtype

    @property
    def nbytes(self) -> int:
        """Device bytes of the row table and its norms."""
        return self.vecs.numel() * self.vecs.element_size() + self.norms.numel() * 4


def _stream_maps(lengths: np.ndarray, starts: np.ndarray, d: int, itemsize: int,
                 main_pad_row: int, chunk: Optional[int]):
    """Host-side index prep: chunk-aligned per-cluster block bases, stream
    row -> main row map, and owning cluster per stream row."""
    starts = starts.astype(np.int64)
    lengths = lengths.astype(np.int64)
    kc = len(lengths)
    order = np.argsort(starts, kind="stable")  # layout placement order
    if chunk is None:
        chunk = pick_chunk(lengths, d, itemsize)
    sizes = -(-np.maximum(lengths[order], 0) // chunk) * chunk
    bases_in_order = np.zeros(kc, np.int64)
    if kc > 1:
        np.cumsum(sizes[:-1], out=bases_in_order[1:])
    bases = np.empty(kc, np.int64)
    bases[order] = bases_in_order
    m_pad = int(max(sizes.sum(), chunk))
    # Pads point at the main table's last row (a zero vector with a
    # SENTINEL norm); their lanes are masked before selection anyway.
    to_main = np.full(m_pad, main_pad_row, np.int64)
    # Owning cluster over the cluster's whole chunk-rounded region.
    row_cid = np.zeros(m_pad, np.int64)
    for c in range(kc):
        ln = int(lengths[c])
        if ln:
            to_main[bases[c] : bases[c] + ln] = np.arange(starts[c], starts[c] + ln)
            row_cid[bases[c] : bases[c] + _round_up(ln, chunk)] = c
    return chunk, bases, m_pad, to_main, row_cid


def _check_dtype(dtype) -> torch.dtype:
    if dtype not in STREAM_DTYPES:
        raise ValueError(f"stream table dtype must be one of {STREAM_DTYPES}, got {dtype}")
    return dtype


def _itemsize(dtype: torch.dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def _table(vecs, norms, to_main, bases, row_cid, lengths, cent, scales, chunk, dev):
    """Assemble a StreamTable on ``dev`` from its host-side maps."""
    m_pad = vecs.shape[0]
    return StreamTable(
        vecs=vecs,
        norms=norms,
        to_main=torch.as_tensor(to_main, device=dev),
        sblk0=torch.as_tensor(bases // chunk, device=dev),
        lengths=torch.as_tensor(np.asarray(lengths).astype(np.int64), device=dev),
        cent=cent,
        blk_cid=torch.as_tensor(row_cid[::chunk], device=dev),
        scales=scales,
        m_pad=m_pad,
        chunk=chunk,
    )


def build_stream_table(layout, centroids, dtype: torch.dtype = torch.bfloat16,
                       chunk: Optional[int] = None) -> StreamTable:
    """Re-pack the layout into chunk-aligned cluster blocks of residual rows
    on the layout's device, in row tiles of _TILE_BYTES of f32 (2^19 rows
    at d 128) to bound the transient at any d.

    ``dtype=torch.int8`` stores symmetric per-cluster-scaled residuals:
    s_c = max|r| / 127 over the cluster (a scatter-max pass), then
    round(r / s_c) clipped to [-127, 127] (a second pass), with the norms of
    the dequantized rows s_c * q8. bf16 and f32 store the residual cast to
    the type, with the norms of the stored rows."""
    _check_dtype(dtype)
    dev = layout.vectors.device
    d = layout.dim
    main_pad_row = layout.vectors.shape[0] - 1
    chunk, bases, m_pad, to_main, row_cid = _stream_maps(
        layout.lengths, layout.offsets[:-1], d, _itemsize(dtype), main_pad_row, chunk
    )
    kc = len(layout.lengths)
    cent = torch.as_tensor(np.asarray(centroids), dtype=torch.float32, device=dev)
    to_main_t = torch.as_tensor(to_main, device=dev)
    row_cid_t = torch.as_tensor(row_cid, device=dev)
    real = to_main_t != main_pad_row
    R = max(1, _TILE_BYTES // (4 * d))

    def residual(lo, hi):
        res = layout.vectors[to_main_t[lo:hi]]  # gather: a fresh tile
        # In place on the tile: residual, then zero the pad rows.
        return res.sub_(cent[row_cid_t[lo:hi]]).mul_(real[lo:hi, None])

    scales = torch.ones(kc, dtype=torch.float32, device=dev)
    if dtype == torch.int8:
        smax = torch.zeros(kc, dtype=torch.float32, device=dev)
        for lo in range(0, m_pad, R):
            hi = min(lo + R, m_pad)
            m = residual(lo, hi).abs().amax(dim=1)
            smax.scatter_reduce_(0, row_cid_t[lo:hi], m, reduce="amax")
        scales = (smax / 127.0).clamp_min(1e-12)
    vecs = torch.empty((m_pad, d), dtype=dtype, device=dev)
    norms = torch.empty(m_pad, dtype=torch.float32, device=dev)
    sentinel = torch.tensor(_SENTINEL, device=dev)
    for lo in range(0, m_pad, R):
        hi = min(lo + R, m_pad)
        res = residual(lo, hi)
        if dtype == torch.int8:
            s = scales[row_cid_t[lo:hi]][:, None]
            q8 = torch.round(res / s).clamp_(-127, 127)
            vecs[lo:hi] = q8.to(torch.int8)
            deq = q8.mul_(s)
        else:
            vecs[lo:hi] = res.to(dtype)
            deq = vecs[lo:hi].to(torch.float32)
        norms[lo:hi] = torch.where(real[lo:hi], torch.sum(deq * deq, dim=1), sentinel)
    return _table(vecs, norms, to_main_t, bases, row_cid, layout.lengths, cent, scales,
                  chunk, dev)


def build_stream_table_from_rows(layout, centroids, row_chunks, dtype: torch.dtype = torch.int8,
                                 chunk: Optional[int] = None, device=None):
    """``build_stream_table``'s table, built on ``device`` from the layout's
    rows as they arrive, so that the layout's own table need not be there
    (a host layout: ``index/offload.py::offload_from_host``).
    ``row_chunks`` yields (lo, hi, rows) in row order over rows 0:rows_used,
    ``rows`` the layout's rows lo:hi as a float32 tensor (copied to
    ``device`` when it is elsewhere, _ROW_TILE_BYTES at a time; it may be
    reused once the copies are enqueued). Each row arrives once: the rows of the lists a chunk ends
    inside stay on the device until the chunk that ends them, so that every
    list is converted whole, int8 lists with one scale max|r| / 127 from
    their own rows. Codes and scales equal ``build_stream_table``'s on the
    same layout; the norms differ only by float32 summation order.
    -> (StreamTable, (rows_used,) float32 |x|^2 of every layout row, on
    ``device``)."""
    _check_dtype(dtype)
    dev = resolve_device(device)
    n_pad, d = layout.table_shape
    main_pad_row = n_pad - 1
    chunk, bases, m_pad, to_main, row_cid = _stream_maps(
        layout.lengths, layout.offsets[:-1], d, _itemsize(dtype), main_pad_row, chunk
    )
    kc = len(layout.lengths)
    rows_used = layout.rows_used
    # Lists in placement order (``_stream_maps``'): each one's first layout
    # row, the most past-the-end row of it and the lists before it (an empty
    # list may share its start with the next), and the end of its
    # chunk-rounded region of stream rows.
    order = np.argsort(layout.offsets[:-1], kind="stable")
    lengths = layout.lengths.astype(np.int64)[order]
    first = layout.offsets[:-1].astype(np.int64)[order]
    past = np.maximum.accumulate(first + lengths) if kc else first
    region_end = bases[order] + _round_up(lengths, chunk)

    cent = torch.as_tensor(np.asarray(centroids, np.float32), device=dev)
    to_main_t = torch.as_tensor(to_main, device=dev)
    row_cid_t = torch.as_tensor(row_cid, device=dev)
    vecs = torch.zeros((m_pad, d), dtype=dtype, device=dev)
    norms = torch.full((m_pad,), _SENTINEL, dtype=torch.float32, device=dev)
    smax = torch.zeros(kc, dtype=torch.float32, device=dev)
    row_sq = torch.empty(rows_used, dtype=torch.float32, device=dev)
    sentinel = torch.tensor(_SENTINEL, device=dev)
    held, held_lo, done = None, 0, 0  # rows held_lo: of unfinished lists; lists finished

    step = max(1, _ROW_TILE_BYTES // (4 * d))
    tiles = ((a, min(a + step, hi), rows[a - lo: min(a + step, hi) - lo])
             for lo, hi, rows in row_chunks for a in range(lo, hi, step))
    for lo, hi, rows in tiles:
        rows = rows.to(dev, non_blocking=True)
        row_sq[lo:hi] = torch.sum(rows * rows, dim=1)
        if held is None:
            held_lo = lo
        else:
            rows = torch.cat([held, rows])
        ended = kc if hi >= rows_used else int(np.searchsorted(past, hi, side="right"))
        if ended > done:
            a, b = (int(region_end[done - 1]) if done else 0), int(region_end[ended - 1])
            tm, cid = to_main_t[a:b], row_cid_t[a:b]
            real = tm != main_pad_row
            res = rows[(tm - held_lo).clamp_(0, rows.shape[0] - 1)]
            res.sub_(cent[cid]).masked_fill_(~real[:, None], 0.0)
            if dtype == torch.int8:
                smax.scatter_reduce_(0, cid, res.abs().amax(dim=1), reduce="amax")
                s = (smax[cid] / 127.0).clamp_min(1e-12)[:, None]
                q8 = torch.round(res / s).clamp_(-127, 127)
                vecs[a:b] = q8.to(torch.int8)
                deq = q8.mul_(s)
            else:
                vecs[a:b] = res.to(dtype)
                deq = vecs[a:b].to(torch.float32)
            norms[a:b] = torch.where(real, torch.sum(deq * deq, dim=1), sentinel)
            done = ended
        keep = int(first[ended]) if ended < kc else hi
        held = rows[keep - held_lo:].clone() if keep < hi else None
        held_lo = keep
    scales = (smax / 127.0).clamp_min(1e-12) if dtype == torch.int8 else torch.ones_like(smax)
    return (_table(vecs, norms, to_main_t, bases, row_cid, layout.lengths, cent, scales, chunk,
                   dev), row_sq)


def expected_tasks_per_query(lengths_np, n_probe: int, chunk: int = CHUNK) -> float:
    """E[chunk tasks per query] under length-proportional probe likelihood."""
    ln = np.asarray(lengths_np, np.float64)
    n = max(ln.sum(), 1.0)
    p_probed = np.minimum(1.0, n_probe * ln / n)
    return float((p_probed * np.ceil(ln / chunk)).sum())


def per_query_slots(lengths_np, n_probe: int, worst_case: bool = False,
                    chunk: int = CHUNK) -> int:
    """t_fixed: task slots per query (multiple of FAN) on the
    {2^m, 1.5*2^m} grid: ~1.25x the expected task count (+2), or the
    worst case (sum of the n_probe longest lists' chunks), which never
    drops a candidate."""
    ln = np.sort(np.asarray(lengths_np))[::-1]
    worst_q = int(np.ceil(ln[: min(n_probe, len(ln))] / chunk).sum())
    worst_q = max(worst_q, 1)
    if worst_case:
        t = worst_q
    else:
        exp_q = expected_tasks_per_query(lengths_np, n_probe, chunk)
        t = min(worst_q, int(1.25 * exp_q) + 2)
    return _round_up(quantize_up(t), FAN)


def pick_stream_groups(chunk: int) -> int:
    """Accumulator group count G for K4: ~1024 (group, lane) positions;
    G divides FAN (fans feed groups round-robin)."""
    g = max(1, min(8, 1024 // chunk))
    while FAN % g:
        g -= 1
    return g


def fused_engages(t_fixed: int, chunk: int, k: int) -> bool:
    """Whether ``block_stream_search`` routes to K4 by default: the task
    plane is at least FUSED_STREAM_MIN_ROWS wide and k fits the groups."""
    return t_fixed * chunk >= FUSED_STREAM_MIN_ROWS and k <= pick_stream_groups(chunk) * chunk


def build_task_grid(queries, table: StreamTable, probe, t_fixed: int, metric: str):
    """Per-query task grid: slot s of a query is chunk c of its probe j,
    nearest probes first. Returns (blk2d, cid2d, nval2d, bias2d), each
    (nq, t_fixed): block id, cluster id, valid lanes (0 = unused slot) and
    the lane-constant bias (|q-c|^2 for l2, -q.c for ip). Unused slots
    point at block 0 / cluster 0."""
    nq = queries.shape[0]
    p = probe.shape[1]
    chunk = table.chunk
    probe = probe.long()
    lens = table.lengths[probe]  # (nq, p)
    nchunks = (lens + chunk - 1) // chunk
    cum = torch.cumsum(nchunks, dim=1)
    cum_prev = cum - nchunks
    s = torch.arange(t_fixed, device=queries.device).expand(nq, t_fixed).contiguous()
    # Probe segment of slot s: the first j with cum[j] > s.
    j = torch.searchsorted(cum, s, right=True)
    used = j < p
    jc = j.clamp_max(p - 1)
    c = s - cum_prev.gather(1, jc)
    zero = torch.zeros_like(s)
    blk2d = torch.where(used, table.sblk0[probe].gather(1, jc) + c, zero)
    cid2d = torch.where(used, probe.gather(1, jc), zero)
    nval2d = torch.where(used, torch.clamp(lens.gather(1, jc) - c * chunk, max=chunk), zero)
    cent_sel = table.cent[cid2d]  # (nq, t_fixed, d)
    if metric == "l2":
        qc = queries[:, None, :] - cent_sel
        bias2d = torch.sum(qc * qc, dim=-1)
    else:
        bias2d = -torch.sum(queries[:, None, :] * cent_sel, dim=-1)
    return blk2d, cid2d, nval2d, bias2d


# ---------------------------------------------------------------------------
# K2: per-task distance rows
# ---------------------------------------------------------------------------


def _slot_scales(scales, cid2d, vecs):
    """Per-slot dequant scale (int8 tables; None means 1)."""
    if vecs.dtype != torch.int8:
        return None
    if scales is None:
        raise ValueError("an int8 stream table needs its per-cluster scales")
    return scales[cid2d.long()]


def stream_distances_reference(queries, cent, cid2d, blk2d, bias2d, vecs, norms,
                               *, chunk: int, metric: str, scales=None, nval2d=None):
    """Plain version of K2: (nq, t_fixed, chunk) f32 distances of every
    task's block. int8 rows are widened exactly and the dot is scaled by
    the slot's cluster scale ``scales[cid]``. Without ``nval2d`` every lane
    is computed, including lanes past the list's end; with it, lanes at or
    past the slot's valid count are +inf."""
    nq, t = blk2d.shape
    d = queries.shape[1]
    blocks = vecs.view(-1, chunk, d)
    nrm_blocks = norms.view(-1, chunk)
    slot_scl = _slot_scales(scales, cid2d, vecs)
    out = torch.empty((nq, t, chunk), dtype=torch.float32, device=queries.device)
    step = max(1, (1 << 25) // max(1, t * chunk * d))  # queries per tile
    for s in range(0, nq, step):
        e = min(nq, s + step)
        blk = blk2d[s:e].long()
        q = queries[s:e, None, :]
        qc = q - cent[cid2d[s:e].long()] if metric == "l2" else q.expand(-1, t, -1)
        rows = blocks[blk].to(torch.float32)  # (b, t, chunk, d)
        cross = torch.matmul(rows, qc.unsqueeze(-1)).squeeze(-1)  # (b, t, chunk)
        if slot_scl is not None:
            cross = cross * slot_scl[s:e, :, None]
        nrm = nrm_blocks[blk]
        bias = bias2d[s:e, :, None]
        if metric == "l2":
            out[s:e] = bias - 2.0 * cross + nrm
        else:
            out[s:e] = bias - cross + torch.where(nrm >= 1e29, nrm, torch.zeros_like(nrm))
    if nval2d is not None:
        lane = torch.arange(chunk, device=out.device)
        out = torch.where(lane[None, None, :] < nval2d[:, :, None], out, float("inf"))
    return out


# Launch plans. Each CUDA launcher takes its kernel's shared-memory layout
# from these functions and checks it (csrc/block_stream.cu,
# block_stream_shared.cu); none re-derives it. Every d gets a plan that fits
# the SMEM_LIMIT bytes a block may opt in to on sm_90.
SMEM_LIMIT = 232_448

# K2: at most this many consecutive slots of one query per block (rows of
# at most K2_MAX_CHUNKS 16-byte chunks; wider rows take the split launch).
K2_SLOTS_PER_BLOCK = 4
K2_MAX_CHUNKS = 128
_K2_NCH = 4  # 16-byte chunks of a row per lane


class K2Plan(NamedTuple):
    lpr: int  # lanes per row
    spb: int  # slots per block
    smem: int  # dynamic shared memory bytes


def stream_distances_plan(d: int, itemsize: int, t_fixed: int, chunk: int) -> Optional[K2Plan]:
    """K2's one-block-per-run launch for rows of d elements of ``itemsize``
    bytes, or None past K2_MAX_CHUNKS 16-byte chunks (bf16 d 1024, int8
    2048, f32 512), where ``stream_distances_split_plan`` takes over. A
    lane reads 4 16-byte chunks of a row, so a row takes few lanes and its
    dot few shuffles: the fewest lanes (a power of two) that cover the
    row's chunks, so narrow rows share a warp. Slots per block: up to
    K2_SLOTS_PER_BLOCK, each with its q - c (the padded row, f32) and its
    distance row in shared memory."""
    epc = 16 // itemsize
    cpr = -(-d // epc)
    if cpr > K2_MAX_CHUNKS:
        return None
    lpr = 1
    while lpr * _K2_NCH < cpr:
        lpr <<= 1
    spb = max(1, min(K2_SLOTS_PER_BLOCK, t_fixed))
    return K2Plan(lpr, spb, 4 * spb * (cpr * epc + chunk))


# K4's register modes: a ring of K4_STAGES stages of ~K4_STAGE_TARGET bytes.
K4_STAGES = 4
K4_STAGE_TARGET = 16 << 10


class FusedPlan(NamedTuple):
    nch: int  # 16-byte chunks per lane in registers
    lpr: int  # lanes per row
    sub_rows: int  # rows per stage
    row_align: int  # rows a copy is rounded up to (a 16-byte multiple)
    stage_bytes: int
    smem: int  # dynamic shared memory bytes


def stream_fused_plan(d: int, itemsize: int, chunk: int) -> Optional[FusedPlan]:
    """K4's one-block-per-(query, group) launch plan (chunk % 16 == 0): up
    to 4 16-byte chunks per lane in registers for bf16 rows and 2 for int8
    (d <= 1024 either way), the fewest lanes (a power of two) that cover the
    row, stages of ~K4_STAGE_TARGET bytes in 16-row steps; None past those
    register modes, where ``stream_fused_split_plan`` takes over at every
    nq."""
    if chunk % 16:
        raise ValueError("stream_fused_plane: chunk % 16 != 0")
    cpr = -(-d // (16 // itemsize))
    nch = 1 if cpr <= 32 else 2 if cpr <= 64 else 4 if cpr <= 128 and itemsize == 2 else 0
    if not nch:
        return None
    lpr = 1
    while lpr * nch < cpr:
        lpr <<= 1
    sub_rows = min(chunk, max(16, (K4_STAGE_TARGET // (d * itemsize)) & ~15))
    stage = _round_up(sub_rows * d * itemsize, 128)
    return FusedPlan(nch, lpr, sub_rows, 16, stage, K4_STAGES * stage + 16 * chunk + 16 * K4_STAGES)


# The split launches (K2 and K4 past their one-block launches' rows, at
# any nq): d is cut into slices of
# at most SPLIT_SLICE_BYTES of a row (at least SPLIT_MIN_SLICE_BYTES) and
# each query's valid rows into equal parts (at most one per SPLIT_PART_ROWS
# lanes of its slots), for up to SPLIT_BLOCKS_PER_SM blocks per SM, two of
# them resident (SPLIT_SMEM bytes each); each block streams its row
# segments through SPLIT_STAGES stages of about SPLIT_STAGE_TARGET bytes.
SPLIT_SLICE_BYTES = 4096
SPLIT_MIN_SLICE_BYTES = 256
SPLIT_PART_ROWS = 128
SPLIT_BLOCKS_PER_SM = 16
SPLIT_STAGES = 3
SPLIT_STAGE_TARGET = 32 << 10
SPLIT_SMEM = 115_712  # half an SM's 228 KB, less the 1 KB each block reserves
# K2's split launch: a block per K2_LANE_BYTES of slot lanes, parts of at
# least K2_PART_ROWS lanes of a query's slots, slices of at most
# K2_SLICE_ELEMS elements.
K2_LANE_BYTES = 512 << 10
K2_PART_ROWS = 32
K2_SLICE_ELEMS = 2048


class SplitPlan(NamedTuple):
    slice: int  # elements of d per block (a multiple of the 16-byte chunk)
    n_slices: int
    parts: int  # equal runs of each query's valid rows (in slot order)
    sub_rows: int  # row segments per stage
    stage_bytes: int
    smem: int  # dynamic shared memory bytes of the partial-dot kernel
    blocks: int  # blocks of the partial-dot launch: nq * parts * n_slices


def split_plan(d: int, itemsize: int, chunk: int, nq: int, t_fixed: int, n_sm: int,
               target: Optional[int] = None, part_rows: int = SPLIT_PART_ROWS,
               slice_bytes: int = SPLIT_SLICE_BYTES) -> SplitPlan:
    """The split launch's sizes, for about ``target`` blocks (default
    SPLIT_BLOCKS_PER_SM * n_sm): slices of at most ``slice_bytes`` of a
    row; parts of each query's valid rows (at most one per ``part_rows`` of
    its t_fixed * chunk lanes); and, where those give fewer than two blocks
    an SM, more slices (down to SPLIT_MIN_SLICE_BYTES of a row). A stage
    holds as many row segments as fit SPLIT_STAGE_TARGET bytes and two
    blocks an SM."""
    epc = 16 // itemsize
    row_bytes = d * itemsize
    if target is None:
        target = SPLIT_BLOCKS_PER_SM * n_sm
    n_slices = -(-row_bytes // slice_bytes)
    parts = max(1, min(t_fixed * chunk // part_rows, -(-target // (nq * n_slices))))
    wave = 2 * n_sm  # one resident wave: more slices where the parts give fewer blocks
    n_slices = max(n_slices, min(-(-row_bytes // SPLIT_MIN_SLICE_BYTES), -(-wave // (nq * parts))))
    slice_ = _round_up(-(-d // n_slices), epc)
    n_slices = -(-d // slice_)
    seg_stride = slice_ * itemsize + (0 if row_bytes % 16 == 0 else 32)
    fixed = 16 * SPLIT_STAGES + 8 * slice_  # the barriers, two q - c slices
    sub_rows = max(1, min(chunk, SPLIT_STAGE_TARGET // seg_stride,
                          (SPLIT_SMEM - fixed) // (SPLIT_STAGES * seg_stride)))
    stage = _round_up(sub_rows * seg_stride, 128)
    while sub_rows > 1 and SPLIT_STAGES * stage + fixed > SPLIT_SMEM:
        sub_rows -= 1
        stage = _round_up(sub_rows * seg_stride, 128)
    return SplitPlan(slice_, n_slices, parts, sub_rows, stage, SPLIT_STAGES * stage + fixed,
                     nq * parts * n_slices)


def stream_distances_split_plan(d: int, itemsize: int, chunk: int, nq: int, t_fixed: int,
                                n_sm: int) -> Optional[SplitPlan]:
    """K2's split plan (``split_plan``) for rows past K2_MAX_CHUNKS 16-byte
    chunks, at any nq; None where ``stream_distances_plan``'s launch
    stays. Blocks: one per K2_LANE_BYTES of the batch's slot lanes
    (t_fixed * chunk rows a query; lists fill ~10-25% of them at n_probe
    8-20, so ~50-125 KB of valid rows a block), at least one resident wave
    (2 an SM) and at most SPLIT_BLOCKS_PER_SM an SM; parts of at least
    K2_PART_ROWS lanes; slices of at most K2_SLICE_ELEMS elements (and
    SPLIT_SLICE_BYTES): a segment's work is its elements' q - c reads and
    FMAs, so int8 rows take 2 KB slices."""
    if stream_distances_plan(d, itemsize, t_fixed, chunk) is not None:
        return None
    lanes = nq * t_fixed * chunk * d * itemsize
    target = min(SPLIT_BLOCKS_PER_SM * n_sm, max(2 * n_sm, lanes // K2_LANE_BYTES))
    return split_plan(d, itemsize, chunk, nq, t_fixed, n_sm, target=target,
                      part_rows=K2_PART_ROWS,
                      slice_bytes=min(SPLIT_SLICE_BYTES, K2_SLICE_ELEMS * itemsize))


def stream_fused_split_plan(d: int, itemsize: int, chunk: int, nq: int, groups: int,
                            t_fixed: int, n_sm: int) -> Optional[SplitPlan]:
    """K4's split plan (``split_plan``) for rows past its register modes,
    at any nq; None where ``stream_fused_plan``'s one-block-per-(query,
    group) launch runs (d <= 1024). On the H100 that launch read 1.14-2.5x
    slower than the split on bf16 rows of 16,384 at nq 33-1000 and 6-11x
    on int8 ones (nq 33-256), and at most 4.5% faster on bf16 rows of
    1,536 (nq 512-1000; slower below 256); chip_smoke.py phase 11, NVIDIA
    H100 80GB HBM3, 700.00 W."""
    if stream_fused_plan(d, itemsize, chunk) is not None:
        return None
    return split_plan(d, itemsize, chunk, nq, t_fixed, n_sm)


# K5: panels of whole rows (~K5_PANEL_TARGET bytes, up to K5_MAX_STAGES
# stages in K5_RING_BYTES), narrower panels and one stage for wider rows,
# and K-panels of K5_KPANEL_BYTES of 32 rows past those.
K5_PANEL_TARGET = 32 << 10
K5_MAX_STAGES = 3
K5_RING_BYTES = 227 * 1024 - 1024
K5_KPANEL_BYTES = 1024
_K5_ITEM_ROWS = 32
_K5_PART_BYTES = 4 * 16 * 8 * 32  # carried accumulators: 16 tasks x 8 x 32 lanes


class SharedPlan(NamedTuple):
    panel_rows: int  # rows per stage
    stages: int
    kpanel: int  # elements of d per stage (d itself: whole rows)
    smem: int  # dynamic shared memory bytes


def stream_shared_plan(d: int, itemsize: int, chunk: int) -> SharedPlan:
    """K5's launch plan (chunk % 16 == 0). Panel rows: the largest multiple
    of 16 that divides ``chunk`` within K5_PANEL_TARGET bytes (16 at
    least), 3 stages when one fits the target, else 2; if those pass
    K5_RING_BYTES, (16, 2), (8, 2), (8, 1) or (4, 1) rows and stages, the
    first that fits with 16-byte-multiple panels; past them (f32 d
    ~14,400, bf16 ~28,900, int8 ~57,800, or rows whose 8- and 4-row
    panels are no 16-byte multiple) K-panels: K5_KPANEL_BYTES of each of
    32 rows a stage (16 if chunk % 32), two stages, and the carried
    accumulators."""
    if chunk % 16:
        raise ValueError("stream_shared_plane: chunk % 16 != 0")
    row_bytes = d * itemsize
    rows = 16
    for r in range(32, chunk + 1, 16):
        if chunk % r == 0 and r * row_bytes <= K5_PANEL_TARGET:
            rows = r
    stages = K5_MAX_STAGES if rows * row_bytes <= K5_PANEL_TARGET else 2
    for r, n in ((rows, stages), (16, 2), (8, 2), (8, 1), (4, 1)):
        b = r * row_bytes
        if b % 16 == 0 and n * b <= K5_RING_BYTES:
            return SharedPlan(r, n, d, n * b)
    rows = _K5_ITEM_ROWS if chunk % _K5_ITEM_ROWS == 0 else 16
    seg_stride = K5_KPANEL_BYTES + (0 if row_bytes % 16 == 0 else 32)
    return SharedPlan(rows, 2, K5_KPANEL_BYTES // itemsize, 2 * rows * seg_stride + _K5_PART_BYTES)


def _require_aligned(name: str, vecs) -> None:
    """K4 and K5 copy rows by cp.async.bulk, from 16-byte aligned sources."""
    if vecs.data_ptr() % 16:
        raise ValueError(f"{name}: the table must start on a 16-byte boundary")


def _row_type(name: str, vecs, scales, allowed=STREAM_DTYPES):
    """(row_type code, launch-count label, the scales the kernel reads) of a
    table, or TypeError / ValueError."""
    if vecs.dtype not in allowed:
        raise TypeError(f"{name}: the kernel takes {allowed} tables, got {vecs.dtype}")
    if vecs.dtype != torch.int8:
        return (*kb.ROW_TYPES[vecs.dtype], None)
    if scales is None:
        raise ValueError(f"{name}: an int8 table needs its per-cluster scales")
    return (*kb.ROW_TYPES[vecs.dtype], scales)


def stream_distances(queries, cent, cid2d, blk2d, bias2d, vecs, norms,
                     *, chunk: int, metric: str, scales=None, nval2d=None):
    """K2. CPU tensors -> plain version; CUDA tensors -> the kernel: one
    block per run of a query's slots (``stream_distances_plan``), or, past
    its rows, the split launch (``stream_distances_split_plan``). With
    ``nval2d`` the kernel reads only each slot's valid rows and the lanes
    past them are +inf."""
    if queries.device.type == "cpu":
        return stream_distances_reference(
            queries, cent, cid2d, blk2d, bias2d, vecs, norms, chunk=chunk, metric=metric,
            scales=scales, nval2d=nval2d,
        )
    code, label, scl = _row_type("stream_distances", vecs, scales)
    nq, t = blk2d.shape
    d = queries.shape[1]
    plan = stream_distances_plan(d, vecs.element_size(), t, chunk)
    # The split launch reads the task grid as build_task_grid makes it (int64);
    # the one-block-per-run launch reads int32.
    idx = torch.int32 if plan is not None else torch.int64
    args = [queries.contiguous(), cent.contiguous(), cid2d.to(idx).contiguous(),
            blk2d.to(idx).contiguous()]
    nval = None if nval2d is None else nval2d.to(idx).contiguous()
    rest = [bias2d.contiguous(), vecs, norms]
    kb.require_cuda("stream_distances", *args, *rest,
                    *[x for x in (nval, scl) if x is not None])
    out = torch.empty((nq, t, chunk), dtype=torch.float32, device=queries.device)
    head = [*map(kb.ptr, args), kb.ptr(nval), *map(kb.ptr, rest), kb.ptr(scl), nq, t, chunk, d,
            int(metric == "l2"), code]
    if plan is None:
        _require_aligned("stream_distances", vecs)
        split = stream_distances_split_plan(d, vecs.element_size(), chunk, nq, t,
                                            kb.sm_count(queries.device))
        part = torch.empty(nq * t * split.n_slices * chunk, dtype=torch.float32,
                           device=queries.device)
        kb.launch(f"stream_distances[{label}]", "vitorch_stream_distances_split", *head,
                  split.slice, split.parts, split.sub_rows, split.stage_bytes, kb.ptr(part),
                  kb.ptr(out), kb.stream_of(out))
        return out
    kb.launch(f"stream_distances[{label}]", "vitorch_stream_distances", *head, plan.lpr,
              plan.spb, kb.ptr(out), kb.stream_of(out))
    return out


def split_parts(nvalid, parts: int):
    """The split launch's parts of one query's valid rows, as its kernel
    finds them: the rows of ``nvalid`` (valid rows per slot) taken in slot
    order as one sequence and cut into ``parts`` runs of ceil(total /
    parts) rows (the last shorter, or empty). -> per part, its (slot, first
    row, rows) runs in slot order."""
    counts = [int(v) for v in nvalid]
    ends = np.cumsum(counts)  # each slot's end in the flattened rows
    total = int(ends[-1]) if counts else 0
    per = -(-total // parts)
    out = []
    for p in range(parts):
        lo = min(p * per, total)
        hi = min(lo + per, total)
        runs = []
        s = int(np.searchsorted(ends, lo, side="right"))  # the slot holding row lo
        while lo < hi:
            take = min(int(ends[s]), hi) - lo
            if take > 0:
                runs.append((s, lo - (int(ends[s]) - counts[s]), take))
            lo += take
            s += 1
        out.append(runs)
    return out


def stream_distances_split_reference(queries, cent, cid2d, blk2d, bias2d, vecs, norms, *,
                                     chunk: int, metric: str, slice_: int, parts: int,
                                     scales=None, nval2d=None):
    """Plain version of K2's split launch: each part of each query's valid
    rows (``split_parts``; every lane without ``nval2d``) writes its rows'
    dots with q - c (ip: q), ``slice_`` elements of d at a time, into a
    scratch plane of partial dots (NaN where no part writes); a finish pass
    sums each row's partials in slice order, applies the scale, bias and
    norm, and writes +inf past each slot's valid count. Only the dot's
    summation order differs from ``stream_distances_reference``."""
    nq, t = blk2d.shape
    d = queries.shape[1]
    n_slices = -(-d // slice_)
    blocks = vecs.view(-1, chunk, d)
    nvalid = torch.full((nq, t), chunk) if nval2d is None else nval2d.clamp(0, chunk).cpu()
    part = torch.full((nq, t, n_slices, chunk), float("nan"), device=queries.device)
    for qi in range(nq):
        for runs in split_parts(nvalid[qi].tolist(), parts):
            for s, r, n in runs:
                qc = queries[qi] - cent[int(cid2d[qi, s])] if metric == "l2" else queries[qi]
                rows = blocks[int(blk2d[qi, s]), r:r + n].to(torch.float32)
                for k in range(n_slices):
                    k0, k1 = k * slice_, min(d, (k + 1) * slice_)
                    part[qi, s, k, r:r + n] = rows[:, k0:k1] @ qc[k0:k1]
    cross = torch.zeros((nq, t, chunk), dtype=torch.float32, device=queries.device)
    for k in range(n_slices):
        cross = cross + part[:, :, k]
    slot_scl = _slot_scales(scales, cid2d, vecs)
    if slot_scl is not None:
        cross = cross * slot_scl[:, :, None]
    nrm = norms.view(-1, chunk)[blk2d.long()]
    bias = bias2d[:, :, None]
    if metric == "l2":
        dist = bias - 2.0 * cross + nrm
    else:
        dist = bias - cross + torch.where(nrm >= 1e29, nrm, torch.zeros_like(nrm))
    lane = torch.arange(chunk, device=dist.device)
    return torch.where(lane[None, None, :] < nvalid.to(dist.device)[:, :, None], dist,
                       float("inf"))


# ---------------------------------------------------------------------------
# K4: fused per-(group, lane) top-2 planes
# ---------------------------------------------------------------------------


def stream_fused_plane_reference(queries, cent, cid2d, blk2d, nval2d, bias2d, vecs,
                                 norms, *, chunk: int, groups: int, metric: str,
                                 scales=None):
    """Plain version of K4: K2's distances with lanes >= nval set to +inf,
    folded slot by slot in the reference's order (local slot u outer, fan f
    inner, group f % G) into per-(group, lane) best/second planes with
    strict '<'. Returns (dist_plane (nq, 2 G chunk) f32, slot_plane i32)."""
    nq, t_fixed = blk2d.shape
    t_sub = t_fixed // FAN
    dist = stream_distances_reference(
        queries, cent, cid2d, blk2d, bias2d, vecs, norms, chunk=chunk, metric=metric,
        scales=scales, nval2d=nval2d,
    )
    inf = float("inf")
    bv = torch.full((nq, groups, chunk), inf, device=dist.device)
    bs = torch.full((nq, groups, chunk), -1, dtype=torch.int32, device=dist.device)
    sv, ss = bv.clone(), bs.clone()
    for u in range(t_sub):
        for f in range(FAN):
            s = f * t_sub + u
            g = f % groups
            dv = dist[:, s]
            b, bi, s2, si = bv[:, g], bs[:, g], sv[:, g], ss[:, g]
            better = dv < b
            disp = torch.where(better, b, dv)  # the displaced candidate
            disp_i = torch.where(better, bi, s)
            sec = disp < s2
            sv[:, g] = torch.where(sec, disp, s2)
            ss[:, g] = torch.where(sec, disp_i, si)
            bv[:, g] = torch.where(better, dv, b)
            bs[:, g] = torch.where(better, s, bi)
    return (
        torch.cat([bv.reshape(nq, -1), sv.reshape(nq, -1)], dim=1),
        torch.cat([bs.reshape(nq, -1), ss.reshape(nq, -1)], dim=1),
    )


def stream_fused_plane_split_reference(queries, cent, cid2d, blk2d, nval2d, bias2d, vecs,
                                       norms, *, chunk: int, groups: int, metric: str,
                                       slice_: int, scales=None):
    """Plain version of K4's split launch: each valid row's dot with q - c
    (ip: q) taken slice by slice (``slice_`` elements of d at a time), the
    slices' partial dots summed in slice order, then the scale, bias and
    norm applied and the rows folded exactly as
    ``stream_fused_plane_reference`` folds them. Only the dot's summation
    order differs from it: the planes hold the same values up to f32
    rounding, and the same slots wherever no two candidates of a lane
    tie."""
    nq, t_fixed = blk2d.shape
    d = queries.shape[1]
    blocks = vecs.view(-1, chunk, d)
    qc = queries[:, None, :] - cent[cid2d.long()] if metric == "l2" else \
        queries[:, None, :].expand(-1, t_fixed, -1)
    rows = blocks[blk2d.long()].to(torch.float32)  # (nq, t_fixed, chunk, d)
    cross = torch.zeros((nq, t_fixed, chunk), dtype=torch.float32, device=queries.device)
    for k0 in range(0, d, slice_):
        cross = cross + torch.matmul(rows[..., k0:k0 + slice_],
                                     qc[..., k0:k0 + slice_].unsqueeze(-1)).squeeze(-1)
    slot_scl = _slot_scales(scales, cid2d, vecs)
    if slot_scl is not None:
        cross = cross * slot_scl[:, :, None]
    nrm = norms.view(-1, chunk)[blk2d.long()]
    bias = bias2d[:, :, None]
    if metric == "l2":
        dist = bias - 2.0 * cross + nrm
    else:
        dist = bias - cross + torch.where(nrm >= 1e29, nrm, torch.zeros_like(nrm))
    lane = torch.arange(chunk, device=dist.device)
    dist = torch.where(lane[None, None, :] < nval2d[:, :, None], dist, float("inf"))
    return fold_planes(dist, groups)


def fold_planes(dist, groups: int):
    """The reference's fold of an (nq, t_fixed, chunk) distance plane into
    per-(group, lane) best / second planes and their slots (local slot u
    outer, fan f inner, group f % G, strict '<'). -> (dist_plane,
    slot_plane). Written apart from stream_fused_plane_reference's own
    fold, which stays the oracle the split rule is held to."""
    nq, t_fixed, chunk = dist.shape
    t_sub = t_fixed // FAN
    inf = float("inf")
    bv = torch.full((nq, groups, chunk), inf, device=dist.device)
    bs = torch.full((nq, groups, chunk), -1, dtype=torch.int32, device=dist.device)
    sv, ss = bv.clone(), bs.clone()
    for u in range(t_sub):
        for f in range(FAN):
            s = f * t_sub + u
            g = f % groups
            dv = dist[:, s]
            b, bi, s2, si = bv[:, g], bs[:, g], sv[:, g], ss[:, g]
            better = dv < b
            disp = torch.where(better, b, dv)  # the displaced candidate
            disp_i = torch.where(better, bi, s)
            sec = disp < s2
            sv[:, g] = torch.where(sec, disp, s2)
            ss[:, g] = torch.where(sec, disp_i, si)
            bv[:, g] = torch.where(better, dv, b)
            bs[:, g] = torch.where(better, s, bi)
    return (
        torch.cat([bv.reshape(nq, -1), sv.reshape(nq, -1)], dim=1),
        torch.cat([bs.reshape(nq, -1), ss.reshape(nq, -1)], dim=1),
    )


def stream_fused_plane(queries, cent, cid2d, blk2d, nval2d, bias2d, vecs, norms,
                       *, chunk: int, groups: int, metric: str, scales=None):
    """K4 (bf16 and int8 tables). CPU tensors -> plain version; CUDA
    tensors -> the kernel: one block per (query, group) in the register
    modes (d <= 1024), the split launch past them
    (``stream_fused_split_plan``)."""
    if queries.device.type == "cpu":
        return stream_fused_plane_reference(
            queries, cent, cid2d, blk2d, nval2d, bias2d, vecs, norms,
            chunk=chunk, groups=groups, metric=metric, scales=scales,
        )
    code, label, scl = _row_type("stream_fused_plane", vecs, scales,
                                 (torch.bfloat16, torch.int8))
    nq, t_fixed = blk2d.shape
    if t_fixed % FAN:
        raise ValueError(f"stream_fused_plane: t_fixed must be a multiple of {FAN}")
    d = queries.shape[1]
    i32 = torch.int32
    args = [queries.contiguous(), cent.contiguous(), cid2d.to(i32).contiguous(),
            blk2d.to(i32).contiguous(), nval2d.to(i32).contiguous(),
            bias2d.contiguous(), vecs, norms]
    kb.require_cuda("stream_fused_plane", *args, *([scl] if scl is not None else []))
    _require_aligned("stream_fused_plane", vecs)
    width = 2 * groups * chunk
    dist_plane = torch.empty((nq, width), dtype=torch.float32, device=queries.device)
    slot_plane = torch.empty((nq, width), dtype=i32, device=queries.device)
    split = stream_fused_split_plan(d, vecs.element_size(), chunk, nq, groups, t_fixed,
                                    kb.sm_count(queries.device))
    if split is not None:
        part = torch.empty(nq * t_fixed * split.n_slices * chunk, dtype=torch.float32,
                           device=queries.device)
        kb.launch(
            f"stream_fused_plane[{label}]", "vitorch_stream_fused_split",
            *map(kb.ptr, args), kb.ptr(scl), nq, t_fixed, t_fixed // FAN, chunk, groups, d,
            int(metric == "l2"), code, split.slice, split.parts, split.sub_rows,
            split.stage_bytes, kb.ptr(part), kb.ptr(dist_plane), kb.ptr(slot_plane),
            kb.stream_of(dist_plane),
        )
        return dist_plane, slot_plane
    plan = stream_fused_plan(d, vecs.element_size(), chunk)
    kb.launch(
        f"stream_fused_plane[{label}]", "vitorch_stream_fused_plane",
        *map(kb.ptr, args), kb.ptr(scl), nq, t_fixed, t_fixed // FAN, chunk, groups, d,
        int(metric == "l2"), code, plan.nch, plan.lpr, plan.sub_rows, plan.row_align,
        plan.stage_bytes, kb.ptr(dist_plane), kb.ptr(slot_plane), kb.stream_of(dist_plane),
    )
    return dist_plane, slot_plane


# ---------------------------------------------------------------------------
# Search
# ---------------------------------------------------------------------------


def _rows_of(dvals, ci, blk2d, table: StreamTable):
    """Plane column -> (distance, main layout row) of a (slot, lane) plane
    of width t_fixed * chunk; sentinel and missing entries -> +inf / -1."""
    chunk = table.chunk
    ci0 = ci.clamp_min(0)
    blk_sel = torch.gather(blk2d, 1, ci0 // chunk)
    main_rows = table.to_main[blk_sel * chunk + ci0 % chunk]
    real = (ci >= 0) & torch.isfinite(dvals) & (dvals < 1e29)
    return (torch.where(real, dvals, float("inf")),
            torch.where(real, main_rows, torch.full_like(main_rows, -1)))


def block_stream_search(queries, table: StreamTable, probe, k: int, *,
                        t_fixed: int, metric: str = "l2", approx: bool = True,
                        fused: Optional[bool] = None):
    """-> (D (nq, k) f32, main layout rows (nq, k) int64), +inf / -1 padded.

    Each query gets ``t_fixed`` chunk-row task slots, nearest probed lists
    first. ``fused`` picks K4 (default: ``fused_engages`` when ``approx``;
    K4's top-2-per-lane planes are an approximate selection, so
    ``approx=False``, the stream_exact program, never engages it, and
    neither does an f32 table, which only that program builds); otherwise K2
    plus a masked top-k over the (nq, t_fixed * chunk) plane. The final
    selection is exact (the reference's approximate selection is exact on
    its CPU backend, which is what the parity tests compare)."""
    nq = queries.shape[0]
    chunk = table.chunk
    blk2d, cid2d, nval2d, bias2d = build_task_grid(queries, table, probe, t_fixed, metric)
    G = pick_stream_groups(chunk)
    if fused is None:
        fused = approx and table.dtype != torch.float32 and fused_engages(t_fixed, chunk, k)
    if fused and k > 2 * G * chunk:
        fused = False  # selection cannot return more than the plane holds
    if fused:
        dist_plane, slot_plane = stream_fused_plane(
            queries, table.cent, cid2d, blk2d, nval2d, bias2d, table.vecs,
            table.norms, chunk=chunk, groups=G, metric=metric, scales=table.scales,
        )
        dvals, ci = topk_smallest(dist_plane, k)
        # Plane column -> (winning slot, lane) -> a column of the slot plane.
        s_sel = torch.gather(slot_plane.long(), 1, ci.clamp_min(0))
        ci = torch.where((ci >= 0) & (s_sel >= 0), s_sel * chunk + ci % chunk, -1)
        return _rows_of(dvals, ci, blk2d, table)
    dist = stream_distances(
        queries, table.cent, cid2d, blk2d, bias2d, table.vecs, table.norms,
        chunk=chunk, metric=metric, scales=table.scales, nval2d=nval2d,
    )
    dvals, ci = topk_smallest(dist.reshape(nq, t_fixed * chunk), k)
    return _rows_of(dvals, ci, blk2d, table)


# ---------------------------------------------------------------------------
# K5: the block-major shared stream
# ---------------------------------------------------------------------------
#
# The per-query kernels read every probed block once PER QUERY; in a large
# batch many queries probe the same cluster. The shared variant inverts the
# task list: one task is one (block, <= Q_SHARE queries) group, built by
# sorting the (query, slot) pairs by block id, so the block is read once and
# scored against every query of its group. K5 writes a task-major plane
# (t_cap, Q_SHARE, chunk); the pairs' rows are gathered back to query order
# and the lane-constant bias (|q-c|^2 or -q.c) is added after the gather.

Q_SHARE = 8  # query rows per task
# The reference's task-cap grain (Q_SHARE x its 8-task grid step), kept so
# both packages size t_cap alike; the port's kernel takes any t_cap.
_TASK_ALIGN = 64


def shared_task_cap(lengths_np, n_probe: int, nq_tile: int, t_fixed: int,
                    worst_case: bool = False, chunk: int = CHUNK) -> int:
    """Static task budget of a query tile. The worst case
    sum_b ceil(c_b / Q) <= npairs // Q + min(npairs, nblocks) never drops a
    (query, chunk) pair; the default sizes to ~1.15x the expected number of
    distinct probed blocks plus the full-task term."""
    ln = np.asarray(lengths_np, np.float64)
    npairs = nq_tile * t_fixed
    nblocks = int(np.ceil(np.maximum(ln, 1) / chunk).sum())
    # A task holds >= 1 pair, so npairs is itself a hard task bound.
    worst = min(npairs, npairs // Q_SHARE + min(npairs, nblocks) + 1)
    if worst_case:
        return _round_up(worst, _TASK_ALIGN)
    n = max(ln.sum(), 1.0)
    p_probed = np.minimum(1.0, n_probe * ln / n)
    # P(cluster probed by >= 1 query of the tile) x its chunk count.
    e_blocks = float(((1.0 - (1.0 - p_probed) ** nq_tile) * np.ceil(ln / chunk)).sum())
    exp = int(1.15 * (e_blocks + npairs / Q_SHARE)) + 8
    return _round_up(min(worst, quantize_up(exp)), _TASK_ALIGN)


@dataclasses.dataclass
class SharedTasks:
    """A tile's block-major task list (K5's inputs) and the map back."""

    qc: torch.Tensor  # (t_cap, Q_SHARE, d) f32 query rows q - c (l2) or q (ip)
    blk: torch.Tensor  # (t_cap,) int32 block per task; -1 = unused task
    scl: torch.Tensor  # (t_cap,) f32 the block's cluster dequant scale
    plane_row: torch.Tensor  # (nq * t_fixed,) int64 plane row of each pair
    written: torch.Tensor  # (nq * t_fixed,) bool: pair is a real, kept pair


def build_shared_tasks(queries, table: StreamTable, blk2d, nval2d, t_cap: int,
                       metric: str) -> SharedTasks:
    """Invert a tile's (query, slot) pairs into block-major tasks of up to
    Q_SHARE pairs. A two-pass stable sort orders the pairs by (the block's
    best probe rank, block, probe rank, query): pass 1 groups pairs by
    (block, probe rank), pass 2 moves whole blocks by their best rank. So
    when the tasks overflow ``t_cap``, the dropped tasks are those whose
    best pair has the worst probe rank, as the per-query kernels drop the
    farthest probes. Pairs of dropped tasks and unused slots read +inf."""
    nq, t_fixed = blk2d.shape
    d = queries.shape[1]
    dev = queries.device
    chunk = table.chunk
    npairs = nq * t_fixed
    nblocks = table.m_pad // chunk
    iota = torch.arange(npairs, device=dev)
    # Unused slots take a sentinel block id and sink to the end.
    blk_f = torch.where(nval2d > 0, blk2d, nblocks).reshape(-1).long()
    slot_f = iota % t_fixed  # probe-rank proxy (slots fill nearest-first)

    def segment_starts(keys):
        is_start = torch.ones_like(keys, dtype=torch.bool)
        is_start[1:] = keys[1:] != keys[:-1]
        return torch.cummax(torch.where(is_start, iota, 0), 0).values

    # Pass 1: (block, slot, query) order. One stable sort on the composite
    # int64 key is the reference's two chained stable sorts.
    ord1 = torch.argsort(blk_f * t_fixed + slot_f, stable=True)
    ks1 = blk_f[ord1]
    prio1 = slot_f[ord1][segment_starts(ks1)]  # the block's best probe rank
    # Pass 2: whole blocks by best rank (pass 1 is block-minor, so a stable
    # sort by rank keeps each block's pairs together).
    ord2 = torch.argsort(prio1, stable=True)
    ordv = ord1[ord2]
    ks = ks1[ord2]
    rank = iota - segment_starts(ks)
    newtask = ((rank % Q_SHARE) == 0) & (ks < nblocks)
    # Task start positions in block order (a stable 0/1 sort compacts them).
    pos_all = torch.argsort((~newtask).to(torch.uint8), stable=True)
    pos_t = pos_all[:t_cap]
    if t_cap > npairs:
        pos_t = torch.cat([pos_t, pos_t.new_zeros(t_cap - npairs)])
    valid_task = torch.arange(t_cap, device=dev) < newtask.sum()
    blk_t = torch.where(valid_task, ks[pos_t], -1)
    cid_t = table.blk_cid[blk_t.clamp_min(0)]

    pos = pos_t[:, None] + torch.arange(Q_SHARE, device=dev)[None, :]  # (t_cap, Q)
    pos_c = pos.clamp_max(npairs - 1)
    in_task = valid_task[:, None] & (pos < npairs) & (ks[pos_c] == blk_t[:, None])
    # Unused task slots take a zero query row (index nq); their plane rows
    # are never gathered.
    qi = torch.where(in_task, ordv[pos_c] // t_fixed, nq)
    qall = torch.cat([queries, queries.new_zeros(1, d)])
    qc = qall[qi]  # (t_cap, Q, d)
    if metric == "l2":
        qc = qc - table.cent[cid_t][:, None, :]

    # Sorted position i sits in task (#task starts <= i) - 1 at in-task rank
    # rank % Q_SHARE; tasks past t_cap are dropped.
    tid = torch.cumsum(newtask, 0) - 1
    written_s = (ks < nblocks) & (tid >= 0) & (tid < t_cap)
    row_s = tid.clamp(0, t_cap - 1) * Q_SHARE + rank % Q_SHARE
    inv = torch.empty_like(ordv)
    inv[ordv] = iota  # pair -> sorted position
    return SharedTasks(
        qc=qc.contiguous(), blk=blk_t.to(torch.int32), scl=table.scales[cid_t],
        plane_row=row_s[inv], written=written_s[inv],
    )


def stream_shared_plane_reference(qc, blk_t, scl_t, vecs, norms, *, chunk: int,
                                  metric: str):
    """Plain version of K5: the task-major (t_cap, Q_SHARE, chunk) plane.
    Task t scores block blk_t[t] against its query rows: l2
    |r^|^2 - 2 qc.r^, ip penalty - q.r^ (the bias is added by the caller);
    int8 rows are scaled by scl_t[t]. Unused tasks (blk_t < 0) are +inf."""
    t_cap, q_share, d = qc.shape
    blocks = vecs.view(-1, chunk, d)
    nrm_blocks = norms.view(-1, chunk)
    out = torch.empty((t_cap, q_share, chunk), dtype=torch.float32, device=qc.device)
    step = max(1, (1 << 25) // max(1, chunk * d))  # tasks per tile
    for s in range(0, t_cap, step):
        e = min(t_cap, s + step)
        blk = blk_t[s:e].long()
        rows = blocks[blk.clamp_min(0)].to(torch.float32)  # (b, chunk, d)
        cross = torch.matmul(qc[s:e], rows.transpose(1, 2))  # (b, Q, chunk)
        if vecs.dtype == torch.int8:
            cross = cross * scl_t[s:e, None, None]
        nrm = nrm_blocks[blk.clamp_min(0)][:, None, :]
        if metric == "l2":
            v = nrm - 2.0 * cross
        else:
            v = torch.where(nrm >= 1e29, nrm, torch.zeros_like(nrm)) - cross
        out[s:e] = torch.where((blk >= 0)[:, None, None], v, float("inf"))
    return out


def stream_shared_plane(qc, blk_t, scl_t, vecs, norms, *, chunk: int, metric: str):
    """K5. CPU tensors -> plain version; CUDA tensors -> the kernel (which
    leaves the rows of unused tasks unwritten: no pair reads them)."""
    if qc.device.type == "cpu":
        return stream_shared_plane_reference(qc, blk_t, scl_t, vecs, norms, chunk=chunk,
                                             metric=metric)
    code, label, _ = _row_type("stream_shared_plane", vecs, scl_t)
    t_cap, q_share, d = qc.shape
    plan = stream_shared_plan(d, vecs.element_size(), chunk)
    args = [qc.contiguous(), blk_t.to(torch.int32).contiguous(), scl_t.contiguous(),
            vecs, norms]
    kb.require_cuda("stream_shared_plane", *args)
    _require_aligned("stream_shared_plane", vecs)
    plane = torch.empty((t_cap, q_share, chunk), dtype=torch.float32, device=qc.device)
    kb.launch(
        f"stream_shared_plane[{label}]", "vitorch_stream_shared_plane",
        *map(kb.ptr, args), t_cap, q_share, chunk, d, int(metric == "l2"), code,
        plan.panel_rows, plan.stages, plan.kpanel, kb.ptr(plane), kb.stream_of(plane),
    )
    return plane


def block_stream_search_shared(queries, table: StreamTable, probe, k: int, *,
                               t_fixed: int, t_cap: int, metric: str = "l2"):
    """Shared-block variant of ``block_stream_search`` (kernel K5): the same
    contract (-> (D, main rows), +inf / -1 padded), but each probed block is
    read once per task of up to Q_SHARE queries of the tile instead of once
    per query. Tasks beyond ``t_cap`` are dropped (their pairs stay +inf;
    size t_cap with worst_case=True to forbid drops). Selection is exact."""
    nq = queries.shape[0]
    chunk = table.chunk
    blk2d, _, nval2d, bias2d = build_task_grid(queries, table, probe, t_fixed, metric)
    tasks = build_shared_tasks(queries, table, blk2d, nval2d, t_cap, metric)
    plane = stream_shared_plane(tasks.qc, tasks.blk, tasks.scl, table.vecs, table.norms,
                                chunk=chunk, metric=metric)
    dist = plane.view(-1, chunk)[tasks.plane_row]  # (npairs, chunk), query order
    dist = torch.where(tasks.written[:, None], dist, float("inf"))
    dist = dist.view(nq, t_fixed, chunk) + bias2d[:, :, None]
    dvals, ci = topk_smallest(dist.view(nq, t_fixed * chunk), k)
    return _rows_of(dvals, ci, blk2d, table)
