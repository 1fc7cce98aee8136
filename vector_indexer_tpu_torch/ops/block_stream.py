"""Probed-blocks stream search: the stream table, its task grid, and
kernels K2 (per-task distance rows) and K4 (fused top-2-per-lane planes).

Port of ``vector_indexer_tpu/ops/pallas/block_stream.py`` (bf16 path).

* A **stream table** re-packs the posting table so that every cluster
  starts at a ``chunk``-row-aligned base and stores RESIDUAL rows
  (vector - centroid) in bf16, with the f32 norms of the STORED rows. So
  |q-c|^2 - 2 (q-c).r^ + |r^|^2 is exactly |q - (c + r^)|^2: the search
  distance is exact to the quantized point.
* Each probed list becomes ceil(len / chunk) **tasks**; every query gets
  ``t_fixed`` task slots, nearest probes first (chunks past ``t_fixed`` are
  dropped, a recall trade sized by ``per_query_slots``).
* **K2** (``stream_distances``) scores every task's block into an
  (nq, t_fixed, chunk) plane; lanes past a list's end are masked here in
  PyTorch before a top-k. **K4** (``stream_fused_plane``) keeps the
  selection on chip and returns per-(group, lane) best/second planes with
  their slot ids; it engages once a query's task plane is wide
  (``fused_engages``), as in the reference.

The sizing constants (chunk target, FAN, the fused threshold) are the
reference's TPU-calibrated values, copied unchanged until they are
re-measured on the H100 (ROADMAP Queue 1 item 10). Each kernel wrapper runs
its plain PyTorch version on a CPU tensor and launches its CUDA kernel on a
CUDA tensor (or raises).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..kernels import build as kb
from .gather import quantize_up
from .topk import topk_smallest

CHUNK = 256  # default rows per task block
FAN = 16  # slots are grouped in FAN fans (fold order of K4; t_fixed % FAN == 0)
SMEM_TASK_CAP = 30_720  # per-tile task budget (sizes the query tile)
FUSED_STREAM_MIN_ROWS = 12 << 10  # probed rows/query where K4 engages
_TARGET_BLOCK_BYTES = 128 << 10


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


@dataclasses.dataclass
class StreamTable:
    """chunk-aligned bf16 residual re-pack of a PostingLayout."""

    vecs: torch.Tensor  # (m_pad, d) bf16 residual rows (x - centroid[c])
    norms: torch.Tensor  # (m_pad,) f32 |stored residual|^2; 1e30 on pad rows
    to_main: torch.Tensor  # (m_pad,) int64 stream row -> main layout row
    sblk0: torch.Tensor  # (kc,) int64 per-cluster start block
    lengths: torch.Tensor  # (kc,) int64 posting lengths
    cent: torch.Tensor  # (kc, d) f32 centroids (residual bases)
    m_pad: int
    chunk: int = CHUNK


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


def build_stream_table(layout, centroids, chunk: Optional[int] = None) -> StreamTable:
    """Re-pack the layout into chunk-aligned cluster blocks of bf16 residual
    rows on the layout's device, in row tiles of 2^19 to bound the f32
    transient. Only the bf16 table is ported (the int8 and f32 stream_exact
    tables: ROADMAP Queue 2)."""
    dev = layout.vectors.device
    d = layout.dim
    main_pad_row = layout.vectors.shape[0] - 1
    chunk, bases, m_pad, to_main, row_cid = _stream_maps(
        layout.lengths, layout.offsets[:-1], d, 2, main_pad_row, chunk
    )
    cent = torch.as_tensor(np.asarray(centroids), dtype=torch.float32, device=dev)
    to_main_t = torch.as_tensor(to_main, device=dev)
    row_cid_t = torch.as_tensor(row_cid, device=dev)
    real = to_main_t != main_pad_row
    vecs = torch.empty((m_pad, d), dtype=torch.bfloat16, device=dev)
    norms = torch.empty(m_pad, dtype=torch.float32, device=dev)
    R = 1 << 19
    for lo in range(0, m_pad, R):
        hi = min(lo + R, m_pad)
        res = layout.vectors[to_main_t[lo:hi]]  # gather: a fresh tile
        # In place on the tile: residual, then zero the pad rows.
        res.sub_(cent[row_cid_t[lo:hi]]).mul_(real[lo:hi, None])
        stored = res.to(torch.bfloat16)
        vecs[lo:hi] = stored
        deq = stored.to(torch.float32)
        norms[lo:hi] = torch.where(
            real[lo:hi], torch.sum(deq * deq, dim=1), torch.tensor(1e30, device=dev)
        )
    return StreamTable(
        vecs=vecs,
        norms=norms,
        to_main=to_main_t,
        sblk0=torch.as_tensor(bases // chunk, device=dev),
        lengths=torch.as_tensor(layout.lengths.astype(np.int64), device=dev),
        cent=cent,
        m_pad=m_pad,
        chunk=chunk,
    )


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


def stream_distances_reference(queries, cent, cid2d, blk2d, bias2d, vecs, norms,
                               *, chunk: int, metric: str):
    """Plain version of K2: (nq, t_fixed, chunk) f32 distances of every
    task's block (every lane, including lanes past the list's end)."""
    nq, t = blk2d.shape
    d = queries.shape[1]
    blocks = vecs.view(-1, chunk, d)
    nrm_blocks = norms.view(-1, chunk)
    out = torch.empty((nq, t, chunk), dtype=torch.float32, device=queries.device)
    step = max(1, (1 << 25) // max(1, t * chunk * d))  # queries per tile
    for s in range(0, nq, step):
        e = min(nq, s + step)
        blk = blk2d[s:e].long()
        q = queries[s:e, None, :]
        qc = q - cent[cid2d[s:e].long()] if metric == "l2" else q.expand(-1, t, -1)
        rows = blocks[blk].to(torch.float32)  # (b, t, chunk, d)
        cross = torch.matmul(rows, qc.unsqueeze(-1)).squeeze(-1)  # (b, t, chunk)
        nrm = nrm_blocks[blk]
        bias = bias2d[s:e, :, None]
        if metric == "l2":
            out[s:e] = bias - 2.0 * cross + nrm
        else:
            out[s:e] = bias - cross + torch.where(nrm >= 1e29, nrm, torch.zeros_like(nrm))
    return out


def stream_distances(queries, cent, cid2d, blk2d, bias2d, vecs, norms,
                     *, chunk: int, metric: str):
    """K2. CPU tensors -> plain version; CUDA tensors -> the kernel."""
    if queries.device.type == "cpu":
        return stream_distances_reference(
            queries, cent, cid2d, blk2d, bias2d, vecs, norms, chunk=chunk, metric=metric
        )
    if vecs.dtype != torch.bfloat16:
        raise TypeError("stream_distances: the kernel takes a bf16 stream table")
    nq, t = blk2d.shape
    d = queries.shape[1]
    args = [queries.contiguous(), cent.contiguous(), cid2d.to(torch.int32).contiguous(),
            blk2d.to(torch.int32).contiguous(), bias2d.contiguous(), vecs, norms]
    kb.require_cuda("stream_distances", *args)
    out = torch.empty((nq, t, chunk), dtype=torch.float32, device=queries.device)
    kb.launch(
        "stream_distances", "vitorch_stream_distances",
        *map(kb.ptr, args), nq, t, chunk, d, int(metric == "l2"),
        kb.ptr(out), kb.stream_of(out),
    )
    return out


# ---------------------------------------------------------------------------
# K4: fused per-(group, lane) top-2 planes
# ---------------------------------------------------------------------------


def stream_fused_plane_reference(queries, cent, cid2d, blk2d, nval2d, bias2d, vecs,
                                 norms, *, chunk: int, groups: int, metric: str):
    """Plain version of K4: K2's distances with lanes >= nval set to +inf,
    folded slot by slot in the reference's order (local slot u outer, fan f
    inner, group f % G) into per-(group, lane) best/second planes with
    strict '<'. Returns (dist_plane (nq, 2 G chunk) f32, slot_plane i32)."""
    nq, t_fixed = blk2d.shape
    t_sub = t_fixed // FAN
    dist = stream_distances_reference(
        queries, cent, cid2d, blk2d, bias2d, vecs, norms, chunk=chunk, metric=metric
    )
    lane = torch.arange(chunk, device=dist.device)
    dist = torch.where(lane[None, None, :] < nval2d[:, :, None], dist, float("inf"))
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
                       *, chunk: int, groups: int, metric: str):
    """K4. CPU tensors -> plain version; CUDA tensors -> the kernel."""
    if queries.device.type == "cpu":
        return stream_fused_plane_reference(
            queries, cent, cid2d, blk2d, nval2d, bias2d, vecs, norms,
            chunk=chunk, groups=groups, metric=metric,
        )
    if vecs.dtype != torch.bfloat16:
        raise TypeError("stream_fused_plane: the kernel takes a bf16 stream table")
    nq, t_fixed = blk2d.shape
    if t_fixed % FAN:
        raise ValueError(f"stream_fused_plane: t_fixed must be a multiple of {FAN}")
    d = queries.shape[1]
    i32 = torch.int32
    args = [queries.contiguous(), cent.contiguous(), cid2d.to(i32).contiguous(),
            blk2d.to(i32).contiguous(), nval2d.to(i32).contiguous(),
            bias2d.contiguous(), vecs, norms]
    kb.require_cuda("stream_fused_plane", *args)
    width = 2 * groups * chunk
    dist_plane = torch.empty((nq, width), dtype=torch.float32, device=queries.device)
    slot_plane = torch.empty((nq, width), dtype=i32, device=queries.device)
    kb.launch(
        "stream_fused_plane", "vitorch_stream_fused_plane",
        *map(kb.ptr, args), nq, t_fixed, t_fixed // FAN, chunk, groups, d,
        int(metric == "l2"), kb.ptr(dist_plane), kb.ptr(slot_plane),
        kb.stream_of(dist_plane),
    )
    return dist_plane, slot_plane


# ---------------------------------------------------------------------------
# Search
# ---------------------------------------------------------------------------


def block_stream_search(queries, table: StreamTable, probe, k: int, *,
                        t_fixed: int, metric: str = "l2",
                        fused: Optional[bool] = None):
    """-> (D (nq, k) f32, main layout rows (nq, k) int64), +inf / -1 padded.

    Each query gets ``t_fixed`` chunk-row task slots, nearest probed lists
    first. ``fused`` picks K4 (default: ``fused_engages``); otherwise K2
    plus a masked top-k over the (nq, t_fixed * chunk) plane. Selection is
    exact (the reference's approximate selection is exact on its CPU
    backend, which is what the parity tests compare)."""
    nq = queries.shape[0]
    chunk = table.chunk
    blk2d, cid2d, nval2d, bias2d = build_task_grid(queries, table, probe, t_fixed, metric)
    G = pick_stream_groups(chunk)
    if fused is None:
        fused = fused_engages(t_fixed, chunk, k)
    if fused and k > 2 * G * chunk:
        fused = False  # selection cannot return more than the plane holds
    inf = torch.tensor(float("inf"), device=queries.device)
    if fused:
        dist_plane, slot_plane = stream_fused_plane(
            queries, table.cent, cid2d, blk2d, nval2d, bias2d, table.vecs,
            table.norms, chunk=chunk, groups=G, metric=metric,
        )
        dvals, ci = topk_smallest(dist_plane, k)
        ci0 = ci.clamp_min(0)
        s_sel = torch.gather(slot_plane.long(), 1, ci0)
        w_sel = ci0 % chunk  # lane within the chunk block
        blk_sel = torch.gather(blk2d, 1, s_sel.clamp_min(0))
        main_rows = table.to_main[blk_sel * chunk + w_sel]
        real = (ci >= 0) & (s_sel >= 0) & torch.isfinite(dvals) & (dvals < 1e29)
    else:
        dist = stream_distances(
            queries, table.cent, cid2d, blk2d, bias2d, table.vecs, table.norms,
            chunk=chunk, metric=metric,
        )
        lane = torch.arange(chunk, device=dist.device)
        dist = torch.where(lane[None, None, :] < nval2d[:, :, None], dist, inf)
        dvals, ci = topk_smallest(dist.reshape(nq, t_fixed * chunk), k)
        ci0 = ci.clamp_min(0)
        blk_sel = torch.gather(blk2d, 1, ci0 // chunk)
        main_rows = table.to_main[blk_sel * chunk + ci0 % chunk]
        real = (ci >= 0) & torch.isfinite(dvals)
    main_rows = torch.where(real, main_rows, torch.full_like(main_rows, -1))
    return torch.where(real, dvals, inf), main_rows
