"""Host-resident staged serving: a corpus bounded by host RAM, not device
memory.

Port of ``vector_indexer_tpu/index/staged.py``. The posting layout (vector
table, norms, CSR offsets) stays in host memory; the device holds the
centroid table. Per query batch:

1. the coarse scan on the device picks each query's probed cells with the
   masked dense program's tie-inclusive rule (a cell is probed when its
   coarse distance is <= the n_probe-th smallest), and their union comes
   back to the host;
2. the host packs the union's aligned posting runs (gap rows keep their
   sentinel norms), their norms, the block -> run map and the union's cell
   ids into one staging buffer, pinned on a card, that grows and is reused;
3. one non-blocking host-to-device copy ships it;
4. ``programs.dense_program`` sweeps the staged sub-table as it would the
   whole table: the staged buffer is itself a valid run layout, so the
   result sets are the device-resident dense path's.

``stage_dtype`` bfloat16 or int8 (int8 codes hold per-cell scaled
residuals x - c_cell, as the offload stream table does) halves or quarters
the copy; the device then ranks approximately and a widened shortlist is
re-ranked exactly on the host. Spilled indexes search (1+spill)k wide and
drop repeated ids on the host.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.distance import score, sq_norms
from ..storage.layout import ALIGN, SENTINEL_NORM
from ..utils.tracing import trace
from . import programs
from .dispatch import pick_q_tile
from .offload import _host_topk, host_dedup_topk

# Staging precisions and their shortlist widening (the int8 offload
# mode's policy: the exact host re-rank needs a wider device shortlist).
_WIDE = {torch.float32: 1, torch.bfloat16: 2, torch.int8: 4}


def _coarse_probe_mask(queries, centroids, c_sq, n_probe: int):
    """(nq, kc) bool: a cell is probed when its coarse L2 distance is <= the
    n_probe-th smallest (ties all probed, so a query can probe more than
    n_probe cells: the masked dense program's rule)."""
    dcoarse = score(queries, centroids, c_sq, sq_norms(queries), "l2")
    thresh = torch.kthvalue(dcoarse, n_probe, dim=1, keepdim=True).values
    return dcoarse <= thresh


def _pack_stage(lay, union):
    """The union cells' aligned posting runs as one run layout: (rows_idx
    (r_used,) source layout rows, gaps included; sub_starts, alens (U,) each
    run's start and aligned length in the staged buffer; r_used)."""
    starts = np.asarray(lay.offsets)[:-1]
    alens = (np.asarray(lay.lengths)[union].astype(np.int64) + ALIGN - 1) // ALIGN * ALIGN
    sub_starts = np.zeros(len(union), np.int64)
    if len(union) > 1:
        np.cumsum(alens[:-1], out=sub_starts[1:])
    r_used = int(alens.sum())
    # Row r of run i is source row starts[u_i] + (r - sub_starts[i]).
    rows_idx = np.repeat(starts[union] - sub_starts, alens) + np.arange(r_used)
    return rows_idx, sub_starts, alens, r_used


class _Stage:
    """The reused staging buffer (pinned on a card) and the event of its
    last copy to the device. ``IvfIndex._stage_lock`` gives it to one
    search at a time."""

    def __init__(self, device: torch.device):
        self.device = device
        self.host = torch.empty(0, dtype=torch.uint8)
        self.done = None

    def buffer(self, nbytes: int) -> torch.Tensor:
        """A host buffer of at least ``nbytes`` that no copy still reads."""
        if self.done is not None:
            self.done.synchronize()
            self.done = None
        if self.host.numel() < nbytes:
            cap = max(nbytes, self.host.numel() * 3 // 2)
            self.host = torch.empty(cap, dtype=torch.uint8,
                                    pin_memory=self.device.type == "cuda")
        return self.host[:nbytes]

    def to_device(self, buf: torch.Tensor) -> torch.Tensor:
        """One non-blocking copy of ``buf`` to the device (on the CPU the
        buffer itself serves)."""
        if self.device.type == "cpu":
            return buf
        dev = torch.empty(buf.numel(), dtype=torch.uint8, device=self.device)
        dev.copy_(buf, non_blocking=True)
        self.done = torch.cuda.Event()
        self.done.record(torch.cuda.current_stream(self.device))
        return dev


class _Segments:
    """Consecutive typed views of one byte buffer (4-byte aligned)."""

    def __init__(self, layout):
        self.layout, off = [], 0
        for name, dtype, shape in layout:
            n = int(np.prod(shape)) * torch.empty((), dtype=dtype).element_size()
            self.layout.append((name, dtype, shape, off, off + n))
            off += -(-n // 4) * 4
        self.nbytes = off

    def views(self, buf: torch.Tensor) -> dict:
        return {name: buf[a:b].view(dtype).view(shape)
                for name, dtype, shape, a, b in self.layout}


def _rerank_exact_host(lay, q, orig_rows, internal, metric: str):
    """Exact f32 distances of a (nq, kk) shortlist from the host layout
    (one batched matmul over the gathered rows)."""
    cand = lay.vectors[np.maximum(orig_rows, 0)]  # (nq, kk, d)
    cross = np.matmul(cand, q[:, :, None])[..., 0]
    if metric == "l2":
        exact = np.maximum(
            (q**2).sum(1)[:, None] - 2.0 * cross + lay.row_norms[np.maximum(orig_rows, 0)], 0.0
        )
    else:
        exact = -cross
    return np.where(internal >= 0, exact, np.inf).astype(np.float32)


def _quantize_int8(staged, cent_rows, real, sub_starts, alens):
    """int8 codes of the staged rows' residuals x - c_cell with one
    symmetric scale per cell (max |residual| of its real rows / 127), and
    the squared norms of the dequantized rows (gap rows keep their
    sentinel). -> (codes (r_used, d) int8, scale_row (r_used,), norms)."""
    res = staged - cent_rows
    absrow = np.abs(res).max(1) * real
    cell_max = np.maximum.reduceat(absrow, sub_starts)
    scale_c = np.maximum(cell_max / 127.0, 1e-30)
    scale_row = np.repeat(scale_c, alens)
    q8 = np.clip(np.round(res / scale_row[:, None]), -127, 127)
    deq = q8 * scale_row[:, None] + cent_rows
    return q8.astype(np.int8), scale_row.astype(np.float32), (deq * deq).sum(1)


def staged_search(idx, queries, k: int, n_probe: int):
    """Search a host-resident index: coarse scan on the device, the probed
    cells' runs staged by one copy, the masked dense program over them.
    -> (D (nq, k) f32, internal ids (nq, k) int64), padded +inf / -1.
    Records the copy's bytes in ``idx._last_stage_bytes``."""
    lay = idx.layout
    q = np.ascontiguousarray(queries, np.float32)
    if q.ndim == 1:
        q = q[None, :]
    nq, d = q.shape
    if d != idx.dimension:
        raise ValueError(f"query dimension mismatch: expected {idx.dimension}, got {d}")
    if idx.metric == "cosine":
        q = q / np.maximum(np.linalg.norm(q, axis=1, keepdims=True), 1e-12)
    metric = idx.metric if idx.metric != "cosine" else "ip"
    n_probe = min(n_probe, idx.num_clusters)
    sd = idx.stage_dtype
    if sd not in _WIDE:
        raise ValueError(f"unsupported stage_dtype: {sd}")
    wide = _WIDE[sd]
    kk = (1 + idx.spill) * (k if wide == 1 else min(max(wide * k, 32 * wide), 4096))

    dev = idx.device
    centroids, c_sq = idx.tables().coarse
    q_dev = torch.as_tensor(q, device=dev)
    with trace("staged.coarse", nq=nq, n_probe=n_probe):
        probed = _coarse_probe_mask(q_dev, centroids, c_sq, n_probe).any(dim=0)
        union = np.flatnonzero(probed.cpu().numpy())
    # Zero-length cells (a partial load) stage nothing; layout order keeps
    # the pack a sequence of forward slices.
    union = union[np.asarray(lay.lengths)[union] > 0]
    starts_all = np.asarray(lay.offsets)[:-1]
    union = union[np.argsort(starts_all[union], kind="stable")]
    if len(union) == 0:
        idx._last_stage_bytes = 0
        return (np.full((nq, k), np.inf, np.float32), np.full((nq, k), -1, np.int64))

    rows_idx, sub_starts, alens, r_used = _pack_stage(lay, union)
    # At least one trailing sentinel block closes the last run.
    r_pad = r_used + ALIGN
    nb = r_pad // ALIGN
    segs = [("vecs", sd, (r_pad, d)), ("norms", torch.float32, (r_pad,))]
    if sd == torch.int8:
        segs += [("scale", torch.float32, (r_pad,)), ("cell", torch.int32, (r_pad,))]
    segs += [("block_run", torch.int32, (nb,)), ("union", torch.int32, (len(union),))]
    layout = _Segments(segs)
    # One search at a time owns the reused buffer, from packing to the end
    # of the sweep that reads its copy.
    with idx._stage_lock:
        if idx._stage is None or idx._stage.device != dev:
            idx._stage = _Stage(dev)
        with trace("staged.pack", cells=len(union), rows=r_pad):
            buf = idx._stage.buffer(layout.nbytes)
            v = layout.views(buf)
            norms = v["norms"].numpy()
            np.take(lay.row_norms, rows_idx, out=norms[:r_used])
            norms[r_used:] = SENTINEL_NORM
            if sd == torch.float32:
                vecs = v["vecs"].numpy()
                np.take(lay.vectors, rows_idx, axis=0, out=vecs[:r_used])
                vecs[r_used:] = 0.0
            else:
                staged = lay.vectors[rows_idx]
                if sd == torch.bfloat16:
                    v["vecs"][:r_used].copy_(torch.from_numpy(staged))
                    v["vecs"][r_used:] = 0
                else:
                    cell = v["cell"].numpy()
                    cell[:r_used] = np.repeat(np.arange(len(union), dtype=np.int32), alens)
                    cell[r_used:] = 0
                    real = norms[:r_used] < 1e29
                    codes, scale_row, norms_q = _quantize_int8(
                        staged, idx.centroids[union][cell[:r_used]], real, sub_starts, alens)
                    v["vecs"].numpy()[:r_used] = codes
                    v["vecs"].numpy()[r_used:] = 0
                    v["scale"].numpy()[:r_used] = scale_row
                    v["scale"].numpy()[r_used:] = 1.0
                    norms[:r_used] = np.where(real, norms_q, norms[:r_used])
            run_start_b = sub_starts // ALIGN
            v["block_run"].numpy()[:] = np.searchsorted(run_start_b, np.arange(nb),
                                                        side="right") - 1
            v["union"].numpy()[:] = union
        idx._last_stage_bytes = layout.nbytes

        with trace("staged.sweep", rows=r_pad, cells=len(union), dtype=str(sd)):
            t = layout.views(idx._stage.to_device(buf))
            ui = t["union"].long()
            cent_ord, csq_ord = centroids[ui], c_sq[ui]
            vecs = t["vecs"].to(torch.float32)
            if sd == torch.int8:
                vecs = vecs * t["scale"][:, None] + cent_ord[t["cell"].long()]
            q_tile = pick_q_tile(nq, max(r_pad * 4 // d, 1), d)
            dv, rows = programs.dense_program(
                q_dev, cent_ord, csq_ord, vecs, t["norms"], t["block_run"].long(),
                min(n_probe, len(union)), k=kk, q_tile=q_tile, metric=metric,
            )
            dv, rows = dv.cpu().numpy(), rows.cpu().numpy()

    staged_to_orig = np.full(r_pad, -1, np.int64)
    staged_to_orig[:r_used] = rows_idx
    orig_rows = np.where(rows >= 0, staged_to_orig[np.clip(rows, 0, r_pad - 1)], -1)
    internal = idx.rows_to_internal(orig_rows)
    dv = np.where(internal >= 0, dv, np.inf).astype(np.float32)
    if wide > 1:
        # Approximate device ranking: exact re-rank of the shortlist from
        # the host layout, then (spilled) the dedup and the k cut.
        with trace("staged.rerank", kk=dv.shape[1]):
            exact = _rerank_exact_host(lay, q, orig_rows, internal, metric)
        if idx.spill:
            return host_dedup_topk(exact, internal, k)
        return _host_topk(exact, internal, k)
    if idx.spill:
        return host_dedup_topk(dv, internal, k)
    return dv[:, :k], internal[:, :k].astype(np.int64)
