"""K6: per-query distances to the rows of every probed posting list,
written to packed candidate slots.

Port of ``vector_indexer_tpu/ops/pallas/ivf_gather.py``
(``ivf_gather_distances``). Each probed list is a contiguous row range of
the layout table; probe j of a query owns the slots that start at the
exclusive prefix sum of round_up(len, 128) over the earlier probes, and
its rows ``start + i`` fill them. The output contract is the reference's,
slot by slot:

* width ``budget_pad = round_up(budget + p*128 + max_len_pad, 128)`` with
  ``max_len_pad = round_up(max(max_len, 8), _chunk_for(max_len))``;
* probe j's segment is max_len_pad slots at min(offset_j, budget_pad -
  max_len_pad), written in probe order (a later probe overwrites an
  earlier one's tail); slots no probe fills are holes, +inf / -1;
* l2 is max(|q|^2 - 2 q.x + |x|^2, 0) with |x|^2 taken from the gathered
  row itself; ip is -q.x (only real posting rows are gathered, so there is
  no sentinel term).

The TPU kernel copied every list into VMEM scratch with concurrent chunked
DMAs, which is why its caller gated it on a scratch budget and on d % 128.
The CUDA kernel reads the rows in place, so it has neither limit, and
serves any d. Up to K6_RESIDENT_D dims, where one item holds a probe's
whole segment, it runs one block per (query, probe) with the query in
shared memory (``ivf_gather_plan``); past that, each probe's slots are cut
into items of ~K6_ITEM_BYTES of rows, one block each, so that a long list
is spread over many SMs (``ivf_gather_item_plan``, ``item_slots``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..kernels import build as kb

_DMA_CHUNK = 512  # the reference's rows per sub-DMA; it sets max_len_pad
K6_RESIDENT_D = 12_288  # query elements held in shared memory (48 KB, no opt-in)


class GatherPlan(NamedTuple):
    qres: int  # query elements in shared memory (d, or K6_RESIDENT_D below it)
    smem: int  # dynamic shared memory bytes


def ivf_gather_plan(d: int) -> GatherPlan:
    """K6's launch plan: the whole query in shared memory up to
    K6_RESIDENT_D elements; past that its first K6_RESIDENT_D, the rest
    read through L1 (csrc/ivf_gather.cu checks the plan)."""
    qres = min(d, K6_RESIDENT_D)
    return GatherPlan(qres, 4 * qres)


# Wide rows: each probe's slots in items of about K6_ITEM_BYTES of rows (at
# least one row per warp), the query in shared memory up to K6_QUERY_SMEM
# bytes (the opt-in's 227 KB, less the kernel's own), in panels past that.
K6_ITEM_BYTES = 1 << 20
K6_QUERY_SMEM = 224 << 10
K6_WARPS = 8
_GRID_Y = 65_535


class ItemPlan(NamedTuple):
    rows: int  # slots per item (R)
    items: int  # items per probe: ceil(max_len_pad / R), the grid's second dimension
    panel: int  # query elements in shared memory at a time (d, or a multiple of 4)
    smem: int  # dynamic shared memory bytes


def ivf_gather_item_plan(d: int, max_len_pad: int) -> Optional[ItemPlan]:
    """K6's item plan, or None where the one-block-per-(query, probe)
    launch stays: d within K6_RESIDENT_D and one item of K6_ITEM_BYTES
    holding a whole segment (d 128: 2,048 rows). R: the rows of
    K6_ITEM_BYTES, at least K6_WARPS (16 at d 16,384), more where the
    items would pass the grid's 65,535; past K6_QUERY_SMEM bytes of query
    the panels are K6_QUERY_SMEM / 4 elements and R is K6_WARPS (a warp's
    one row carries its partial dot across the panels)."""
    rows = max(K6_WARPS, K6_ITEM_BYTES // (4 * d), -(-max_len_pad // _GRID_Y))
    if d <= K6_RESIDENT_D and rows >= max_len_pad:
        return None
    panel = d
    if 4 * d > K6_QUERY_SMEM:
        panel, rows = K6_QUERY_SMEM // 4, K6_WARPS
    return ItemPlan(rows, -(-max_len_pad // rows), panel, 4 * panel)


def item_slots(offs, width: int, rows: int, items: int):
    """The item launch's rule, plainly: for one query's clamped segment
    offsets ``offs`` (p ints), the (probe, first slot, end slot) of every
    item that is not empty. Item y of probe j holds slots
    [off_j + y R, off_j + (y + 1) R) of the probe's range [off_j,
    off_{j+1}) (the last probe's up to ``width``), the last item also the
    rest of the range."""
    out = []
    p = len(offs)
    for j in range(p):
        off = int(offs[j])
        span = (int(offs[j + 1]) if j + 1 < p else width) - off
        for y in range(items):
            lo = y * rows
            if lo >= span:
                break
            hi = span if y == items - 1 else min(lo + rows, span)
            out.append((j, off + lo, off + hi))
    return out


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _chunk_for(max_len: int) -> int:
    return min(_DMA_CHUNK, _round_up(max(max_len, 8), 8))


def max_len_pad(max_len: int) -> int:
    """Slots of one probe's segment."""
    return _round_up(max(max_len, 8), _chunk_for(max_len))


def output_width(p: int, max_len: int, budget: int) -> int:
    """budget_pad: slots per query."""
    return _round_up(budget + p * 128 + max_len_pad(max_len), 128)


def slot_offsets(lengths: torch.Tensor, max_len: int, budget: int) -> torch.Tensor:
    """(nq, p) int64 first slot of each probe's segment: the exclusive prefix
    sum of round_up(len, 128), clamped as the reference clamps it."""
    lens_al = (lengths.long() + 127) // 128 * 128
    offs = torch.cumsum(lens_al, dim=1) - lens_al
    width = output_width(lengths.shape[1], max_len, budget)
    return offs.clamp_max(width - max_len_pad(max_len))


def _check(queries, vectors, starts, lengths):
    if queries.dtype != torch.float32 or vectors.dtype != torch.float32:
        raise TypeError("ivf_gather_distances takes f32 queries and table")
    if queries.shape[1] != vectors.shape[1] or starts.shape != lengths.shape \
            or starts.shape[0] != queries.shape[0]:
        raise ValueError("ivf_gather_distances: shape mismatch")


def ivf_gather_distances_reference(queries, vectors, starts, lengths, *, max_len: int,
                                   budget: int, metric: str = "l2"):
    """Plain version of K6: each slot takes the last probe whose segment
    starts at or before it (the reference's write order), in tiles of
    queries that bound the (tile, budget_pad, d) row gather."""
    _check(queries, vectors, starts, lengths)
    nq, d = queries.shape
    p = starts.shape[1]
    width = output_width(p, max_len, budget)
    mlp = max_len_pad(max_len)
    dist = torch.full((nq, width), float("inf"), device=queries.device)
    rows = torch.full((nq, width), -1, dtype=torch.int32, device=queries.device)
    if p == 0 or nq == 0:
        return dist, rows
    offs = slot_offsets(lengths, max_len, budget).contiguous()
    slot = torch.arange(width, device=queries.device)
    tile = max(1, (64 << 20) // (width * max(d, 1) * 4))
    for s in range(0, nq, tile):
        o = offs[s : s + tile]
        seg = torch.searchsorted(o, slot.expand(o.shape[0], width).contiguous(), right=True) - 1
        local = slot[None, :] - torch.gather(o, 1, seg)
        valid = (local < torch.gather(lengths[s : s + tile].long(), 1, seg)) & (local < mlp)
        r = torch.gather(starts[s : s + tile].long(), 1, seg) + local
        r = torch.where(valid, r, torch.zeros_like(r))
        x = vectors[r]  # (tile, width, d)
        q = queries[s : s + tile]
        cross = torch.matmul(x, q[:, :, None])[..., 0]
        if metric == "l2":
            dv = ((q * q).sum(1)[:, None] - 2.0 * cross + (x * x).sum(2)).clamp_min(0.0)
        else:
            dv = -cross
        dist[s : s + tile] = torch.where(valid, dv, float("inf"))
        rows[s : s + tile] = torch.where(valid, r, -1).to(torch.int32)
    return dist, rows


def ivf_gather_distances(queries, vectors, starts, lengths, *, max_len: int, budget: int,
                         metric: str = "l2"):
    """K6 -> (dist (nq, budget_pad) f32 +inf-padded, rows (nq, budget_pad)
    int32 -1-padded): the distances of each query to the rows of its probed
    lists (``starts``, ``lengths``: (nq, p)), in probe order at 128-aligned
    slot offsets. CPU tensors -> plain version; CUDA tensors -> the
    kernel."""
    if queries.device.type == "cpu":
        return ivf_gather_distances_reference(queries, vectors, starts, lengths,
                                              max_len=max_len, budget=budget, metric=metric)
    _check(queries, vectors, starts, lengths)
    nq, d = queries.shape
    p = starts.shape[1]
    width = output_width(p, max_len, budget)
    if p == 0 or nq == 0:
        return (torch.full((nq, width), float("inf"), device=queries.device),
                torch.full((nq, width), -1, dtype=torch.int32, device=queries.device))
    # The probes' segments partition [0, width): the kernel writes every slot.
    dist = torch.empty((nq, width), dtype=torch.float32, device=queries.device)
    rows = torch.empty((nq, width), dtype=torch.int32, device=queries.device)
    ops = [queries.contiguous(), vectors.contiguous(), starts.to(torch.int32).contiguous(),
           lengths.to(torch.int32).contiguous(),
           slot_offsets(lengths, max_len, budget).to(torch.int32).contiguous()]
    kb.require_cuda("ivf_gather_distances", *ops)
    plan = ivf_gather_item_plan(d, max_len_pad(max_len))
    if plan is not None:
        kb.launch(
            "ivf_gather_distances", "vitorch_ivf_gather_items",
            *(kb.ptr(t) for t in ops), nq, p, d, plan.rows, plan.items, plan.panel,
            max_len_pad(max_len), width, int(metric == "l2"), kb.ptr(dist), kb.ptr(rows),
            kb.stream_of(dist),
        )
        return dist, rows
    kb.launch(
        "ivf_gather_distances", "vitorch_ivf_gather_distances",
        *(kb.ptr(t) for t in ops), nq, p, d, ivf_gather_plan(d).qres, max_len_pad(max_len), width,
        int(metric == "l2"), kb.ptr(dist), kb.ptr(rows), kb.stream_of(dist),
    )
    return dist, rows
