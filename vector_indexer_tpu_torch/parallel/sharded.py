"""Sharded IVF search over a device mesh (1-D: every device holds a slice of
the posting lists; queries and the centroid table are replicated).

Port of ``vector_indexer_tpu/parallel/sharded.py``. Whole shards (the
super-centroid groups of the layout, contiguous row ranges) are balanced
over the devices by row count (greedy LPT), and each device's slice is
packed from the index's host mirror (``_host_data``, internal-id order),
so construction never copies the corpus back from a card. Per device and
per call:

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
Layout rows map to internal ids on the host; a spilled index searches
(1+spill)k wide and drops repeated ids there (``offload.host_dedup_topk``).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..index import programs
from ..index.dispatch import choose_sweep_body, pick_q_tile, stream_itemsize
from ..index.offload import host_dedup_topk
from ..ops.block_stream import FAN, SMEM_TASK_CAP, StreamTable, pick_chunk
from ..ops.distance import sq_norms
from ..ops.flat_sweep import plan_fused
from ..ops.gather import quantize_up
from ..storage.layout import ALIGN, SENTINEL_NORM, SENTINEL_THRESHOLD
from ..utils.tracing import trace
from .mesh import Mesh

METHODS = ("auto", "dense", "dense_fused", "stream")


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _round_up_arr(x, m):
    return ((x + m - 1) // m) * m


def on_device(dev: torch.device):
    """Make ``dev`` the current CUDA device (a no-op for the CPU)."""
    return torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()


# ---------------------------------------------------------------------------
# Host-side per-device tables
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class LocalTables:
    """Host-side (numpy) per-device tables, the reference's arrays, plus
    each local cell's global id."""

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


def build_local_tables(index, n_dev: int) -> LocalTables:
    """Partition the posting layout into per-device tables (host-side):
    whole shards balanced over devices by row count (greedy LPT), payload
    rows taken from ``index._host_data``."""
    with trace("sharded.build_local_tables", n_dev=n_dev):
        return _build_local_tables(index, n_dev)


def _build_local_tables(index, n_dev: int) -> LocalTables:
    lay = index.layout
    if lay is None:
        raise RuntimeError("index has no posting layout")
    starts = np.asarray(lay.offsets)[:-1]
    lengths = np.asarray(lay.lengths)
    kc = len(lengths)
    c2s = np.asarray(index.centroids_to_shard)
    perm = lay.perm
    host = getattr(index, "_host_data", None)
    fetched = None
    if host is None:  # no mirror: one copy of the table
        v = lay.vectors
        fetched = v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)

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

    local_vecs = np.zeros((n_dev, rows_per_dev, dim), np.float32)
    local_norms = np.full((n_dev, rows_per_dev), SENTINEL_NORM, np.float32)
    # Pad cells keep +inf coarse distance and start past the block grid, so
    # they are never probed.
    local_cent = np.zeros((n_dev, kc_local, dim), np.float32)
    local_csq = np.full((n_dev, kc_local), np.inf, np.float32)
    local_run_starts_b = np.full((n_dev, kc_local), rows_per_dev // ALIGN, np.int32)
    local_lengths = np.zeros((n_dev, kc_local), np.int32)
    local_perm = np.full((n_dev, rows_per_dev), -1, np.int64)
    local_cid = np.full((n_dev, kc_local), -1, np.int64)

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
            internal = perm[s : s + m]
            block = host[internal] if fetched is None else fetched[s : s + m]
            local_vecs[d_, fill : fill + m] = block
            local_norms[d_, fill : fill + m] = (
                (block.astype(np.float64) ** 2).sum(1).astype(np.float32)
            )
            local_perm[d_, fill : fill + m] = internal
            fill += _round_up(m, ALIGN)

    return LocalTables(
        local_vecs=local_vecs, local_norms=local_norms, local_cent=local_cent,
        local_csq=local_csq, local_run_starts_b=local_run_starts_b,
        local_lengths=local_lengths, local_perm=local_perm, shard_to_dev=shard_to_dev,
        cents=cents, c_sq=(cents.astype(np.float64) ** 2).sum(1).astype(np.float32),
        local_cid=local_cid,
    )


def build_local_stream_tables(tables: LocalTables, dtype: torch.dtype) -> dict:
    """Per-device chunk-aligned RESIDUAL stream tables (host-side), the
    multi-device twin of ``ops.block_stream.build_stream_table``: stacked
    arrays with a leading n_dev axis (``svecs`` a CPU tensor of ``dtype``,
    the rest numpy), the common ``m_pad`` and ``chunk``. Cell slot
    ``kc_local`` is the zero-length pad probe that unprobed slots are
    redirected to. int8 rows are symmetric per-cell quantized; norms are
    those of the rows as stored."""
    with trace("sharded.build_stream_tables", n_dev=tables.local_vecs.shape[0],
               dtype=str(dtype)):
        return _build_local_stream_tables(tables, dtype)


def _build_local_stream_tables(tables: LocalTables, dtype: torch.dtype) -> dict:
    n_dev, rows, d = tables.local_vecs.shape
    kc_local = tables.local_cent.shape[1]
    chunk = pick_chunk(tables.local_lengths.reshape(-1), d, stream_itemsize(dtype))
    sizes = _round_up_arr(np.maximum(tables.local_lengths, 0), chunk)
    m_pad = _round_up(int(max(sizes.sum(axis=1).max(), chunk)), chunk)

    svecs = np.zeros((n_dev, m_pad, d), np.float32)
    snorms = np.full((n_dev, m_pad), SENTINEL_NORM, np.float32)
    sto_local = np.full((n_dev, m_pad), rows - 1, np.int32)  # pad -> last row
    sblk0 = np.zeros((n_dev, kc_local + 1), np.int32)
    slen = np.zeros((n_dev, kc_local + 1), np.int32)
    blk_cid = np.zeros((n_dev, m_pad // chunk), np.int32)
    scales = np.ones((n_dev, kc_local + 1), np.float32)
    int8 = dtype == torch.int8
    for d_ in range(n_dev):
        base = 0
        for i in range(kc_local):
            m = int(tables.local_lengths[d_, i])
            if m == 0:
                continue
            src = int(tables.local_run_starts_b[d_, i]) * ALIGN
            res = tables.local_vecs[d_, src : src + m] - tables.local_cent[d_, i]
            if int8:
                s = max(float(np.abs(res).max()) / 127.0, 1e-12)
                scales[d_, i] = s
                q8 = np.clip(np.round(res / s), -127, 127)
                res = q8 * s
                svecs[d_, base : base + m] = q8
            else:
                svecs[d_, base : base + m] = res
                res = torch.from_numpy(res).to(dtype).to(torch.float32).numpy()
            snorms[d_, base : base + m] = (res.astype(np.float64) ** 2).sum(1).astype(np.float32)
            sto_local[d_, base : base + m] = np.arange(src, src + m)
            size = _round_up(m, chunk)
            sblk0[d_, i] = base // chunk
            slen[d_, i] = m
            blk_cid[d_, base // chunk : (base + size) // chunk] = i
            base += size
    return dict(svecs=torch.from_numpy(svecs).to(dtype), snorms=snorms, sto_local=sto_local,
                sblk0=sblk0, slen=slen, blk_cid=blk_cid, scales=scales, m_pad=m_pad,
                chunk=chunk)


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
    """Slice ``j`` of ``LocalTables`` on ``dev``: the payload, the block ->
    local run map, the global centroid table and each local cell's column
    in the global coarse distances (pads read an appended +inf column). The
    stream table is built on first use."""

    def __init__(self, tables: LocalTables, j: int, dev: torch.device):
        self.dev = dev
        self.j = j
        self.vecs = torch.as_tensor(tables.local_vecs[j], device=dev)
        self.norms = torch.as_tensor(tables.local_norms[j], device=dev)
        nb = tables.local_vecs.shape[1] // ALIGN
        block_run = np.searchsorted(tables.local_run_starts_b[j], np.arange(nb), side="right") - 1
        self.block_run = torch.as_tensor(block_run.astype(np.int64), device=dev)
        self.cents = torch.as_tensor(tables.cents, device=dev)
        self.c_sq = torch.as_tensor(tables.c_sq, device=dev)
        kc = tables.cents.shape[0]
        cid = tables.local_cid[j]
        self.cid = torch.as_tensor(np.where(cid >= 0, cid, kc), device=dev)
        self.kc_local = cid.shape[0]
        self.stream: Optional[StreamTable] = None

    def set_stream(self, st: dict, cent_l: np.ndarray) -> None:
        """Take this slice's share of ``build_local_stream_tables``' arrays;
        ``cent_l``: its local centroids (the pad probe gets a zero row)."""
        dev, j = self.dev, self.j

        def i64(a):
            return torch.as_tensor(np.asarray(a[j], np.int64), device=dev)

        cent = np.concatenate([cent_l, np.zeros((1, cent_l.shape[1]), np.float32)])
        self.stream = StreamTable(
            vecs=st["svecs"][j].to(dev), norms=torch.as_tensor(st["snorms"][j], device=dev),
            to_main=i64(st["sto_local"]), sblk0=i64(st["sblk0"]), lengths=i64(st["slen"]),
            cent=torch.as_tensor(cent, device=dev), blk_cid=i64(st["blk_cid"]),
            scales=torch.as_tensor(st["scales"][j], device=dev), m_pad=int(st["m_pad"]),
            chunk=int(st["chunk"]),
        )

    def coarse(self, qt, n_probe: int):
        """(local coarse distances (q, kc_local), global threshold (q, 1)):
        L2 to every centroid (coarse probing is always L2), the n_probe-th
        smallest, and this device's cells' columns of the same matrix (so
        the local test reads the very values the threshold came from)."""
        dg = sq_norms(qt)[:, None] - 2.0 * torch.matmul(qt, self.cents.T) + self.c_sq[None, :]
        thresh = torch.kthvalue(dg, n_probe, dim=1, keepdim=True).values
        inf = torch.full((qt.shape[0], 1), float("inf"), device=qt.device)
        return torch.cat([dg, inf], dim=1)[:, self.cid], thresh

    def search(self, q, kk: int, n_probe: int, probe_bound: int, method: str, metric: str,
               plan=None, stream_args=None):
        """This slice's (D (nq, kk), local rows (nq, kk) int32) for the
        queries ``q`` already on ``dev``: +inf / -1 where there is no
        result. Only enqueues device work."""
        nq, d = q.shape

        def probe_sets(qt):
            dl, thresh = self.coarse(qt, n_probe)
            return dl <= thresh, torch.argmin(dl, dim=1)

        if method == "stream":
            t_fixed, q_tile, rerank = stream_args
            pb_l = min(probe_bound, self.kc_local)

            def probe_fn(qt):
                dl, thresh = self.coarse(qt, n_probe)
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
    that holds it, the lazy stream tables, and the per-call parameters."""

    def __init__(self, index, n_slices: int, placement, method: str):
        """``placement``: a list of (slice j, device) pairs."""
        if method not in METHODS:
            raise ValueError(f"unknown sharded search method: {method}")
        self.index = index
        self.method = method
        t = build_local_tables(index, n_slices)
        self._host_tables = t
        self.shard_to_dev = t.shard_to_dev
        self.local_perm = t.local_perm
        self.last_merge_bytes: dict = {}
        self.last_method: Optional[str] = None  # the body of the last search
        self._slices = {}
        for j, dev in placement:
            if (j, dev) not in self._slices:
                self._slices[(j, dev)] = DeviceSlice(t, j, dev)

    def _stream_tables(self) -> None:
        if any(sl.stream is None for sl in self._slices.values()):
            st = build_local_stream_tables(self._host_tables, self.index.stream_dtype)
            for (j, _), sl in self._slices.items():
                sl.set_stream(st, self._host_tables.local_cent[j])

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
            q_tile = max(8, min(256, (SMEM_TASK_CAP // max(t_fixed, 1)) // 8 * 8))
            q_tile = min(q_tile, _round_up(nq_local, 8))
            stream_args = (t_fixed, q_tile, self.index.stream_dtype == torch.int8)
        elif method == "dense_fused" and d % 128 == 0:
            # The single-device gate; no plan -> the plain dense body.
            plan = plan_fused(self._host_tables.local_vecs.shape[1], d, nq_local, kk)
        return n_probe, probe_bound, method, plan, stream_args

    @property
    def metric(self) -> str:
        """Ranking metric (cosine is ip over unit vectors)."""
        return self.index.metric if self.index.metric != "cosine" else "ip"

    def run(self, jobs, kk: int, n_probe: int, nq_local: int):
        """Run ``jobs`` = [(slice j, device, queries numpy)] -> [(D, rows)]
        on each job's device, all enqueued before any result is read."""
        n_probe, probe_bound, method, plan, stream_args = self.params(nq_local, kk, n_probe)
        self.last_method = method
        # The queries go to the cards from pinned memory (a copy from
        # pageable memory would synchronise inside the loop).
        pin = any(dev.type == "cuda" for _, dev, _ in jobs)
        host = {}
        for _, _, q in jobs:
            if id(q) not in host:
                t = torch.tensor(q)  # a copy: the caller's array may be read-only
                host[id(q)] = t.pin_memory() if pin else t
        out = []
        for j, dev, q in jobs:
            with on_device(dev):
                qd = host[id(q)].to(dev, non_blocking=True)
                out.append(self._slices[(j, dev)].search(
                    qd, kk, n_probe, probe_bound, method, self.metric, plan, stream_args))
        return out

    def finish(self, D, rows, owner, k: int) -> Tuple[np.ndarray, np.ndarray]:
        """Host side of a search: (D, internal ids) cut to k, spilled
        indexes de-duplicated."""
        D = D.cpu().numpy()
        rows = rows.cpu().numpy()
        owner = owner.cpu().numpy()
        internal = np.where(
            rows >= 0, self.local_perm[np.clip(owner, 0, None), np.clip(rows, 0, None)], -1
        ).astype(np.int64)
        if getattr(self.index, "spill", 0):
            D, internal = host_dedup_topk(D, internal, D.shape[1])
        return D[:, :k], internal[:, :k]


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
        """(nq, d) -> (D (nq, k) f32, internal ids (nq, k) int64), padded
        +inf / -1."""
        _check_k(k, n_probe)
        q = normalize_queries(self.index, queries)
        kk = (1 + getattr(self.index, "spill", 0)) * k
        outs = self.run([(j, dev, q) for j, dev in enumerate(self.devices)], kk, n_probe,
                        q.shape[0])
        parts = [(dv, rows, torch.full_like(rows, j)) for j, (dv, rows) in enumerate(outs)]
        (D, rows, owner), moved = merge(parts, kk, self.devices[0])
        self.last_merge_bytes = {"shards": moved}
        return self.finish(D, rows, owner, k)
