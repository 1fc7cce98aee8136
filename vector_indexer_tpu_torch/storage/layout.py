"""Device-resident posting-list layout (CSR over a cluster-permuted table).

All posting lists live on the device as one permuted (n_pad, d) f32 table
plus CSR offsets, ordered so that every shard's clusters are contiguous.
Invariants (the same as the reference's storage/layout.py):

* every posting run starts at a multiple of ``ALIGN`` rows, so 8-row
  blocks map 1:1 to clusters (the dense program's probe mask works on that
  block grid);
* alignment gap rows and the table tail are zero vectors whose
  ``row_norms`` hold ``SENTINEL_NORM``, which pushes their distances past
  any real candidate; ``perm`` is -1 there;
* the table carries a tail pad of round_up(max_list_len, 512) + 1 rows past
  the last run, kept so that the table shape equals the reference's (the
  converted-index tests rely on it; no port kernel reads past a list end).

A layout is normally on a torch device. A HOST-placed layout (numpy
``vectors`` and ``row_norms``: the reference's ``device_put=False``) is
what ``load(..., resident='offload')`` quantizes from, so that the f32
table never reaches the device, and what a host-resident index
(``fit(resident='host')``, ``load(..., resident='host')``) serves from.
"""

from __future__ import annotations

import dataclasses
import mmap
import os
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np
import torch

from ..ops.distance import sq_norms

ALIGN = 8  # posting-run row alignment (block-mask granularity)
SENTINEL_NORM = np.float32(1e30)  # gap/tail rows: distance ~1e30, never win
SENTINEL_THRESHOLD = 1e29  # distances above this are non-results
_HOST_GATHER_ROWS = 1 << 20  # rows per gather of a host-packed table
_MIN_PART_ROWS = 1 << 12  # rows per thread of one ``rows_into`` at the least


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _round_up_arr(x, m):
    return ((x + m - 1) // m) * m


@dataclasses.dataclass
class PostingLayout:
    """Cluster-permuted vector table + CSR offsets on one device (or, host
    staged, in numpy arrays). ``vectors`` and ``row_norms`` are None once
    an offloaded index has freed them. A host layout packed from a host
    array gathers its table on the first read of either (``_Table``);
    ``rows_into`` reads its rows before that without making it."""

    # (n_pad, d) f32; gap/tail rows are zero
    vectors: Optional[torch.Tensor] = dataclasses.field(repr=False)
    # (n_pad,) f32 squared norms; SENTINEL_NORM on pads
    row_norms: Optional[torch.Tensor] = dataclasses.field(repr=False)
    offsets: np.ndarray  # (k + 1,) int32: per-cluster start rows (+ row end)
    lengths: np.ndarray  # (k,) int32 posting-list lengths
    perm: np.ndarray  # (rows_used,) int64: layout row -> internal id; -1 gaps
    n: int  # real vector count
    max_list_len: int
    # A host table not yet gathered: (source (m, d) host array, (n_pad,) row
    # map, -1 on rows of no vector).
    _pending = None

    @property
    def num_clusters(self) -> int:
        return int(self.lengths.shape[0])

    @property
    def dim(self) -> int:
        return int(self.table_shape[1])

    @property
    def table_shape(self) -> tuple:
        """(n_pad, d) of the table, made or pending."""
        if self._pending is not None:
            source, rowmap = self._pending
            return (len(rowmap), source.shape[1])
        return tuple(self.vectors.shape)

    @property
    def on_host(self) -> bool:
        """Whether the table is (or will be) a host array."""
        return self._pending is not None or isinstance(self.vectors, np.ndarray)

    @property
    def rows_used(self) -> int:
        return len(self.perm)

    def rows_into(self, lo: int, hi: int, out: np.ndarray) -> None:
        """Write table rows lo:hi of a host layout into ``out`` (a (hi - lo, d)
        float32 host array): copied from the table where it is made, else
        gathered from the source (zero on rows of no vector) in parts over
        threads, without making the table. The parts of all the calls that
        run at once (one a card's packing thread) share ``host_workers()``
        slots, so they gather on as many cores as there are, not more."""
        pending = self._pending
        if pending is None:
            out[:] = self.vectors[lo:hi]
            return
        source, rowmap = pending
        slots = _gather_slots()
        parts = range(lo, hi, max(_MIN_PART_ROWS, -(-(hi - lo) // host_workers())))

        def one(a: int) -> None:
            b = min(a + parts.step, hi)
            with slots:
                _gather_rows(source, rowmap[a:b], out[a - lo:b - lo])

        if len(parts) > 1:
            with ThreadPoolExecutor(len(parts)) as pool:
                list(pool.map(one, parts))
        else:
            for a in parts:
                one(a)

    def _make_table(self) -> None:
        with _TABLE_LOCK:
            if self._pending is None:  # another thread made it
                return
            source, rowmap = self._pending
            real = rowmap >= 0
            vectors, sq = _host_gather(source, rowmap, real)
            # Both tables are in place before the pending gather goes: a
            # reader that finds none pending reads them without the lock.
            self.__dict__["_vectors"] = vectors
            self.__dict__["_row_norms"] = np.where(real, sq, SENTINEL_NORM).astype(np.float32)
            self._pending = None


class _Table:
    """A PostingLayout's ``vectors`` / ``row_norms``: the first read of either
    on a layout with a pending host table gathers both; setting either drops
    the pending gather (an offloaded index frees both)."""

    def __init__(self, name: str):
        self.key = "_" + name

    def __get__(self, lay, cls=None):
        if lay is None:
            return self
        if lay._pending is not None:
            lay._make_table()
        return lay.__dict__.get(self.key)

    def __set__(self, lay, value) -> None:
        lay._pending = None
        lay.__dict__[self.key] = value


PostingLayout.vectors = _Table("vectors")
PostingLayout.row_norms = _Table("row_norms")
_TABLE_LOCK = threading.Lock()


def _placement(starts: np.ndarray, lengths: np.ndarray, num_clusters: int):
    """rows_used, max_len and n_pad of a layout with these aligned starts."""
    if num_clusters and int(lengths.sum()):
        rows_used = int((starts + _round_up_arr(lengths, ALIGN)).max())
        max_len = int(lengths.max())
    else:
        rows_used, max_len = 0, 0
    tail = _round_up(max(max_len, 1), 512) if max_len else 1
    return rows_used, max_len, _round_up(rows_used + tail + 1, ALIGN)


def host_zeros(shape, populate: bool = True) -> np.ndarray:
    """A zero float32 host array over anonymous memory. ``populate``: its
    pages are all mapped up front (``MAP_POPULATE``, where the platform has
    it): a table of ~100 GB faulted in page by page as one thread's gather
    first touches it fills about 2.4 times slower (the same ratio as a 20M x
    128 corpus drawn into host memory on an H100 machine's host). Without,
    the pages are left to the threads that first write them, which fault
    them in at once, in huge pages where the kernel grants them (5M x 128
    gathered by 8 threads: 0.49 s against 1.27 s populated up front, on
    one 8-core host)."""
    size = int(np.prod(shape)) * 4
    if not size:
        return np.zeros(shape, np.float32)
    flags = mmap.MAP_PRIVATE | mmap.MAP_ANONYMOUS
    if populate:
        flags |= getattr(mmap, "MAP_POPULATE", 0)
    buf = mmap.mmap(-1, size, flags=flags)
    if not populate and hasattr(mmap, "MADV_HUGEPAGE"):
        try:
            buf.madvise(mmap.MADV_HUGEPAGE)
        except OSError:  # a kernel without transparent huge pages
            pass
    return np.frombuffer(buf, np.float32).reshape(shape)


def host_workers() -> int:
    """Threads for host-memory passes over a table: the cores this process
    may run on (numpy's gathers, copies and ``einsum`` release the GIL)."""
    if hasattr(os, "sched_getaffinity"):
        return max(1, len(os.sched_getaffinity(0)))
    return max(1, os.cpu_count() or 1)


def _gather_slots() -> threading.BoundedSemaphore:
    """The ``host_workers()`` slots that the parts of every ``rows_into``
    running at once share (one semaphore per count of usable cores: the
    count is read at the call, since the process may pin itself after
    import)."""
    n = host_workers()
    return _SLOTS.setdefault(n, threading.BoundedSemaphore(n))


_SLOTS: dict = {}


def _gather_rows(source: np.ndarray, rowmap: np.ndarray, out: np.ndarray, real=None) -> None:
    """``out`` = the ``source`` rows ``rowmap`` names, zero where it holds -1."""
    if source.shape[0]:
        np.take(source, rowmap, axis=0, out=out, mode="clip")
        out[~(rowmap >= 0 if real is None else real)] = 0.0
    else:
        out[:] = 0.0


def _host_gather(source: np.ndarray, rowmap: np.ndarray, real: np.ndarray):
    """(vectors (len rowmap, d) f32, their squared norms (len rowmap,) f32):
    layout row r is source row ``rowmap[r]``, zero where ``real`` is false.
    Gathered a slice of rows at a time, with no temporary of the table, the
    slices spread over ``host_workers()`` threads."""
    n_pad = len(rowmap)
    slices = range(0, n_pad if source.shape[0] else 0, _HOST_GATHER_ROWS)
    workers = min(host_workers(), len(slices))
    vectors = host_zeros((n_pad, source.shape[1]), populate=workers <= 1)
    sq = np.zeros(n_pad, np.float32)

    def one(lo: int) -> None:
        hi = min(lo + _HOST_GATHER_ROWS, n_pad)
        v = vectors[lo:hi]
        _gather_rows(source, rowmap[lo:hi], v, real[lo:hi])
        np.einsum("ij,ij->i", v, v, out=sq[lo:hi])

    if workers > 1:
        with ThreadPoolExecutor(workers) as pool:
            list(pool.map(one, slices))
    else:
        for lo in slices:
            one(lo)
    return vectors, sq


def pack_layout(
    source,
    src_rows: np.ndarray,
    perm: np.ndarray,
    starts: np.ndarray,
    lengths: np.ndarray,
    n_real: int,
) -> PostingLayout:
    """Gather the layout table on ``source``'s device (a torch tensor) or in
    host memory (a numpy array: a host-staged layout): layout row r takes
    source row ``src_rows[r]`` (-1 on gap rows -> zero vector + SENTINEL
    norm). ``perm`` is the layout row -> internal id map."""
    num_clusters = len(lengths)
    rows_used, max_len, n_pad = _placement(starts, lengths, num_clusters)
    rowmap = np.full(n_pad, -1, np.int64)
    rowmap[:rows_used] = src_rows
    if isinstance(source, np.ndarray):
        vectors = norms = None  # gathered on first read (PostingLayout._make_table)
    else:
        dev = source.device
        rm = torch.as_tensor(rowmap, device=dev)
        real = rm >= 0
        if source.shape[0]:
            vectors = source[rm.clamp_min(0)].to(torch.float32)
            vectors.mul_(real[:, None].to(vectors.dtype))  # zero gap rows in place
        else:
            vectors = torch.zeros((n_pad, source.shape[1]), dtype=torch.float32, device=dev)
        norms = torch.where(
            real, sq_norms(vectors), torch.tensor(SENTINEL_NORM, device=dev)
        )
    csr = np.zeros(num_clusters + 1, dtype=np.int32)
    csr[:-1] = starts
    csr[-1] = rows_used
    lay = PostingLayout(
        vectors=vectors,
        row_norms=norms,
        offsets=csr,
        lengths=np.asarray(lengths, np.int32),
        perm=perm,
        n=int(n_real),
        max_list_len=max_len,
    )
    if isinstance(source, np.ndarray):
        lay._pending = (source, rowmap)
    return lay


def build_layout(
    vectors,
    labels: np.ndarray,
    num_clusters: int,
    cluster_order: Optional[np.ndarray] = None,
    point_ids: Optional[np.ndarray] = None,
) -> PostingLayout:
    """Pack vectors into cluster-contiguous, ALIGN-aligned CSR order, on
    ``vectors``' device (the host computes only the int64 row map), or in
    host memory when ``vectors`` is a numpy array (nothing reaches a
    device).

    ``cluster_order`` permutes cluster placement (clusters of the same shard
    are laid out adjacently). Labels must already be in the dense
    post-filter id space. ``point_ids`` maps each label entry to its source
    row (= internal id) for multi-assigned builds; default: entry i is
    vector i."""
    labels = np.asarray(labels, dtype=np.int64)
    n = vectors.shape[0]
    if point_ids is not None:
        point_ids = np.asarray(point_ids, dtype=np.int64)
    if cluster_order is None:
        cluster_order = np.arange(num_clusters, dtype=np.int64)
    cluster_rank = np.empty(num_clusters, dtype=np.int64)
    cluster_rank[cluster_order] = np.arange(num_clusters)

    # Stable sort by placement rank keeps intra-cluster insertion order;
    # numpy sorts 16-bit keys by radix, several times faster at 1e8 entries.
    key = (cluster_rank.astype(np.uint16) if num_clusters <= 1 << 16 else cluster_rank)[labels]
    entry_perm = np.argsort(key, kind="stable")
    del key
    # placement order -> internal id (entry i is vector i by default)
    perm_real = entry_perm if point_ids is None else point_ids[entry_perm]

    lengths = np.bincount(labels, minlength=num_clusters).astype(np.int32)
    sizes_in_order = _round_up_arr(lengths[cluster_order].astype(np.int64), ALIGN)
    starts_in_order = np.zeros(num_clusters, dtype=np.int64)
    if num_clusters > 1:
        np.cumsum(sizes_in_order[:-1], out=starts_in_order[1:])
    starts = np.empty(num_clusters, dtype=np.int64)
    starts[cluster_order] = starts_in_order

    perm = scatter_runs(perm_real, starts, lengths)
    return pack_layout(vectors, perm, perm, starts, lengths, min(n, len(labels)))


def scatter_runs(values: np.ndarray, starts: np.ndarray, lengths: np.ndarray):
    """Place ``values`` (clusters concatenated in placement order) at their
    aligned run starts; gap rows get -1."""
    rows_used, _, _ = _placement(starts, lengths, len(lengths))
    out = np.full(rows_used, -1, dtype=np.int64)
    pos = 0
    for cid in np.argsort(starts, kind="stable"):
        m = int(lengths[cid])
        if m:
            s = int(starts[cid])
            out[s : s + m] = values[pos : pos + m]
            pos += m
    return out


def cluster_starts(layout: PostingLayout) -> np.ndarray:
    """Per-cluster start rows, indexed by cluster id (host numpy)."""
    return layout.offsets[:-1]
