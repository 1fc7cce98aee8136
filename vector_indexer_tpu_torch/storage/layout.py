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
from typing import Optional

import numpy as np
import torch

from ..ops.distance import sq_norms

ALIGN = 8  # posting-run row alignment (block-mask granularity)
SENTINEL_NORM = np.float32(1e30)  # gap/tail rows: distance ~1e30, never win
SENTINEL_THRESHOLD = 1e29  # distances above this are non-results


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _round_up_arr(x, m):
    return ((x + m - 1) // m) * m


@dataclasses.dataclass
class PostingLayout:
    """Cluster-permuted vector table + CSR offsets on one device (or, host
    staged, in numpy arrays). ``vectors`` and ``row_norms`` are None once
    an offloaded index has freed them."""

    vectors: Optional[torch.Tensor]  # (n_pad, d) f32; gap/tail rows are zero
    row_norms: Optional[torch.Tensor]  # (n_pad,) f32 squared norms; SENTINEL_NORM on pads
    offsets: np.ndarray  # (k + 1,) int32: per-cluster start rows (+ row end)
    lengths: np.ndarray  # (k,) int32 posting-list lengths
    perm: np.ndarray  # (rows_used,) int64: layout row -> internal id; -1 gaps
    n: int  # real vector count
    max_list_len: int

    @property
    def num_clusters(self) -> int:
        return int(self.lengths.shape[0])

    @property
    def dim(self) -> int:
        return int(self.vectors.shape[1])

    @property
    def rows_used(self) -> int:
        return len(self.perm)


def _placement(starts: np.ndarray, lengths: np.ndarray, num_clusters: int):
    """rows_used, max_len and n_pad of a layout with these aligned starts."""
    if num_clusters and int(lengths.sum()):
        rows_used = int((starts + _round_up_arr(lengths, ALIGN)).max())
        max_len = int(lengths.max())
    else:
        rows_used, max_len = 0, 0
    tail = _round_up(max(max_len, 1), 512) if max_len else 1
    return rows_used, max_len, _round_up(rows_used + tail + 1, ALIGN)


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
        real = rowmap >= 0
        vectors = np.zeros((n_pad, source.shape[1]), np.float32)
        vectors[real] = source[rowmap[real]]
        norms = np.where(real, np.einsum("ij,ij->i", vectors, vectors), SENTINEL_NORM)
        norms = norms.astype(np.float32)
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
    return PostingLayout(
        vectors=vectors,
        row_norms=norms,
        offsets=csr,
        lengths=np.asarray(lengths, np.int32),
        perm=perm,
        n=int(n_real),
        max_list_len=max_len,
    )


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
    if point_ids is None:
        point_ids = np.arange(len(labels), dtype=np.int64)
    else:
        point_ids = np.asarray(point_ids, dtype=np.int64)
    if cluster_order is None:
        cluster_order = np.arange(num_clusters, dtype=np.int64)
    cluster_rank = np.empty(num_clusters, dtype=np.int64)
    cluster_rank[cluster_order] = np.arange(num_clusters)

    # Stable sort by placement rank keeps intra-cluster insertion order.
    entry_perm = np.argsort(cluster_rank[labels], kind="stable")
    perm_real = point_ids[entry_perm]  # placement order -> internal id

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
