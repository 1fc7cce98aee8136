"""Index persistence: index.bin metadata + shard_N.bin posting files.

The same two-artifact format as ``vector_indexer_tpu/storage/persist.py``,
byte for byte, so an index saved by either package loads in the other:

  index_dir/index.bin    - header, centroid table, centroid -> shard map
  shards_dir/shard_N.bin - posting lists (vectors + ids + timestamps)

Loading parses every shard file and re-stages the posting layout on the
requested device, or in host memory: for ``resident='offload'`` only the
compact offload tables are uploaded from there, and for ``resident='host'``
the layout stays there and searches stage their probed cells. Spilled
indexes (the header's spill count) load either way. A missing or corrupt
shard is logged and skipped: its clusters drop out of the searchable set,
and search keeps working.
"""

from __future__ import annotations

import logging
import os
import struct
import zlib
from pathlib import Path

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..utils.tracing import trace
from .layout import ALIGN, cluster_starts, pack_layout, scatter_runs
from .shard_format import (
    ClusterData,
    Shard,
    ShardFormatError,
    load_shard_from_disk,
    save_shard,
    shard_path,
)

log = logging.getLogger("vector_indexer_tpu_torch")

INDEX_MAGIC = 0x56495849  # 'VIXI'
INDEX_VERSION = 1
_IDX_HEADER = struct.Struct("<IIIIIIQII")  # 40 bytes incl. crc + spill


def index_path(index_dir) -> Path:
    return Path(index_dir) / "index.bin"


def save_index(index, index_dir, shards_dir=None) -> None:
    """Write index.bin (and the shard files when shards_dir is given)."""
    os.makedirs(index_dir, exist_ok=True)
    n_total = index.layout.n if index.layout is not None else 0
    metric_id = {"l2": 0, "ip": 1, "cosine": 2}[index.metric]
    body = _IDX_HEADER.pack(
        INDEX_MAGIC, INDEX_VERSION, index.dimension, index.num_clusters,
        index.num_shards, metric_id, n_total, 0, 0,
    )
    # CRC over the first 32 bytes; the trailing u32 is the spill count.
    header = body[:32] + struct.pack("<II", zlib.crc32(body[:32]), index.spill)
    with open(index_path(index_dir), "wb") as f:
        f.write(header)
        f.write(np.ascontiguousarray(index.centroids, np.float32).tobytes())
        f.write(np.ascontiguousarray(index.centroids_to_shard, np.int32).tobytes())
    if shards_dir is not None:
        save_shards(index, shards_dir)


def save_shards(index, shards_dir) -> None:
    """Write one file per shard. Payload rows come from the index's host
    mirror when it has one; otherwise the table is copied off the device
    once."""
    lay = index.layout
    if lay is None:
        raise RuntimeError("index has no posting layout to persist")
    host = index._host_data
    vectors = None
    if host is None or host.shape[0] < lay.n:
        vectors = np.asarray(lay.vectors[: lay.rows_used].cpu()
                             if isinstance(lay.vectors, torch.Tensor)
                             else lay.vectors[: lay.rows_used])
    starts = cluster_starts(lay)
    lengths = lay.lengths
    perm = lay.perm
    with trace("save.shards", shards=index.num_shards):
        for sid in range(index.num_shards):
            _save_one_shard(index, sid, shards_dir, host, vectors, starts, lengths, perm)
    log.info("%d shards written to %s", index.num_shards, shards_dir)


def _save_one_shard(index, sid, shards_dir, host, vectors, starts, lengths, perm):
    clusters = []
    for cid in np.flatnonzero(index.centroids_to_shard == sid):
        s, m = int(starts[cid]), int(lengths[cid])
        internal = perm[s : s + m]
        clusters.append(
            ClusterData(
                centroid_id=int(cid),
                centroid=index.centroids[cid],
                internal_ids=internal.astype(np.uint64),
                external_ids=index.external_ids[internal],
                timestamps=index.timestamps[internal],
                vectors=host[internal] if vectors is None else vectors[s : s + m],
            )
        )
    shard = Shard(id=sid, dimension=index.dimension, clusters=clusters)
    try:
        save_shard(shard, shards_dir)
    except OSError as e:  # log and continue, as the reference does
        log.error("failed to write shard %d: %s", sid, e)


def load_index(index_dir, shards_dir=None, device: DeviceLike = None,
               resident: str = "device", offload_rerank: str = "host"):
    """Read index.bin; when shards_dir is given, re-stage the posting lists.

    ``resident``: 'device' stages the layout on ``device``; 'offload' stages
    it in host memory, passes its rows through the device to build the int8
    stream table there and keeps only that (plus the correction table for
    ``offload_rerank='device'``), so the f32 table never stays on the device (IvfIndex.offload_from_host); 'host'
    keeps it in host memory and serves by staging each batch's probed cells
    (index/staged.py), so no corpus-sized copy reaches the device."""
    from ..index.ivf import IvfIndex

    if resident not in ("device", "host", "offload"):
        raise ValueError("resident must be 'device', 'host', or 'offload'")
    dev = resolve_device(device)
    p = index_path(index_dir)
    if not os.path.exists(p):
        raise FileNotFoundError(f"index file not found: {p}")
    with open(p, "rb") as f:
        buf = f.read()
    if len(buf) < 40:
        raise ShardFormatError(f"{p}: truncated index header")
    magic, version, dim, kc, num_shards, metric_id, n_total, crc, spill = (
        _IDX_HEADER.unpack_from(buf, 0)
    )
    if magic != INDEX_MAGIC:
        raise ShardFormatError(f"{p}: bad index magic")
    if zlib.crc32(buf[:32]) != crc:
        raise ShardFormatError(f"{p}: index header CRC mismatch")
    if version != INDEX_VERSION:
        raise ShardFormatError(f"{p}: unsupported index version {version}")

    off = 40
    cent = np.frombuffer(buf, "<f4", count=kc * dim, offset=off).reshape(kc, dim)
    off += 4 * kc * dim
    c2s = np.frombuffer(buf, "<i4", count=kc, offset=off)

    idx = IvfIndex(dim, metric={0: "l2", 1: "ip", 2: "cosine"}.get(metric_id, "l2"),
                   device=dev)
    idx.centroids = cent.copy()
    idx.centroids_to_shard = c2s.copy()
    idx.num_shards = num_shards
    idx.spill = int(spill)
    if shards_dir is not None:
        _stage_shards(idx, shards_dir, n_total, device_put=resident == "device")
        idx.host_resident = resident == "host"
        if resident == "offload":
            idx.offload_from_host(rerank=offload_rerank)
    return idx


def _stage_shards(idx, shards_dir, n_total: int, device_put: bool = True) -> None:
    """Parse all shard files and rebuild the posting layout on the index's
    device (``device_put``) or in host memory. Missing/corrupt shards are
    skipped with a warning; their clusters keep zero-length posting
    lists."""
    kc = idx.num_clusters
    dim = idx.dimension
    clusters: dict = {}
    with trace("load.stage_shards", shards=idx.num_shards):
        for sid in range(idx.num_shards):
            path = shard_path(shards_dir, sid)
            try:
                shard = load_shard_from_disk(path)
                if shard.id != sid:
                    raise ShardFormatError(f"{path}: shard id mismatch")
            except (ShardFormatError, OSError) as e:
                log.warning("skipping shard %d: %s", sid, e)
                continue
            for cl in shard.clusters:
                clusters[cl.centroid_id] = cl

    # Cluster placement identical to build: grouped by shard (stable),
    # run starts ALIGN-aligned.
    cluster_order = np.argsort(idx.centroids_to_shard, kind="stable")
    lengths = np.zeros(kc, np.int64)
    starts = np.zeros(kc, np.int64)
    vec_parts, perm_parts = [], []
    row = 0
    for cid in cluster_order:
        cl = clusters.get(int(cid))
        starts[cid] = row
        if cl is None:
            continue
        m = cl.vectors.shape[0]
        lengths[cid] = m
        vec_parts.append(cl.vectors)
        perm_parts.append(cl.internal_ids.astype(np.int64))
        row += -(-m // ALIGN) * ALIGN
    if vec_parts:
        allvecs = np.concatenate(vec_parts, axis=0)
        perm_real = np.concatenate(perm_parts)
    else:
        allvecs = np.zeros((0, dim), np.float32)
        perm_real = np.zeros(0, np.int64)

    # The concatenated vectors are in placement order: layout row r takes
    # concatenated row src[r].
    src = scatter_runs(np.arange(len(perm_real)), starts, lengths)
    perm = scatter_runs(perm_real, starts, lengths)
    source = torch.as_tensor(allvecs, device=idx.device) if device_put else allvecs
    idx.layout = pack_layout(
        source, src, perm, starts, lengths,
        n_real=min(n_total, len(perm_real)) if n_total else len(perm_real),
    )

    # Record columns indexed by internal id (dense 0..n_total).
    size = max(n_total, int(perm_real.max()) + 1 if len(perm_real) else 0)
    ext = np.zeros(size, np.uint64)
    ts = np.zeros(size, np.uint64)
    host = np.zeros((size, dim), np.float32)
    for cl in clusters.values():
        ii = cl.internal_ids.astype(np.int64)
        ext[ii] = cl.external_ids
        ts[ii] = cl.timestamps
        host[ii] = cl.vectors
    idx.external_ids = ext
    idx.timestamps = ts
    idx._host_data = host  # lets a loaded index re-save without a device copy
