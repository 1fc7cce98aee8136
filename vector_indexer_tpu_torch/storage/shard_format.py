"""Binary shard container: header / centroid index / aligned cluster blocks.

Same capabilities as the original Rust shard file (src/shards.rs): O(1)
centroid lookup via a fixed-stride index, selective per-centroid reads,
shard-id validation, corruption -> error (never a crash), 8-byte block
alignment, versioned header. The byte layout is
our own (little-endian, CRC-protected header):

    header (48 B):
        magic:u32 'VIXS'  version:u32  shard_id:u64  dim:u32
        num_centroids:u32  index_offset:u64  data_offset:u64  crc32:u32 pad:u32
    centroid index (32 B per entry, at index_offset):
        centroid_id:u64  num_vectors:u64  data_offset:u64  data_size:u64
    cluster block (8-aligned, at entry.data_offset):
        centroid f32[dim] (padded to 8)
        num_vectors x { internal_id:u64 external_id:u64 timestamp:u64
                        vector f32[dim] (record padded to 8) }

A C++ reader / writer (native/shardio.cpp: write + fsync, pread, and a
zero-copy mmap with sequential readahead for whole-shard loads) is used
when g++ can build it, and the numpy path otherwise. The bytes on disk are
the JAX package's, so either package reads what the other wrote.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import struct
import zlib
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

import numpy as np

SHARD_MAGIC = 0x56495853  # 'VIXS'
SHARD_VERSION = 1
_HEADER_FMT = struct.Struct("<IIQIIQQII")  # 48 bytes
_ENTRY_FMT = struct.Struct("<QQQQ")  # 32 bytes
META_DTYPE = np.dtype([("id", "<u8"), ("external_id", "<u8"), ("timestamp", "<u8")])

assert _HEADER_FMT.size == 48
assert _ENTRY_FMT.size == 32


class ShardFormatError(IOError):
    """Raised for any structural problem: bad magic, CRC, truncation,
    shard-id mismatch, unknown centroid. Never lets corruption escalate to a
    crash (parity with the reference's corrupt-header test,
    tests/shards_tests.rs:588-630)."""


@dataclasses.dataclass
class ShardHeader:
    shard_id: int
    version: int
    dimensions: int
    num_centroids: int
    index_offset: int
    data_offset: int


@dataclasses.dataclass
class ClusterData:
    """One posting list as stored in a shard."""

    centroid_id: int
    centroid: np.ndarray  # (dim,) f32
    internal_ids: np.ndarray  # (m,) u64
    external_ids: np.ndarray  # (m,) u64
    timestamps: np.ndarray  # (m,) u64
    vectors: np.ndarray  # (m, dim) f32


@dataclasses.dataclass
class Shard:
    id: int
    dimension: int
    clusters: List[ClusterData]

    @property
    def num_vectors(self) -> int:
        return sum(c.vectors.shape[0] for c in self.clusters)


def _pad8(nbytes: int) -> int:
    return (8 - (nbytes % 8)) % 8


def shard_path(shards_dir, shard_id: int) -> Path:
    return Path(shards_dir) / f"shard_{shard_id}.bin"


def _native():
    """The native I/O module when its library is available, else None."""
    from .native import shardio

    return shardio if shardio.available() else None


# ---------------------------------------------------------------------------
# Write
# ---------------------------------------------------------------------------


def _pack_header(h: ShardHeader) -> bytes:
    body = _HEADER_FMT.pack(
        SHARD_MAGIC,
        h.version,
        h.shard_id,
        h.dimensions,
        h.num_centroids,
        h.index_offset,
        h.data_offset,
        0,
        0,
    )
    crc = zlib.crc32(body[:40])
    return body[:40] + struct.pack("<II", crc, 0)


def _record_stride(dim: int) -> int:
    raw = META_DTYPE.itemsize + 4 * dim
    return raw + _pad8(raw)


def _centroid_stride(dim: int) -> int:
    raw = 4 * dim
    return raw + _pad8(raw)


def save_shard(shard: Shard, shards_dir) -> Path:
    """Serialize and write shard_{id}.bin (overwrite semantics)."""
    os.makedirs(shards_dir, exist_ok=True)
    path = shard_path(shards_dir, shard.id)
    dim = shard.dimension
    nc = len(shard.clusters)

    index_offset = 48
    data_offset = index_offset + 32 * nc
    data_offset += _pad8(data_offset)

    entries = []
    blocks = []
    off = data_offset
    cstride = _centroid_stride(dim)
    rstride = _record_stride(dim)
    for cl in shard.clusters:
        m = cl.vectors.shape[0]
        size = cstride + m * rstride
        entries.append((cl.centroid_id, m, off, size))

        block = bytearray(size)
        cbytes = np.ascontiguousarray(cl.centroid, np.float32).tobytes()
        block[: len(cbytes)] = cbytes
        rec = np.zeros(
            m,
            dtype=np.dtype(
                [
                    ("meta", META_DTYPE),
                    ("vec", "<f4", (dim,)),
                    ("pad", "V%d" % _pad8(META_DTYPE.itemsize + 4 * dim)),
                ]
                if _pad8(META_DTYPE.itemsize + 4 * dim)
                else [("meta", META_DTYPE), ("vec", "<f4", (dim,))]
            ),
        )
        rec["meta"]["id"] = cl.internal_ids
        rec["meta"]["external_id"] = cl.external_ids
        rec["meta"]["timestamp"] = cl.timestamps
        rec["vec"] = cl.vectors
        block[cstride:] = rec.tobytes()
        blocks.append(bytes(block))
        off += size

    header = ShardHeader(
        shard_id=shard.id,
        version=SHARD_VERSION,
        dimensions=dim,
        num_centroids=nc,
        index_offset=index_offset,
        data_offset=data_offset,
    )

    payload = b"".join(
        [_pack_header(header)]
        + [_ENTRY_FMT.pack(*e) for e in entries]
        + [b"\0" * _pad8(index_offset + 32 * nc)]
        + blocks
    )
    nat = _native()
    if nat is not None:
        nat.write_file(str(path), payload)
    else:
        with open(path, "wb") as f:
            f.write(payload)
    return path


# ---------------------------------------------------------------------------
# Read
# ---------------------------------------------------------------------------


def _read_file(path) -> bytes:
    p = str(path)
    if not os.path.exists(p):
        raise ShardFormatError(f"shard file not found: {p}")
    nat = _native()
    if nat is not None:
        return nat.read_file(p)
    with open(p, "rb") as f:
        return f.read()


@contextlib.contextmanager
def _open_buffer(path):
    """Yield the file's bytes as a buffer for parsing: a zero-copy mmap view
    (sequential readahead; the load-time staging path, as the original
    system's mmap in load_from_disk_in, shards.rs:356-425) when the native
    library is present, else an ordinary read. The parsers copy everything
    they return, so the mapping can be released on exit."""
    nat = _native()
    if nat is not None:
        try:
            view = nat.mmap_view(str(path))
            mv = view.__enter__()
        except OSError:  # missing, empty or unmappable: _read_file raises
            pass
        else:
            try:
                yield mv
            finally:
                view.__exit__(None, None, None)
            return
    yield _read_file(path)


def _parse_header(buf: bytes, path) -> ShardHeader:
    if len(buf) < 48:
        raise ShardFormatError(f"{path}: truncated header ({len(buf)} bytes)")
    magic, version, shard_id, dim, nc, ioff, doff, crc, _ = _HEADER_FMT.unpack_from(
        buf, 0
    )
    if magic != SHARD_MAGIC:
        raise ShardFormatError(f"{path}: bad magic 0x{magic:08x}")
    if zlib.crc32(buf[:40]) != crc:
        raise ShardFormatError(f"{path}: header CRC mismatch")
    if version != SHARD_VERSION:
        raise ShardFormatError(f"{path}: unsupported version {version}")
    return ShardHeader(shard_id, version, dim, nc, ioff, doff)


def read_shard_header(path) -> ShardHeader:
    """The shard's header alone (48 bytes read)."""
    p = str(path)
    if not os.path.exists(p):
        raise ShardFormatError(f"shard file not found: {p}")
    nat = _native()
    if nat is not None:
        return _parse_header(nat.read_file(p, 0, 48), path)
    with open(p, "rb") as f:
        return _parse_header(f.read(48), path)


def _parse_entries(buf: bytes, h: ShardHeader, path) -> List[Tuple[int, int, int, int]]:
    end = h.index_offset + 32 * h.num_centroids
    if len(buf) < end:
        raise ShardFormatError(f"{path}: truncated centroid index")
    return [
        _ENTRY_FMT.unpack_from(buf, h.index_offset + 32 * i)
        for i in range(h.num_centroids)
    ]


def _parse_block(
    buf: bytes, entry, dim: int, path
) -> Tuple[np.ndarray, np.ndarray]:
    cid, m, off, size = entry
    if off + size > len(buf):
        raise ShardFormatError(f"{path}: truncated block for centroid {cid}")
    cstride = _centroid_stride(dim)
    rstride = _record_stride(dim)
    if size != cstride + m * rstride:
        raise ShardFormatError(f"{path}: inconsistent block size for centroid {cid}")
    centroid = np.frombuffer(buf, "<f4", count=dim, offset=off)
    pad = _pad8(META_DTYPE.itemsize + 4 * dim)
    fields = [("meta", META_DTYPE), ("vec", "<f4", (dim,))]
    if pad:
        fields.append(("pad", "V%d" % pad))
    rec = np.frombuffer(buf, np.dtype(fields), count=m, offset=off + cstride)
    return centroid, rec


def _cluster(buf, entry, dim: int, path) -> ClusterData:
    centroid, rec = _parse_block(buf, entry, dim, path)
    return ClusterData(
        centroid_id=int(entry[0]),
        centroid=centroid.copy(),
        internal_ids=rec["meta"]["id"].copy(),
        external_ids=rec["meta"]["external_id"].copy(),
        timestamps=rec["meta"]["timestamp"].copy(),
        vectors=rec["vec"].copy(),
    )


def read_centroid_vectors(path, shard_id: int,
                          centroid_ids: Sequence[int]) -> Dict[int, ClusterData]:
    """Selective per-centroid read (parity: get_centroid_vectors_from,
    shards.rs:188-349, with its shard-id validation :222-231 and
    missing-centroid error :256-265)."""
    with _open_buffer(path) as buf:
        h = _parse_header(buf, path)
        if h.shard_id != shard_id:
            raise ShardFormatError(
                f"{path}: shard id mismatch: expected {shard_id}, found {h.shard_id}"
            )
        entries = {e[0]: e for e in _parse_entries(buf, h, path)}
        out: Dict[int, ClusterData] = {}
        for cid in centroid_ids:
            if cid not in entries:
                raise ShardFormatError(f"{path}: centroid {cid} not in shard {shard_id}")
            out[cid] = _cluster(buf, entries[cid], h.dimensions, path)
        return out


def load_shard_from_disk(path) -> Shard:
    """Whole-shard load, through the zero-copy mmap when the native library
    is available (parity: load_from_disk_in, shards.rs:356-425)."""
    with _open_buffer(path) as buf:
        h = _parse_header(buf, path)
        clusters = [_cluster(buf, e, h.dimensions, path)
                    for e in _parse_entries(buf, h, path)]
    return Shard(id=h.shard_id, dimension=h.dimensions, clusters=clusters)
