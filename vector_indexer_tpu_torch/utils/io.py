"""Batched vector-file helpers and timestamps.

Counterpart of the reference's test-vector generator / reader
(reference src/utils.rs:34-107). The reference appends bincode-encoded
batches of ``(id: u64, vector: [f32], metadata: u64)``; here the same record
stream is stored in a self-describing binary batch format:

    file   := batch*
    batch  := magic:u32('VIXB') count:u32 dim:u32 reserved:u32
              then ``count`` records of [id:u64, ts:u64, vector:f32*dim]

Reads loop over appended batches until EOF (mirroring the reference's
decode-until-error loop at utils.rs:94-104). All heavy lifting is numpy
bulk I/O rather than a per-record loop.
"""

from __future__ import annotations

import struct
import time
from typing import List, Tuple

import numpy as np

_BATCH_MAGIC = 0x56495842  # 'VIXB'
_HEADER = struct.Struct("<IIII")

Record = Tuple[int, np.ndarray, int]  # (external_id, vector f32[dim], timestamp)


def unix_timestamp_secs() -> int:
    return int(time.time())


def write_vectors_to_file(
    filename: str,
    ids: np.ndarray,
    vectors: np.ndarray,
    timestamps: np.ndarray | None = None,
    batch_size: int = 1000,
    append: bool = False,
) -> None:
    """Write (id, vector, timestamp) records as appended batches."""
    vectors = np.ascontiguousarray(vectors, dtype=np.float32)
    n, dim = vectors.shape
    ids = np.asarray(ids, dtype=np.uint64)
    if timestamps is None:
        timestamps = np.zeros(n, dtype=np.uint64)
    timestamps = np.asarray(timestamps, dtype=np.uint64)

    mode = "ab" if append else "wb"
    with open(filename, mode) as f:
        for start in range(0, n, batch_size):
            end = min(start + batch_size, n)
            count = end - start
            f.write(_HEADER.pack(_BATCH_MAGIC, count, dim, 0))
            # Interleave as a structured array for one contiguous write.
            rec = np.zeros(
                count,
                dtype=np.dtype(
                    [("id", "<u8"), ("ts", "<u8"), ("vec", "<f4", (dim,))]
                ),
            )
            rec["id"] = ids[start:end]
            rec["ts"] = timestamps[start:end]
            rec["vec"] = vectors[start:end]
            f.write(rec.tobytes())


def generate_test_vectors(
    filename: str,
    count: int,
    dimension: int,
    seed: int = 0,
    batch_size: int = 1000,
) -> None:
    """Generate ``count`` random vectors in [-1, 1) and persist them.

    Functional parity with generate_test_vectors_parallel
    (reference src/utils.rs:34-79): id = row index, random payload,
    random u64 metadata. Deterministic given ``seed``.
    """
    rng = np.random.default_rng(seed)
    with open(filename, "wb"):
        pass  # truncate
    for start in range(0, count, batch_size):
        end = min(start + batch_size, count)
        vecs = rng.uniform(-1.0, 1.0, size=(end - start, dimension)).astype(
            np.float32
        )
        ids = np.arange(start, end, dtype=np.uint64)
        meta = rng.integers(0, 2**63, size=end - start, dtype=np.uint64)
        write_vectors_to_file(
            filename, ids, vecs, meta, batch_size=batch_size, append=True
        )


def read_vectors_from_file(filename: str) -> List[Record]:
    """Read all appended batches; stop cleanly at truncated/garbage tails.

    Mirrors read_vectors_from_file (reference src/utils.rs:82-107):
    decode batches until the stream no longer parses.
    """
    ids, tss, vecs = read_vectors_from_file_arrays(filename)
    return [(int(i), v, int(t)) for i, v, t in zip(ids, vecs, tss)]


def read_vectors_from_file_arrays(
    filename: str,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Bulk (columnar) variant: returns (ids u64[n], timestamps u64[n], vectors f32[n,dim])."""
    with open(filename, "rb") as f:
        buf = f.read()

    all_ids: list[np.ndarray] = []
    all_ts: list[np.ndarray] = []
    all_vecs: list[np.ndarray] = []
    off = 0
    dim0 = None
    while off + _HEADER.size <= len(buf):
        magic, count, dim, _ = _HEADER.unpack_from(buf, off)
        if magic != _BATCH_MAGIC:
            break
        rec_dtype = np.dtype(
            [("id", "<u8"), ("ts", "<u8"), ("vec", "<f4", (dim,))]
        )
        need = _HEADER.size + count * rec_dtype.itemsize
        if off + need > len(buf):
            break  # truncated tail: keep what we have
        rec = np.frombuffer(
            buf, dtype=rec_dtype, count=count, offset=off + _HEADER.size
        )
        all_ids.append(rec["id"])
        all_ts.append(rec["ts"])
        all_vecs.append(rec["vec"])
        dim0 = dim if dim0 is None else dim0
        off += need

    if not all_ids:
        return (
            np.zeros(0, np.uint64),
            np.zeros(0, np.uint64),
            np.zeros((0, 0), np.float32),
        )
    return (
        np.concatenate(all_ids),
        np.concatenate(all_ts),
        np.concatenate(all_vecs),
    )
