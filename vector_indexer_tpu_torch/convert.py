"""Carry an index's state across from the JAX package, as numpy arrays.

``index_from_reference_arrays`` builds a port ``IvfIndex`` from the arrays
of a ``vector_indexer_tpu`` index, so that both packages search the same
centroids and the same posting table; ``stream_table_from_reference_arrays``
and ``correction_table_from_reference_arrays`` carry a quantized stream
table (bf16, int8 or f32) and an offload correction table across, and
``sweep_int8_tables_from_reference_arrays`` the int8 sweep tables of
``quantize_table_int8``, so that both packages' kernels read the same
quantized rows. The port never imports
jax: the caller does the ``np.asarray`` on the reference side (see
``reference_arrays`` in the tests).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .device import DeviceLike, resolve_device
from .index.ivf import IvfIndex
from .ops.block_stream import StreamTable
from .ops.correction import CorrectionTable
from .storage.layout import PostingLayout

# Keys the reference side must provide.
REFERENCE_KEYS = (
    "centroids", "centroids_to_shard", "num_shards", "metric", "external_ids",
    "timestamps", "vectors", "row_norms", "offsets", "lengths", "perm", "n",
    "max_list_len",
)


def index_from_reference_arrays(arrays: Dict[str, np.ndarray],
                                device: DeviceLike = None) -> IvfIndex:
    """Port IvfIndex holding the reference index's state on ``device``.
    ``arrays['spill']`` (default 0) carries a spilled index's spill count."""
    missing = [k for k in REFERENCE_KEYS if k not in arrays]
    if missing:
        raise KeyError(f"reference arrays missing: {missing}")
    dev = resolve_device(device)
    centroids = np.asarray(arrays["centroids"], np.float32)
    idx = IvfIndex(centroids.shape[1], metric=str(arrays["metric"]), device=dev)
    idx.centroids = centroids.copy()
    idx.centroids_to_shard = np.asarray(arrays["centroids_to_shard"], np.int32).copy()
    idx.num_shards = int(arrays["num_shards"])
    idx.external_ids = np.asarray(arrays["external_ids"], np.uint64).copy()
    idx.timestamps = np.asarray(arrays["timestamps"], np.uint64).copy()
    idx.spill = int(arrays.get("spill", 0))
    vectors = np.array(arrays["vectors"], np.float32)  # a writable copy
    idx.layout = PostingLayout(
        vectors=torch.as_tensor(vectors, device=dev),
        row_norms=torch.as_tensor(np.array(arrays["row_norms"], np.float32), device=dev),
        offsets=np.asarray(arrays["offsets"], np.int32).copy(),
        lengths=np.asarray(arrays["lengths"], np.int32).copy(),
        perm=np.asarray(arrays["perm"], np.int64).copy(),
        n=int(arrays["n"]),
        max_list_len=int(arrays["max_list_len"]),
    )
    # Host mirror in internal-id order, for persistence.
    lay = idx.layout
    host = np.zeros((max(lay.n, int(lay.perm.max()) + 1 if len(lay.perm) else 0),
                     vectors.shape[1]), np.float32)
    real = lay.perm >= 0
    host[lay.perm[real]] = vectors[: lay.rows_used][real]
    idx._host_data = host
    return idx


STREAM_TABLE_KEYS = ("vecs", "norms", "to_main", "sblk0", "lengths", "cent", "blk_cid",
                     "scales", "m_pad", "chunk")
CORRECTION_TABLE_KEYS = ("q2", "scales2", "norms_abs", "inv", "m_pad")


def _rows(a: np.ndarray, dev) -> torch.Tensor:
    """A table of rows; numpy has no bf16, so the reference's bf16 arrays
    (ml_dtypes, dtype name 'bfloat16') cross as their 16-bit patterns."""
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy()).view(
            torch.bfloat16).to(dev)
    return torch.as_tensor(np.array(a), device=dev)


def _i64(a, dev) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.int64), device=dev)


def _f32(a, dev) -> torch.Tensor:
    return torch.as_tensor(np.array(a, np.float32), device=dev)


def stream_table_from_reference_arrays(arrays: Dict[str, np.ndarray],
                                       device: DeviceLike = None) -> StreamTable:
    """Port StreamTable holding a reference stream table's arrays."""
    missing = [k for k in STREAM_TABLE_KEYS if k not in arrays]
    if missing:
        raise KeyError(f"reference stream table arrays missing: {missing}")
    dev = resolve_device(device)
    return StreamTable(
        vecs=_rows(np.asarray(arrays["vecs"]), dev),
        norms=_f32(arrays["norms"], dev),
        to_main=_i64(arrays["to_main"], dev),
        sblk0=_i64(arrays["sblk0"], dev),
        lengths=_i64(arrays["lengths"], dev),
        cent=_f32(arrays["cent"], dev),
        blk_cid=_i64(arrays["blk_cid"], dev),
        scales=_f32(arrays["scales"], dev),
        m_pad=int(arrays["m_pad"]),
        chunk=int(arrays["chunk"]),
    )


def correction_table_from_reference_arrays(arrays: Dict[str, np.ndarray],
                                           device: DeviceLike = None) -> CorrectionTable:
    """Port CorrectionTable holding a reference correction table's arrays."""
    missing = [k for k in CORRECTION_TABLE_KEYS if k not in arrays]
    if missing:
        raise KeyError(f"reference correction table arrays missing: {missing}")
    dev = resolve_device(device)
    return CorrectionTable(
        q2=_rows(np.asarray(arrays["q2"]), dev),
        scales2=_f32(arrays["scales2"], dev),
        norms_abs=_f32(arrays["norms_abs"], dev),
        inv=_i64(arrays["inv"], dev),
        m_pad=int(arrays["m_pad"]),
    )


def sweep_int8_tables_from_reference_arrays(x8: np.ndarray, r8: np.ndarray, sx: np.ndarray,
                                            device: DeviceLike = None):
    """The reference's int8 sweep tables (x8, r8 (n, d) int8, sx (n,) f32,
    from ``quantize_table_int8``) as port tensors on ``device``."""
    x8, r8, sx = np.asarray(x8), np.asarray(r8), np.asarray(sx)
    if x8.dtype != np.int8 or r8.dtype != np.int8 or x8.shape != r8.shape \
            or sx.shape != (x8.shape[0],):
        raise ValueError("sweep tables: x8, r8 (n, d) int8 and sx (n,) required")
    dev = resolve_device(device)
    return (torch.as_tensor(x8.copy(), device=dev), torch.as_tensor(r8.copy(), device=dev),
            _f32(sx, dev))
