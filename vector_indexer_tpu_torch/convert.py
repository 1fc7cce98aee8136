"""Carry an index's state across from the JAX package, as numpy arrays.

``index_from_reference_arrays`` builds a port ``IvfIndex`` from the arrays
of a ``vector_indexer_tpu`` index, so that both packages search the same
centroids and the same posting table. The port never imports jax: the
caller does the ``np.asarray`` on the reference side (see
``reference_arrays`` in the tests).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .device import DeviceLike, resolve_device
from .index.ivf import IvfIndex
from .storage.layout import PostingLayout

# Keys the reference side must provide.
REFERENCE_KEYS = (
    "centroids", "centroids_to_shard", "num_shards", "metric", "external_ids",
    "timestamps", "vectors", "row_norms", "offsets", "lengths", "perm", "n",
    "max_list_len",
)


def index_from_reference_arrays(arrays: Dict[str, np.ndarray],
                                device: DeviceLike = None) -> IvfIndex:
    """Port IvfIndex holding the reference index's state on ``device``."""
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
