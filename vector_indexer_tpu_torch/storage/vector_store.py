"""In-memory vector store: dense internal ids + columnar payloads.

Parity with the reference's src/vector_store.rs: internal id = insertion
index (0..n), timestamps default to "now" when 0/None (vector_store.rs:29-46),
and the densified (n, d) f32 matrix feeds training (get_vectors,
vector_store.rs:48-58). Storage is columnar numpy from the start (no
per-record objects on the hot path), so densification is free and the copy
to the device is one contiguous transfer. The port keeps its own copy: the
JAX package's ``storage`` imports jax.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Optional, Sequence, Tuple

import numpy as np

from ..utils.io import unix_timestamp_secs


@dataclasses.dataclass
class Vector:
    """Single-record view (parity type; bulk paths never materialize these)."""

    id: int  # dense internal id
    external_id: int
    data: np.ndarray
    timestamp: int


class VectorStore:
    """Columnar store of (internal_id, external_id, vector, timestamp)."""

    def __init__(
        self,
        records: Iterable[Tuple[int, Sequence[float], Optional[int]]] | None = None,
        *,
        external_ids: np.ndarray | None = None,
        vectors: np.ndarray | None = None,
        timestamps: np.ndarray | None = None,
    ):
        if records is not None:
            recs = list(records)
            if external_ids is not None or vectors is not None:
                raise ValueError("pass either records or columnar arrays, not both")
            external_ids = np.array([r[0] for r in recs], dtype=np.uint64)
            vectors = np.asarray([np.asarray(r[1], np.float32) for r in recs])
            timestamps = np.array(
                [r[2] if len(r) > 2 and r[2] else 0 for r in recs], dtype=np.uint64
            )
        if vectors is None or external_ids is None:
            raise ValueError("VectorStore requires vectors")
        self.vectors = np.ascontiguousarray(vectors, dtype=np.float32)
        if self.vectors.ndim != 2:
            raise ValueError("vectors must be 2-D (n, dim)")
        n = self.vectors.shape[0]
        self.external_ids = np.asarray(external_ids, dtype=np.uint64)
        if timestamps is None:
            timestamps = np.zeros(n, dtype=np.uint64)
        timestamps = np.asarray(timestamps, dtype=np.uint64).copy()
        # Timestamp 0 means "unset": stamp with now (vector_store.rs:36-41).
        timestamps[timestamps == 0] = np.uint64(unix_timestamp_secs())
        self.timestamps = timestamps
        if not (len(self.external_ids) == n == len(self.timestamps)):
            raise ValueError("column length mismatch")

    def __len__(self) -> int:
        return self.vectors.shape[0]

    @property
    def dimension(self) -> int:
        return self.vectors.shape[1]

    @property
    def internal_ids(self) -> np.ndarray:
        return np.arange(len(self), dtype=np.int64)

    def get_vectors(self) -> np.ndarray:
        """Dense (n, d) f32 matrix (parity: get_vectors, vector_store.rs:48-58)."""
        return self.vectors

    def get(self, internal_id: int) -> Vector:
        return Vector(
            id=internal_id,
            external_id=int(self.external_ids[internal_id]),
            data=self.vectors[internal_id],
            timestamp=int(self.timestamps[internal_id]),
        )
