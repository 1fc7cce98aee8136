"""Public API facade: config / records / requests / results / indexer.

Port of ``vector_indexer_tpu/api.py`` with the same defaults, caps and
validation (reference src/api.rs): index_dir="index", shards_dir="shards",
default_k=10, default_n_probe=20, max_k=10_000, max_n_probe=10_000; builds
use the fixed seed 42; search clamps k/n_probe to the caps and validates the
query dimension. The port adds ``device`` to the config: where the index
lives and searches run (None: the first CUDA device; with no CUDA device
present that raises, and only ``device="cpu"`` runs on the CPU).
"""

from __future__ import annotations

import asyncio
import dataclasses
from logging import DEBUG
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np

from .index.ivf import IvfIndex, load_index_from
from .storage.vector_store import VectorStore
from .utils.io import read_vectors_from_file_arrays
from .utils.tracing import trace


@dataclasses.dataclass
class VectorIndexerConfig:
    """Index configuration with reference-parity defaults and caps."""

    dimension: int
    index_dir: Path = Path("index")
    shards_dir: Path = Path("shards")
    default_k: int = 10
    default_n_probe: int = 20
    max_k: int = 10_000
    max_n_probe: int = 10_000
    # 'l2' | 'ip' | 'cosine'; for ip/cosine distances are negated
    # similarities (ascending = most similar first).
    metric: str = "l2"
    # SOAR spilled assignment: 0 or 1 secondary cells per vector (searches
    # of a spilled index drop repeated ids).
    spill: int = 0
    device: Optional[str] = None

    def __post_init__(self):
        self.index_dir = Path(self.index_dir)
        self.shards_dir = Path(self.shards_dir)

    def with_metric(self, metric: str) -> "VectorIndexerConfig":
        return dataclasses.replace(self, metric=metric)

    def with_spill(self, spill: int) -> "VectorIndexerConfig":
        return dataclasses.replace(self, spill=spill)

    def with_index_dir(self, index_dir) -> "VectorIndexerConfig":
        return dataclasses.replace(self, index_dir=Path(index_dir))

    def with_shards_dir(self, shards_dir) -> "VectorIndexerConfig":
        return dataclasses.replace(self, shards_dir=Path(shards_dir))

    def with_device(self, device) -> "VectorIndexerConfig":
        return dataclasses.replace(self, device=None if device is None else str(device))


@dataclasses.dataclass
class VectorRecord:
    external_id: int
    values: Sequence[float]
    timestamp: Optional[int] = None  # None -> stamped with "now" at build


@dataclasses.dataclass
class SearchRequest:
    query: Sequence[float]
    include_vectors: bool = False
    k: int = 10
    n_probe: int = 20

    def with_k(self, k: int) -> "SearchRequest":
        return dataclasses.replace(self, k=k)

    def with_n_probe(self, n_probe: int) -> "SearchRequest":
        return dataclasses.replace(self, n_probe=n_probe)

    def with_include_vectors(self, include_vectors: bool) -> "SearchRequest":
        return dataclasses.replace(self, include_vectors=include_vectors)


@dataclasses.dataclass
class SearchResult:
    external_id: int
    distance: float
    vector: Optional[np.ndarray] = None


class VectorIndexer:
    """User-facing build/load/search wrapper around the IVF core."""

    def __init__(self, cfg: VectorIndexerConfig, _index: Optional[IvfIndex] = None):
        self.cfg = cfg
        self.index = (
            _index if _index is not None
            else IvfIndex(cfg.dimension, metric=cfg.metric, device=cfg.device)
        )

    # ------------------------------------------------------------------
    # Construction
    # ------------------------------------------------------------------

    @classmethod
    def load(cls, cfg: VectorIndexerConfig, resident: str = "device",
             offload_rerank: str = "host") -> "VectorIndexer":
        """``resident='offload'`` keeps only an int8 stream table on the
        device, built there from staged host rows, for serving f32 tables
        larger than device memory;
        ``offload_rerank`` ('host', 'device' or 'none') picks how its
        shortlist is re-ranked (index/offload.py). ``resident='host'``
        keeps the layout in host memory and stages each batch's probed
        cells (index/staged.py)."""
        index = load_index_from(
            cfg.index_dir, cfg.shards_dir, resident=resident, device=cfg.device,
            offload_rerank=offload_rerank,
        )
        return cls(cfg, _index=index)

    def build_from_records(self, records: List[VectorRecord]) -> "VectorIndexer":
        if not records:
            raise ValueError("no vectors provided")
        dim = self.cfg.dimension
        for i, r in enumerate(records):
            if len(r.values) != dim:
                raise ValueError(
                    f"vector dimension mismatch at index {i}: "
                    f"expected {dim}, got {len(r.values)}"
                )
        store = VectorStore(
            external_ids=np.array([r.external_id for r in records], np.uint64),
            vectors=np.asarray([r.values for r in records], np.float32),
            timestamps=np.array(
                [r.timestamp if r.timestamp else 0 for r in records], np.uint64
            ),
        )
        return self._fit_and_save(store)

    def build_from_arrays(
        self,
        vectors: np.ndarray,
        external_ids: Optional[np.ndarray] = None,
        timestamps: Optional[np.ndarray] = None,
    ) -> "VectorIndexer":
        """Columnar fast path (no per-record objects) for bulk builds."""
        vectors = np.ascontiguousarray(vectors, np.float32)
        if vectors.ndim != 2 or vectors.shape[0] == 0:
            raise ValueError("no vectors provided")
        if vectors.shape[1] != self.cfg.dimension:
            raise ValueError(
                f"vector dimension mismatch: expected {self.cfg.dimension}, "
                f"got {vectors.shape[1]}"
            )
        if external_ids is None:
            external_ids = np.arange(vectors.shape[0], dtype=np.uint64)
        store = VectorStore(external_ids=external_ids, vectors=vectors, timestamps=timestamps)
        return self._fit_and_save(store)

    def build_from_vector_file(self, vector_file) -> "VectorIndexer":
        ids, ts, vecs = read_vectors_from_file_arrays(str(vector_file))
        if vecs.shape[0] == 0:
            raise ValueError("no vectors in vector_file")
        if vecs.shape[1] != self.cfg.dimension:
            raise ValueError(
                f"vector dimension mismatch: expected {self.cfg.dimension}, "
                f"got {vecs.shape[1]}"
            )
        return self._fit_and_save(VectorStore(external_ids=ids, vectors=vecs, timestamps=ts))

    def _fit_and_save(self, store: VectorStore) -> "VectorIndexer":
        # The batched (D, I) contract returns ids as int64 with -1 padding,
        # so ids >= 2^63 (which would wrap negative) are rejected.
        if (np.asarray(store.external_ids) >> 63).any():
            raise ValueError(
                "external ids must be < 2**63 (the batched search contract "
                "returns int64 ids with -1 as the missing-slot sentinel)"
            )
        # Fixed seed for API builds: deterministic, not configurable.
        self.index = IvfIndex.fit(
            store, seed=42, metric=self.cfg.metric, spill=self.cfg.spill,
            device=self.cfg.device,
        )
        self.index.save_shards_to(self.cfg.shards_dir)
        self.index.save_to(self.cfg.index_dir)
        return self

    # ------------------------------------------------------------------
    # Search
    # ------------------------------------------------------------------

    def search_request(self, query) -> SearchRequest:
        return SearchRequest(
            query=query, include_vectors=False,
            k=self.cfg.default_k, n_probe=self.cfg.default_n_probe,
        )

    def search_sync(self, req: SearchRequest) -> List[SearchResult]:
        k = min(req.k, self.cfg.max_k)
        n_probe = min(req.n_probe, self.cfg.max_n_probe)
        query = np.asarray(req.query, np.float32)
        if query.shape != (self.cfg.dimension,):
            raise ValueError(
                f"query dimension mismatch: expected {self.cfg.dimension}, "
                f"got {query.shape[-1] if query.ndim else 0}"
            )
        return [
            SearchResult(
                external_id=ext, distance=dist,
                vector=vec if req.include_vectors else None,
            )
            for ext, dist, vec in self.index.search(query, k, n_probe)
        ]

    async def search(self, req: SearchRequest) -> List[SearchResult]:
        return await asyncio.get_running_loop().run_in_executor(None, self.search_sync, req)

    def search_batch(self, queries: np.ndarray, k: Optional[int] = None,
                     n_probe: Optional[int] = None, method: str = "auto"):
        """Columnar batched search -> (D (nq, k) f32, I (nq, k) external ids
        int64), padded with +inf / -1."""
        with trace("search", level=DEBUG):
            k = min(k if k is not None else self.cfg.default_k, self.cfg.max_k)
            n_probe = min(
                n_probe if n_probe is not None else self.cfg.default_n_probe,
                self.cfg.max_n_probe,
            )
            return self.index.search_batch(queries, k, n_probe, method=method, external=True)

    def config(self) -> VectorIndexerConfig:
        return self.cfg
