"""Numpy-first bindings surface: build / load / suggest_nlist / VectorIndex.

Port of ``vector_indexer_tpu/bindings.py`` (reference
bindings/python/src/lib.rs):

  * ``build(xb, work_dir)``: one-shot build from an (n, d) f32 array,
    external_id = row index;
  * ``build(xb, work_dir, spill=1)``: every vector also joins a SOAR-chosen
    second cell (searches drop repeated ids);
  * ``load(index_dir, shards_dir, dim, resident)``: ``resident='offload'``
    serves from a host-quantized int8 stream table (the f32 table never
    reaches the device); ``resident='host'`` keeps the table in host
    memory and stages each batch's probed cells;
  * ``VectorIndex.search_sync(xq, k, n_probe)`` returning ``(D, I)``
    float32/int64 arrays of shape (nq, k), padded with +inf / -1;
  * ``VectorIndex.search_device`` returning device tensors (no copy to the
    host) for serving and benchmark loops, on queries that
    ``VectorIndex.stage_queries`` copied to the device once;
  * ``VectorIndex.offload(stream_dtype, rerank)``: free a loaded index's f32
    table and serve from the compact stream table.

Both ``build`` and ``load`` take ``device``. ``None`` (the default) means
``cuda:0`` and raises when there is no card; the CPU runs only when the
caller passes ``device="cpu"``.
"""

from __future__ import annotations

import asyncio
import os
import tempfile
from logging import DEBUG
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

from .api import VectorIndexer, VectorIndexerConfig
from .utils.heuristics import suggest_nlist
from .utils.tracing import trace

__all__ = ["build", "load", "suggest_nlist", "VectorIndex"]


class VectorIndex:
    """Batched query handle over a built/loaded index."""

    def __init__(self, indexer: VectorIndexer):
        self._indexer = indexer

    @property
    def d(self) -> int:
        return self._indexer.cfg.dimension

    @property
    def nlist(self) -> int:
        return self._indexer.index.num_clusters

    @property
    def index(self):
        return self._indexer.index

    @property
    def indexer(self) -> VectorIndexer:
        return self._indexer

    def search_sync(self, xq: np.ndarray, k: int, n_probe: int,
                    method: str = "auto") -> Tuple[np.ndarray, np.ndarray]:
        """(nq, d) -> (D (nq, k) f32, I (nq, k) i64 external ids; pads +inf/-1)."""
        xq = np.ascontiguousarray(xq, dtype=np.float32)
        if xq.ndim == 1:
            xq = xq[None, :]
        return self._indexer.search_batch(xq, k=k, n_probe=n_probe, method=method)

    search_blocking = search_sync

    def search_device(self, xq, k: int, n_probe: int, method: str = "auto"):
        """Device-resident search: (D, layout_rows) tensors on the index's
        device, no copy to the host: the serving / benchmark hot path.
        Queries staged by ``stage_queries`` are used without another copy;
        ``rows_to_external`` maps the rows to external ids, and
        ``search_sync`` returns host arrays with external ids."""
        cfg = self._indexer.cfg
        with trace("search", level=DEBUG):
            return self._indexer.index.search_batch_device(
                xq, min(k, cfg.max_k), min(n_probe, cfg.max_n_probe), method
            )

    def stage_queries(self, xq, pad_to: int = 512) -> torch.Tensor:
        """Copy a query batch to the index's device once, as f32; pass the
        tensor to ``search_device`` to keep repeated searches free of
        host-to-device copies. Rows are padded with zero rows to a multiple
        of ``pad_to``, so a batch of any size searches at a few shapes; the
        first ``len(xq)`` rows of a result belong to ``xq``. On a card the
        copy goes through pinned memory, without blocking the host."""
        xq = np.ascontiguousarray(xq, dtype=np.float32)
        if xq.ndim == 1:
            xq = xq[None, :]
        n = xq.shape[0]
        n_pad = -(-n // pad_to) * pad_to if pad_to > 1 else n
        dev = self._indexer.index.device
        cuda = dev.type == "cuda"
        host = torch.zeros((n_pad, xq.shape[1]), dtype=torch.float32, pin_memory=cuda)
        host[:n] = torch.from_numpy(xq)
        return host.to(dev, non_blocking=True) if cuda else host

    def offload(self, stream_dtype=None, rerank: str = "host") -> None:
        """Larger-than-device mode: free the f32 main table and serve from a
        compact (int8 by default) stream table, with the shortlist re-ranked
        exactly on the host (rerank='host'), on the device against a
        two-layer int8 reconstruction ('device'), or not at all ('none').
        See IvfIndex.offload_main_table."""
        self._indexer.index.offload_main_table(stream_dtype, rerank=rerank)

    def rows_to_external(self, rows) -> np.ndarray:
        """Map layout rows (from search_device) to external ids."""
        idx = self._indexer.index
        if isinstance(rows, torch.Tensor):
            rows = rows.cpu().numpy()
        return idx.internal_to_external(idx.rows_to_internal(np.asarray(rows)))

    async def search(self, xq: np.ndarray, k: int, n_probe: int) -> Tuple[np.ndarray, np.ndarray]:
        loop = asyncio.get_running_loop()
        return await loop.run_in_executor(None, self.search_sync, xq, k, n_probe)


def _default_work_dir() -> Path:
    return Path(tempfile.gettempdir()) / "vector_indexer_tpu_torch"


def build(xb: np.ndarray, work_dir: Optional[str] = None, metric: str = "l2",
          spill: int = 0, device=None) -> VectorIndex:
    """Build an index from an (n, d) float32 array; external_id = row index."""
    xb = np.ascontiguousarray(xb, dtype=np.float32)
    if xb.ndim != 2 or xb.shape[0] == 0:
        raise ValueError("xb must be a non-empty (n, d) array")
    wd = Path(work_dir) if work_dir else _default_work_dir()
    cfg = (
        VectorIndexerConfig(xb.shape[1], metric=metric, spill=spill)
        .with_index_dir(wd / "index")
        .with_shards_dir(wd / "shards")
        .with_device(device)
    )
    os.makedirs(cfg.index_dir, exist_ok=True)
    os.makedirs(cfg.shards_dir, exist_ok=True)
    return VectorIndex(VectorIndexer(cfg).build_from_arrays(xb))


def load(index_dir: str, shards_dir: str, dim: int, resident: str = "device",
         device=None) -> VectorIndex:
    """Load a saved index onto ``device``. ``resident='offload'`` serves
    f32 tables larger than device memory from a host-quantized int8 stream
    table with an exact host re-rank (see IvfIndex.offload_from_host);
    ``resident='host'`` serves method 'staged' from host memory (see
    index/staged.py)."""
    cfg = (
        VectorIndexerConfig(dim)
        .with_index_dir(index_dir)
        .with_shards_dir(shards_dir)
        .with_device(device)
    )
    return VectorIndex(VectorIndexer.load(cfg, resident=resident))
