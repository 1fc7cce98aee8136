"""Two-level IVF-Flat index: build (fit) and batched search, on one device.

Port of ``vector_indexer_tpu/index/ivf.py``:

* ``fit``: full-batch Lloyd on the device (optionally trained on a seeded
  subsample, ``train_sample``; ``trainer='mini_batch'`` or ``'balanced'``
  for the other trainers; ``mesh=`` for the data-parallel Lloyd over a
  device mesh, parallel/dp_kmeans.py), a super-centroid k-means over the centroid
  table with ``num_shards = ceil(sqrt(nlist))`` and seed ``seed*31 + 7``,
  empty lists filtered and ids densely remapped, and a posting layout whose
  clusters are grouped by shard. ``spill=1`` also puts every vector into a
  SOAR-chosen second cell (``ops/distance.py::assign_spill_chunked``);
  searches then run (1+spill)k wide and drop duplicate ids.
  ``resident='host'`` is the low-device-memory build: only the training
  sample and fixed-size assignment slices reach the device, and the layout
  stays in host memory; with ``mesh=`` too, the sample is split over the
  mesh's devices and each assigns its own range of the host rows, so a
  corpus larger than any one device builds;
* ``search_batch``: ``index/dispatch.py::resolve`` picks the program
  (stream, fused or plain dense, fused or plain flat, the int8 sweeps,
  the packed gather or the K6 range gather), ``index/programs.py`` runs
  it, and layout rows map to internal or external ids on the device, by
  one gather through a cached row table, before the copy back; a call
  shape a device-resident index on a card has answered before replays as
  one captured CUDA graph (index/graphs.py);
* persistence through ``storage/persist.py`` (the reference's on-disk
  format);
* offloaded serving (``offload_main_table``, ``offload_from_host``,
  ``load_index_from(..., resident='offload')``): the f32 table leaves the
  device, an int8 stream table serves, and the shortlist is re-ranked on
  the host, on the device, or not at all (index/offload.py);
* host-resident serving (``to_host_resident``, ``load_index_from(...,
  resident='host')``): the layout stays in host memory and each batch
  stages only its probed cells (index/staged.py).

Search over a corpus split across devices is ``parallel/sharded.py``.
"""

from __future__ import annotations

import logging
import threading
from functools import partial
from logging import DEBUG
from typing import Optional, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..models.kmeans import (
    run_kmeans_balanced,
    run_kmeans_lloyd,
    run_kmeans_lloyd_host,
    run_kmeans_lloyd_sampled,
    run_kmeans_mini_batch,
)
from ..ops.block_stream import pick_chunk
from ..ops.distance import assign_spill_chunked
from ..storage.layout import PostingLayout, build_layout
from ..storage.vector_store import VectorStore
from ..utils.heuristics import (
    calculate_max_iterations,
    calculate_num_clusters,
    num_shards_for,
)
from ..utils.tracing import trace
from . import offload as _offload
from . import programs
from .dispatch import (
    choose_sweep_body,
    mean_slot_rows_of,
    resolve,
    shared_gate,
    stream_itemsize,
    stream_params,
)
from .graphs import SearchGraphs
from .staged import staged_search
from .tables import DeviceTables

log = logging.getLogger("vector_indexer_tpu_torch")


class IvfIndex:
    """Two-level IVF-Flat index with a device-resident posting layout."""

    def __init__(self, dimension: int, metric: str = "l2", device: DeviceLike = None):
        if metric not in ("l2", "ip", "cosine"):
            raise ValueError(f"unsupported metric: {metric}")
        self.dimension = int(dimension)
        self.metric = metric
        self.device = resolve_device(device)
        self.centroids = np.zeros((0, dimension), np.float32)
        self.centroids_to_shard = np.zeros(0, np.int32)
        self.num_shards = 0
        self.layout: Optional[PostingLayout] = None
        # Secondary (SOAR) assignments per vector: 0 or 1. A spilled index
        # searches (1+spill)k wide and drops duplicate ids.
        self.spill = 0
        # Host-resident serving (index/staged.py): the layout lives in host
        # memory, each batch stages its probed cells in ``stage_dtype``.
        self.host_resident = False
        self.stage_dtype = torch.float32
        self._stage = None
        self._stage_lock = threading.Lock()
        self._last_stage_bytes = 0
        # Host-side record columns, in internal-id order.
        self.external_ids = np.zeros(0, np.uint64)
        self.timestamps = np.zeros(0, np.uint64)
        # Host mirror of the corpus in internal-id order (persistence reads
        # it instead of copying the table back from the device).
        self._host_data: Optional[np.ndarray] = None
        # Stream-table type of method 'stream' (bf16 halves the sweep's
        # bytes; an offloaded index serves int8).
        self.stream_dtype = torch.bfloat16
        # Every table derived from the layout, read through ``tables()``.
        self._tables: Optional[DeviceTables] = None
        # Larger-than-device mode (index/offload.py): f32 table freed, a
        # compact stream table serves; the shortlist re-rank mode.
        self.offloaded = False
        self._offload_rerank = "host"
        # Captured CUDA graphs of repeated search_batch shapes.
        self._graphs = SearchGraphs()

    # ------------------------------------------------------------------
    # Build
    # ------------------------------------------------------------------

    @classmethod
    def fit(
        cls,
        store: VectorStore,
        seed: int = 42,
        nlist: Optional[int] = None,
        max_iters: Optional[int] = None,
        refine_iters: int = 2,
        metric: str = "l2",
        trainer: str = "lloyd",
        mesh=None,
        mesh_axis: str = "shards",
        spill: int = 0,
        spill_lambda: float = 1.0,
        balance: float = 1.0,
        train_sample: Optional[int] = None,
        resident: str = "device",
        device: DeviceLike = None,
    ) -> "IvfIndex":
        """Train the coarse quantizer and pack the posting layout.

        ``trainer``: 'lloyd' (full batch, the default), 'mini_batch' (the
        original engine's algorithm, then ``refine_iters`` Lloyd passes) or
        'balanced' (occupancy-penalized Lloyd; ``balance`` scales the
        penalty). ``mesh`` (a ``parallel.Mesh``): train with the
        data-parallel Lloyd, the points split along ``mesh_axis`` (lloyd
        only); the index itself lives on ``device``. ``mesh`` with
        ``resident='host'``: the corpus stays in host memory, the mesh
        trains on the ``train_sample`` rows and assigns every row, a range
        of rows a device (``run_kmeans_lloyd_dp_host``), and the layout is
        packed in host memory, for ``parallel.ShardedSearcher`` to share
        out over the mesh."""
        if resident not in ("device", "host"):
            raise ValueError("resident must be 'device' or 'host'")
        if trainer not in ("lloyd", "mini_batch", "balanced"):
            raise ValueError(f"unknown trainer: {trainer}")
        if train_sample is not None and (
                trainer != "lloyd" or (mesh is not None and resident != "host")):
            raise ValueError(
                "train_sample is a full-batch Lloyd option (mini_batch is already "
                "subsampled; balanced and device-resident data-parallel sweeps need "
                "every point)"
            )
        if resident == "host" and (trainer != "lloyd" or spill):
            raise ValueError(
                "resident='host' fit supports trainer='lloyd' without spill (the "
                "low-device-memory build stages only a training sample and per-slice "
                "assignments)"
            )
        if mesh is not None and trainer != "lloyd":
            raise ValueError(
                "mesh-parallel fit supports trainer='lloyd' (the mini-batch step is "
                "batch-bound, not data-bound: data parallelism would split a <= 256-row batch)"
            )
        if spill not in (0, 1):
            raise ValueError("spill supports 0 or 1 secondary assignments")
        n = len(store)
        if n == 0:
            raise ValueError("no vectors provided")
        dev = resolve_device(device)
        with trace("fit", n=n, resident=resident):
            data = store.get_vectors()
            if metric == "cosine":
                # Cosine reduces to inner product over unit vectors; stored
                # payloads are the normalized vectors.
                norms = np.linalg.norm(data, axis=1, keepdims=True)
                data = (data / np.maximum(norms, 1e-12)).astype(np.float32)
            dim = data.shape[1]
            k = nlist if nlist is not None else calculate_num_clusters(n)
            k = max(1, min(k, n))
            iters = max_iters if max_iters is not None else calculate_max_iterations(n)
            log.info("ivf.fit: n=%d dim=%d nlist=%d max_iters=%d", n, dim, k, iters)

            spherical = metric == "cosine"
            data_dev = None
            with trace("fit.kmeans", n=n, k=k, mesh=mesh is not None):
                if mesh is not None and resident == "host":
                    from ..parallel.dp_kmeans import run_kmeans_lloyd_dp_host

                    kres = run_kmeans_lloyd_dp_host(
                        data, k, iters, train_sample or min(n, 2_000_000), mesh=mesh,
                        axis=mesh_axis, seed=seed, spherical=spherical,
                    )
                elif mesh is not None:
                    from ..parallel.dp_kmeans import run_kmeans_lloyd_dp

                    kres = run_kmeans_lloyd_dp(data, k, iters, mesh=mesh, axis=mesh_axis, seed=seed,
                                               spherical=spherical)
                    data_dev = torch.as_tensor(data, device=dev)  # for the spill pass and layout
                elif resident == "host":
                    # Only the training sample and one assignment slice at a
                    # time reach the device; the layout packs in host memory.
                    kres = run_kmeans_lloyd_host(
                        data, k, iters, train_sample or min(n, 2_000_000), seed=seed,
                        spherical=spherical, device=dev,
                    )
                else:
                    # One copy of the corpus on the device serves training, the
                    # spill assignment and the layout.
                    data_dev = torch.as_tensor(data, device=dev)
                    if trainer == "balanced":
                        kres = run_kmeans_balanced(data_dev, k, iters, balance=balance, seed=seed,
                                                   spherical=spherical)
                    elif trainer == "mini_batch":
                        kres = run_kmeans_mini_batch(data_dev, k, iters, seed=seed,
                                                     refine_iters=refine_iters, spherical=spherical)
                    elif train_sample is not None and train_sample < n:
                        kres = run_kmeans_lloyd_sampled(
                            data_dev, k, iters, train_sample, seed=seed, spherical=spherical
                        )
                    else:
                        kres = run_kmeans_lloyd(data_dev, k, iters, seed=seed, spherical=spherical)
            log.info("fit.kmeans: %d iterations, converged=%s", kres.iterations, kres.converged)
            centroids = kres.centroids.cpu().numpy()
            labels = kres.labels.cpu().numpy().astype(np.int64)

            # Spilled assignment: each vector also joins its SOAR-chosen second
            # cell (entries [primary labels, secondary labels], both of points
            # 0..n-1).
            entry_labels, point_ids = labels, None
            if spill:
                with trace("fit.spill", n=n):
                    labels2 = assign_spill_chunked(
                        data_dev, kres.centroids.to(dev), kres.labels.to(dev),
                        soar_lambda=spill_lambda,
                    ).cpu().numpy().astype(np.int64)
                entry_labels = np.concatenate([labels, labels2])
                point_ids = np.concatenate([np.arange(n, dtype=np.int64)] * 2)
            del kres

            # Super-centroid clustering over the (unfiltered) centroid table.
            num_shards = num_shards_for(k)
            super_seed = (seed * 31 + 7) % (2**63)
            if num_shards >= k:
                shard_labels_all = np.arange(k, dtype=np.int64) % num_shards
            else:
                with trace("fit.super_kmeans", sync=dev, k=k, shards=num_shards):
                    sres = run_kmeans_lloyd(
                        torch.as_tensor(centroids, device=dev), num_shards, 100,
                        seed=super_seed,
                    )
                shard_labels_all = sres.labels.cpu().numpy().astype(np.int64)

            # Filter empty posting lists; densify centroid ids (order-preserving).
            counts = np.bincount(entry_labels, minlength=k)
            keep = np.flatnonzero(counts > 0)
            log.info(
                "ivf.fit: filtered %d empty lists, %d remain, %d shards",
                k - len(keep), len(keep), num_shards,
            )
            old_to_new = np.full(k, -1, np.int64)
            old_to_new[keep] = np.arange(len(keep))

            idx = cls(dim, metric=metric, device=dev)
            idx.spill = int(spill)
            idx.centroids = centroids[keep]
            idx.centroids_to_shard = shard_labels_all[keep].astype(np.int32)
            idx.num_shards = num_shards
            idx.external_ids = store.external_ids
            idx.timestamps = store.timestamps
            idx._host_data = data
            # Clusters of one shard are laid out contiguously, so shard files
            # (and later sharded search) slice contiguous row ranges.
            cluster_order = np.argsort(idx.centroids_to_shard, kind="stable")
            with trace("fit.layout", sync=dev, n=n, clusters=len(keep)):
                idx.layout = build_layout(
                    data if resident == "host" else data_dev, old_to_new[entry_labels],
                    len(keep), cluster_order, point_ids=point_ids,
                )
            idx.host_resident = resident == "host"
            return idx

    # ------------------------------------------------------------------
    # Search
    # ------------------------------------------------------------------

    @property
    def num_clusters(self) -> int:
        return self.centroids.shape[0]

    def tables(self) -> DeviceTables:
        """The owner of the tables derived from the layout: a new one once
        the layout, the centroids or the id column is a new object."""
        t = self._tables
        if (t is None or t.layout is not self.layout or t.centroids is not self.centroids
                or t.external_ids is not self.external_ids):
            t = self._tables = DeviceTables(self.layout, self.centroids, self.external_ids,
                                            self.device)
        return t

    def _set_tables(self, tables: Optional[DeviceTables]) -> None:
        """Install ``tables`` (None: anew on next use); the graphs go."""
        self._graphs.clear()
        self._tables = tables

    def offload_main_table(self, stream_dtype=None, rerank: str = "host") -> None:
        """Larger-than-device serving: free the f32 main table and serve
        from a compact (int8 by default) stream table; ``rerank`` is 'host',
        'device' or 'none' (index/offload.py::offload_main_table)."""
        self._graphs.clear()  # their memory, before the compact table is built
        _offload.offload_main_table(self, stream_dtype, rerank)

    def offload_from_host(self, stream_dtype=None, rerank: str = "host") -> None:
        """Offload entry for host layouts (a host fit, ``load_index_from(...,
        resident='offload')``): the rows pass through the device a staging
        buffer at a time and only the compact tables stay there
        (index/offload.py::offload_from_host)."""
        _offload.offload_from_host(self, stream_dtype, rerank)

    def to_host_resident(self, stage_dtype=None) -> None:
        """Serve from host memory: move the posting layout to the host, free
        its device copies, and stage only each batch's probed cells
        (index/staged.py), so the corpus is bounded by host RAM, not device
        memory. ``stage_dtype`` (torch.float32 by default, or bfloat16 /
        int8) is the staging precision; bf16 and int8 halve / quarter the
        per-batch copy and re-rank a widened shortlist exactly on the host.
        ``load_index_from(..., resident='host')`` never puts the table on
        the device at all."""
        if self.layout is None:
            raise RuntimeError("index is empty: fit or load it first")
        if self.offloaded:
            raise RuntimeError("index is offloaded (main table freed); reload it before "
                               "switching to host-resident serving")
        lay = self.layout
        if isinstance(lay.vectors, torch.Tensor):
            lay.vectors = lay.vectors.cpu().numpy()
            lay.row_norms = lay.row_norms.cpu().numpy()
        self._set_tables(None)  # every device table derived from the layout goes
        if stage_dtype is not None:
            self.stage_dtype = stage_dtype
        self.host_resident = True
        log.info("host-resident mode: %d rows in host memory, the device holds the "
                 "centroids only", lay.table_shape[0])

    def choose_method(self, nq: int, n_probe: int) -> str:
        """Resolve 'auto' for this (nq, n_probe): the dense-vs-stream byte
        model (index/dispatch.py::choose_sweep_body), upgraded to the shared
        stream (K5) at huge probed footprints. An offloaded index serves the
        stream kernels only; there the shared upgrade applies only under a
        re-ranked mode ('host' or 'device'), where the re-ranked >= 128-wide
        shortlist makes the two kernels result-equivalent, while the
        rank-only mode returns the raw plane, where the shared selection is
        measurably lossier (the reference's measurement)."""
        if getattr(self, "host_resident", False):
            return "staged"
        lengths = np.asarray(self.layout.lengths)
        n_probe = min(n_probe, self.num_clusters)
        itemsize = stream_itemsize(self.stream_dtype)
        chunk = pick_chunk(lengths, self.dimension, itemsize)
        if self.offloaded:
            if self._offload_rerank in ("host", "device") and shared_gate(
                nq, n_probe, mean_slot_rows_of(lengths, chunk)
            ):
                return "stream_shared"
            return "stream"
        return choose_sweep_body(
            lengths, self.layout.table_shape[0], self.dimension,
            itemsize, nq, n_probe, chunk, allow_shared=True,
        )

    def _queries_on_device(self, queries) -> torch.Tensor:
        if isinstance(queries, torch.Tensor):
            q = queries.to(device=self.device, dtype=torch.float32)
        else:  # a copy: the caller's array may be read-only
            q = torch.tensor(np.asarray(queries, np.float32), device=self.device)
        if q.ndim == 1:
            q = q[None, :]
        if q.shape[1] != self.dimension:
            raise ValueError(
                f"query dimension mismatch: expected {self.dimension}, got {q.shape[1]}"
            )
        if self.metric == "cosine":
            q = q / q.norm(dim=1, keepdim=True).clamp_min(1e-12)
        return q.contiguous()

    def search_batch_device(self, queries, k: int, n_probe: int, method: str = "auto"):
        """Device-side search: (D (nq, k) f32, layout rows (nq, k) int64)
        tensors on the index's device, padded +inf / -1. On a spilled index
        a vector can surface from 1+spill probed cells: the program runs
        (1+spill)k wide and duplicate ids are dropped on the device."""
        if self.layout is None or self.num_clusters == 0:
            raise RuntimeError("index is empty: fit or load it first")
        if k <= 0:
            raise ValueError("k must be > 0")
        if n_probe <= 0:
            raise ValueError("n_probe must be > 0")
        if self.host_resident:
            raise RuntimeError("host-resident index has no device-resident layout; use "
                               "search_batch (method='staged')")
        if not self.spill:
            return self._search_rows(queries, k, n_probe, method)
        dv, rows = self._search_rows(queries, (1 + self.spill) * k, n_probe, method)
        with trace("search.select", level=DEBUG):
            return _offload.dedup_topk(dv, rows, self.tables().row_internal, k)

    def _search_rows(self, queries, k: int, n_probe: int, method: str = "auto"):
        """``search_batch_device`` without the spill dedup: the program's
        own (D, layout rows) at width k (a spilled index's rows may repeat
        an id)."""
        with trace("search.upload", level=DEBUG):
            q = self._queries_on_device(queries)
        with trace("search.dispatch", level=DEBUG):
            program = self._bind(q, k, n_probe, method)
        with trace("search.program", level=DEBUG):
            return program()

    def _bind(self, q, k: int, n_probe: int, method: str):
        """The program ``resolve`` picks for the device queries ``q``, bound
        to its device tables (built here on first use) and sizes: a call
        with no arguments that enqueues it."""
        nq = q.shape[0]  # after the reshape: one (d,) query is nq = 1
        n_probe = min(n_probe, self.num_clusters)
        # 'auto' on an offloaded index resolves to a stream kernel.
        if self.offloaded and method not in ("auto", "stream", "stream_shared"):
            raise RuntimeError(
                "offloaded index serves the stream kernels only (the f32 main "
                "table was freed; the dense and exact paths need it: reload the "
                "index to restore them)"
            )
        metric = self.metric if self.metric != "cosine" else "ip"
        lay, tables = self.layout, self.tables()
        dec = resolve(self, nq, n_probe, k=k, method=method)
        if dec.program in ("stream", "stream_shared"):
            centroids, c_sq = tables.coarse
            st = tables.stream(torch.float32 if dec.exact else self.stream_dtype)
            t_fixed, q_tile, t_cap = dec.t_fixed, dec.q_tile, dec.t_cap
            if st.chunk != dec.chunk:
                # The Decision sizes against the chunk pick_chunk gives; a
                # table built with another chunk is re-sized to its own
                # blocks (reference ivf.py:1321-1330).
                _, t_fixed, q_tile, t_cap = stream_params(
                    np.asarray(lay.lengths), self.dimension, st.vecs.element_size(), nq,
                    n_probe, exact=dec.exact, shared=dec.program == "stream_shared",
                    chunk=st.chunk,
                )
            # int8 on a device-resident index: exact f32 re-rank of the
            # shortlist (an offloaded index re-ranks in index/offload.py).
            rerank = st.dtype == torch.int8 and not self.offloaded
            return partial(
                programs.stream_program, q, centroids, c_sq, st, k=k, n_probe=n_probe,
                t_fixed=t_fixed, q_tile=q_tile, metric=metric, approx=not dec.exact,
                shared=dec.program == "stream_shared", t_cap=t_cap,
                rerank_from=(lay.vectors, lay.row_norms) if rerank else None,
            )
        if dec.program in ("gather", "gather_dma"):
            centroids, c_sq = tables.coarse
            starts, lengths = tables.lists
            if dec.program == "gather":
                return partial(
                    programs.gather_program, q, centroids, c_sq, lay.vectors, lay.row_norms,
                    starts, lengths, k=k, n_probe=n_probe, budget=dec.budget,
                    q_tile=dec.q_tile, metric=metric,
                )
            return partial(
                programs.gather_dma_program, q, centroids, c_sq, lay.vectors, starts, lengths,
                k=k, n_probe=n_probe, max_len=lay.max_list_len, budget=dec.budget,
                q_tile=dec.q_tile, metric=metric,
            )
        if dec.program == "flat_torch":
            return partial(programs.flat_program, q, lay.vectors, lay.row_norms, k=k,
                           q_tile=dec.q_tile, metric=metric)
        # The fused sweeps read the f32 table, or its int8 twin.
        table, resid, scales = lay.vectors, None, None
        if dec.precision != "highest":
            table, resid, scales = tables.sweep_int8
            resid = resid if dec.precision == "int8" else None
        if dec.program == "flat_fused":
            w, _, c_groups = dec.plan
            return partial(
                programs.flat_fused_program, q, table, lay.row_norms, resid, scales, k=k, w=w,
                c_groups=c_groups, metric=metric, precision=dec.precision,
            )
        block_run, c_ord, c_sq_ord = tables.runs
        if dec.program == "dense_fused":
            w, _, c_groups = dec.plan
            return partial(
                programs.dense_fused_program, q, c_ord, c_sq_ord, table, lay.row_norms,
                block_run, n_probe, resid, scales, k=k, w=w, c_groups=c_groups, metric=metric,
                precision=dec.precision,
            )
        return partial(
            programs.dense_program, q, c_ord, c_sq_ord, lay.vectors, lay.row_norms, block_run,
            n_probe, k=k, q_tile=dec.q_tile, metric=metric,
        )

    def _graphable(self) -> bool:
        """Whether ``search_batch`` may answer through a captured graph: a
        device-resident, unspilled, not offloaded layout."""
        lay = self.layout
        return (not self.host_resident and not self.offloaded and not self.spill
                and lay is not None and isinstance(lay.vectors, torch.Tensor)
                and self.num_clusters > 0)

    def _search_ids_device(self, queries, k: int, n_probe: int, method: str,
                           external: bool):
        """``search_batch_device`` with its rows mapped to internal ids, or
        external ones with ``external``: one gather on the device, enqueued
        behind the program, so the host maps nothing after the copy back."""
        dv, rv = self.search_batch_device(queries, k, n_probe, method)
        with trace("search.id_map", level=DEBUG):
            tables = self.tables()
            return dv, (tables.row_external if external else tables.row_internal)[rv]

    def _search_host(self, queries, k: int, n_probe: int, method: str, external: bool):
        """``search_batch``'s eager path on a device-resident index: (D, ids)
        copied back to the host."""
        dv, iv = self._search_ids_device(queries, k, n_probe, method, external)
        with trace("search.to_host", level=DEBUG):
            return dv.cpu().numpy(), iv.cpu().numpy()

    def rows_to_internal(self, rows: np.ndarray) -> np.ndarray:
        """Layout rows -> internal ids (-1 stays -1)."""
        return self.tables().padded_perm[np.where(rows >= 0, rows, -1)]

    def internal_to_external(self, internal: np.ndarray) -> np.ndarray:
        """Internal ids -> external ids as int64 (-1 stays -1)."""
        ext = self.external_ids[np.clip(internal, 0, None)].astype(np.int64)
        return np.where(internal >= 0, ext, -1)

    def search_batch(self, queries, k: int, n_probe: int, method: str = "auto",
                     external: bool = False) -> Tuple[np.ndarray, np.ndarray]:
        """Batched search: (nq, d) -> (D (nq, k) f32, internal ids (nq, k)
        int64, or external ids with ``external``), missing slots padded
        +inf / -1. An offloaded index re-ranks its shortlist as its mode
        says (index/offload.py); a host-resident one stages its probed
        cells (index/staged.py). A device-resident index on a card answers a
        call shape it has answered before by replaying one captured CUDA
        graph of the whole call (index/graphs.py)."""
        if self.host_resident:
            if method not in ("auto", "staged"):
                raise RuntimeError(
                    "host-resident index serves method='staged' only (the posting layout "
                    "lives in host memory; reload with resident='device' for the others)"
                )
            if k <= 0:
                raise ValueError("k must be > 0")
            if n_probe <= 0:
                raise ValueError("n_probe must be > 0")
            dvals, ids = staged_search(self, queries, k, n_probe)
        elif self.offloaded and self._offload_rerank in ("host", "device"):
            if k <= 0:
                raise ValueError("k must be > 0")
            if n_probe <= 0:
                raise ValueError("n_probe must be > 0")
            search = (_offload.search_offloaded if self._offload_rerank == "host"
                      else _offload.search_offloaded_device)
            dvals, ids = search(self, queries, k, n_probe, method)
        else:
            return self._graphs.search(
                self, queries, k, n_probe, method, external,
                partial(self._search_host, queries, k, n_probe, method, external),
            )
        # The staged and re-ranked paths give internal ids on the host.
        with trace("search.id_map", level=DEBUG), trace("search.id_map.host", level=DEBUG):
            return dvals, self.internal_to_external(ids) if external else ids

    def search(self, query, k: int, n_probe: int) -> list:
        """Single query: list of (external_id, distance, vector), ascending,
        real hits only."""
        dvals, internal = self.search_batch(np.asarray(query)[None, :], k, n_probe)
        out = []
        for dist, iid in zip(dvals[0], internal[0]):
            if iid < 0 or not np.isfinite(dist):
                continue
            row = int(iid)
            out.append((int(self.external_ids[row]), float(dist), self._vector_of(row)))
        return out

    def _vector_of(self, internal_id: int) -> np.ndarray:
        lay = self.layout
        if lay.vectors is None:  # offloaded: the rows live in the host mirror
            if self._host_data is None:
                raise RuntimeError("result vectors unavailable: main table offloaded "
                                   "and no host mirror present")
            return np.asarray(self._host_data[internal_id], np.float32)
        row = self.tables().perm_inv[internal_id]
        if row < 0:
            raise KeyError(f"internal id {internal_id} not present in layout")
        if isinstance(lay.vectors, np.ndarray):  # host-resident
            return np.array(lay.vectors[int(row)])
        return lay.vectors[int(row)].cpu().numpy()

    # ------------------------------------------------------------------
    # Persistence (delegates to storage.persist)
    # ------------------------------------------------------------------

    def save_to(self, index_dir, shards_dir=None) -> None:
        from ..storage import persist

        persist.save_index(self, index_dir, shards_dir)

    def save_shards_to(self, shards_dir) -> None:
        from ..storage import persist

        persist.save_shards(self, shards_dir)


def load_index_from(index_dir, shards_dir=None, resident: str = "device",
                    device: DeviceLike = None, offload_rerank: str = "host") -> IvfIndex:
    """Load index metadata (+ the posting layout from shard files when
    ``shards_dir`` is given) onto ``device``. ``resident='offload'`` builds
    an int8 stream table on the device from staged host rows and keeps only
    it (the f32 table never stays on the device); ``offload_rerank`` is then 'host', 'device'
    or 'none' (index/offload.py). ``resident='host'`` keeps the layout in
    host memory and serves by per-batch staging (index/staged.py)."""
    from ..storage import persist

    return persist.load_index(index_dir, shards_dir, device=device, resident=resident,
                              offload_rerank=offload_rerank)
