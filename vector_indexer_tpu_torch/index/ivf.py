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
  stays in host memory;
* ``search_batch``: ``index/dispatch.py::resolve`` picks the program
  (stream, fused or plain dense, fused or plain flat, the int8 sweeps,
  the packed gather or the K6 range gather), ``index/programs.py`` runs
  it, and layout rows map to internal or external ids on the device, by
  one gather through a cached row table, before the copy back;
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
from ..ops.block_stream import build_stream_table, pick_chunk
from ..ops.distance import assign_spill_chunked, sq_norms
from ..ops.flat_sweep import quantize_table_int8
from ..ops.gather import candidate_budget
from ..storage.layout import ALIGN, PostingLayout, build_layout
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
from .staged import staged_search

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
        self._dev = None
        # Stream-table type of method 'stream' (bf16 halves the sweep's
        # bytes; an offloaded index serves int8) and the tables built so
        # far, by type (the exact methods build an f32 one).
        self.stream_dtype = torch.bfloat16
        self._stream_tables: dict = {}
        self._runs = None
        self._perm_inv = None
        self._perm_dev = None
        self._ext_dev = None
        # Per-layout caches: the int8 sweep tables, the device list
        # starts/lengths and the gather budgets, each (layout, value).
        self._sweep_q = None
        self._lists = None
        self._budgets = None
        # Larger-than-device mode (index/offload.py): f32 table freed, a
        # compact stream table serves; the shortlist re-rank mode, the
        # freed table's row count, the correction table ('device') and the
        # host mirror's norms ('host').
        self.offloaded = False
        self._offload_rerank = "host"
        self._n_pad = 0
        self._corr_table = None
        self._host_norms = None

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
        only); the index itself lives on ``device``."""
        if resident not in ("device", "host"):
            raise ValueError("resident must be 'device' or 'host'")
        if trainer not in ("lloyd", "mini_batch", "balanced"):
            raise ValueError(f"unknown trainer: {trainer}")
        if train_sample is not None and (trainer != "lloyd" or mesh is not None):
            raise ValueError(
                "train_sample is a full-batch Lloyd option (mini_batch is already "
                "subsampled; balanced and data-parallel sweeps need every point)"
            )
        if resident == "host" and (trainer != "lloyd" or mesh is not None or spill):
            raise ValueError(
                "resident='host' fit supports trainer='lloyd' without mesh or spill (the "
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
                if mesh is not None:
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

    def _device_tables(self):
        if self._dev is None:
            c = torch.as_tensor(self.centroids, dtype=torch.float32, device=self.device)
            self._dev = (c, sq_norms(c))
        return self._dev

    def _stream_table(self, dtype: Optional[torch.dtype] = None):
        """Stream table of ``dtype`` (default: ``stream_dtype``), built on
        first use (a one-time device re-pack of the posting table)."""
        dtype = self.stream_dtype if dtype is None else dtype
        if dtype not in self._stream_tables:
            with trace("stream_table.build", sync=self.device, dtype=str(dtype)):
                self._stream_tables[dtype] = build_stream_table(
                    self.layout, self.centroids, dtype
                )
        return self._stream_tables[dtype]

    def offload_main_table(self, stream_dtype=None, rerank: str = "host") -> None:
        """Larger-than-device serving: free the f32 main table and serve
        from a compact (int8 by default) stream table; ``rerank`` is 'host',
        'device' or 'none' (index/offload.py::offload_main_table)."""
        _offload.offload_main_table(self, stream_dtype, rerank)

    def offload_from_host(self, stream_dtype=None, rerank: str = "host") -> None:
        """Offload entry for host-staged layouts (``load_index_from(...,
        resident='offload')``): the tables are built on the host and only
        they are uploaded (index/offload.py::offload_from_host)."""
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
        # Every device table derived from the layout goes.
        self._stream_tables = {}
        self._runs = self._sweep_q = self._lists = self._budgets = None
        self._perm_dev = self._ext_dev = self._perm_inv = None
        if stage_dtype is not None:
            self.stage_dtype = stage_dtype
        self.host_resident = True
        log.info("host-resident mode: %d rows in host memory, the device holds the "
                 "centroids only", lay.vectors.shape[0])

    def _padded_perm(self) -> np.ndarray:
        """Layout row -> internal id over the table's rows, -1 on gap and
        tail rows, and one trailing -1: a -1 row (no result) indexes it
        directly, since torch and numpy wrap negative indices."""
        lay = self.layout
        n_pad = lay.vectors.shape[0] if lay.vectors is not None else self._n_pad
        pd = np.full(n_pad + 1, -1, np.int64)
        pd[: lay.rows_used] = lay.perm
        return pd

    def _perm_dev_table(self):
        """Device map layout row -> internal id (``_padded_perm``), cached
        per layout object."""
        lay = self.layout
        if self._perm_dev is None or self._perm_dev[0] is not lay:
            self._perm_dev = (lay, torch.as_tensor(self._padded_perm(), device=self.device))
        return self._perm_dev[1]

    def _ext_dev_table(self):
        """Device map layout row -> external id as int64 (ids at or above
        2**63 wrap, as ``internal_to_external``'s cast does), -1 where
        ``_padded_perm`` holds -1; cached per layout and id column, both of
        which fit and load replace. ~8 MB per 1M rows."""
        lay, ext = self.layout, self.external_ids
        cached = self._ext_dev
        if cached is None or cached[0] is not lay or cached[1] is not ext:
            ext_s = np.append(ext.astype(np.int64), -1)  # -1 indexes the trailing -1
            table = torch.as_tensor(ext_s[self._padded_perm()], device=self.device)
            self._ext_dev = cached = (lay, ext, table)
        return cached[2]

    def _run_tables(self):
        """(block_run, centroids_ord, c_sq_ord): posting runs in layout order
        with the centroid table reordered to match, and for every 8-row
        block the index of the last run that starts at or before it."""
        if self._runs is None:
            starts = self.layout.offsets[:-1].astype(np.int64)
            order = np.argsort(starts, kind="stable")
            run_start_b = starts[order] // ALIGN
            nb = self.layout.vectors.shape[0] // ALIGN
            block_run = np.searchsorted(run_start_b, np.arange(nb), side="right") - 1
            c_ord = torch.as_tensor(
                self.centroids[order], dtype=torch.float32, device=self.device
            )
            self._runs = (
                torch.as_tensor(block_run, device=self.device),
                c_ord,
                sq_norms(c_ord),
            )
        return self._runs

    def _sweep_int8_tables(self):
        """(x8, r8, sx): the fixed-point int8 twin of the layout table for
        the int8 sweeps ('flat_int8', 'dense_int8' and their x1 variants),
        quantized on the device once per layout (~2 n d bytes beside the
        f32 table)."""
        lay = self.layout
        if self._sweep_q is None or self._sweep_q[0] is not lay:
            with trace("sweep_int8_tables.build", sync=self.device):
                self._sweep_q = (lay, quantize_table_int8(lay.vectors))
        return self._sweep_q[1]

    def _list_tables(self):
        """(starts, lengths) of the posting lists as device int64 tensors,
        cached per layout."""
        lay = self.layout
        if self._lists is None or self._lists[0] is not lay:
            self._lists = (lay, (
                torch.as_tensor(lay.offsets[:-1].astype(np.int64), device=self.device),
                torch.as_tensor(lay.lengths.astype(np.int64), device=self.device),
            ))
        return self._lists[1]

    def _budget_for(self, n_probe: int) -> int:
        """Packed-gather budget for n_probe: the sum of the n_probe longest
        lists (never truncates), on the reference's shape grid; cached per
        layout."""
        lay = self.layout
        if self._budgets is None or self._budgets[0] is not lay:
            self._budgets = (lay, {})
        cache = self._budgets[1]
        if n_probe not in cache:
            cache[n_probe] = candidate_budget(np.asarray(lay.lengths), n_probe)
        return cache[n_probe]

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
            lengths, self.layout.vectors.shape[0], self.dimension,
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
            return _offload.dedup_topk(dv, rows, self._perm_dev_table(), k)

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
        if self.offloaded:
            if method == "auto":
                method = self.choose_method(nq, n_probe)
            if method not in ("stream", "stream_shared"):
                raise RuntimeError(
                    "offloaded index serves the stream kernels only (the f32 main "
                    "table was freed; the dense and exact paths need it: reload the "
                    "index to restore them)"
                )
        metric = self.metric if self.metric != "cosine" else "ip"
        lay = self.layout
        dec = resolve(self, nq, n_probe, k=k, method=method)
        if dec.program in ("stream", "stream_shared"):
            centroids, c_sq = self._device_tables()
            st = self._stream_table(torch.float32 if dec.exact else self.stream_dtype)
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
            centroids, c_sq = self._device_tables()
            starts, lengths = self._list_tables()
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
            table, resid, scales = self._sweep_int8_tables()
            resid = resid if dec.precision == "int8" else None
        if dec.program == "flat_fused":
            w, _, c_groups = dec.plan
            return partial(
                programs.flat_fused_program, q, table, lay.row_norms, resid, scales, k=k, w=w,
                c_groups=c_groups, metric=metric, precision=dec.precision,
            )
        block_run, c_ord, c_sq_ord = self._run_tables()
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

    def rows_to_internal(self, rows: np.ndarray) -> np.ndarray:
        """Layout rows -> internal ids (-1 stays -1)."""
        lay = self.layout
        bound = max(lay.rows_used - 1, 0)
        return np.where(rows >= 0, lay.perm[np.clip(rows, 0, bound)], -1).astype(np.int64)

    def internal_to_external(self, internal: np.ndarray) -> np.ndarray:
        """Internal ids -> external ids as int64 (-1 stays -1)."""
        return np.where(
            internal >= 0,
            self.external_ids[np.clip(internal, 0, None)].astype(np.int64),
            -1,
        )

    def search_batch(self, queries, k: int, n_probe: int, method: str = "auto",
                     external: bool = False) -> Tuple[np.ndarray, np.ndarray]:
        """Batched search: (nq, d) -> (D (nq, k) f32, internal ids (nq, k)
        int64, or external ids with ``external``), missing slots padded
        +inf / -1. An offloaded index re-ranks its shortlist as its mode
        says (index/offload.py); a host-resident one stages its probed
        cells (index/staged.py)."""
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
            dv, rv = self.search_batch_device(queries, k, n_probe, method)
            # One gather on the device, enqueued behind the program: the
            # host maps nothing after the copy back.
            with trace("search.id_map", level=DEBUG):
                iv = (self._ext_dev_table() if external else self._perm_dev_table())[rv]
            with trace("search.to_host", level=DEBUG):
                return dv.cpu().numpy(), iv.cpu().numpy()
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
        if self._perm_inv is None or self._perm_inv[0] is not lay:
            size = int(lay.perm.max()) + 1 if lay.n else 0
            inv = np.full(size, -1, np.int64)
            real = lay.perm >= 0
            inv[lay.perm[real]] = np.flatnonzero(real)
            self._perm_inv = (lay, inv)
        row = self._perm_inv[1][internal_id]
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
    an int8 stream table on the host and uploads only it (the f32 table
    never reaches the device); ``offload_rerank`` is then 'host', 'device'
    or 'none' (index/offload.py). ``resident='host'`` keeps the layout in
    host memory and serves by per-batch staging (index/staged.py)."""
    from ..storage import persist

    return persist.load_index(index_dir, shards_dir, device=device, resident=resident,
                              offload_rerank=offload_rerank)
