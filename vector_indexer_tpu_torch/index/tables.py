"""Every table an ``IvfIndex`` derives from its layout, in one owner.

Each table is built on first use and kept for the owner's life; the owner
never checks its sources, since the index replaces it whole
(``IvfIndex.tables()``). So a captured search graph (index/graphs.py) is
valid while its index holds the same owner, whatever tables join it later.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..ops.block_stream import build_stream_table
from ..ops.distance import sq_norms
from ..ops.flat_sweep import quantize_table_int8
from ..ops.gather import candidate_budget
from ..storage.layout import ALIGN
from ..utils.tracing import trace


class _once:
    """A table built on its first read and then held. Threads that race to
    build it all get the first build, so no graph reads a replaced copy."""

    def __init__(self, build):
        self.build, self.name, self.__doc__ = build, build.__name__, build.__doc__

    def __get__(self, owner, cls=None):
        return self if owner is None else owner.__dict__.setdefault(self.name, self.build(owner))


class DeviceTables:
    """The tables derived from one (layout, centroids, external_ids) on
    ``device``. ``rows`` is the table's padded row count, which an
    offloaded index keeps after freeing the table; ``streams``, ``corr``
    and ``host_norms`` take what offload built before it freed it."""

    def __init__(self, layout, centroids: np.ndarray, external_ids: np.ndarray,
                 device: torch.device, *, rows: Optional[int] = None,
                 streams: Optional[dict] = None, corr=None,
                 host_norms: Optional[np.ndarray] = None):
        self.layout = layout
        self.centroids = centroids
        self.external_ids = external_ids
        self.device = device
        self.rows = layout.table_shape[0] if rows is None else rows
        # Stream tables by type (bf16 serves 'stream', f32 the exact methods)
        self.streams = dict(streams or {})
        self.corr = corr  # the correction table of an offloaded rerank='device' index
        # |x|^2 (f32) of every internal id, for an offloaded rerank='host' index
        self.host_norms = host_norms
        self.gather_budgets: dict = {}  # n_probe -> budget

    @_once
    def coarse(self):
        """(centroids, c_sq) on the device."""
        c = torch.as_tensor(self.centroids, dtype=torch.float32, device=self.device)
        return c, sq_norms(c)

    def stream(self, dtype: torch.dtype):
        """Stream table of ``dtype`` (a one-time device re-pack of the layout)."""
        st = self.streams.get(dtype)
        if st is None:
            with trace("stream_table.build", sync=self.device, dtype=str(dtype)):
                st = self.streams.setdefault(
                    dtype, build_stream_table(self.layout, self.centroids, dtype))
        return st

    @_once
    def runs(self):
        """(block_run, centroids_ord, c_sq_ord): posting runs in layout order
        with the centroid table reordered to match, and for every 8-row
        block the index of the last run that starts at or before it."""
        starts = self.layout.offsets[:-1].astype(np.int64)
        order = np.argsort(starts, kind="stable")
        run_start_b = starts[order] // ALIGN
        nb = self.rows // ALIGN
        block_run = np.searchsorted(run_start_b, np.arange(nb), side="right") - 1
        c_ord = torch.as_tensor(self.centroids[order], dtype=torch.float32, device=self.device)
        return torch.as_tensor(block_run, device=self.device), c_ord, sq_norms(c_ord)

    @_once
    def sweep_int8(self):
        """(x8, r8, sx): the fixed-point int8 twin of the layout table for the
        int8 sweeps, quantized on the device (~2 n d bytes beside the f32 table)."""
        with trace("sweep_int8_tables.build", sync=self.device):
            return quantize_table_int8(self.layout.vectors)

    @_once
    def lists(self):
        """(starts, lengths) of the posting lists as device int64 tensors."""
        lay = self.layout
        return (torch.as_tensor(lay.offsets[:-1].astype(np.int64), device=self.device),
                torch.as_tensor(lay.lengths.astype(np.int64), device=self.device))

    def budget(self, n_probe: int) -> int:
        """Packed-gather budget for n_probe: the sum of the n_probe longest
        lists (never truncates), on the reference's shape grid."""
        b = self.gather_budgets
        if n_probe not in b:
            b[n_probe] = candidate_budget(np.asarray(self.layout.lengths), n_probe)
        return b[n_probe]

    @_once
    def padded_perm(self) -> np.ndarray:
        """Layout row -> internal id over the table's rows, -1 on gap and
        tail rows, and one trailing -1: a -1 row (no result) indexes it
        directly, since torch and numpy wrap negative indices."""
        pd = np.full(self.rows + 1, -1, np.int64)
        pd[: self.layout.rows_used] = self.layout.perm
        return pd

    @_once
    def row_internal(self) -> torch.Tensor:
        """Device map layout row -> internal id (``padded_perm``)."""
        return torch.as_tensor(self.padded_perm, device=self.device)

    @_once
    def row_external(self) -> torch.Tensor:
        """Device map layout row -> external id as int64 (ids past 2**63 wrap,
        as ``IvfIndex.internal_to_external``'s cast does), -1 where
        ``padded_perm`` holds -1. ~8 MB per 1M rows."""
        ext = np.append(self.external_ids.astype(np.int64), -1)  # -1 indexes the trailing -1
        return torch.as_tensor(ext[self.padded_perm], device=self.device)

    @_once
    def perm_inv(self) -> np.ndarray:
        """Internal id -> layout row, -1 where the id has no row."""
        pd = self.padded_perm
        inv = np.full(int(pd.max()) + 1, -1, np.int64)
        real = np.flatnonzero(pd >= 0)
        inv[pd[real]] = real
        return inv
