"""Data-parallel Lloyd k-means over a device mesh.

Port of ``vector_indexer_tpu/parallel/dp_kmeans.py``. The points are split
over the devices of one mesh axis in equal slices (n padded to a multiple
of 8 * n_dev, as the reference pads it); the centroids are replicated.
Each iteration every device computes its slice's partial (sums, counts)
with the single-device sweep (``models.kmeans.lloyd_stats``), the partials
are summed on the first device (the reference's ``psum``), and the updated
centroids are copied back to every device. The empty-cell repair draws
GLOBAL row ids from one generator and takes each row from the slice that
owns it: a repair drawn from each device's own slice would make the
replicated centroids diverge. The k-means++ init gathers its sample rows
the same way, so it equals the single-device init of the same corpus on
the first device. The final assignment is exact, per slice.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..models.kmeans import (
    _ASSIGN_CHUNK,
    KMeansResult,
    _assign_dense,
    _rms_delta,
    _to_sphere,
    init_from_rows,
    lloyd_stats,
    make_generator,
    mean_update,
)
from .mesh import Mesh
from .sharded import axis_devices, on_device


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


class _Slices:
    """Equal slices of a corpus, one per device; ``rows(idx)`` gathers any
    global rows onto the first device (each slice contributes the rows it
    owns, the others zeros: a sum, as the reference's psum)."""

    def __init__(self, data: np.ndarray, devices: list):
        n = data.shape[0]
        self.n = n
        self.devices = devices
        self.local_n = _round_up(n, len(devices) * 8) // len(devices)
        self.parts = [torch.as_tensor(data[j * self.local_n : (j + 1) * self.local_n],
                                      device=dev) for j, dev in enumerate(devices)]

    def rows(self, idx: Optional[torch.Tensor]) -> torch.Tensor:
        root = self.devices[0]
        if idx is None:
            idx = torch.arange(self.n, device=root)
        out = None
        for j, (dev, part) in enumerate(zip(self.devices, self.parts)):
            if part.shape[0] == 0:
                continue
            with on_device(dev):
                ij = idx.to(dev)
                own = (ij // self.local_n) == j
                loc = (ij % self.local_n).clamp_max(part.shape[0] - 1)
                got = (part[loc] * own[:, None].to(part.dtype)).to(root, non_blocking=True)
            out = got if out is None else out + got
        return out


def run_kmeans_lloyd_dp(data, k: int, max_iters: int, mesh: Mesh, axis: str = "shards",
                        early_stop_threshold: float = 1e-4, seed: int = 42,
                        spherical: bool = False, chunk: int = _ASSIGN_CHUNK) -> KMeansResult:
    """Data-parallel full-batch Lloyd over the devices of ``mesh`` along
    ``axis``. ``data``: (n, d) host array (or tensor). The result's
    centroids and labels are on the axis's first device; ``converged`` is
    whether it stopped before ``max_iters``, as in the reference."""
    if isinstance(data, torch.Tensor):
        data = data.detach().cpu().numpy()
    data = np.ascontiguousarray(data, np.float32)
    if data.ndim != 2 or data.shape[0] == 0 or data.shape[1] == 0:
        raise ValueError("Input vectors cannot be empty")
    devices = axis_devices(mesh, axis)
    root = devices[0]
    sl = _Slices(data, devices)
    chunk = min(chunk, max(8, sl.local_n))
    centroids = init_from_rows(sl.rows, sl.n, k, seed, root)
    gen = make_generator(root, seed ^ 0xD9)
    it = 0
    while it < max_iters:
        partial = []
        for dev, part in zip(devices, sl.parts):
            with on_device(dev):
                partial.append(lloyd_stats(part, centroids.to(dev), k, chunk))
        sums = sum(s.to(root) for s, _ in partial)
        counts = sum(c.to(root) for _, c in partial)
        new_c = mean_update(sums, counts, centroids)
        ridx = torch.randint(0, sl.n, (k,), generator=gen, device=root)
        new_c = torch.where((counts == 0)[:, None], sl.rows(ridx), new_c)
        if spherical:
            new_c = _to_sphere(new_c)
        delta = float(_rms_delta(new_c, centroids))
        centroids = new_c
        it += 1
        if delta < early_stop_threshold:
            break
    labels = []
    for dev, part in zip(devices, sl.parts):
        if part.shape[0] == 0:
            continue
        with on_device(dev):
            labels.append(_assign_dense(part, centroids.to(dev), chunk)[0].to(root))
    return KMeansResult(centroids, torch.cat(labels), it, it < max_iters)
