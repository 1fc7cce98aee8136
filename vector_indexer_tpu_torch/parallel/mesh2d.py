"""2-D mesh search: query-parallel x shard-parallel.

Port of ``vector_indexer_tpu/parallel/mesh2d.py``. The posting slices
split over the ``shards`` axis and the query batch over the ``queries``
axis: device (q, s) searches query slice q against posting slice s (slice
s is held by every device of its column), and each query slice merges over
the shard axis only, so query slices never exchange anything.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .mesh import Mesh, make_grid_mesh
from .sharded import _check_k, _SlicedSearcher, merge, normalize_queries


def make_mesh_2d(q_devices: int, shard_devices: int, q_axis: str = "queries",
                 shard_axis: str = "shards") -> Mesh:
    """(q_devices, shard_devices) mesh of the first CUDA cards; raises when
    fewer are present."""
    return make_grid_mesh(q_devices, shard_devices, q_axis, shard_axis)


class Sharded2DSearcher(_SlicedSearcher):
    """Query x shard parallel search over a 2-D mesh. ``method`` as in
    ``ShardedSearcher`` (default 'dense'); 'auto' sizes the byte model for
    one device's query slice."""

    def __init__(self, index, mesh: Mesh, q_axis: str = "queries",
                 shard_axis: str = "shards", method: str = "dense"):
        if set(mesh.axis_names) != {q_axis, shard_axis}:
            raise ValueError(f"a 2-D mesh with axes {q_axis!r} and {shard_axis!r} is required, "
                             f"got {mesh.axis_names}")
        self.mesh = mesh
        self.q_axis = q_axis
        self.shard_axis = shard_axis
        order = (mesh.axis_names.index(q_axis), mesh.axis_names.index(shard_axis))
        self.grid = mesh.devices.transpose(order)  # (Q, S)
        Q, S = self.grid.shape
        super().__init__(index, S, [(s, self.grid[q, s]) for q in range(Q) for s in range(S)],
                         method)

    def search_batch(self, queries, k: int, n_probe: int) -> Tuple[np.ndarray, np.ndarray]:
        """(nq, d) -> (D (nq, k) f32, internal ids (nq, k) int64), padded
        +inf / -1."""
        _check_k(k, n_probe)
        q = normalize_queries(self.index, queries)
        kk = (1 + getattr(self.index, "spill", 0)) * k
        Q, S = self.grid.shape
        per = -(-q.shape[0] // Q)
        slices = [(qi, q[qi * per : (qi + 1) * per]) for qi in range(Q)]
        slices = [(qi, qs) for qi, qs in slices if len(qs)]
        jobs = [(s, self.grid[qi, s], qs) for qi, qs in slices for s in range(S)]
        outs = self.run(jobs, kk, n_probe, per)
        results, moved = [], 0
        for n, (qi, _) in enumerate(slices):
            parts = [(dv, rows, torch.full_like(rows, s))
                     for s, (dv, rows) in enumerate(outs[n * S : (n + 1) * S])]
            res, b = merge(parts, kk, self.grid[qi, 0])
            results.append(res)
            moved += b
        self.last_merge_bytes = {"shards": moved}
        D, rows, owner = (torch.cat([r[i].cpu() for r in results]) for i in range(3))
        return self.finish(D, rows, owner, k)
