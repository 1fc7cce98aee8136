"""Multi-host sharded search: a ``hosts`` mesh axis over ``shards``.

Port of ``vector_indexer_tpu/parallel/multihost.py``. The merge is
hierarchical, for a topology where the devices of one host are linked by a
fast fabric and hosts by a slow network: stage 1 fuses the S per-device
lists of each host into one top-k on the host's first device; stage 2
gathers only each host's fused list, carrying flat owner ids h*S + s. A
flat merge over all H*S devices would move S times more bytes across
hosts. Slices are placed host-major (device (h, s) holds slice h*S + s),
one contiguous stripe of the corpus per host. ``last_merge_bytes`` records
what each stage gathered in the last search.

The port's mesh is one process's devices, as the reference's is one
controller's: its tests build a (hosts, shards) mesh of CPU entries, the
counterpart of the reference's virtual CPU devices.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .mesh import Mesh, make_grid_mesh
from .sharded import _check_k, _SlicedSearcher, merge, normalize_queries


def make_mesh_hosts(n_hosts: int, shards_per_host: int, host_axis: str = "hosts",
                    shard_axis: str = "shards") -> Mesh:
    """(n_hosts, shards_per_host) mesh of the first CUDA cards; raises when
    fewer are present."""
    return make_grid_mesh(n_hosts, shards_per_host, host_axis, shard_axis)


def hier_merge(parts, k: int, grid):
    """Two-stage merge of per-device lists ``parts[h][s]`` = (D, rows) on
    device ``grid[h, s]``: per host over its shards onto ``grid[h, 0]``,
    owner ids made flat (h*S + s), then over hosts onto ``grid[0, 0]``.
    -> ((D, rows, owner) (nq, k), bytes gathered in stage 1, in stage 2)."""
    H, S = grid.shape
    fused, stage1 = [], 0
    for h in range(H):
        res, b = merge([(dv, rows, torch.full_like(rows, s))
                        for s, (dv, rows) in enumerate(parts[h])], k, grid[h, 0])
        d1, r1, o1 = res
        fused.append((d1, r1, torch.where(o1 >= 0, h * S + o1, -1)))
        stage1 += b
    res, stage2 = merge(fused, k, grid[0, 0])
    return res, stage1, stage2


class MultiHostSearcher(_SlicedSearcher):
    """Hierarchically merged search over a (hosts, shards) mesh. ``method``
    as in ``ShardedSearcher``."""

    def __init__(self, index, mesh: Mesh, host_axis: str = "hosts",
                 shard_axis: str = "shards", method: str = "auto"):
        if set(mesh.axis_names) != {host_axis, shard_axis}:
            raise ValueError(f"a 2-D mesh with axes {host_axis!r} and {shard_axis!r} is "
                             f"required, got {mesh.axis_names}")
        self.mesh = mesh
        self.host_axis = host_axis
        self.shard_axis = shard_axis
        order = (mesh.axis_names.index(host_axis), mesh.axis_names.index(shard_axis))
        self.grid = mesh.devices.transpose(order)  # (H, S)
        H, S = self.grid.shape
        self.n_dev = H * S
        super().__init__(index, H * S,
                         [(h * S + s, self.grid[h, s]) for h in range(H) for s in range(S)],
                         method)

    def search_batch(self, queries, k: int, n_probe: int) -> Tuple[np.ndarray, np.ndarray]:
        """(nq, d) -> (D (nq, k) f32, internal ids (nq, k) int64), padded
        +inf / -1."""
        _check_k(k, n_probe)
        q = normalize_queries(self.index, queries)
        kk = (1 + getattr(self.index, "spill", 0)) * k
        H, S = self.grid.shape

        def reduce(outs):
            (D, rows, owner), b1, b2 = hier_merge(
                [outs[h * S : (h + 1) * S] for h in range(H)], kk, self.grid)
            self.last_merge_bytes = {"shards": b1, "hosts": b2}
            return self.finish(D, rows, owner, k)

        return self._graphs.search(
            self, [(h * S + s, self.grid[h, s], q) for h in range(H) for s in range(S)], kk,
            n_probe, q.shape[0], reduce)
