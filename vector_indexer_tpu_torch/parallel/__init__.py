"""Parallel layer: sharded search over a device mesh and data-parallel
training.

Port of ``vector_indexer_tpu/parallel``. The reference shards the posting
lists over a ``jax.sharding.Mesh`` axis and runs one program per device
under ``shard_map``; here one process drives every device of a ``Mesh``
(an array of ``torch.device``), enqueues each device's body, and merges
the partial top-k lists on the mesh's first device. A 1-device mesh gives
the single-device results.
"""

from .dp_kmeans import run_kmeans_lloyd_dp
from .mesh import Mesh, make_shard_mesh
from .mesh2d import Sharded2DSearcher, make_mesh_2d
from .multihost import MultiHostSearcher, make_mesh_hosts
from .sharded import ShardedSearcher

__all__ = [
    "Mesh",
    "make_shard_mesh",
    "ShardedSearcher",
    "Sharded2DSearcher",
    "make_mesh_2d",
    "MultiHostSearcher",
    "make_mesh_hosts",
    "run_kmeans_lloyd_dp",
]
