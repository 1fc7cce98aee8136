"""Size-based heuristics for index geometry and training budgets.

Parity with the reference heuristics:
  - cluster count:    reference src/utils.rs:9-16
  - max iterations:   reference src/utils.rs:18-26
  - mini-batch size:  reference src/kmeans.rs:83
  - suggest_nlist:    reference bindings/python/src/lib.rs:308-315
"""

from __future__ import annotations

import math


def calculate_num_clusters(num_vectors: int) -> int:
    """Cluster count (nlist) as a function of corpus size.

    n < 10k  -> floor(sqrt(n))
    n < 100k -> 2 * ceil(sqrt(n))
    else     -> 4 * ceil(sqrt(n))
    """
    if num_vectors < 10_000:
        return int(math.sqrt(num_vectors))
    if num_vectors < 100_000:
        return 2 * math.ceil(math.sqrt(num_vectors))
    return 4 * math.ceil(math.sqrt(num_vectors))


def calculate_max_iterations(num_vectors: int) -> int:
    """Training iteration budget as a function of corpus size."""
    if num_vectors < 10_000:
        return 300
    if num_vectors < 100_000:
        return 100
    if num_vectors < 1_000_000:
        return 50
    return 20


def mini_batch_size(num_vectors: int) -> int:
    """Mini-batch size: clamp(sqrt(n), 10, 256).

    The mini-batch trainer is not ported yet; this is kept as the parity
    default for when it is.
    """
    return max(10, min(256, int(math.sqrt(num_vectors))))


def suggest_nlist(num_vectors: int) -> int:
    """Public alias of the cluster-count heuristic (bindings parity)."""
    return calculate_num_clusters(num_vectors)


def num_shards_for(nlist: int) -> int:
    """Shard count = ceil(sqrt(nlist)) super-centroids.

    Parity: reference src/ivf_index.rs:104.
    """
    return max(1, math.ceil(math.sqrt(nlist)))
