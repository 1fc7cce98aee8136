"""Heuristics, vector-file I/O and tracing.

The numeric heuristics match the reference's exactly, so that index
geometry (nlist, shard count, iteration budgets) is comparable. Tracing
(``utils.tracing``) is imported by its own path.
"""

from .heuristics import (
    calculate_max_iterations,
    calculate_num_clusters,
    mini_batch_size,
    suggest_nlist,
)
from .io import (
    generate_test_vectors,
    read_vectors_from_file,
    unix_timestamp_secs,
    write_vectors_to_file,
)

__all__ = [
    "calculate_num_clusters",
    "calculate_max_iterations",
    "mini_batch_size",
    "suggest_nlist",
    "generate_test_vectors",
    "read_vectors_from_file",
    "write_vectors_to_file",
    "unix_timestamp_secs",
]
