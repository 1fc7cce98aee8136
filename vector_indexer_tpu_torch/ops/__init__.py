"""Distance, selection and kernel operators (K1-K7 with their plain versions).

The package exports the plain operators; each kernel's wrapper is imported
by its module's path (``ops.assign``, ``ops.block_stream``, ...), so that
importing the package loads no kernel module.
"""

from .distance import assign_chunked, euclidean_distance_squared, pairwise_sq_l2, sq_norms
from .topk import brute_force_topk, merge_topk, topk_smallest

__all__ = [
    "sq_norms",
    "pairwise_sq_l2",
    "assign_chunked",
    "euclidean_distance_squared",
    "topk_smallest",
    "merge_topk",
    "brute_force_topk",
]
