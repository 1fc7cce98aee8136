"""Trainers: k-means for the index build."""

__all__ = [
    "KMeansResult",
    "kmeans_plus_plus_init",
    "run_kmeans_balanced",
    "run_kmeans_lloyd",
    "run_kmeans_lloyd_sampled",
    "run_kmeans_mini_batch",
    "assign_points",
    "assign_points_hierarchical",
    "compute_inertia",
]


def __getattr__(name):
    # Lazy: models.kmeans imports the kernel wrappers (ops.assign).
    if name in __all__:
        from . import kmeans

        return getattr(kmeans, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
