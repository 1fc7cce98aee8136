"""vector_indexer_tpu_torch - the IVF-Flat vector index in PyTorch and CUDA.

A port of ``vector_indexer_tpu`` (JAX/Pallas on a TPU) to PyTorch on an
NVIDIA H100. The build (k-means + posting layout), persistence and the
default ``auto`` search path are ported; each Pallas kernel on that path is
a hand-written CUDA kernel in ``csrc/`` (K1 assignment, K2/K4 stream, K3
fused sweep), built with nvcc at first use. Every kernel has a plain
PyTorch version beside it, which runs on CPU tensors. The JAX package stays
the reference the port is tested against; this package never imports jax.
"""

__version__ = "0.1.0"

_API = (
    "VectorIndexer",
    "VectorIndexerConfig",
    "VectorRecord",
    "SearchRequest",
    "SearchResult",
)
_BINDINGS = ("build", "load", "suggest_nlist", "VectorIndex")

__all__ = list(_API + _BINDINGS)


def __getattr__(name):
    # Lazy, so that importing a submodule does not load the whole stack.
    if name in _API:
        from . import api

        return getattr(api, name)
    if name in _BINDINGS:
        from . import bindings

        return getattr(bindings, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
