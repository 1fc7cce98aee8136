"""The IVF index, its dispatch model and its search programs."""

__all__ = ["IvfIndex", "load_index_from"]


def __getattr__(name):
    # Lazy: index.ivf imports every kernel wrapper.
    if name in __all__:
        from . import ivf

        return getattr(ivf, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
