"""A device mesh for the sharded searchers and the data-parallel trainer.

One process drives every device of the mesh (the reference's
single-controller model: one Python process holds a ``jax.sharding.Mesh``
and runs ``shard_map``; Faiss's ``IndexShards`` is likewise one process
over a list of GPUs). A ``Mesh`` is an ndarray of ``torch.device`` with one
name per axis. A mesh built directly may name one device several times: a
CPU list ``[torch.device("cpu")] * 8`` is the counterpart of the
reference's 8 virtual CPU devices, and ``[cuda:0] * 4`` puts four shards on
one card.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch


class Mesh:
    """``devices``: an ndarray (or nested list) of ``torch.device`` whose
    ndim equals ``len(axis_names)``. ``shape[axis]`` is an axis's size,
    as on a JAX mesh."""

    def __init__(self, devices, axis_names: Sequence[str]):
        given = np.asarray(devices, dtype=object)
        grid = np.empty(given.shape, dtype=object)
        for pos in np.ndindex(given.shape):
            grid[pos] = torch.device(given[pos])
        axis_names = tuple(axis_names)
        if grid.ndim != len(axis_names) or len(set(axis_names)) != len(axis_names):
            raise ValueError(f"a {grid.ndim}-D device grid needs {grid.ndim} distinct axis "
                             f"names, got {axis_names}")
        if grid.size == 0:
            raise ValueError("a mesh needs at least one device")
        self.devices = grid
        self.axis_names = axis_names
        self.shape = dict(zip(axis_names, grid.shape))

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={[str(d) for d in self.devices.flat]})"


def _cuda_devices(need: int) -> list:
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if need > count:
        raise ValueError(f"requested {need} devices but only {count} CUDA devices available")
    return [torch.device("cuda", i) for i in range(need)]


def make_shard_mesh(n_devices: int | None = None, axis: str = "shards") -> Mesh:
    """1-D mesh of the first ``n_devices`` CUDA cards (default: all).
    Raises when fewer are present, and never substitutes the CPU: a CPU
    mesh is a ``Mesh`` built directly."""
    if n_devices is None:
        n_devices = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n_devices == 0:
            raise ValueError("no CUDA device available for a shard mesh")
    return Mesh(_cuda_devices(n_devices), (axis,))


def make_grid_mesh(rows: int, cols: int, row_axis: str, col_axis: str) -> Mesh:
    """(rows, cols) mesh of the first rows * cols CUDA cards, row-major."""
    grid = np.empty((rows, cols), dtype=object)
    for i, dev in enumerate(_cuda_devices(rows * cols)):
        grid[i // cols, i % cols] = dev
    return Mesh(grid, (row_axis, col_axis))
