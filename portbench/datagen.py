"""Seeded clustered corpus and query pool, drawn on the device.

Frozen copy of ``benchmarks/datasets.py::clustered`` (the generator behind
every number of the port's smoke), rewritten in torch so that a corpus of
1M x 1,536 is drawn on the card from ``--seed`` in a few large calls instead
of tens of seconds of numpy. Same distribution: ``ncent`` Gaussian centres
of scale ``spread``, unit-variance points and queries around them.

A corpus larger than one card (a configuration's ``"corpus": "host"``) is
drawn by the same calls on the card, one ``CHUNK_ROWS`` chunk at a time, and
each chunk is copied into one host array: the same seed gives the same bits
either way, and the card never holds more than one chunk of it.
"""

from __future__ import annotations

import mmap

import numpy as np
import torch

CHUNK_ROWS = 1 << 18  # rows per draw: bounds the scratch at 1.6 GB for d 1,536


def generator(seed: int, device) -> torch.Generator:
    """A torch generator on ``device`` seeded by any whole number."""
    return torch.Generator(device=device).manual_seed(int(seed) % (2**63))


def host_array(n: int, d: int) -> np.ndarray:
    """An (n, d) float32 array over anonymous memory whose pages are all
    mapped up front (``MAP_POPULATE``): faulting them in page by page as the
    copies first touch them took 2.5 times as long (20M x 128 on an H100
    machine's host)."""
    flags = mmap.MAP_PRIVATE | mmap.MAP_ANONYMOUS | mmap.MAP_POPULATE
    return np.frombuffer(mmap.mmap(-1, n * d * 4, flags=flags), np.float32).reshape(n, d)


def clustered(n: int, d: int, nq: int, seed: int, device, ncent: int, spread: float,
              host: bool = False):
    """(xb (n, d), xq (nq, d)) float32 tensors on ``device``; the same seed and
    device give the same arrays. A configuration names this generator by its
    ``generator.kind`` and gives its other parameters. ``host``: xb is a
    host tensor over a numpy array, filled chunk by chunk from the card."""
    g = generator(seed, device)
    centers = torch.randn((ncent, d), generator=g, device=device).mul_(spread)
    if host:
        xb = torch.from_numpy(host_array(n, d))
    else:
        xb = torch.empty((n, d), dtype=torch.float32, device=device)
    for s in range(0, n, CHUNK_ROWS):
        e = min(s + CHUNK_ROWS, n)
        lab = torch.randint(0, ncent, (e - s,), generator=g, device=device)
        xb[s:e] = torch.randn((e - s, d), generator=g, device=device).add_(centers[lab])
    lab = torch.randint(0, ncent, (nq,), generator=g, device=device)
    xq = torch.randn((nq, d), generator=g, device=device).add_(centers[lab])
    return xb, xq
