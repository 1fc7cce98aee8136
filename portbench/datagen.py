"""Seeded clustered corpus and query pool, drawn on the device.

Frozen copy of ``benchmarks/datasets.py::clustered`` (the generator behind
every number of the port's smoke), rewritten in torch so that a corpus of
1M x 1,536 is drawn on the card from ``--seed`` in a few large calls instead
of tens of seconds of numpy. Same distribution: ``ncent`` Gaussian centres
of scale ``spread``, unit-variance points and queries around them.
"""

from __future__ import annotations

import torch

CHUNK_ROWS = 1 << 18  # rows per draw: bounds the scratch at 1.6 GB for d 1,536


def generator(seed: int, device) -> torch.Generator:
    """A torch generator on ``device`` seeded by any whole number."""
    return torch.Generator(device=device).manual_seed(int(seed) % (2**63))


def clustered(n: int, d: int, nq: int, seed: int, device, ncent: int, spread: float):
    """(xb (n, d), xq (nq, d)) float32 tensors on ``device``; the same seed and
    device give the same arrays. A configuration names this generator by its
    ``generator.kind`` and gives its other parameters."""
    g = generator(seed, device)
    centers = torch.randn((ncent, d), generator=g, device=device).mul_(spread)
    xb = torch.empty((n, d), dtype=torch.float32, device=device)
    for s in range(0, n, CHUNK_ROWS):
        e = min(s + CHUNK_ROWS, n)
        lab = torch.randint(0, ncent, (e - s,), generator=g, device=device)
        xb[s:e] = torch.randn((e - s, d), generator=g, device=device).add_(centers[lab])
    lab = torch.randint(0, ncent, (nq,), generator=g, device=device)
    xq = torch.randn((nq, d), generator=g, device=device).add_(centers[lab])
    return xb, xq
