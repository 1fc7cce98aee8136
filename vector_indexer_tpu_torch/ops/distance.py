"""Squared-L2 distances as matrix products.

D = ||x||^2 - 2 X C^T + ||c||^2: one ``torch.matmul`` per tile, in full
float32. (On the card that needs ``torch.backends.cuda.matmul.allow_tf32``
to stay False, PyTorch's default; TF32 keeps ~3 decimal digits and flips
near-tie argmins.)
"""

from __future__ import annotations

from typing import Optional

import torch


def sq_norms(x: torch.Tensor) -> torch.Tensor:
    """Row-wise squared L2 norms. x: (n, d) -> (n,)."""
    return torch.sum(x * x, dim=-1)


def pairwise_sq_l2(
    x: torch.Tensor,
    c: torch.Tensor,
    c_sq: Optional[torch.Tensor] = None,
    x_sq: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Full pairwise squared-L2 matrix. x: (n, d), c: (k, d) -> (n, k),
    clamped at 0 (the expansion can go epsilon-negative)."""
    if x_sq is None:
        x_sq = sq_norms(x)
    if c_sq is None:
        c_sq = sq_norms(c)
    d = torch.matmul(x, c.T)
    # In place on the (n, k) product: saves one matrix-sized temporary.
    d.mul_(-2.0).add_(x_sq[:, None]).add_(c_sq[None, :])
    return d.clamp_min_(0.0)


def assign_chunked(x: torch.Tensor, c: torch.Tensor, chunk: int = 16384):
    """Nearest-centroid assignment over tiles of ``chunk`` points, so the
    (n, k) distance matrix is never whole: (labels int32 (n,), min squared
    distance f32 (n,)); ties take the lower centroid id."""
    c_sq = sq_norms(c)
    labels, dists = [], []
    for s in range(0, x.shape[0], chunk):
        dmat = pairwise_sq_l2(x[s : s + chunk], c, c_sq=c_sq)
        m, i = torch.min(dmat, dim=1)  # first index among equal minima
        labels.append(i.to(torch.int32))
        dists.append(m)
    if not labels:
        return x.new_zeros(0, dtype=torch.int32), x.new_zeros(0)
    return torch.cat(labels), torch.cat(dists)


def euclidean_distance_squared(a, b) -> torch.Tensor:
    """Squared distance of one pair of vectors (a parity helper)."""
    diff = torch.as_tensor(a) - torch.as_tensor(b)
    return torch.sum(diff * diff)


def score(qt, table, table_norms, q_sq, metric: str) -> torch.Tensor:
    """Batched 'distance' (smaller = better): exact squared L2 via the norm
    expansion, or the negated inner product for ip/cosine. Sentinel
    (gap/tail) rows carry SENTINEL_NORM in ``table_norms``: for l2 that term
    dominates directly; for ip it is added as an explicit penalty."""
    cross = torch.matmul(qt, table.T)
    if metric == "l2":
        return (q_sq[:, None] - 2.0 * cross + table_norms[None, :]).clamp_min_(0.0)
    penalty = torch.where(table_norms >= 1e29, table_norms, torch.zeros_like(table_norms))
    return penalty[None, :] - cross
