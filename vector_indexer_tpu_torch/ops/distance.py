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


def assign_spill_chunked(x: torch.Tensor, c: torch.Tensor, labels: torch.Tensor,
                         soar_lambda: float = 1.0, chunk: int = 8192) -> torch.Tensor:
    """SOAR secondary assignment of a spilled index: for each point with
    primary cell ``labels``, the cell j != primary that minimises

        |x - c_j|^2 + lambda * <x - c_j, r>^2 / |r|^2,   r = x - c_primary,

    so that the spill cell's residual is as orthogonal to the primary's as
    the distance allows (lambda = 0: the plain second-nearest cell). Ties
    take the lower id. Two f32 products per tile of ``chunk`` points.
    x: (n, d), c: (k, d), labels: (n,) -> (n,) int32."""
    c_sq = sq_norms(c)
    lam = float(soar_lambda)
    out = []
    for s in range(0, x.shape[0], chunk):
        xt = x[s : s + chunk]
        lt = labels[s : s + chunk].long()
        dmat = pairwise_sq_l2(xt, c, c_sq=c_sq)
        r = xt - c[lt]  # primary residuals
        r_sq = sq_norms(r)
        # <x - c_j, r> = <x, r> - <c_j, r>
        proj = torch.sum(xt * r, dim=-1)[:, None] - torch.matmul(r, c.T)
        dmat += lam * proj * proj / r_sq.clamp_min(1e-12)[:, None]
        dmat[torch.arange(xt.shape[0], device=x.device), lt] = float("inf")
        out.append(torch.argmin(dmat, dim=1).to(torch.int32))
    if not out:
        return labels.new_zeros(0, dtype=torch.int32)
    return torch.cat(out)


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
