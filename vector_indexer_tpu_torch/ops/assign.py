"""K1: fused nearest-centroid assignment (kernel + plain version).

``assign_argmin(x, centroids)`` -> (labels (n,) int32, sq_dists (n,) f32).
The kernel (csrc/assign.cu) ranks centroids by |c|^2 - 2 x.c, which drops
the per-point constant |x|^2; the wrapper adds it back for the winner and
clamps at 0, as the reference's ``assign_argmin_pallas`` does.

On a CPU tensor the wrapper runs ``assign_argmin_reference``; on a CUDA
tensor it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from ..kernels import build as kb
from .distance import sq_norms

_REF_CHUNK = 8192  # points per plain-version tile ((chunk, k) score matrix)


def _check(x: torch.Tensor, centroids: torch.Tensor) -> None:
    if x.dtype != torch.float32 or centroids.dtype != torch.float32:
        raise TypeError("assign_argmin takes float32 points and centroids")
    if x.ndim != 2 or centroids.ndim != 2 or x.shape[1] != centroids.shape[1]:
        raise ValueError("assign_argmin: x (n, d) and centroids (k, d) required")
    if centroids.shape[0] == 0:
        raise ValueError("assign_argmin: no centroids")


def assign_argmin_reference(x: torch.Tensor, centroids: torch.Tensor):
    """Plain PyTorch version: per tile of points, the (tile, k) score
    matrix |c|^2 - 2 x.c and its first-occurrence argmin."""
    _check(x, centroids)
    c_sq = sq_norms(centroids)
    labels, best = [], []
    for s in range(0, x.shape[0], _REF_CHUNK):
        score = torch.matmul(x[s : s + _REF_CHUNK], centroids.T)
        score.mul_(-2.0).add_(c_sq[None, :])  # in place on the (tile, k) matrix
        m, i = torch.min(score, dim=1)  # first index among equal minima
        labels.append(i.to(torch.int32))
        best.append(m)
    labels = torch.cat(labels) if labels else x.new_zeros(0, dtype=torch.int32)
    best = torch.cat(best) if best else x.new_zeros(0)
    return labels, (best + sq_norms(x)).clamp_min_(0.0)


def assign_argmin(x: torch.Tensor, centroids: torch.Tensor):
    """Nearest centroid per point: (labels int32, squared distance f32)."""
    if x.device.type == "cpu":
        return assign_argmin_reference(x, centroids)
    _check(x, centroids)
    x = x.contiguous()
    centroids = centroids.contiguous()
    kb.require_cuda("assign_argmin", x, centroids)
    n, d = x.shape
    k = centroids.shape[0]
    c_sq = sq_norms(centroids).contiguous()
    best = torch.empty(n, dtype=torch.float32, device=x.device)
    labels = torch.empty(n, dtype=torch.int32, device=x.device)
    kb.launch(
        "assign_argmin", "vitorch_assign_argmin",
        kb.ptr(x), kb.ptr(centroids), kb.ptr(c_sq), n, k, d,
        kb.ptr(best), kb.ptr(labels), kb.stream_of(x),
    )
    return labels, (best + sq_norms(x)).clamp_min_(0.0)
