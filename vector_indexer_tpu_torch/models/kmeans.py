"""K-means for the index build: k-means++ init, full-batch Lloyd, final
assignment.

Port of the Lloyd slice of ``vector_indexer_tpu/models/kmeans.py``:

* k-means++ init is exact below 50k points and subsampled above, with
  blocks of D^2-weighted draws (Gumbel top-B) for large k, as in the
  reference (kmeans.py:72-158);
* each Lloyd iteration assigns with ``torch.matmul`` + argmin per
  8192-point tile, as the reference's loop does outside its kernel, and
  accumulates per-cluster sums with ``index_add_`` (the reference's
  one-hot matmul: the same sums in another order);
* empty clusters are re-seeded from random points every iteration and the
  loop stops when the RMS centroid move falls below ``tol``;
* the final assignment of all points goes through kernel K1 at large n*k,
  and through the two-level (hierarchical) assignment past k = 8192, as in
  the reference (kmeans.py:187-305).

Random draws come from a ``torch.Generator`` seeded from ``seed``. They
differ from the reference's jax.random streams by design, so the seeded
steps are held to the reference statistically (inertia, recovery) and the
Lloyd iterations from a shared init.

The mini-batch, balanced, sampled and host-resident trainers are not
ported yet (ROADMAP Queue 1 item 6) and raise.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from ..ops.assign import assign_argmin
from ..ops.distance import pairwise_sq_l2, sq_norms

_SAMPLE_THRESHOLD = 50_000  # exact vs sampled k-means++ switch
_DEFAULT_TOL = 1e-4
_ASSIGN_CHUNK = 8192
_HIERARCHICAL_K_THRESHOLD = 8192
# The hierarchical assignment bounds its (chunk, probes * g_max, d)
# candidate gather to about this many bytes (two copies, as the reference
# counts them).
_HIERARCHICAL_TILE_CAP = 2 << 30


@dataclasses.dataclass
class KMeansResult:
    centroids: torch.Tensor  # (k, d) f32
    labels: torch.Tensor  # (n,) int32
    iterations: int
    converged: bool


def _check_data(data: torch.Tensor) -> torch.Tensor:
    if not isinstance(data, torch.Tensor):
        raise TypeError("k-means takes a torch.Tensor (on the build device)")
    data = data.to(torch.float32)
    if data.ndim != 2 or data.shape[0] == 0 or data.shape[1] == 0:
        raise ValueError("Input vectors cannot be empty")
    return data


def make_generator(device: torch.device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed) % (2**63))


# ---------------------------------------------------------------------------
# k-means++ initialization
# ---------------------------------------------------------------------------


def _min_dist_to(data, x_sq, cblk) -> torch.Tensor:
    """(n,) squared distance of every point to its nearest row of cblk."""
    dd = torch.matmul(data, cblk.T)
    dd.mul_(-2.0).add_(x_sq[:, None]).add_(sq_norms(cblk)[None, :])
    return dd.min(dim=1).values.clamp_min_(0.0)


def _kmeans_pp_exact(gen, data: torch.Tensor, k: int, draw_block: int = 1):
    """k-means++ with ``draw_block`` D^2-weighted draws per step (Gumbel
    top-B over log D^2, i.e. a without-replacement batch whose weights are
    updated between blocks). All-zero weights degrade to uniform."""
    n, d = data.shape
    dev = data.device
    first = torch.randint(0, n, (1,), generator=gen, device=dev)
    centroids = torch.zeros((k, d), dtype=torch.float32, device=dev)
    centroids[0] = data[first[0]]
    x_sq = sq_norms(data)
    min_d = _min_dist_to(data, x_sq, data[first])
    num_blocks = -(-(k - 1) // draw_block)
    tiny = torch.finfo(torch.float32).tiny
    for i in range(num_blocks):
        total = min_d.sum()
        logits = torch.where(
            min_d > 0, torch.log(min_d.clamp_min(1e-30)), float("-inf")
        )
        logits = torch.where(total > 0, logits, torch.zeros_like(logits))
        u = torch.rand(n, generator=gen, device=dev).clamp_min_(tiny)
        gumbel = -torch.log(-torch.log(u))
        idx = torch.topk(logits + gumbel, draw_block).indices
        cblk = data[idx]
        # The reference's dynamic_update_slice clamps the last block's start
        # so that it fits; mirror that (it rewrites a few rows with valid
        # draws).
        start = min(1 + i * draw_block, k - draw_block)
        centroids[start : start + draw_block] = cblk
        min_d = torch.minimum(min_d, _min_dist_to(data, x_sq, cblk))
    return centroids


def kmeans_plus_plus_init(
    data: torch.Tensor,
    k: int,
    seed: int = 42,
    sample_threshold: int = _SAMPLE_THRESHOLD,
) -> torch.Tensor:
    """k-means++ seeding; subsampled above ``sample_threshold`` points."""
    data = _check_data(data)
    n = data.shape[0]
    gen = make_generator(data.device, seed)
    if k >= n:
        # Every point becomes a centroid; surplus centroids cycle through the
        # points again (empty-cluster repair owns them during training).
        return data[torch.arange(k, device=data.device) % n].clone()
    if n > sample_threshold:
        pick = torch.randperm(n, generator=gen, device=data.device)
        data = data[pick[:sample_threshold]]
        n = sample_threshold
    draw_block = 1 if k <= 128 else max(1, min(64, k - 1, n))
    return _kmeans_pp_exact(gen, data, k, draw_block=draw_block)


# ---------------------------------------------------------------------------
# Assignment
# ---------------------------------------------------------------------------


def _assign_dense(data, centroids, chunk: int = _ASSIGN_CHUNK):
    c_sq = sq_norms(centroids)
    labels, dists = [], []
    for s in range(0, data.shape[0], chunk):
        dmat = pairwise_sq_l2(data[s : s + chunk], centroids, c_sq=c_sq)
        m, i = torch.min(dmat, dim=1)
        labels.append(i.to(torch.int32))
        dists.append(m)
    return torch.cat(labels), torch.cat(dists)


def assign_points(data, centroids, method: str = "auto", chunk: int = _ASSIGN_CHUNK):
    """labels (int32), sq_dists = nearest centroid per point.

    ``auto`` takes the two-level assignment past k = 8192 (the reference's
    threshold), else kernel K1 when the (n, k) score plane is large
    (n*k >= 2^26 and k >= 512, the reference's gate) and the tiled
    matmul + argmin otherwise. On a CPU tensor K1's wrapper runs its plain
    version."""
    data = _check_data(data)
    centroids = centroids.to(torch.float32)
    k = centroids.shape[0]
    if method == "auto":
        if k > _HIERARCHICAL_K_THRESHOLD:
            method = "hierarchical"
        else:
            big = data.shape[0] * k >= (1 << 26) and k >= 512
            method = "kernel" if big else "dense"
    if method == "dense":
        return _assign_dense(data, centroids, chunk=chunk)
    if method == "kernel":
        return assign_argmin(data, centroids)
    if method == "hierarchical":
        return assign_points_hierarchical(data, centroids, chunk=chunk)
    raise ValueError(f"unknown assignment method: {method}")


def assign_points_hierarchical(data, centroids, seed: int = 42, probes: int = 3,
                               chunk: int = _ASSIGN_CHUNK):
    """Two-level assignment: each point probes its ``probes`` nearest meta
    centroids and takes the argmin over their member centroids only.

    The reference's parameters (models/kmeans.py:223-276): meta_k =
    clamp(sqrt(k), 2, k/2); the meta clustering is 5 Lloyd iterations over
    the centroid table with seed ``seed*17+42``; the member table is padded
    to (meta_k, g_max) with -1 holes; the (chunk, probes*g_max, d) candidate
    gather is capped near 2 GiB (the chunk rounded down to 256). A point's
    label can differ from the exact argmin where its nearest centroid sits
    in a group it did not probe."""
    data = _check_data(data)
    centroids = centroids.to(torch.float32)
    k = centroids.shape[0]
    meta_k = max(2, min(int(math.sqrt(k)), k // 2))
    probes = min(probes, meta_k)
    meta = run_kmeans_lloyd(centroids, meta_k, max_iters=5, seed=seed * 17 + 42,
                            early_stop_threshold=0.0)
    table = member_table(meta.labels, meta_k)
    per_point = 2 * probes * table.shape[1] * data.shape[1] * 4
    if chunk * per_point > _HIERARCHICAL_TILE_CAP:
        chunk = max(256, _HIERARCHICAL_TILE_CAP // per_point // 256 * 256)
    return _assign_hierarchical(data, centroids, meta.centroids, table, probes=probes,
                                chunk=chunk)


def member_table(meta_labels: torch.Tensor, meta_k: int) -> torch.Tensor:
    """(meta_k, g_max) int64 centroid ids of each meta group in id order,
    -1 past a group's end."""
    lbl = meta_labels.long()
    counts = torch.bincount(lbl, minlength=meta_k)
    g_max = max(1, int(counts.max()))
    order = torch.argsort(lbl, stable=True)  # ids grouped, ascending within a group
    first = torch.cumsum(counts, 0) - counts
    slot = torch.arange(lbl.shape[0], device=lbl.device) - first[lbl[order]]
    table = torch.full((meta_k, g_max), -1, dtype=torch.int64, device=lbl.device)
    table[lbl[order], slot] = order
    return table


def _assign_hierarchical(data, centroids, meta_centroids, table, *, probes: int, chunk: int):
    """The deterministic half of ``assign_points_hierarchical`` (the
    reference's ``_assign_hierarchical_jit``): per tile of ``chunk`` points,
    the ``probes`` nearest meta centroids (ties to the lower id), the
    candidates of their groups, and the argmin (first candidate on a tie)
    of |x|^2 - 2 x.c + |c|^2 clamped at 0 (+inf on holes). The cross term
    is one batched f32 product (TF32 stays off, PyTorch's default: the
    reference's HIGHEST precision). -> (labels int32, dists f32)."""
    table = table.to(device=data.device, dtype=torch.int64)
    c_sq = sq_norms(centroids)
    m_sq = sq_norms(meta_centroids)
    labels, dists = [], []
    for s in range(0, data.shape[0], chunk):
        xt = data[s : s + chunk]
        dmeta = pairwise_sq_l2(xt, meta_centroids, c_sq=m_sq)
        top = torch.topk(dmeta, probes, dim=1, largest=False, sorted=True).indices
        cand = table[top].reshape(xt.shape[0], -1)  # (chunk, probes * g_max)
        valid = cand >= 0
        cand = cand.clamp_min(0)
        cross = torch.bmm(centroids[cand], xt[:, :, None])[:, :, 0]
        dist = sq_norms(xt)[:, None] - 2.0 * cross + c_sq[cand]
        dist = torch.where(valid, dist.clamp_min(0.0), float("inf"))
        m, best = torch.min(dist, dim=1)  # first index among equal minima
        labels.append(cand.gather(1, best[:, None])[:, 0].to(torch.int32))
        dists.append(m)
    return torch.cat(labels), torch.cat(dists)


# ---------------------------------------------------------------------------
# Lloyd
# ---------------------------------------------------------------------------


def _segment_stats(x, labels, k: int, valid=None):
    """(sums (k, d), counts (k,)) per cluster. ``valid`` (n,) weights rows
    (0 drops a row). ``index_add_`` replaces the reference's one-hot
    matmul: the same sums, summed in another order."""
    w = None if valid is None else valid.to(x.dtype)
    sums = torch.zeros((k, x.shape[1]), dtype=x.dtype, device=x.device)
    sums.index_add_(0, labels.long(), x if w is None else x * w[:, None])
    counts = torch.zeros(k, dtype=x.dtype, device=x.device)
    counts.index_add_(
        0, labels.long(), torch.ones_like(labels, dtype=x.dtype) if w is None else w
    )
    return sums, counts


def _repair_empty(gen, centroids, counts, data):
    """Re-seed zero-count clusters from random data points."""
    k = centroids.shape[0]
    ridx = torch.randint(0, data.shape[0], (k,), generator=gen, device=data.device)
    return torch.where((counts == 0)[:, None], data[ridx], centroids)


def _rms_delta(curr, prev) -> torch.Tensor:
    k, d = curr.shape
    return torch.sqrt(torch.sum((curr - prev) ** 2) / (k * d))


def _lloyd_loop(data, init_centroids, gen, k: int, max_iters: int, tol: float,
                chunk: int, spherical: bool = False):
    """Full-batch Lloyd from ``init_centroids``. Returns (centroids,
    iterations, converged). Each iteration is an exact f32 assignment sweep
    over ``chunk``-point tiles plus the mean update."""
    centroids = init_centroids.to(torch.float32).clone()
    it, converged = 0, False
    while it < max_iters:
        c_sq = sq_norms(centroids)
        sums = torch.zeros_like(centroids)
        counts = torch.zeros(k, dtype=torch.float32, device=data.device)
        for s in range(0, data.shape[0], chunk):
            xt = data[s : s + chunk]
            lbl = torch.argmin(pairwise_sq_l2(xt, centroids, c_sq=c_sq), dim=1)
            ts, tc = _segment_stats(xt, lbl, k)
            sums.add_(ts)
            counts.add_(tc)
        new_c = torch.where(
            (counts > 0)[:, None], sums / counts.clamp_min(1.0)[:, None], centroids
        )
        new_c = _repair_empty(gen, new_c, counts, data)
        if spherical:
            # Spherical k-means: centroids stay on the unit sphere, so L2
            # assignment == cosine assignment for unit data.
            new_c = new_c / new_c.norm(dim=1, keepdim=True).clamp_min(1e-12)
        delta = float(_rms_delta(new_c, centroids))
        centroids = new_c
        it += 1
        if delta < tol:
            converged = True
            break
    return centroids, it, converged


def run_kmeans_lloyd(
    data: torch.Tensor,
    k: int,
    max_iters: int,
    early_stop_threshold: Optional[float] = _DEFAULT_TOL,
    seed: int = 42,
    chunk: int = _ASSIGN_CHUNK,
    spherical: bool = False,
) -> KMeansResult:
    """Full-batch Lloyd: k-means++ init, Lloyd iterations, final exact
    assignment (``assign_points``)."""
    data = _check_data(data)
    tol = _DEFAULT_TOL if early_stop_threshold is None else early_stop_threshold
    init = kmeans_plus_plus_init(data, k, seed=seed)
    gen = make_generator(data.device, seed ^ 0x5EED)
    chunk = min(chunk, max(8, data.shape[0]))
    centroids, iters, converged = _lloyd_loop(
        data, init, gen, k, max_iters, tol, chunk, spherical=spherical
    )
    labels, _ = assign_points(data, centroids, chunk=chunk)
    return KMeansResult(centroids, labels, iters, converged)


def compute_inertia(data, centroids, labels) -> float:
    """Sum of squared distances of points to their assigned centroid."""
    diff = data - centroids[labels.long()]
    return float(torch.sum(diff * diff))


def _not_ported(name: str):
    def fn(*args, **kwargs):
        raise NotImplementedError(
            f"{name} is not ported yet (ROADMAP Queue 1 item 6)"
        )

    fn.__name__ = name
    return fn


run_kmeans_mini_batch = _not_ported("run_kmeans_mini_batch")
run_kmeans_balanced = _not_ported("run_kmeans_balanced")
run_kmeans_lloyd_sampled = _not_ported("run_kmeans_lloyd_sampled")
run_kmeans_lloyd_host = _not_ported("run_kmeans_lloyd_host")
