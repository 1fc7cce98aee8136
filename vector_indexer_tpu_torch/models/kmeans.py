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

The sampled trainer (Lloyd on a seeded subsample, every point assigned)
and its host-corpus twin (only the subsample and one fixed-size assignment
slice at a time reach the device) draw the reference's numpy sample, so
both packages train on the same rows.

The mini-batch trainer (kmeans.py:766-864) keeps the original engine's
per-cluster step eta = 1/count over batches of ``mini_batch_size(n)``
points, then ``refine_iters`` full Lloyd passes and the final assignment
(K1 at large n*k). The balanced trainer (kmeans.py:556-755) adds a
per-cell penalty to the assignment, driven by an integral controller on
the cells' occupancy, and clones an overfull cell's centroid onto an
underfull one; its final assignment keeps the penalty. The data-parallel
Lloyd is ``parallel/dp_kmeans.py``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..ops.assign import assign_argmin
from ..ops.distance import pairwise_sq_l2, sq_norms
from ..utils.heuristics import mini_batch_size

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
    return init_from_rows(lambda idx: data if idx is None else data[idx], data.shape[0], k,
                          seed, data.device, sample_threshold)


def init_from_rows(rows_of, n: int, k: int, seed: int, dev: torch.device,
                   sample_threshold: int = _SAMPLE_THRESHOLD) -> torch.Tensor:
    """``kmeans_plus_plus_init`` over a corpus of ``n`` rows that
    ``rows_of(idx)`` gathers onto ``dev`` (``idx`` None: every row), so a
    corpus split over devices (parallel/dp_kmeans.py) draws the same init
    as the same rows on one device."""
    gen = make_generator(dev, seed)
    if k >= n:
        # Every point becomes a centroid; surplus centroids cycle through the
        # points again (empty-cluster repair owns them during training).
        return rows_of(torch.arange(k, device=dev) % n).clone()
    if n > sample_threshold:
        pick = torch.randperm(n, generator=gen, device=dev)
        data = rows_of(pick[:sample_threshold])
        n = sample_threshold
    else:
        data = rows_of(None)
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


def lloyd_stats(data, centroids, k: int, chunk: int):
    """One exact f32 assignment sweep over ``chunk``-point tiles: the
    per-cluster (sums (k, d), counts (k,)) of ``data``."""
    c_sq = sq_norms(centroids)
    sums = torch.zeros_like(centroids)
    counts = torch.zeros(k, dtype=torch.float32, device=data.device)
    for s in range(0, data.shape[0], chunk):
        xt = data[s : s + chunk]
        lbl = torch.argmin(pairwise_sq_l2(xt, centroids, c_sq=c_sq), dim=1)
        ts, tc = _segment_stats(xt, lbl, k)
        sums.add_(ts)
        counts.add_(tc)
    return sums, counts


def mean_update(sums, counts, centroids):
    """Each hit cluster's mean; empty clusters keep their centroid."""
    return torch.where((counts > 0)[:, None], sums / counts.clamp_min(1.0)[:, None], centroids)


def _to_sphere(c):
    """Spherical k-means: centroids stay on the unit sphere, so L2
    assignment == cosine assignment for unit data."""
    return c / c.norm(dim=1, keepdim=True).clamp_min(1e-12)


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
        sums, counts = lloyd_stats(data, centroids, k, chunk)
        new_c = _repair_empty(gen, mean_update(sums, counts, centroids), counts, data)
        if spherical:
            new_c = _to_sphere(new_c)
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


def training_sample(n: int, train_sample: int, seed: int) -> np.ndarray:
    """The sampled trainers' rows: ``train_sample`` of ``n`` drawn without
    replacement by numpy's generator seeded ``seed ^ 0x5A3B1E``, sorted
    (the reference's draw, so both packages train on the same rows)."""
    rng = np.random.default_rng(np.uint64(seed) ^ np.uint64(0x5A3B1E))
    return np.sort(rng.choice(n, size=train_sample, replace=False))


def run_kmeans_lloyd_sampled(data: torch.Tensor, k: int, max_iters: int, train_sample: int,
                             seed: int = 42, chunk: int = _ASSIGN_CHUNK,
                             spherical: bool = False) -> KMeansResult:
    """Lloyd trained on a seeded subsample (``training_sample``); every
    point is then assigned exactly. Past ~100 points per centroid more
    training rows move the centroids little and cost every sweep."""
    data = _check_data(data)
    n = data.shape[0]
    if train_sample >= n:
        return run_kmeans_lloyd(data, k, max_iters, seed=seed, chunk=chunk, spherical=spherical)
    if train_sample < k:
        raise ValueError(f"train_sample={train_sample} must be >= k={k} centroids")
    sel = torch.as_tensor(training_sample(n, train_sample, seed), device=data.device)
    res = run_kmeans_lloyd(data[sel], k, max_iters, seed=seed, chunk=chunk, spherical=spherical)
    labels, _ = assign_points(data, res.centroids, chunk=chunk)
    return KMeansResult(res.centroids, labels, res.iterations, res.converged)


def assign_points_host_chunked(data_host: np.ndarray, centroids, chunk_rows: int = 1 << 20,
                               method: str = "auto", device: DeviceLike = None) -> np.ndarray:
    """Assignment of a corpus held in host memory: ``chunk_rows`` rows at a
    time go to the device through one reused staging buffer (pinned when
    the device is a card), the tail zero-padded so every slice has the same
    shape, each assigned by ``assign_points(method=method)``; labels come
    back (4 bytes a row). The device holds one slice and the centroids.
    -> (n,) int32 labels."""
    dev = resolve_device(device)
    cent = torch.as_tensor(np.asarray(centroids, np.float32), device=dev) \
        if not isinstance(centroids, torch.Tensor) else centroids.to(dev, torch.float32)
    n, d = data_host.shape
    chunk_rows = min(chunk_rows, max(8, n))
    out = np.empty(n, np.int32)
    buf = torch.zeros((chunk_rows, d), dtype=torch.float32, pin_memory=dev.type == "cuda")
    buf_np = buf.numpy()
    slab = buf if dev.type == "cpu" else torch.empty((chunk_rows, d), dtype=torch.float32,
                                                      device=dev)
    for lo in range(0, n, chunk_rows):
        hi = min(lo + chunk_rows, n)
        buf_np[: hi - lo] = data_host[lo:hi]
        buf_np[hi - lo :] = 0.0
        if slab is not buf:
            slab.copy_(buf, non_blocking=True)
        lbl, _ = assign_points(slab, cent, method=method)
        # The copy back waits for the slice's work, so the buffer is free
        # for the next slice.
        out[lo:hi] = lbl[: hi - lo].cpu().numpy()
    return out


def run_kmeans_lloyd_host(data_host: np.ndarray, k: int, max_iters: int, train_sample: int,
                          seed: int = 42, chunk: int = _ASSIGN_CHUNK, spherical: bool = False,
                          chunk_rows: int = 1 << 20, device: DeviceLike = None) -> KMeansResult:
    """Host-corpus twin of ``run_kmeans_lloyd_sampled``: only the training
    subsample (the same rows) goes to the device; the exact assignment of
    every point runs through ``assign_points_host_chunked``. The result's
    labels are a CPU tensor."""
    dev = resolve_device(device)
    n = data_host.shape[0]
    train_sample = min(train_sample, n)
    if train_sample < k:
        raise ValueError(f"train_sample={train_sample} must be >= k={k} centroids")
    sub = data_host[training_sample(n, train_sample, seed)] if train_sample < n else data_host
    res = run_kmeans_lloyd(torch.as_tensor(np.asarray(sub, np.float32), device=dev), k,
                           max_iters, seed=seed, chunk=chunk, spherical=spherical)
    del sub
    labels = assign_points_host_chunked(data_host, res.centroids, chunk_rows=chunk_rows,
                                        device=dev)
    return KMeansResult(res.centroids, torch.from_numpy(labels), res.iterations, res.converged)


# ---------------------------------------------------------------------------
# Balanced Lloyd (occupancy-penalized assignment)
# ---------------------------------------------------------------------------


def _assign_dense_biased(data, centroids, bias, chunk: int = _ASSIGN_CHUNK):
    """Nearest centroid under an additive per-cluster ``bias`` (squared
    distance units): the argmin of dmat + bias per point (first index on a
    tie). Returns (labels int32, the TRUE squared distance to the chosen
    cell)."""
    c_sq = sq_norms(centroids)
    labels, dists = [], []
    for s in range(0, data.shape[0], chunk):
        dmat = pairwise_sq_l2(data[s : s + chunk], centroids, c_sq=c_sq)
        lbl = torch.argmin(dmat + bias[None, :], dim=1)
        labels.append(lbl.to(torch.int32))
        dists.append(dmat.gather(1, lbl[:, None])[:, 0])
    return torch.cat(labels), torch.cat(dists)


def _balanced_stats(data, centroids, pen, k: int, chunk: int):
    """One penalized assignment sweep: (sums, counts, per-cell sums of the
    chosen cells' squared distances, mean top-2 margin). The margin (the
    second-nearest minus the nearest distance, unpenalized) is the unit of
    the occupancy penalty: in high dimension margins are far smaller than
    the error level (distance concentration), so an error-scaled penalty
    would drown the geometry (the reference measured max/mean 148x at
    d 128).

    The per-cell sums are one one-hot product per tile, as the reference
    computes them, not ``index_add_``: on the card that sums with atomics
    in a varying order, and the controller and the clone-split amplify
    those roundings until two runs of one seed differ by several percent
    of inertia. The product gives the same result on every run."""
    c_sq = sq_norms(centroids)
    d = data.shape[1]
    stats = torch.zeros((k, d + 2), dtype=torch.float32, device=data.device)
    msum = torch.zeros((), dtype=torch.float32, device=data.device)
    for s in range(0, data.shape[0], chunk):
        xt = data[s : s + chunk]
        dmat = pairwise_sq_l2(xt, centroids, c_sq=c_sq)
        lbl = torch.argmin(dmat + pen[None, :], dim=1)
        dsel = dmat.gather(1, lbl[:, None])
        # [x | 1 | chosen distance] summed per cell: sums, counts, errs.
        rhs = torch.cat([xt, torch.ones_like(dsel), dsel], dim=1)
        stats.add_(torch.zeros_like(dmat).scatter_(1, lbl[:, None], 1.0).T @ rhs)
        if k >= 2:
            v2 = torch.topk(dmat, 2, dim=1, largest=False, sorted=True).values
            msum.add_(torch.sum(v2[:, 1] - v2[:, 0]))
    return stats[:, :d], stats[:, d], stats[:, d + 1], msum / data.shape[0]


def _balanced_loop(data, init_centroids, gen, k: int, max_iters: int, tol: float, chunk: int,
                   balance: float, spherical: bool = False):
    """Lloyd with an occupancy-penalized assignment (the reference's
    ``_lloyd_loop_balanced``). Returns (centroids, penalty, iterations,
    converged).

    * Integral controller in margin units: the penalty accumulates
      0.5 * min(balance, 1) * margin * clip(count/target - 1, -1, 1) per
      pass, mean-centred and clamped to +-4 margins (anti-windup; a
      proportional penalty oscillates, an error-scaled one drowns the
      geometry).
    * Clone-split: a point mass leaves a cell as one bloc, so when the
      heaviest cell holds > 2x target and the lightest < 0.6x target (and
      more than 5 passes remain), the lightest cell's centroid becomes the
      heaviest's plus a jitter of 0.1 of the donor's RMS radius, and takes
      its penalty."""
    n, d = data.shape
    centroids = init_centroids.to(torch.float32).clone()
    pen = torch.zeros(k, dtype=torch.float32, device=data.device)
    target = n / k
    rows = torch.arange(k, device=data.device)
    it, converged = 0, False
    while it < max_iters:
        sums, counts, errs, margin = _balanced_stats(data, centroids, pen, k, chunk)
        new_c = _repair_empty(gen, mean_update(sums, counts, centroids), counts, data)
        if spherical:
            new_c = _to_sphere(new_c)
        push = torch.clamp(counts / target - 1.0, -1.0, 1.0)
        new_pen = pen + 0.5 * min(balance, 1.0) * margin * push
        new_pen = new_pen - new_pen.mean()
        new_pen = torch.maximum(torch.minimum(new_pen, 4.0 * margin), -4.0 * margin)
        heavy, light = torch.argmax(counts), torch.argmin(counts)
        cell_rms = torch.sqrt(errs[heavy] / counts[heavy].clamp_min(1.0))
        jitter = 0.1 * cell_rms.clamp_min(1e-15) * torch.randn(
            d, generator=gen, device=data.device) / math.sqrt(d)
        split = ((counts[heavy] > 2.0 * target) & (counts[light] < 0.6 * target)
                 & (it < max_iters - 5)) & (rows == light)
        new_c = torch.where(split[:, None], (new_c[heavy] + jitter)[None, :], new_c)
        new_pen = torch.where(split, new_pen[heavy], new_pen)
        delta = float(_rms_delta(new_c, centroids))
        centroids, pen = new_c, new_pen
        it += 1
        if delta < tol:
            converged = True
            break
    return centroids, pen, it, converged


def run_kmeans_balanced(data: torch.Tensor, k: int, max_iters: int, balance: float = 1.0,
                        early_stop_threshold: Optional[float] = None, seed: int = 42,
                        chunk: int = _ASSIGN_CHUNK, spherical: bool = False) -> KMeansResult:
    """Occupancy-penalized full-batch Lloyd: bounds posting-list skew by
    construction (``balance`` scales the penalty's gain, saturating at 1).
    The final assignment keeps the trained penalty (an unpenalized pass
    would restore the skew). Early stopping is off unless
    ``early_stop_threshold`` is given: the controller keeps working after
    the centroids settle."""
    data = _check_data(data)
    tol = 0.0 if early_stop_threshold is None else early_stop_threshold
    init = kmeans_plus_plus_init(data, k, seed=seed)
    gen = make_generator(data.device, seed ^ 0x5EED)
    chunk = min(chunk, max(8, data.shape[0]))
    centroids, pen, iters, converged = _balanced_loop(
        data, init, gen, k, max_iters, tol, chunk, float(balance), spherical=spherical
    )
    labels, _ = _assign_dense_biased(data, centroids, pen, chunk=chunk)
    return KMeansResult(centroids, labels, iters, converged)


# ---------------------------------------------------------------------------
# Mini-batch
# ---------------------------------------------------------------------------


def _mini_batch_loop(data, init_centroids, gen, k: int, max_iters: int, tol: float,
                     batch_size: int, spherical: bool = False):
    """Mini-batch k-means from ``init_centroids``: per batch, a cluster the
    batch hit counts one more hit and moves by eta = 1/count toward the
    batch's mean of its points; empty clusters (cumulative count 0) are
    re-seeded. Batches are ``randint`` draws when n >= 16 * batch (the
    collisions are negligible) and draws without replacement otherwise.
    Returns (centroids, iterations, converged)."""
    n = data.shape[0]
    centroids = init_centroids.to(torch.float32).clone()
    counts = torch.zeros(k, dtype=torch.float32, device=data.device)
    it, converged = 0, False
    while it < max_iters:
        if n >= 16 * batch_size:
            idx = torch.randint(0, n, (batch_size,), generator=gen, device=data.device)
        else:
            idx = torch.randperm(n, generator=gen, device=data.device)[:batch_size]
        batch = data[idx]
        lbl = torch.argmin(pairwise_sq_l2(batch, centroids), dim=1)
        sums, bcounts = _segment_stats(batch, lbl, k)
        hit = bcounts > 0
        new_counts = counts + hit.to(torch.float32)
        eta = torch.where(hit, 1.0 / new_counts.clamp_min(1.0), 0.0)[:, None]
        mean = sums / bcounts.clamp_min(1.0)[:, None]
        new_c = torch.where(hit[:, None], (1.0 - eta) * centroids + eta * mean, centroids)
        new_c = _repair_empty(gen, new_c, new_counts, data)
        if spherical:
            new_c = _to_sphere(new_c)
        delta = float(_rms_delta(new_c, centroids))
        centroids, counts = new_c, new_counts
        it += 1
        if delta < tol:
            converged = True
            break
    return centroids, it, converged


def run_kmeans_mini_batch(data: torch.Tensor, k: int, max_iters: int,
                          early_stop_threshold: Optional[float] = _DEFAULT_TOL, seed: int = 42,
                          batch_size: Optional[int] = None, chunk: int = _ASSIGN_CHUNK,
                          refine_iters: int = 0, spherical: bool = False) -> KMeansResult:
    """Mini-batch k-means (the original engine's algorithm) with batches of
    ``mini_batch_size(n)`` = clamp(sqrt(n), 10, 256) points unless
    ``batch_size`` is given. ``refine_iters`` > 0 appends full-batch Lloyd
    passes: mini-batch alone leaves rarely hit clusters where the init put
    them, and a couple of Lloyd sweeps rebalance the posting lists. The
    final assignment is ``assign_points`` (K1 at large n*k)."""
    data = _check_data(data)
    n = data.shape[0]
    tol = _DEFAULT_TOL if early_stop_threshold is None else early_stop_threshold
    batch_size = min(mini_batch_size(n) if batch_size is None else batch_size, n)
    init = kmeans_plus_plus_init(data, k, seed=seed)
    gen = make_generator(data.device, seed ^ 0xB47C4)
    centroids, iters, converged = _mini_batch_loop(
        data, init, gen, k, max_iters, tol, batch_size, spherical=spherical
    )
    chunk = min(chunk, max(8, n))
    if refine_iters > 0:
        centroids, _, _ = _lloyd_loop(data, centroids, make_generator(data.device, seed ^ 0x5EF1E),
                                      k, refine_iters, 0.0, chunk, spherical=spherical)
    labels, _ = assign_points(data, centroids, chunk=chunk)
    return KMeansResult(centroids, labels, iters, converged)
