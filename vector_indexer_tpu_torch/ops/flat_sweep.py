"""K3: fused exhaustive sweep with on-chip top-2-per-lane selection.

Port of ``vector_indexer_tpu/ops/pallas/flat_sweep.py`` (f32 mode).

Window semantics: the NB = 128 * w table rows of step j are split into 128
strided windows; output lane c covers rows {j*NB + jj*128 + c : jj < w}.
Each step's window minimum (ties keep the lower jj) folds into group
j % C's per-lane (best, second) pair, so a FIXED (nq, 2 * C * 128) plane
leaves the kernel whatever n is. The true nearest row is never lost; the
expected top-k tail loss is k(k-1)w/2n plus C(k,3)/(C*128)^2 (see the
reference). Values exclude the per-query |q|^2 (l2), which the caller adds
after selection.

Masked (IVF dense) mode: a per-(query, 8-row block) mask sets unprobed rows
to +inf before the window minimum, so an unprobed row never shadows a
probed one.

``plan_fused``, ``pick_window`` and ``pick_groups`` are the reference's
sizing rules, copied unchanged (the VMEM budget in ``plan_fused`` decides
whether the fused route is taken at all, so the port keeps it until the
H100 recalibration, ROADMAP Queue 1 item 10).
"""

from __future__ import annotations

import torch

from ..kernels import build as kb

S = 128  # lanes per step
MASK_ALIGN = 8  # rows per mask element (== storage.layout.ALIGN)
INT8_MAX_D = 2048  # int32 accumulator bound of the (unported) int8 modes


def pick_window(n_rows: int, k: int) -> int:
    """Window width w: powers of two in [8, 32], as large as the expected
    top-k loss k(k-1)w/2n (~<1%) allows."""
    w = 8
    while w < 32 and n_rows // (2 * w) >= 16384 and k * k * 2 * w <= n_rows:
        w *= 2
    return w


def pick_groups(n_rows: int, w: int, k: int) -> int:
    """Accumulator group count C (plane = 2*C*128 columns); shrinks only
    when the sweep has fewer steps than groups."""
    nj = -(-n_rows // (S * w))
    c = 8
    while c > 1 and c > nj:
        c //= 2
    return c


def plan_fused(n_rows: int, d: int, nq: int, k: int, precision: str = "highest"):
    """(w, q_tile, c_groups), or None when the fused route should not be
    used: the expected tail loss must stay within ~1.5% and the plane must
    hold 2k candidates. The byte budget is the reference's VMEM model."""
    int8_mode = precision in ("int8", "int8x1")
    if int8_mode and d > INT8_MAX_D:
        return None
    xb = {"int8": 2, "int8x1": 1}.get(precision, 4)
    trans = 3 if int8_mode else 2
    w = pick_window(n_rows, k)
    while w > 4 and 2 * (S * w) * d * xb > 6 << 20:
        w //= 2
    c = pick_groups(n_rows, w, k)
    cs = c * S
    loss = (k - 1) * w / (2.0 * max(n_rows, 1)) + (
        (k - 1) * max(k - 2, 0) / (2.0 * cs * cs)
    )
    if k > cs or loss > 0.015:
        return None
    for q_tile in (512, 256, 128, 64):
        nb = S * w
        need = (
            2 * nb * d * xb
            + q_tile * d * 4
            + 4 * q_tile * c * S * 4
            + trans * q_tile * nb * 4
        )
        if need <= 13 << 20:
            return w, min(q_tile, max(8, -(-nq // 8) * 8)), c
    return None


def _check(queries, vectors, row_norms, mask_b, w: int):
    if queries.dtype != torch.float32 or vectors.dtype != torch.float32:
        raise TypeError("flat_sweep_topk_plane takes f32 queries and table (f32 mode)")
    if queries.shape[1] != vectors.shape[1] or row_norms.shape[0] != vectors.shape[0]:
        raise ValueError("flat_sweep_topk_plane: shape mismatch")
    if mask_b is not None:
        nj = -(-vectors.shape[0] // (S * w))
        if mask_b.shape[0] != queries.shape[0] or mask_b.shape[1] * MASK_ALIGN < nj * S * w:
            raise ValueError("flat_sweep_topk_plane: mask must cover (nq, nj*NB/8)")


def flat_sweep_topk_plane_reference(queries, vectors, row_norms, mask_b=None, *,
                                    metric: str = "l2", w: int = 8, c_groups: int = 8):
    """Plain version of K3: the same planes, from batches of whole steps
    (matmul, tail/mask -> +inf, strided window min with first-occurrence
    ties) folded step by step in ascending j."""
    _check(queries, vectors, row_norms, mask_b, w)
    nq = queries.shape[0]
    n_rows = vectors.shape[0]
    NB = S * w
    nj = -(-n_rows // NB)
    dev = queries.device
    inf = float("inf")
    v1 = torch.full((nq, c_groups, S), inf, device=dev)
    i1 = torch.full((nq, c_groups, S), -1, dtype=torch.int32, device=dev)
    v2, i2 = v1.clone(), i1.clone()
    lane = torch.arange(S, device=dev, dtype=torch.int32)
    steps = max(1, (1 << 25) // max(1, nq * NB))  # steps per batch
    for j0 in range(0, nj, steps):
        j1 = min(nj, j0 + steps)
        r0, r1 = j0 * NB, j1 * NB
        x = vectors[r0:r1]
        nrm = row_norms[r0:r1]
        cross = torch.matmul(queries, x.T)
        if metric == "l2":
            dist = nrm[None, :] - 2.0 * cross
        else:
            dist = torch.where(nrm >= 1e29, nrm, torch.zeros_like(nrm))[None, :] - cross
        if dist.shape[1] < r1 - r0:  # tail step: rows past the table
            dist = torch.cat(
                [dist, dist.new_full((nq, r1 - r0 - dist.shape[1]), inf)], dim=1
            )
        if mask_b is not None:
            rows_ok = mask_b[:, r0 // MASK_ALIGN : r1 // MASK_ALIGN].bool()
            rows_ok = rows_ok.repeat_interleave(MASK_ALIGN, dim=1)
            dist = torch.where(rows_ok, dist, inf)
        wv, wj = dist.view(nq, j1 - j0, w, S).min(dim=2)  # first index on ties
        for jl in range(j1 - j0):
            j = j0 + jl
            g = j % c_groups
            val = wv[:, jl]
            row = (j * NB + wj[:, jl].to(torch.int32) * S + lane).expand(nq, S)
            b1 = val < v1[:, g]
            lv = torch.where(b1, v1[:, g], val)
            li = torch.where(b1, i1[:, g], row)
            v1[:, g] = torch.where(b1, val, v1[:, g])
            i1[:, g] = torch.where(b1, row, i1[:, g])
            b2 = lv < v2[:, g]
            v2[:, g] = torch.where(b2, lv, v2[:, g])
            i2[:, g] = torch.where(b2, li, i2[:, g])
    vals = torch.cat([v1.reshape(nq, -1), v2.reshape(nq, -1)], dim=1)
    rows = torch.cat([i1.reshape(nq, -1), i2.reshape(nq, -1)], dim=1)
    return vals, rows


def flat_sweep_topk_plane(queries, vectors, row_norms, mask_b=None, *,
                          metric: str = "l2", w: int = 8, c_groups: int = 8):
    """K3 -> (vals (nq, 2*C*128) f32, rows (nq, 2*C*128) int32), +inf / -1
    on unfilled entries. ``mask_b``: optional (nq, >= nj*NB/8) bool block
    mask. CPU tensors -> plain version; CUDA tensors -> the kernel."""
    if queries.device.type == "cpu":
        return flat_sweep_topk_plane_reference(
            queries, vectors, row_norms, mask_b, metric=metric, w=w, c_groups=c_groups
        )
    _check(queries, vectors, row_norms, mask_b, w)
    nq, d = queries.shape
    n_rows = vectors.shape[0]
    ops = [queries.contiguous(), vectors.contiguous(), row_norms.contiguous()]
    mask = None
    if mask_b is not None:
        mask = mask_b.to(torch.bool).contiguous()
        ops.append(mask)
    kb.require_cuda("flat_sweep_topk_plane", *ops)
    cs = c_groups * S
    dev = queries.device
    v1 = torch.empty((nq, cs), dtype=torch.float32, device=dev)
    v2 = torch.empty_like(v1)
    i1 = torch.empty((nq, cs), dtype=torch.int32, device=dev)
    i2 = torch.empty_like(i1)
    kb.launch(
        "flat_sweep_topk_plane", "vitorch_flat_sweep_topk_plane",
        kb.ptr(ops[0]), kb.ptr(ops[1]), kb.ptr(ops[2]), kb.ptr(mask),
        nq, n_rows, d, w, c_groups, 0 if mask is None else mask.shape[1],
        int(metric == "l2"), kb.ptr(v1), kb.ptr(i1), kb.ptr(v2), kb.ptr(i2),
        kb.stream_of(v1),
    )
    return torch.cat([v1, v2], dim=1), torch.cat([i1, i2], dim=1)
