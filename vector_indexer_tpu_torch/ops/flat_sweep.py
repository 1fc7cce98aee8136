"""K3: fused exhaustive sweep with on-chip top-2-per-lane selection, and K7,
its window argmin alone.

Port of ``vector_indexer_tpu/ops/pallas/flat_sweep.py``: the f32 sweep
(precision 'highest') and the fixed-point int8 sweeps 'int8' and 'int8x1'
of ``flat_sweep_topk_plane``, and ``flat_sweep_minreduce``.

Window semantics: the NB = 128 * w table rows of step j are split into 128
strided windows; output lane c covers rows {j*NB + jj*128 + c : jj < w}.
``flat_sweep_topk_plane`` folds each step's window minimum (ties keep the
lower jj) into group j % C's per-lane (best, second) pair, so a FIXED
(nq, 2 * C * 128) plane leaves the kernel whatever n is. The true nearest
row is never lost; the expected top-k tail loss is k(k-1)w/2n plus
C(k,3)/(C*128)^2 (see the reference). ``flat_sweep_minreduce`` writes each
step's window minima instead: an (nq, nj * 128) survivor plane. Values
exclude the per-query |q|^2 (l2), which the caller adds after selection.

Masked (IVF dense) mode: a per-(query, 8-row block) mask sets unprobed rows
to +inf before the window minimum, so an unprobed row never shadows a
probed one.

Fixed-point int8 modes: the table is x ~= sx*x8 + (sx/SHIFT)*r8
(``quantize_table_int8``) and a query q ~= sq*q8 + (sq/SHIFT)*qr8
(``quantize_queries_int8``). 'int8' accumulates SHIFT*q8.x8 + q8.r8 +
qr8.x8 in int32 (the dropped qr8.r8 term is below the grid), 'int8x1' q8.x8
alone; the cross term is then ((float)t * row_mul) * sq with row_mul =
sx/SHIFT ('int8') or sx ('int8x1'). Row norms stay exact f32. The reference
quantizes the queries inside the kernel, once per grid step, only because a
Pallas kernel has no prologue; here the wrapper quantizes them once, and
the kernel and the plain version both take that output, so their integer
dots are equal. The quantizers reproduce the reference's arithmetic as XLA
evaluates it on the CPU, bit for bit: ``/127`` is a multiplication by
float32(1/127), and the residuals ``v - x8*s`` and ``q - q8*sq`` are one
fused multiply-add (emulated exactly in float64 here).

``plan_fused``, ``pick_window`` and ``pick_groups`` are the reference's
sizing rules, copied unchanged (the VMEM budget in ``plan_fused`` decides
whether the fused route is taken at all, so the port keeps it until the
H100 recalibration, ROADMAP Queue 1 item 10).
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels import build as kb

S = 128  # lanes per step
MASK_ALIGN = 8  # rows per mask element (== storage.layout.ALIGN)
PRECISIONS = ("highest", "int8", "int8x1")  # 'highest': the f32 sweep
# int8 fixed point: residual scales are 1/SHIFT of the main scales, so the
# three cross terms share one int32 sum, bounded by
# (SHIFT*127 + 2*(SHIFT/2))*127*d, which fits int32 up to d = INT8_MAX_D.
SHIFT = 64
INT8_MAX_D = 2048
assert (SHIFT * 127 + 2 * (SHIFT // 2)) * 127 * INT8_MAX_D < 2**31
_INV127 = float(np.float32(1.0 / 127.0))  # XLA's rewrite of '/ 127.0'
_QUANT_ROWS = 1 << 16  # table rows quantized per batch (bounds the f64 copy)


def _residual(v: torch.Tensor, x8: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """f32 v - x8 * s rounded once, as one fused multiply-add rounds it (the
    float64 product and difference are exact for these operands)."""
    return (v.double() - x8.double() * s.double()).float()


def _scale(v: torch.Tensor) -> torch.Tensor:
    """Per-row symmetric int8 scale max|row| / 127 (1e-30 guard), as a
    (rows, 1) f32 column."""
    ax = v.abs().amax(dim=1, keepdim=True)
    return ax.clamp_min(1e-30) * torch.tensor(_INV127, dtype=torch.float32, device=v.device)


def quantize_table_int8(vectors: torch.Tensor):
    """Per-row int8 quantization with an int8 fixed-point residual:
    x ~= sx*x8 + (sx/SHIFT)*r8, reconstruction error <= sx/(2*SHIFT). Zero
    (gap/tail) rows quantize to zeros. -> (x8 (n, d) int8, r8 (n, d) int8,
    sx (n,) f32), on ``vectors``' device."""
    x8s, r8s, sxs = [], [], []
    for s in range(0, vectors.shape[0], _QUANT_ROWS):
        v = vectors[s : s + _QUANT_ROWS].to(torch.float32)
        sx = _scale(v)
        x8 = torch.round(v / sx)
        r8 = torch.round(_residual(v, x8, sx) * (SHIFT / sx))
        x8s.append(x8.to(torch.int8))
        r8s.append(r8.to(torch.int8))
        sxs.append(sx[:, 0])
    if not x8s:
        z = torch.zeros(vectors.shape, dtype=torch.int8, device=vectors.device)
        return z, z.clone(), torch.zeros(0, dtype=torch.float32, device=vectors.device)
    return torch.cat(x8s), torch.cat(r8s), torch.cat(sxs)


def quantize_queries_int8(queries: torch.Tensor):
    """q ~= sq*q8 + (sq/SHIFT)*qr8 per query row, with the reference's
    in-kernel arithmetic. -> (q8 (nq, d) int8, qr8 (nq, d) int8, sq (nq,)
    f32)."""
    q = queries.to(torch.float32)
    sq = _scale(q)
    inv = torch.ones_like(sq) / sq
    q8 = torch.round(q * inv)
    qr8 = torch.round(_residual(q, q8, sq) * (inv * float(SHIFT)))
    return (q8.to(torch.int8).contiguous(), qr8.to(torch.int8).contiguous(),
            sq[:, 0].contiguous())


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


def _check(queries, vectors, row_norms, mask_b, vec_resid, scale_row, w: int, precision: str):
    if precision not in PRECISIONS:
        raise ValueError(f"flat sweep precision must be one of {PRECISIONS}, got {precision!r}")
    if queries.dtype != torch.float32:
        raise TypeError("flat sweep: queries must be float32")
    n_rows = vectors.shape[0]
    if precision == "highest":
        if vectors.dtype != torch.float32:
            raise TypeError("flat sweep precision 'highest' takes an f32 table")
    else:
        if vectors.dtype != torch.int8 or scale_row is None or scale_row.dtype != torch.float32:
            raise TypeError(f"flat sweep precision {precision!r} takes an int8 table and "
                            "f32 per-row scales (quantize_table_int8)")
        if scale_row.shape != (n_rows,):
            raise ValueError("flat sweep: scale_row must be (n_rows,)")
        if precision == "int8" and (vec_resid is None or vec_resid.dtype != torch.int8
                                    or vec_resid.shape != vectors.shape):
            raise TypeError("flat sweep precision 'int8' takes the int8 residual table")
        if vectors.shape[1] > INT8_MAX_D:
            raise ValueError(f"flat sweep int8 modes: d > {INT8_MAX_D} overflows int32")
    if queries.shape[1] != vectors.shape[1] or row_norms.shape[0] != n_rows:
        raise ValueError("flat sweep: shape mismatch")
    if mask_b is not None:
        nj = -(-n_rows // (S * w))
        if mask_b.shape[0] != queries.shape[0] or mask_b.shape[1] * MASK_ALIGN < nj * S * w:
            raise ValueError("flat sweep: mask must cover (nq, nj*NB/8)")


def _window_minima(queries, vectors, row_norms, mask_b, vec_resid, scale_row, *,
                   metric: str, w: int, precision: str):
    """Plain version of the sweep's shared step: yields (j0, wv, row) for
    batches of whole steps in ascending j, wv and row (nq, steps, 128) the
    window minima (first occurrence on ties) and their global rows. The
    int8 dots are float64 products of the int8 values, which are exact
    (|t| < 2^31 < 2^53), so they equal the kernel's int32 sums."""
    nq = queries.shape[0]
    n_rows = vectors.shape[0]
    NB = S * w
    nj = -(-n_rows // NB)
    dev = queries.device
    inf = float("inf")
    lane = torch.arange(S, device=dev, dtype=torch.int32)
    if precision != "highest":
        q8, qr8, sq = quantize_queries_int8(queries)
        q8d, qr8d = q8.double(), qr8.double()
        row_mul = scale_row * (1.0 / SHIFT) if precision == "int8" else scale_row
    steps = max(1, (1 << 25) // max(1, nq * NB))  # steps per batch
    for j0 in range(0, nj, steps):
        j1 = min(nj, j0 + steps)
        r0, r1 = j0 * NB, j1 * NB
        nrm = row_norms[r0:r1]
        if precision == "highest":
            cross = torch.matmul(queries, vectors[r0:r1].T)
        else:
            x8d = vectors[r0:r1].double()
            t = torch.matmul(q8d, x8d.T)
            if precision == "int8":
                t = t * SHIFT + (torch.matmul(q8d, vec_resid[r0:r1].double().T)
                                 + torch.matmul(qr8d, x8d.T))
            cross = (t.float() * row_mul[None, r0:r1]) * sq[:, None]
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
        base = (torch.arange(j0, j1, device=dev, dtype=torch.int32) * NB)[None, :, None]
        yield j0, wv, base + wj.to(torch.int32) * S + lane


def flat_sweep_topk_plane_reference(queries, vectors, row_norms, mask_b=None, vec_resid=None,
                                    scale_row=None, *, metric: str = "l2", w: int = 8,
                                    c_groups: int = 8, precision: str = "highest"):
    """Plain version of K3: the window minima of ``_window_minima`` folded
    step by step in ascending j."""
    _check(queries, vectors, row_norms, mask_b, vec_resid, scale_row, w, precision)
    nq = queries.shape[0]
    dev = queries.device
    v1 = torch.full((nq, c_groups, S), float("inf"), device=dev)
    i1 = torch.full((nq, c_groups, S), -1, dtype=torch.int32, device=dev)
    v2, i2 = v1.clone(), i1.clone()
    for j0, wv, wrow in _window_minima(queries, vectors, row_norms, mask_b, vec_resid,
                                       scale_row, metric=metric, w=w, precision=precision):
        for jl in range(wv.shape[1]):
            g = (j0 + jl) % c_groups
            val, row = wv[:, jl], wrow[:, jl]
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


def flat_sweep_topk_plane(queries, vectors, row_norms, mask_b=None, vec_resid=None,
                          scale_row=None, *, metric: str = "l2", w: int = 8, c_groups: int = 8,
                          precision: str = "highest"):
    """K3 -> (vals (nq, 2*C*128) f32, rows (nq, 2*C*128) int32), +inf / -1
    on unfilled entries. ``mask_b``: optional (nq, >= nj*NB/8) bool block
    mask. ``precision`` 'highest' sweeps the f32 ``vectors``; 'int8' /
    'int8x1' sweep the int8 ``vectors`` (x8) with ``scale_row`` (sx) and,
    for 'int8', ``vec_resid`` (r8) from ``quantize_table_int8``. CPU
    tensors -> plain version; CUDA tensors -> the kernel."""
    if queries.device.type == "cpu":
        return flat_sweep_topk_plane_reference(
            queries, vectors, row_norms, mask_b, vec_resid, scale_row, metric=metric, w=w,
            c_groups=c_groups, precision=precision,
        )
    _check(queries, vectors, row_norms, mask_b, vec_resid, scale_row, w, precision)
    nq, d = queries.shape
    n_rows = vectors.shape[0]
    x, norms = vectors.contiguous(), row_norms.contiguous()
    qr8 = sq = r8 = scales = None
    if precision == "highest":
        name, code, q = "flat_sweep_topk_plane", 0, queries.contiguous()
    else:
        if d % 4:
            raise ValueError("flat sweep int8 kernel: d must be a multiple of 4 (packed int8x4 dots)")
        name, code = f"flat_sweep_topk_plane[{precision}]", 1 if precision == "int8" else 2
        q, qr8, sq = quantize_queries_int8(queries)
        scales = scale_row.contiguous()
        if precision == "int8":
            r8 = vec_resid.contiguous()
        else:
            qr8 = None
    codes = [t for t in (q, x, qr8, r8) if t is not None and t.dtype == torch.int8]
    if any(t.data_ptr() % 4 for t in codes):
        raise ValueError("flat sweep int8 kernel: int8 rows must be 4-byte aligned")
    mask = None if mask_b is None else mask_b.to(torch.bool).contiguous()
    kb.require_cuda(name, *(t for t in (q, x, norms, qr8, sq, r8, scales, mask) if t is not None))
    cs = c_groups * S
    dev = queries.device
    v1 = torch.empty((nq, cs), dtype=torch.float32, device=dev)
    v2 = torch.empty_like(v1)
    i1 = torch.empty((nq, cs), dtype=torch.int32, device=dev)
    i2 = torch.empty_like(i1)
    kb.launch(
        name, "vitorch_flat_sweep_topk_plane",
        kb.ptr(q), kb.ptr(qr8), kb.ptr(sq), kb.ptr(x), kb.ptr(r8), kb.ptr(scales),
        kb.ptr(norms), kb.ptr(mask), nq, n_rows, d, w, c_groups,
        0 if mask is None else mask.shape[1], int(metric == "l2"), code,
        kb.ptr(v1), kb.ptr(i1), kb.ptr(v2), kb.ptr(i2), kb.stream_of(v1),
    )
    return torch.cat([v1, v2], dim=1), torch.cat([i1, i2], dim=1)


def flat_sweep_minreduce_reference(queries, vectors, row_norms, mask_b=None, *,
                                   metric: str = "l2", w: int = 8):
    """Plain version of K7: the window minima of every step, concatenated
    in ascending j."""
    _check(queries, vectors, row_norms, mask_b, None, None, w, "highest")
    parts = list(_window_minima(queries, vectors, row_norms, mask_b, None, None,
                                metric=metric, w=w, precision="highest"))
    nq = queries.shape[0]
    if not parts:
        return queries.new_zeros((nq, 0)), torch.zeros((nq, 0), dtype=torch.int32,
                                                       device=queries.device)
    vals = torch.cat([p[1].reshape(nq, -1) for p in parts], dim=1)
    rows = torch.cat([p[2].reshape(nq, -1) for p in parts], dim=1)
    return vals, rows


def flat_sweep_minreduce(queries, vectors, row_norms, mask_b=None, *, metric: str = "l2",
                         w: int = 8):
    """K7 -> (vals (nq, nj*128) f32, rows (nq, nj*128) int32): column
    j*128 + c holds step j's window minimum of lane c (f32 table, exact
    f32), +inf on masked and tail lanes. No serving path calls it (the
    reference keeps it for diagnostics); it is a mode of the K3 kernel
    that writes each step instead of folding it. CPU tensors -> plain
    version; CUDA tensors -> the kernel."""
    if queries.device.type == "cpu":
        return flat_sweep_minreduce_reference(queries, vectors, row_norms, mask_b,
                                              metric=metric, w=w)
    _check(queries, vectors, row_norms, mask_b, None, None, w, "highest")
    nq, d = queries.shape
    n_rows = vectors.shape[0]
    ops = [queries.contiguous(), vectors.contiguous(), row_norms.contiguous()]
    mask = None
    if mask_b is not None:
        mask = mask_b.to(torch.bool).contiguous()
        ops.append(mask)
    kb.require_cuda("flat_sweep_minreduce", *ops)
    width = -(-n_rows // (S * w)) * S
    vals = torch.empty((nq, width), dtype=torch.float32, device=queries.device)
    rows = torch.empty((nq, width), dtype=torch.int32, device=queries.device)
    kb.launch(
        "flat_sweep_minreduce", "vitorch_flat_sweep_minreduce",
        kb.ptr(ops[0]), kb.ptr(ops[1]), kb.ptr(ops[2]), kb.ptr(mask), nq, n_rows, d, w,
        0 if mask is None else mask.shape[1], int(metric == "l2"),
        kb.ptr(vals), kb.ptr(rows), kb.stream_of(vals),
    )
    return vals, rows
