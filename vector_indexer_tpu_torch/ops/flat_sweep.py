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

The kernel (``csrc/flat_sweep.cu``) runs the product on the tensor cores
and spreads each group's steps over ``sweep_splits`` blocks; the splits'
planes are merged in ascending split order (``merge_top2_planes`` is the
plain version of that merge), which gives the sequential fold's planes.
It takes any d whose rows are whole 16-byte units (f32 d % 4 == 0, int8
d % 16 == 0): the query tile stays in shared memory where it fits and
streams beside the table panels at larger d.

``plan_fused``, ``pick_window`` and ``pick_groups`` are the reference's
sizing rules, copied unchanged (the VMEM budget in ``plan_fused`` decides
whether the fused route is taken at all, so the port keeps it until the
H100 recalibration, ROADMAP Queue 1 item 4).
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
_QT = 64  # queries per kernel block (the mask's tile OR)
_QUANT_ROWS = 1 << 16  # table rows quantized per batch (bounds the f64 copy)


def _residual(v: torch.Tensor, x8: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """f32 v - x8 * s rounded once, as one fused multiply-add rounds it (the
    float64 product and difference are exact for these operands)."""
    return (v.double() - x8.double() * s.double()).float()


def _scale(v: torch.Tensor) -> torch.Tensor:
    """Per-row symmetric int8 scale max|row| / 127 (1e-30 guard), as a
    (rows, 1) f32 column. The factor is an f32 value, so the Python scalar
    multiplies in f32 exactly as an f32 tensor would, without a host-to-
    device copy (which would wait for the stream)."""
    ax = v.abs().amax(dim=1, keepdim=True)
    return ax.clamp_min(1e-30) * _INV127


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


def _kernel_rows_ok(d: int, precision: str) -> None:
    """The kernel reads rows by TMA, whose row stride is a multiple of 16
    bytes."""
    if d <= 0 or d * (4 if precision == "highest" else 1) % 16:
        raise ValueError(f"flat sweep kernel: d = {d} in precision {precision!r} is not a "
                         "whole number of 16-byte units")


def sweep_splits(nq: int, n_rows: int, w: int, c_groups: int, sms: int) -> int:
    """Blocks per group over which the kernel spreads a group's steps: two
    waves of one block per SM, at most one block per step. (At nq 256 this
    makes the sweep ~3x faster than one block per group; at nq 1000 it is
    within 2% either way; PERF.md.)"""
    blocks = -(-nq // _QT) * c_groups
    steps = -(-(-(-n_rows // (S * w))) // c_groups)  # steps of group 0, the most
    return max(1, min(-(-2 * sms // blocks), steps))


def merge_top2_planes(parts):
    """Plain version of the kernel's merge: fold each later split's best,
    then its second, into the first split's (best, second) pairs with
    strict '<'. ``parts``: [(vals (nq, 2 cs), rows (nq, 2 cs)), ...] in
    ascending split order. The fold keeps the two smallest values under
    the order (value, position), and every split's positions precede the
    next split's, so this equals the sequential fold over all steps, rows
    included."""
    vals, rows = parts[0]
    cs = vals.shape[1] // 2
    state = (vals[:, :cs], rows[:, :cs], vals[:, cs:], rows[:, cs:])
    for pv, pr in parts[1:]:
        state = _fold(*state, pv[:, :cs], pr[:, :cs])
        state = _fold(*state, pv[:, cs:], pr[:, cs:])
    b1, r1, b2, r2 = state
    return torch.cat([b1, b2], dim=1), torch.cat([r1, r2], dim=1)


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


def _fold(b1, r1, b2, r2, val, row):
    """One fold step: candidates (val, row) enter the (best, second) pairs
    (b1, r1), (b2, r2) with strict '<', the displaced best falling through
    to second. -> the updated (b1, r1, b2, r2)."""
    better = val < b1
    lv = torch.where(better, b1, val)
    li = torch.where(better, r1, row)
    sec = lv < b2
    return (torch.where(better, val, b1), torch.where(better, row, r1),
            torch.where(sec, lv, b2), torch.where(sec, li, r2))


def _fold_minima(v1, i1, v2, i2, j, val, row):
    """Fold step j's window minima (val, row: (nq, 128)) into group planes
    (v1, i1, v2, i2: (nq, C, 128)) in place."""
    g = j % v1.shape[1]
    v1[:, g], i1[:, g], v2[:, g], i2[:, g] = _fold(v1[:, g], i1[:, g], v2[:, g], i2[:, g],
                                                   val, row)


def _empty_planes(nq: int, c_groups: int, dev):
    v1 = torch.full((nq, c_groups, S), float("inf"), device=dev)
    i1 = torch.full((nq, c_groups, S), -1, dtype=torch.int32, device=dev)
    return v1, i1, v1.clone(), i1.clone()


def _planes_out(v1, i1, v2, i2):
    nq = v1.shape[0]
    return (torch.cat([v1.reshape(nq, -1), v2.reshape(nq, -1)], dim=1),
            torch.cat([i1.reshape(nq, -1), i2.reshape(nq, -1)], dim=1))


def flat_sweep_topk_plane_reference(queries, vectors, row_norms, mask_b=None, vec_resid=None,
                                    scale_row=None, *, metric: str = "l2", w: int = 8,
                                    c_groups: int = 8, precision: str = "highest"):
    """Plain version of K3: the window minima of ``_window_minima`` folded
    step by step in ascending j."""
    _check(queries, vectors, row_norms, mask_b, vec_resid, scale_row, w, precision)
    planes = _empty_planes(queries.shape[0], c_groups, queries.device)
    for j0, wv, wrow in _window_minima(queries, vectors, row_norms, mask_b, vec_resid,
                                       scale_row, metric=metric, w=w, precision=precision):
        for jl in range(wv.shape[1]):
            _fold_minima(*planes, j0 + jl, wv[:, jl], wrow[:, jl])
    return _planes_out(*planes)


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
    _kernel_rows_ok(d, precision)
    x, norms = vectors.contiguous(), row_norms.contiguous()
    qr8 = sq = r8 = scales = qsplit = None
    if precision == "highest":
        name, code, q = "flat_sweep_topk_plane", 0, queries.contiguous()
        qsplit = torch.empty(2 * nq * d, dtype=torch.float32, device=q.device)
    else:
        name, code = f"flat_sweep_topk_plane[{precision}]", 1 if precision == "int8" else 2
        q, qr8, sq = quantize_queries_int8(queries)
        scales = scale_row.contiguous()
        if precision == "int8":
            r8 = vec_resid.contiguous()
        else:
            qr8 = None
    mask, tile_any = _masks(mask_b, nq, n_rows, w)
    ops = [t for t in (q, x, norms, qr8, sq, r8, scales, mask, tile_any) if t is not None]
    kb.require_cuda(name, *ops)
    _check_aligned(q, x, qr8, r8, norms, scales, tile_any)
    cs = c_groups * S
    dev = queries.device
    splits = sweep_splits(nq, n_rows, w, c_groups,
                          torch.cuda.get_device_properties(dev).multi_processor_count)
    part = torch.empty(4 * splits * nq * cs, dtype=torch.int32, device=dev)
    vals = torch.empty((nq, 2 * cs), dtype=torch.float32, device=dev)
    rows = torch.empty((nq, 2 * cs), dtype=torch.int32, device=dev)
    kb.launch(
        name, "vitorch_flat_sweep_topk_plane",
        kb.ptr(q), kb.ptr(qr8), kb.ptr(sq), kb.ptr(x), kb.ptr(r8), kb.ptr(scales),
        kb.ptr(norms), kb.ptr(mask), kb.ptr(tile_any), nq, n_rows, d, w, c_groups, splits,
        0 if mask is None else mask.shape[1], 0 if tile_any is None else tile_any.shape[1],
        int(metric == "l2"), code, kb.ptr(qsplit), kb.ptr(part), kb.ptr(vals), kb.ptr(rows),
        kb.stream_of(vals),
    )
    return vals, rows


def _check_aligned(*tensors):
    """The operands the kernel reads by TMA or in 8- and 16-byte words."""
    if any(t is not None and t.data_ptr() % 16 for t in tensors):
        raise ValueError("flat sweep kernel: queries, table, norms, scales and tile mask "
                         "must start 16-byte aligned")


def _masks(mask_b, nq: int, n_rows: int, w: int):
    """The kernel's masks: the (nq, mcols) byte mask, and its OR over each
    64-query tile, (query tiles, nj * NB / 8) bytes, which lets the kernel
    skip a table tile that no query of the block probes. (None, None) when
    unmasked."""
    if mask_b is None:
        return None, None
    mask = mask_b.to(torch.bool).contiguous()
    if mask.shape[1] % 16 or mask.data_ptr() % 16:  # the kernel reads 8-byte words of rows
        padded = mask.new_zeros((mask.shape[0], -(-mask.shape[1] // 16) * 16))
        padded[:, : mask.shape[1]] = mask
        mask = padded
    cols = -(-n_rows // (S * w)) * S * w // MASK_ALIGN
    nqt = -(-nq // _QT)
    m = mask[:, :cols]
    if nqt * _QT > nq:
        m = torch.cat([m, m.new_zeros((nqt * _QT - nq, cols))])
    return mask, m.reshape(nqt, _QT, cols).any(dim=1).to(torch.uint8).contiguous()


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
    j*128 + c holds step j's window minimum of lane c (f32 table; the
    kernel's cross term is 3xTF32, within the bound stated in
    csrc/flat_sweep.cu of the f32 dot), +inf on masked and tail lanes. No serving path calls it (the
    reference keeps it for diagnostics); it is a mode of the K3 kernel
    that writes each step instead of folding it. CPU tensors -> plain
    version; CUDA tensors -> the kernel."""
    if queries.device.type == "cpu":
        return flat_sweep_minreduce_reference(queries, vectors, row_norms, mask_b,
                                              metric=metric, w=w)
    _check(queries, vectors, row_norms, mask_b, None, None, w, "highest")
    nq, d = queries.shape
    n_rows = vectors.shape[0]
    _kernel_rows_ok(d, "highest")
    q, x, norms = queries.contiguous(), vectors.contiguous(), row_norms.contiguous()
    mask, tile_any = _masks(mask_b, nq, n_rows, w)
    ops = [t for t in (q, x, norms, mask, tile_any) if t is not None]
    kb.require_cuda("flat_sweep_minreduce", *ops)
    _check_aligned(q, x, norms, tile_any)
    width = -(-n_rows // (S * w)) * S
    qsplit = torch.empty(2 * nq * d, dtype=torch.float32, device=queries.device)
    vals = torch.empty((nq, width), dtype=torch.float32, device=queries.device)
    rows = torch.empty((nq, width), dtype=torch.int32, device=queries.device)
    kb.launch(
        "flat_sweep_minreduce", "vitorch_flat_sweep_minreduce",
        kb.ptr(q), kb.ptr(x), kb.ptr(norms), kb.ptr(mask), kb.ptr(tile_any), nq, n_rows, d, w,
        0 if mask is None else mask.shape[1], 0 if tile_any is None else tile_any.shape[1],
        int(metric == "l2"), kb.ptr(qsplit), kb.ptr(vals), kb.ptr(rows), kb.stream_of(vals),
    )
    return vals, rows
