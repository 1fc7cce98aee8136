#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA GPU and check it.

    python3 chip_smoke.py                  # on the first CUDA device
    python3 chip_smoke.py --kernels-only   # phases 1-3 only

``--kernels-only`` stops after phase 3 and prints no JSON lines. Copied into
the root of another checkout (an unpacked earlier commit), the script
builds, checks and times that checkout's kernels with this script's code:
the way two kernel designs are compared in one call.

Phases (each prints its own lines; any failure exits non-zero):

0. No CUDA device: exit 1 without a result.
1. Environment: torch / CUDA versions and the card's name and power limit.
2. Build: compile vector_indexer_tpu_torch/csrc with nvcc (seconds printed).
3. Kernels: each CUDA kernel of the paths below, in every table mode (K1
   assign_argmin; K2 stream_distances bf16 / int8 / f32; K4
   stream_fused_plane bf16 / int8; K3 flat_sweep_topk_plane f32 / int8 /
   int8x1, flat and masked; K5 stream_shared_plane bf16 / int8 / f32; K7
   flat_sweep_minreduce at w 32; K6 ivf_gather_distances at n_probe 32)
   vs its plain PyTorch version on the same device inputs at the paths'
   shapes, with the tolerance stated beside it; l2 timed with CUDA
   events (K1, K2, K5 and K6, whose wrappers can take the host longer to
   issue than the card to run, over a replayed CUDA graph of the calls,
   the event loop beside it), ip checked; K2 with and without the slots'
   valid counts (nval2d), K1 with at most 1e-3 of its labels different,
   each a near-tie; K6 with the sharing factor of its probed lists. It
   first prints nvcc's register, shared-memory and spill report for every
   instantiation of K1-K6. Each kernel gets its
   bound (the larger of the bytes it must move over 3.35 TB/s and its
   operations over the peak of their type) and, where one PyTorch call
   computes its product, that call's time (``library_ms``).
4. Main path: ``bindings.build`` on a SIFT1M-shaped corpus (1M x 128 f32,
   clustered, seed 42), ``bindings.load``, then ``search_device`` with
   method 'auto' at the n_probe values whose resolved programs cover K2, K4
   and K3; recall and the share of the exact top-100 returned, against an
   exact ground truth computed on the card; a single-query
   ``VectorIndexer.search_sync`` self-hit; the peak device memory. The launch counters are reset just before this phase and read
   just after it: every kernel must have run inside it. Then the
   hierarchical assignment (the build's route past nlist 8192) is timed
   beside K1 at 1M x 16,384 x 128 with their label agreement, and K1 (the
   build's final assignment, 1M x 4,000 x 128), K3 (f32 / int8 / int8x1;
   masked at n_probe 128 with the dense program's query order, and
   unmasked), K4 (bf16 / int8, one query tile at n_probe 32) and K2 bf16
   (one query tile at n_probe 8, with and without nval2d) are checked
   against their plain versions and timed at these shapes (nq 1000 over
   the 1M table); the JSON line reports them. Then 200 of the
   queries are searched again on the CPU, where every kernel runs its
   plain version, at one n_probe per route and the largest: the card's
   results must agree rank by rank.
5. Offload (on the index phase 4 saved): ``bindings.load(...,
   resident='offload')`` keeps the f32 table off the card (peak device
   memory over the load below its bytes) and serves ``auto`` through K2
   int8 (n_probe 8) and K4 int8 (32) with the exact host re-rank; ``auto``
   at 1024 queries and a huge probed footprint takes K5 int8 and is held
   to method 'stream'; ``offload_rerank='device'`` is held to exact f32
   distances; ``VectorIndex.offload(rerank='none')`` frees at least the f32
   table's bytes; the device-resident 'stream_shared' (K5 bf16),
   'stream_shared_exact' (K5 f32) and 'stream_exact' (K2 f32) return
   'stream''s sets; and 200 queries searched on the CPU agree rank by rank
   in modes 'host' and 'none'. Launch counters are reset at the phase's
   start and every kernel mode above must launch in it.
6. Exhaustive, int8 and gather methods (on the index phase 4 saved):
   ``search_device(method=...)`` for 'flat' (K3 f32), 'flat_exact' (plain),
   'flat_int8' / 'flat_int8x1' (K3 int8 modes), 'dense_int8' /
   'dense_int8x1' at n_probe 128 (masked), and 'gather' (plain) and
   'gather_dma' (K6) at n_probe 8 and 32: QPS by CUDA events, R@1/10/100
   and overlaps against phase 4's exact ground truth, the gates below, a
   launch check on the phase's counters (every new mode but K7, which no
   serving path runs), and 200 queries again on the CPU for 'flat',
   'flat_int8', 'dense_int8' and 'gather_dma'.

The line before the last is a JSON object describing each kernel; the last
line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import importlib.util
import json
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

_BS = "vector_indexer_tpu/ops/pallas/block_stream.py"
_FS = "vector_indexer_tpu/ops/pallas/flat_sweep.py"
SOURCES = {  # kernel (mode) -> (source, TPU kernel it replaces)
    "assign_argmin": ("vector_indexer_tpu_torch/csrc/assign.cu",
                      "vector_indexer_tpu/ops/pallas/assign.py:80"),
    **{f"stream_distances[{m}]": ("vector_indexer_tpu_torch/csrc/block_stream.cu",
                                  f"{_BS}:611") for m in ("bf16", "int8", "f32")},
    **{f"stream_fused_plane[{m}]": ("vector_indexer_tpu_torch/csrc/block_stream.cu",
                                    f"{_BS}:773") for m in ("bf16", "int8")},
    "flat_sweep_topk_plane": ("vector_indexer_tpu_torch/csrc/flat_sweep.cu", f"{_FS}:473"),
    **{f"stream_shared_plane[{m}]": ("vector_indexer_tpu_torch/csrc/block_stream_shared.cu",
                                     f"{_BS}:1174") for m in ("bf16", "int8", "f32")},
    **{f"flat_sweep_topk_plane[{m}]": ("vector_indexer_tpu_torch/csrc/flat_sweep.cu",
                                       f"{_FS}:473") for m in ("int8", "int8x1")},
    "flat_sweep_minreduce": ("vector_indexer_tpu_torch/csrc/flat_sweep.cu", f"{_FS}:573"),
    "ivf_gather_distances": ("vector_indexer_tpu_torch/csrc/ivf_gather.cu",
                             "vector_indexer_tpu/ops/pallas/ivf_gather.py:197"),
}
# The kernels phase 4 (the device-resident main path) must launch; phase 5
# (offload and the other stream methods) and phase 6 (the exhaustive, int8
# and gather methods) must launch theirs. K7 has no serving caller (the
# reference runs it only in its tests), so only phase 3 launches it.
MAIN_KERNELS = ("assign_argmin", "stream_distances[bf16]", "stream_fused_plane[bf16]",
                "flat_sweep_topk_plane")
OFFLOAD_KERNELS = ("stream_distances[int8]", "stream_distances[f32]", "stream_fused_plane[int8]",
                   "stream_shared_plane[bf16]", "stream_shared_plane[int8]",
                   "stream_shared_plane[f32]")
PHASE6_KERNELS = ("flat_sweep_topk_plane[int8]", "flat_sweep_topk_plane[int8x1]",
                  "ivf_gather_distances")
RTOL = 1e-5  # of the magnitude of the terms each distance is summed from
# K1 (3xTF32): the share of points whose label may differ from the plain
# version's exact f32 argmin (each one a near-tie, check_k1).
K1_DIFF_SHARE = 1e-3
# nvcc's register / spill report is printed for every instantiation of these.
PTXAS_KERNELS = ("assign_argmin_kernel", "stream_distances_kernel", "flat_sweep_kernel",
                 "stream_fused_plane_kernel", "stream_shared_plane_kernel", "ivf_gather_kernel")
# Published peaks of one H100 SXM (dense, 700 W), for each kernel's bound:
# the larger of its bytes over the memory rate and its operations over the
# peak rate of their type (f32 outside the tensor cores; TF32 and s8 on them).
HBM_BYTES_S = 3.35e12
F32_FLOP_S = 67e12
TF32_FLOP_S = 495e12
INT8_OP_S = 1979e12
# Share of the exact top-k that the largest n_probe must return. There
# 'auto' takes the fused dense sweep (K3), whose fixed plane keeps one row
# per lane of each step's window: neighbours that sit in the same few
# contiguous posting lists collide there, so the plane (the reference's
# design, reproduced exactly) returns ~0.89 of the exact top-100 on this
# corpus. Whether the kernels match their plain versions is checked rank
# by rank on the CPU (NQ_TWIN) instead.
OVERLAP_FLOOR = 0.85
NQ_TWIN = 200  # queries searched again on the CPU (plain versions)
TWIN_SAME_FLOOR = 0.95  # the rest may differ only by near-tie swaps
N, NQ, K = 1_000_000, 1000, 100  # corpus rows (SIFT1M), queries per batch, neighbours
NQ_SHARED = 1024  # the shared stream's batch gate (dispatch.SHARED_MIN_NQ)
# Phase 5 gates: the host-re-ranked offload returns the device-resident
# path's top-100 within 0.01 of overlap (the reference measured identical
# sets at this shape); K5's task budget may drop a few far probes
# (the reference documents 0.92-0.98 of the exact path's sets before the
# re-rank), so shared may trail 'stream' by 0.03; the device re-rank's
# distances are within 1e-4 relative at the 99th percentile (the
# reference documents ~1e-5); the rank-only int8 mode keeps R@10 >= 0.95.
OFFLOAD_OVERLAP_SLACK = 0.01
SHARED_OVERLAP_SLACK = 0.03
DEVICE_RERANK_P99_REL = 1e-4
NONE_R10_FLOOR = 0.95
# Phase 6: (method, n_probe) runs (n_probe is unused by the flat methods),
# the runs searched again on the CPU, and the gates. flat_exact is exact;
# flat sweeps the cluster-permuted table with K3's plane, so it loses
# neighbours that share a step's lanes as the masked sweep does (the K3
# route's OVERLAP_FLOOR) but never the nearest; 'int8' keeps the
# reference's own top-10 floor (0.97, tests/test_flat_sweep.py, isotropic
# data). 'int8x1' (no residual term) is restated from the reference's 0.92:
# on this corpus (1000 points per center, spread 4) its one-level grid is
# coarser than the gaps between near neighbours, which costs top-10 overlap
# whatever computes it; the CPU twins (PHASE6_TWINS) hold both int8x1 routes
# to their plain versions at this shape. gather_dma is the exact gather
# with K6's distances.
PHASE6_RUNS = (("flat", 1), ("flat_exact", 1), ("flat_int8", 1), ("flat_int8x1", 1),
               ("dense_int8", 128), ("dense_int8x1", 128), ("gather", 8), ("gather", 32),
               ("gather_dma", 8), ("gather_dma", 32))
PHASE6_TWINS = (("flat", 1), ("flat_int8", 1), ("flat_int8x1", 1), ("dense_int8", 128),
                ("dense_int8x1", 128), ("gather_dma", 32))
FLAT_EXACT_FLOOR = 0.999
FLAT_R1_FLOOR = 0.99
INT8_TOP10_FLOORS = {"flat_int8": 0.97, "flat_int8x1": 0.85}
GATHER_SAME_FLOOR = 0.99


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(torch, fn, reps: int = 5) -> float:
    """Mean CUDA-event milliseconds of fn() over ``reps`` after one warm-up."""
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def graph_ms(torch, fn, reps: int = 20) -> float:
    """Mean CUDA-event milliseconds of fn() over ``reps`` calls captured in
    one CUDA graph and replayed (after one warm-up replay): the device time
    of fn's launches without the host's time to issue them, which a loop
    of calls measures instead once the host is the slower side."""
    s = torch.cuda.Stream()
    with torch.cuda.stream(s):
        fn()
        torch.cuda.synchronize()
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g, stream=s):
            for _ in range(reps):
                fn()
    g.replay()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    g.replay()
    t1.record()
    torch.cuda.synchronize()
    del g
    return t0.elapsed_time(t1) / reps


def bound(nbytes: float, ops: float, rate: float) -> dict:
    """The least time the card could take for a function that must move
    ``nbytes`` and do ``ops`` operations of a type peaking at ``rate``."""
    t_bytes, t_ops = nbytes / HBM_BYTES_S * 1e3, ops / rate * 1e3
    return dict(bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations")


def assign_bound(n: int, k: int, d: int) -> dict:
    """K1: x and c read once, the (n,) scores and labels written; 2 n k d
    operations three times over (3xTF32 on the tensor cores, as the kernel
    computes them)."""
    return bound((n + k) * d * 4 + n * 8, 3 * 2.0 * n * k * d, TF32_FLOP_S)


def stream_bound(q, table, grid, out_bytes: int) -> dict:
    """K2 / K4: each probed block's valid rows (and norms) read once, the
    queries, the outputs; 2 d operations per valid (query, row) pair."""
    import torch

    nval = grid["nval"].clamp_min(0)
    used = nval > 0
    rows = torch.zeros(table.vecs.shape[0] // table.chunk, dtype=torch.int64, device=q.device)
    rows.scatter_(0, grid["blk"][used].long(), nval[used].long())  # a block's count is its own
    d = q.shape[1]
    nbytes = int(rows.sum()) * (d * table.vecs.element_size() + 4) + q.numel() * 4 + out_bytes
    return bound(nbytes, 2.0 * float(nval.sum()) * d, F32_FLOP_S)


def sweep_bound(q, n_rows: int, mask, precision: str, out_bytes: int) -> dict:
    """K3 / K7: the probed rows (any query's mask block set; all rows when
    unmasked) read once in the table's type (x8 + r8 for 'int8') with their
    norms (and scales), the mask, the queries, the outputs; 2 d operations
    per probed (query, row) pair, three products for f32 (3xTF32 on the
    tensor cores, as the kernel computes it) and for 'int8' (s8)."""
    nq, d = q.shape
    if mask is None:
        rows, pairs = n_rows, nq * n_rows
    else:
        m = mask[:, : -(-n_rows // 8)]
        rows, pairs = 8 * int(m.any(dim=0).sum()), 8 * int(m.sum())
    per_row = {"highest": 4 * d + 4, "int8": 2 * d + 8, "int8x1": d + 8}[precision]
    nbytes = rows * per_row + (0 if mask is None else mask.numel()) + q.numel() * 4 + out_bytes
    ops = (1 if precision == "int8x1" else 3) * 2.0 * pairs * d
    return bound(nbytes, ops, TF32_FLOP_S if precision == "highest" else INT8_OP_S)


def shared_bound(table, tasks) -> dict:
    """K5: each distinct block of the used tasks read once (rows and
    norms), the used tasks' query rows, the whole plane written; per used
    task 8 queries x chunk rows x d, as TF32 products on the tensor cores:
    two (bf16 / int8 rows are exact in TF32 against the split query),
    three for f32 rows (3xTF32)."""
    import torch

    q_share, d = tasks.qc.shape[1], tasks.qc.shape[2]
    used = tasks.blk >= 0
    n_used = int(used.sum())
    n_blocks = int(torch.unique(tasks.blk[used]).numel())
    item = table.vecs.element_size()
    nbytes = (n_blocks * table.chunk * (d * item + 4) + n_used * q_share * d * 4
              + tasks.qc.shape[0] * q_share * table.chunk * 4)
    ops = (3 if item == 4 else 2) * 2.0 * n_used * q_share * table.chunk * d
    return bound(nbytes, ops, TF32_FLOP_S)


def library(torch, fn, what: str) -> dict:
    """One PyTorch call timed beside a kernel as a yardstick (never used by
    the port): ``library_ms`` and what it computes; None where it fails."""
    try:
        return dict(library_ms=cuda_ms(torch, fn), library_call=what)
    except (RuntimeError, TypeError) as e:
        log(f"  library call {what} unavailable: {e}")
        return dict(library_ms=None, library_call=None)


def gpu_line() -> str:
    """The first card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def load_datasets():
    spec = importlib.util.spec_from_file_location("datasets", ROOT / "benchmarks" / "datasets.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Check:
    def __init__(self):
        self.failures = []

    def __call__(self, ok: bool, what: str) -> None:
        log(f"  [{'ok' if ok else 'FAIL'}] {what}")
        if not ok:
            self.failures.append(what)


# ---------------------------------------------------------------------------
# Phase 3: each kernel vs its plain version
# ---------------------------------------------------------------------------


def check_k1(x, cent):
    """K1 vs its plain version: labels equal except near-ties, distances
    within RTOL of |x|^2 + |c|^2. -> (ok, label differences, max |err|)."""
    import torch
    from vector_indexer_tpu_torch.ops import assign

    lk, dk = assign.assign_argmin(x, cent)
    lp, dp = assign.assign_argmin_reference(x, cent)
    torch.cuda.synchronize()
    x_sq = (x * x).sum(1)
    c_sq = (cent * cent).sum(1)
    same = lk == lp
    err = (dk - dp).abs()
    tol = RTOL * (x_sq + c_sq[lp.long()])
    diff = torch.nonzero(~same).flatten()
    xd = x[diff].double()
    sk = c_sq[lk[diff].long()].double() - 2 * (xd * cent[lk[diff].long()].double()).sum(1)
    sp = c_sq[lp[diff].long()].double() - 2 * (xd * cent[lp[diff].long()].double()).sum(1)
    ties_ok = bool(((sk - sp).abs() <= tol[diff].double()).all())
    return bool((err[same] <= tol[same]).all()) and ties_ok, len(diff), float(err.max())


def stream_grid(q, table, c, c_sq, lengths, n_probe: int, metric: str,
                worst_case: bool = False):
    """The stream program's task grid for these queries (worst-case slots
    for the exact methods), and the magnitude of the terms each distance is
    summed from (l2 |q-c|^2 + |r|^2, which bounds 2|q-c||r|; ip
    |q.c| + |q||r|; r is the stored, dequantized row)."""
    import torch
    from vector_indexer_tpu_torch.index import programs
    from vector_indexer_tpu_torch.ops import block_stream as bs

    t_fixed = bs.per_query_slots(lengths, n_probe, worst_case=worst_case, chunk=table.chunk)
    probe = programs._probe(q, c, c_sq, n_probe)
    blk, cid, nval, bias = bs.build_task_grid(q, table, probe, t_fixed, metric)
    lane = torch.arange(table.chunk, device=q.device)
    valid = lane[None, None, :] < nval[:, :, None]
    nrm = table.norms[blk[:, :, None] * table.chunk + lane[None, None, :]]
    nrm = torch.where(valid, nrm, torch.zeros_like(nrm))
    if metric == "l2":
        term = bias[:, :, None].abs() + nrm
    else:
        term = bias[:, :, None].abs() + q.norm(dim=1)[:, None, None] * nrm.sqrt()
    return dict(t_fixed=t_fixed, blk=blk, cid=cid, nval=nval, bias=bias, valid=valid, term=term)


def k2_args(q, table, grid):  # scales go by keyword
    return (q, table.cent, grid["cid"], grid["blk"], grid["bias"], table.vecs, table.norms)


def k4_args(q, table, grid):
    return (q, table.cent, grid["cid"], grid["blk"], grid["nval"], grid["bias"],
            table.vecs, table.norms)


def k2_kw(table, grid, metric: str, nval: bool) -> dict:
    """K2's keywords; ``nval``: pass the slots' valid counts (the kernel
    then reads only valid rows and writes +inf past them)."""
    return dict(chunk=table.chunk, metric=metric, scales=table.scales,
                nval2d=grid["nval"] if nval else None)


def check_k2(q, table, grid, metric: str, nval: bool = False):
    """K2 vs its plain version on the valid lanes (with ``nval``, also
    +inf past each slot's valid count on both sides). -> (ok, max |err|)."""
    import torch
    from vector_indexer_tpu_torch.ops import block_stream as bs

    args = k2_args(q, table, grid)
    kw = k2_kw(table, grid, metric, nval)
    dist_k = bs.stream_distances(*args, **kw)
    dist_p = bs.stream_distances_reference(*args, **kw)
    torch.cuda.synchronize()
    valid = grid["valid"]
    err = (dist_k - dist_p).abs()[valid]
    ok = bool((err <= RTOL * grid["term"][valid]).all())
    if nval:
        ok = ok and bool(torch.isinf(dist_k[~valid]).all()) and bool(torch.isinf(dist_p[~valid]).all())
    return ok, float(err.max())


def check_k4(q, table, grid, metric: str):
    """K4 vs its plain version: planes within RTOL of the query's term
    scale, and a different slot only where its distance is a near-tie.
    -> (ok, slot differences, max |err|)."""
    import torch
    from vector_indexer_tpu_torch.ops import block_stream as bs

    kw = dict(chunk=table.chunk, groups=bs.pick_stream_groups(table.chunk), metric=metric,
              scales=table.scales)
    pk, sk = bs.stream_fused_plane(*k4_args(q, table, grid), **kw)
    pp, sp = bs.stream_fused_plane_reference(*k4_args(q, table, grid), **kw)
    dist_p = bs.stream_distances_reference(*k2_args(q, table, grid), chunk=table.chunk,
                                           metric=metric, scales=table.scales)
    torch.cuda.synchronize()
    scale = grid["term"].flatten(1).max(dim=1).values[:, None]
    fin = torch.isfinite(pp)
    same_fin = bool((torch.isfinite(pk) == fin).all())
    err = (pk - pp).abs()[fin]
    vals_ok = bool((err <= RTOL * scale.expand_as(pp)[fin]).all())
    mism = torch.nonzero((sk != sp) & fin)
    qi, col = mism[:, 0], mism[:, 1]
    alt = dist_p[qi, sk[qi, col].long(), col % table.chunk]
    ties_ok = bool(((alt - pp[qi, col]).abs() <= RTOL * scale[qi, 0]).all())
    return same_fin and vals_ok and ties_ok, len(mism), float(err.max()) if err.numel() else 0.0


def shared_tasks(q, table, c, c_sq, lengths, n_probe: int, t_fixed: int, t_cap: int,
                 metric: str):
    """K5's task list for these queries (one tile), as
    block_stream_search_shared builds it."""
    from vector_indexer_tpu_torch.index import programs
    from vector_indexer_tpu_torch.ops import block_stream as bs

    probe = programs._probe(q, c, c_sq, n_probe)
    blk, _, nval, _ = bs.build_task_grid(q, table, probe, t_fixed, metric)
    return bs.build_shared_tasks(q, table, blk, nval, t_cap, metric)


def k5_args(table, tasks):
    return (tasks.qc, tasks.blk, tasks.scl, table.vecs, table.norms)


def check_k5(table, tasks, metric: str):
    """K5 vs its plain version on the rows of the used tasks (unused tasks'
    rows are never read): within RTOL of |qc|^2 + |r|^2, which bounds both
    |r|^2 and 2|qc.r|. -> (ok, max |err|)."""
    import torch
    from vector_indexer_tpu_torch.ops import block_stream as bs

    kw = dict(chunk=table.chunk, metric=metric)
    pk = bs.stream_shared_plane(*k5_args(table, tasks), **kw)
    pp = bs.stream_shared_plane_reference(*k5_args(table, tasks), **kw)
    torch.cuda.synchronize()
    used = tasks.blk >= 0
    blk = tasks.blk[used].long()
    nrm = table.norms.view(-1, table.chunk)[blk][:, None, :]
    qsq = (tasks.qc[used] ** 2).sum(-1)[:, :, None]
    err = (pk[used] - pp[used]).abs()
    return bool((err <= RTOL * (qsq + nrm)).all()), float(err.max())


def check_k3(q, vectors, row_norms, mask, metric: str, w: int, C: int,
             precision: str = "highest", tables=None):
    """K3 vs its plain version (compare_planes). ``precision`` 'int8' /
    'int8x1' sweeps ``tables`` = (x8, r8, sx) (``vectors`` is then only the
    f32 table the scale is taken from); both sides dequantize the same exact
    integer dots with the same two f32 products, so their values should be
    equal and a different row is a tie only at an equal value."""
    from vector_indexer_tpu_torch.ops import flat_sweep as fs

    kw = dict(metric=metric, w=w, c_groups=C, precision=precision)
    args = (q, vectors, row_norms, mask) if tables is None else (
        q, tables[0], row_norms, mask, tables[1] if precision == "int8" else None, tables[2])
    vk, rk = fs.flat_sweep_topk_plane(*args, **kw)
    vp, rp = fs.flat_sweep_topk_plane_reference(*args, **kw)
    return compare_planes(q, vectors, row_norms, (vk, rk), (vp, rp), metric,
                          exact_ties=precision != "highest")


def check_k7(q, vectors, row_norms, mask, metric: str, w: int):
    """K7 vs its plain version over the whole survivor plane
    (compare_planes)."""
    from vector_indexer_tpu_torch.ops import flat_sweep as fs

    kw = dict(metric=metric, w=w)
    return compare_planes(q, vectors, row_norms,
                          fs.flat_sweep_minreduce(q, vectors, row_norms, mask, **kw),
                          fs.flat_sweep_minreduce_reference(q, vectors, row_norms, mask, **kw),
                          metric)


def compare_planes(q, vectors, row_norms, kernel, plain, metric: str, exact_ties: bool = False):
    """A sweep kernel's (values, rows) plane vs its plain version's: the same
    +inf entries with the same rows; elsewhere, short of the padding rows'
    sentinel (>= 1e29), values within RTOL of |x|^2 + 2|q||x| and a
    different row only at a tie (an equal value if ``exact_ties``, else a
    float64 near-tie). -> (ok, row differences, max |err|)."""
    import torch

    (vk, rk), (vp, rp) = kernel, plain
    torch.cuda.synchronize()
    real = row_norms < 1e29
    max_norm = float(row_norms[real].max())
    scale = (max_norm + 2 * q.norm(dim=1) * max_norm ** 0.5)[:, None]
    fin = torch.isfinite(vp)
    same_fin = bool((torch.isfinite(vk) == fin).all()) and bool((rk == rp)[~fin].all())
    ok = fin & (vp < 1e29)
    err = (vk - vp).abs()[ok]
    vals_ok = bool((err <= RTOL * scale.expand_as(vp)[ok]).all())
    mism = torch.nonzero((rk != rp) & ok)
    qi, col = mism[:, 0], mism[:, 1]
    if exact_ties:
        ties_ok = bool((vk[qi, col] == vp[qi, col]).all())
    else:
        ties_ok = near_ties(q, vectors, row_norms, qi, rk[qi, col], rp[qi, col], metric, scale)
    return same_fin and vals_ok and ties_ok, len(mism), float(err.max()) if err.numel() else 0.0


def near_ties(q, vectors, row_norms, qi, ra, rb, metric: str, scale) -> bool:
    """Whether rows ra and rb score within 2 RTOL * scale of each other for
    queries qi (float64 distances without |q|^2)."""
    ra, rb, qd = ra.long(), rb.long(), q[qi].double()
    wgt = 2.0 if metric == "l2" else 1.0
    na = row_norms[ra].double() if metric == "l2" else 0.0
    nb = row_norms[rb].double() if metric == "l2" else 0.0
    da = na - wgt * (qd * vectors[ra].double()).sum(1)
    db = nb - wgt * (qd * vectors[rb].double()).sum(1)
    return bool(((da - db).abs() <= 2 * RTOL * scale[qi, 0].double()).all())


def gather_operands(q, idx, n_probe: int):
    """K6's operands for these queries on an index, as gather_dma_program
    builds them: (starts, lengths) of the probed lists, max_len, budget."""
    from vector_indexer_tpu_torch.index import programs

    c, c_sq = idx._device_tables()
    starts, lengths = idx._list_tables()
    probe = programs._probe(q, c, c_sq, n_probe)
    return starts[probe], lengths[probe], max(1, idx.layout.max_list_len), idx._budget_for(n_probe)


def check_k6(q, vectors, starts, lengths, max_len: int, budget: int, metric: str):
    """K6 vs its plain version slot by slot: equal rows and holes, distances
    within RTOL of |q|^2 + |x|^2 (l2) or |q||x| (ip). -> (ok, max |err|)."""
    import torch
    from vector_indexer_tpu_torch.ops import ivf_gather as ig

    kw = dict(max_len=max_len, budget=budget, metric=metric)
    dk, rk = ig.ivf_gather_distances(q, vectors, starts, lengths, **kw)
    dp, rp = ig.ivf_gather_distances_reference(q, vectors, starts, lengths, **kw)
    torch.cuda.synchronize()
    rows_ok = bool((rk == rp).all()) and bool((torch.isinf(dk) == (rp < 0)).all())
    filled = rp >= 0
    xn = vectors.norm(dim=1)[rp.clamp_min(0).long()]
    qn = q.norm(dim=1)[:, None]
    term = qn * qn + xn * xn if metric == "l2" else qn * xn
    err = (dk - dp).abs()[filled]
    return rows_ok and bool((err <= RTOL * term[filled]).all()), float(err.max())


def sweep_mask(q, idx, n_probe: int, w: int):
    """The dense program's probe mask over 8-row blocks, padded to whole
    sweep steps."""
    import torch
    from vector_indexer_tpu_torch.index import programs
    from vector_indexer_tpu_torch.ops import flat_sweep as fs

    n_rows = idx.layout.vectors.shape[0]
    block_run, c_ord, c_sq_ord = idx._run_tables()
    NB = fs.S * w
    mask = torch.zeros((q.shape[0], -(-n_rows // NB) * NB // 8), dtype=torch.bool,
                       device=q.device)
    mask[:, : n_rows // 8] = programs._block_mask(q, c_ord, c_sq_ord, block_run, n_probe)
    return mask


def k1_entry(torch, x, cent, check, where: str) -> dict:
    """K1 vs its plain version (check_k1, and at most K1_DIFF_SHARE of the
    labels different), timed beside the plain version and torch.matmul's
    product alone, in this order, in one run."""
    from vector_indexer_tpu_torch.ops import assign

    n, k, d = x.shape[0], cent.shape[0], x.shape[1]
    ok, n_diff, err = check_k1(x, cent)
    share = n_diff / n
    check(ok and share <= K1_DIFF_SHARE,
          f"K1 assign_argmin vs plain ({where}, {n} x {k} x {d}): {n_diff} label differences "
          f"(share {share:.2e} <= {K1_DIFF_SHARE:g}), all near-ties (|score gap| <= "
          f"{RTOL:g}*(|x|^2+|c|^2)); max |dist err| {err:.3e}")
    reps = 20 if n * k <= 1 << 28 else 3
    entry = dict(
        max_abs_err=err, label_diffs=n_diff, label_diff_share=share,
        ms=graph_ms(torch, lambda: assign.assign_argmin(x, cent), reps),
        events_ms=cuda_ms(torch, lambda: assign.assign_argmin(x, cent)),
        plain_ms=cuda_ms(torch, lambda: assign.assign_argmin_reference(x, cent), reps=2),
        shape=f"{n} x {k} x {d}", **assign_bound(n, k, d),
        **library(torch, lambda: torch.matmul(x, cent.T), "torch.matmul(x, c.T), product only"),
    )
    log(f"  K1 {where} {entry['shape']}: kernel {entry['ms']:.3f} ms (graph replay; event loop "
        f"{entry['events_ms']:.3f}), plain {entry['plain_ms']:.3f} "
        f"ms, torch.matmul {entry['library_ms']} ms, bound {entry['bound_ms']:.3f} ms "
        f"({entry['bound_by']}); {n_diff} label differences ({share:.2e})")
    return entry


def kernel_phase(torch, np, xb, xq, check, results, dev):
    from vector_indexer_tpu_torch.index import dispatch
    from vector_indexer_tpu_torch.index.ivf import IvfIndex
    from vector_indexer_tpu_torch.kernels import build as kb
    from vector_indexer_tpu_torch.ops import assign, block_stream as bs, flat_sweep as fs
    from vector_indexer_tpu_torch.storage.vector_store import VectorStore

    for line in ptxas_lines(kb.build_info().get("log", ""), PTXAS_KERNELS):
        log(f"  ptxas {line}")
    # K1 at the build's final-assignment shape: 65,536 points x 4,000 x 128.
    x = torch.as_tensor(xb[:65536], device=dev)
    g = torch.Generator(device=dev).manual_seed(1)
    cent = x[torch.randperm(x.shape[0], generator=g, device=dev)[:4000]]
    cent = cent + 0.1 * torch.randn(cent.shape, generator=g, device=dev)
    results["assign_argmin"] = k1_entry(torch, x, cent, check, "phase 3")
    del x, cent

    # A 262,144-vector index gives K2/K4 a real stream table and K3 a real
    # layout with a real probe mask.
    xs = xb[:262_144]
    store = VectorStore(external_ids=np.arange(len(xs), dtype=np.uint64), vectors=xs)
    t0 = time.perf_counter()
    idx = IvfIndex.fit(store, seed=7, max_iters=10, device=dev)
    table = idx._stream_table()
    torch.cuda.synchronize()
    log(f"  kernel-phase index: n={len(xs)} nlist={idx.num_clusters} chunk={table.chunk} "
        f"m_pad={table.m_pad} built in {time.perf_counter() - t0:.2f}s")
    q = torch.as_tensor(xq[:256], device=dev)
    c, c_sq = idx._device_tables()
    nqk = q.shape[0]

    # K2 (n_probe 8) and K4 (n_probe 32) at the main path's l2 shapes
    # (timed), then the same inputs under ip (checked only): on the bf16
    # table (device-resident 'stream'), the int8 table (offload) and, for
    # K2 alone, the f32 table with worst-case slots ('stream_exact').
    tables = {"bf16": table, "int8": bs.build_stream_table(idx.layout, idx.centroids, torch.int8),
              "f32": bs.build_stream_table(idx.layout, idx.centroids, torch.float32)}
    cases = [("bf16", 8, "K2"), ("bf16", 32, "K4"), ("int8", 8, "K2"), ("int8", 32, "K4"),
             ("f32", 8, "K2")]
    for metric in ("l2", "ip"):
        for mode, n_probe, kern in cases:
            tb = tables[mode]
            grid = stream_grid(q, tb, c, c_sq, idx.layout.lengths, n_probe, metric,
                               worst_case=mode == "f32")
            what = (f"({mode}, {metric}, nq={nqk}, n_probe={n_probe}, t_fixed={grid['t_fixed']}, "
                    f"chunk={tb.chunk})")
            if kern == "K2":
                name = f"stream_distances[{mode}]"
                for nval in (False, True):
                    ok, err = check_k2(q, tb, grid, metric, nval)
                    check(ok, f"K2 {name} vs plain {what}, {'valid rows only (nval2d)' if nval else 'every lane'}: "
                              f"|err| <= {RTOL:g}*(term magnitude) on valid lanes"
                              f"{', +inf past nval' if nval else ''}; max |err| {err:.3e}")
                kw = k2_kw(tb, grid, metric, True)
                fn_k = lambda: bs.stream_distances(*k2_args(q, tb, grid), **kw)
                fn_p = lambda: bs.stream_distances_reference(*k2_args(q, tb, grid), **kw)
                kw_all = k2_kw(tb, grid, metric, False)
                fn_all = lambda: bs.stream_distances(*k2_args(q, tb, grid), **kw_all)
            else:
                name = f"stream_fused_plane[{mode}]"
                ok, n_mism, err = check_k4(q, tb, grid, metric)
                G = bs.pick_stream_groups(tb.chunk)
                check(ok, f"K4 {name} vs plain {what}, G={G}: planes within "
                          f"{RTOL:g}*(query term scale), {n_mism} slot differences all "
                          f"near-ties; max |err| {err:.3e}")
                kw = dict(chunk=tb.chunk, groups=G, metric=metric, scales=tb.scales)
                fn_k = lambda: bs.stream_fused_plane(*k4_args(q, tb, grid), **kw)
                fn_p = lambda: bs.stream_fused_plane_reference(*k4_args(q, tb, grid), **kw)
            if metric == "l2":
                out_bytes = nqk * (grid["t_fixed"] if kern == "K2" else
                                   2 * bs.pick_stream_groups(tb.chunk)) * tb.chunk * (4 if kern == "K2" else 8)
                results[name] = dict(
                    max_abs_err=err, plain_ms=cuda_ms(torch, fn_p),
                    ms=graph_ms(torch, fn_k) if kern == "K2" else cuda_ms(torch, fn_k),
                    shape=f"nq={nqk} t_fixed={grid['t_fixed']} chunk={tb.chunk} d=128"
                          + (" (ms: valid rows only, nval2d)" if kern == "K2" else ""),
                    library_ms=None, library_call=None, **stream_bound(q, tb, grid, out_bytes),
                )
                if kern == "K2":
                    results[name].update(events_ms=cuda_ms(torch, fn_k), all_lanes_ms=graph_ms(torch, fn_all))

    # K5 at the shape stream_params(shared=True) gives a 1024-query batch at
    # the smallest power-of-two n_probe the shared gate passes on this index
    # (worst-case slots and budget for the f32 table: 'stream_shared_exact').
    lengths = np.asarray(idx.layout.lengths)
    n_probe = shared_n_probe(lengths, idx.num_clusters, bs.pick_chunk(lengths, 128, 2))
    check(n_probe is not None, f"the shared gate opens on the kernel-phase index (n_probe {n_probe})")
    for metric in ("l2", "ip"):
        for mode, tb in (tables.items() if n_probe else ()):
            exact = mode == "f32"
            _, t_fixed, q_tile, t_cap = dispatch.stream_params(
                lengths, 128, tb.vecs.element_size(), NQ_SHARED, n_probe, exact=exact,
                shared=True, chunk=tb.chunk)
            qs = torch.as_tensor(xq[:q_tile], device=dev)
            tasks = shared_tasks(qs, tb, c, c_sq, lengths, n_probe, t_fixed, t_cap, metric)
            name = f"stream_shared_plane[{mode}]"
            ok, err = check_k5(tb, tasks, metric)
            check(ok, f"K5 {name} vs plain ({metric}, q_tile={q_tile} of nq={NQ_SHARED}, "
                      f"n_probe={n_probe}, t_fixed={t_fixed}, t_cap={t_cap}, used tasks "
                      f"{int((tasks.blk >= 0).sum())}): |err| <= {RTOL:g}*(|qc|^2+|r|^2) on "
                      f"used tasks; max |err| {err:.3e}")
            if metric == "l2":
                kw = dict(chunk=tb.chunk, metric=metric)
                fn_k5 = lambda: bs.stream_shared_plane(*k5_args(tb, tasks), **kw)
                used = tasks.blk >= 0
                n_used = int(used.sum())
                n_blocks = int(torch.unique(tasks.blk[used]).numel())
                results[name] = dict(
                    library_ms=None, library_call=None, **shared_bound(tb, tasks),
                    max_abs_err=err, ms=graph_ms(torch, fn_k5), events_ms=cuda_ms(torch, fn_k5),
                    plain_ms=cuda_ms(torch, lambda: bs.stream_shared_plane_reference(
                        *k5_args(tb, tasks), **kw)),
                    shape=f"t_cap={t_cap} (q_tile={q_tile}, n_probe={n_probe}) chunk={tb.chunk} "
                          f"d=128, {n_used} used tasks over {n_blocks} blocks",
                )
    del tables

    # K3 on the index's layout table, unmasked (flat) and masked (dense at
    # n_probe = 64, the main path's shape); l2 timed, ip checked only.
    lay = idx.layout
    n_rows = lay.vectors.shape[0]
    # The main path's sizing rule (a small table falls back to w=8).
    w, _, C = fs.plan_fused(n_rows, 128, nqk, 100) or (8, 0, fs.pick_groups(n_rows, 8, 100))
    mask = sweep_mask(q, idx, 64, w)
    errs, times = [], {}
    for metric in ("l2", "ip"):
        for label, m in (("flat", None), ("masked", mask)):
            ok, n_mism, err = check_k3(q, lay.vectors, lay.row_norms, m, metric, w, C)
            check(ok, f"K3 flat_sweep_topk_plane vs plain ({metric}, {label}, nq={nqk}, "
                      f"n_rows={n_rows}, w={w}, C={C}): values within {RTOL:g}*(|x|^2+2|q||x|), "
                      f"{n_mism} row differences all near-ties; max |err| {err:.3e}")
            if metric == "l2":
                kw = dict(metric=metric, w=w, c_groups=C)
                errs.append(err)
                times[label] = (
                    cuda_ms(torch, lambda: fs.flat_sweep_topk_plane(
                        q, lay.vectors, lay.row_norms, m, **kw)),
                    cuda_ms(torch, lambda: fs.flat_sweep_topk_plane_reference(
                        q, lay.vectors, lay.row_norms, m, **kw)),
                )
                log(f"  K3 {label}: kernel {times[label][0]:.3f} ms, plain {times[label][1]:.3f} ms")
    cs_bytes = nqk * 2 * C * fs.S * 8
    results["flat_sweep_topk_plane"] = dict(
        max_abs_err=max(errs), ms=times["masked"][0], plain_ms=times["masked"][1],
        flat_ms=times["flat"][0], flat_plain_ms=times["flat"][1],
        shape=f"nq={nqk} n_rows={n_rows} w={w} C={C} (ms: masked, n_probe=64)",
        **sweep_bound(q, n_rows, mask, "highest", cs_bytes),
        **library(torch, lambda: torch.matmul(q, lay.vectors.T),
                  "torch.matmul(q, x.T), dense product only"),
    )

    # K3's int8 modes over the layout's int8 twin (quantized on the card),
    # at the plans plan_fused gives them, flat and masked at n_probe 64.
    tabs = idx._sweep_int8_tables()
    for prec in ("int8", "int8x1"):
        wp, _, Cp = fs.plan_fused(n_rows, 128, nqk, 100, precision=prec) or (w, 0, C)
        mask_p = mask if wp == w else sweep_mask(q, idx, 64, wp)
        errs, times = [], {}
        for metric in ("l2", "ip"):
            for label, m in (("flat", None), ("masked", mask_p)):
                ok, n_mism, err = check_k3(q, lay.vectors, lay.row_norms, m, metric, wp, Cp,
                                           prec, tabs)
                check(ok, f"K3 flat_sweep_topk_plane[{prec}] vs plain ({metric}, {label}, "
                          f"nq={nqk}, n_rows={n_rows}, w={wp}, C={Cp}): values within "
                          f"{RTOL:g}*(|x|^2+2|q||x|), {n_mism} row differences all at equal "
                          f"values; max |err| {err:.3e}")
                if metric == "l2":
                    kw = dict(metric=metric, w=wp, c_groups=Cp, precision=prec)
                    args = (q, tabs[0], lay.row_norms, m, tabs[1] if prec == "int8" else None,
                            tabs[2])
                    errs.append(err)
                    times[label] = (
                        cuda_ms(torch, lambda: fs.flat_sweep_topk_plane(*args, **kw)),
                        cuda_ms(torch, lambda: fs.flat_sweep_topk_plane_reference(*args, **kw)),
                    )
                    log(f"  K3 [{prec}] {label}: kernel {times[label][0]:.3f} ms, plain "
                        f"{times[label][1]:.3f} ms")
        q8 = fs.quantize_queries_int8(q)[0]
        results[f"flat_sweep_topk_plane[{prec}]"] = dict(
            max_abs_err=max(errs), ms=times["masked"][0], plain_ms=times["masked"][1],
            flat_ms=times["flat"][0], flat_plain_ms=times["flat"][1],
            shape=f"nq={nqk} n_rows={n_rows} w={wp} C={Cp} (ms: masked, n_probe=64)",
            **sweep_bound(q, n_rows, mask_p, prec, nqk * 2 * Cp * fs.S * 8),
            **library(torch, lambda: torch._int_mm(q8, tabs[0].T),
                      "torch._int_mm(q8, x8.T), the q8.x8 product only"),
        )
    del tabs

    # K7 at w = 32, flat and masked (n_probe 64). No serving path runs it,
    # so its launch count in the JSON line is this block's.
    kb.reset_launch_counts()
    mask32 = sweep_mask(q, idx, 64, 32)
    errs = []
    for metric in ("l2", "ip"):
        for label, m in (("flat", None), ("masked", mask32)):
            ok, n_mism, err = check_k7(q, lay.vectors, lay.row_norms, m, metric, 32)
            check(ok, f"K7 flat_sweep_minreduce vs plain ({metric}, {label}, nq={nqk}, "
                      f"n_rows={n_rows}, w=32): values within {RTOL:g}*(|x|^2+2|q||x|), "
                      f"{n_mism} row differences all near-ties; max |err| {err:.3e}")
            errs.append(err)
    kw = dict(metric="l2", w=32)
    nj32 = -(-n_rows // (fs.S * 32))
    results["flat_sweep_minreduce"] = dict(
        **sweep_bound(q, n_rows, None, "highest", nqk * nj32 * fs.S * 8),
        **library(torch, lambda: torch.matmul(q, lay.vectors.T), "torch.matmul(q, x.T), product only"),
        max_abs_err=max(errs),
        ms=cuda_ms(torch, lambda: fs.flat_sweep_minreduce(q, lay.vectors, lay.row_norms, **kw)),
        plain_ms=cuda_ms(torch, lambda: fs.flat_sweep_minreduce_reference(
            q, lay.vectors, lay.row_norms, **kw)),
        shape=f"nq={nqk} n_rows={n_rows} w=32 (ms: flat)",
    )
    results["flat_sweep_minreduce"]["launches"] = kb.launch_counts()["flat_sweep_minreduce"]
    del mask32

    # K6 at n_probe 32 (the gather_dma program's operands for these queries).
    starts, lengths, max_len, budget = gather_operands(q, idx, 32)
    errs = []
    for metric in ("l2", "ip"):
        ok, err = check_k6(q, lay.vectors, starts, lengths, max_len, budget, metric)
        check(ok, f"K6 ivf_gather_distances vs plain ({metric}, nq={nqk}, n_probe=32, "
                  f"max_len={max_len}, budget={budget}): equal rows and holes in every slot, "
                  f"distances within {RTOL:g}*(terms); max |err| {err:.3e}")
        errs.append(err)
    results["ivf_gather_distances"] = k6_entry(torch, q, lay.vectors, starts, lengths, max_len,
                                               budget, max(errs))
    for name, r in results.items():
        log(f"  {name}: kernel {r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms, bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}), library {r['library_ms']} ms"
            + (f", every lane {r['all_lanes_ms']:.3f} ms" if "all_lanes_ms" in r else "")
            + (f", event loop {r['events_ms']:.3f} ms" if "events_ms" in r else "")
            + f" ({r['shape']})")


def k6_entry(torch, q, vectors, starts, lengths, max_len: int, budget: int, err: float) -> dict:
    """K6 (l2) timed over a replayed CUDA graph of the whole wrapper (the
    task inversion included), the event loop and the plain version beside
    it; its bound counts each probed list once. The sharing factor is the
    probed rows over the distinct lists' rows: how many queries read a list
    on average."""
    from vector_indexer_tpu_torch.ops import ivf_gather as ig

    kw = dict(max_len=max_len, budget=budget, metric="l2")
    fn = lambda: ig.ivf_gather_distances(q, vectors, starts, lengths, **kw)
    dk6, _ = fn()
    list_rows = torch.zeros(vectors.shape[0] + 1, dtype=torch.int64, device=q.device)
    list_rows.scatter_(0, starts.flatten().long(), lengths.flatten().long())  # each list once
    distinct = int(list_rows.sum())
    k6_bytes = distinct * q.shape[1] * 4 + q.numel() * 4 + dk6.numel() * 8
    sharing = float(lengths.sum()) / max(distinct, 1)
    return dict(
        **bound(k6_bytes, 2.0 * float(lengths.sum()) * q.shape[1], F32_FLOP_S),
        library_ms=None, library_call=None, max_abs_err=err,
        ms=graph_ms(torch, fn), events_ms=cuda_ms(torch, fn),
        plain_ms=cuda_ms(torch, lambda: ig.ivf_gather_distances_reference(
            q, vectors, starts, lengths, **kw)),
        sharing=sharing,
        shape=f"nq={q.shape[0]} n_probe={starts.shape[1]} budget={budget} max_len={max_len} "
              f"d={q.shape[1]}, sharing factor {sharing:.2f}",
    )


def hierarchical_vs_k1(torch, xb_dev, check, n: int = N, k: int = 16_384):
    """The build's assignment past nlist 8192 (``assign_points(method=
    'hierarchical')``) beside K1 on n points x k centroids (random points
    of the corpus, jittered): both times, their label agreement, and the
    hierarchical labels' distances, which are never below K1's exact argmin
    beyond rounding (RTOL of |x|^2 + |c|^2)."""
    from vector_indexer_tpu_torch.kernels import build as kb
    from vector_indexer_tpu_torch.models import kmeans
    from vector_indexer_tpu_torch.ops import assign

    x = xb_dev[:n]
    g = torch.Generator(device=x.device).manual_seed(2)
    cent = x[torch.randperm(x.shape[0], generator=g, device=x.device)[:k]]
    cent = cent + 0.1 * torch.randn(cent.shape, generator=g, device=x.device)
    kmeans.assign_points(x[:65536], cent, method="hierarchical")  # warm-up
    torch.cuda.synchronize()
    before = kb.launch_counts()["assign_argmin"]
    t0 = time.perf_counter()
    hl, hd = kmeans.assign_points(x, cent, method="hierarchical")
    torch.cuda.synchronize()
    h_ms = (time.perf_counter() - t0) * 1e3
    k1_calls = kb.launch_counts()["assign_argmin"] - before
    kl, kd = assign.assign_argmin(x, cent)
    k_ms = cuda_ms(torch, lambda: assign.assign_argmin(x, cent), reps=3)
    agree = float((hl == kl).float().mean())
    terms = (x * x).sum(1) + (cent * cent).sum(1)[kl.long()]
    ok = (bool(torch.isfinite(hd).all()) and k1_calls == 0
          and bool((hd >= kd - RTOL * terms).all()))
    check(ok, f"hierarchical assignment {n} x {k} x {x.shape[1]}: {h_ms:.1f} ms (host clock, "
              f"meta Lloyd included; K1 not launched: {k1_calls == 0}) beside K1 {k_ms:.3f} ms; "
              f"label agreement {agree:.4f}; no distance below K1's exact argmin beyond "
              f"{RTOL:g}*(|x|^2+|c|^2)")
    return dict(hierarchical_ms=h_ms, k1_ms=k_ms, agreement=agree)


def _template_args(mangled_tail: str) -> str:
    """'ILb1ELb0ELi2ELb1EEEv...' -> '<true,false,2,true>' (the kernels' bool,
    int and row-type template arguments)."""
    body = mangled_tail[1:].split("EEv", 1)[0] + "E"
    body = body.replace("13__nv_bfloat16", "bf16,").replace("Lb1E", "true,").replace("Lb0E", "false,")
    body = re.sub(r"(^|,)([af])(?=Li|true|false|E|$)",
                  lambda m: m.group(1) + {"a": "int8", "f": "f32"}[m.group(2)] + ",", body)
    body = re.sub(r"Li(\d+)E", r"\1,", body)
    return "<" + body.rstrip("E").rstrip(",") + ">"


def ptxas_lines(log_text: str, kernels=("flat_sweep_kernel", "stream_fused_plane_kernel")):
    """nvcc -Xptxas -v's register / shared-memory / spill report of each
    instantiation of the named kernels, one line each."""
    out, current, props = [], None, {}
    for line in log_text.splitlines():
        if "Function properties for" in line:
            current = line.split("Function properties for")[-1].strip()
        elif current and "spill stores" in line:
            props["spill"] = line.strip()
        elif current and "Used" in line and "registers" in line:
            if any(k in current for k in kernels):
                name = next(k for k in kernels if k in current)
                out.append(f"{name}{_template_args(current.split(name, 1)[1])}: "
                           f"{line.split(':', 1)[1].strip()}; {props.get('spill', '')}")
            current, props = None, {}
    return out


def main_shape_kernels(torch, vi, xb, xq_dev, check, results):
    """K1 (the build's final assignment: the 1M corpus against the index's
    4,000 centroids), K3 (f32 / int8 / int8x1; masked at n_probe 128, its
    queries ordered by nearest probe as the dense program orders them, and
    unmasked as 'flat' runs it), K4 (bf16 / int8, one query tile of the
    n_probe-32 stream program) and K2 bf16 (one query tile of the
    n_probe-8 stream program, with and without nval2d) at the main path's
    own shapes on the 1M index, each against its plain version and timed.
    These become the JSON line's numbers for K1-K4; phase 3's are kept
    beside them."""
    from vector_indexer_tpu_torch.index import programs
    from vector_indexer_tpu_torch.index.dispatch import resolve
    from vector_indexer_tpu_torch.ops import block_stream as bs
    from vector_indexer_tpu_torch.ops import flat_sweep as fs

    idx = vi.index
    lay = idx.layout
    n_rows = lay.vectors.shape[0]
    nq = xq_dev.shape[0]
    c, c_sq = idx._device_tables()
    x = torch.as_tensor(xb, device=xq_dev.device)
    results["assign_argmin"] = dict(phase3=results["assign_argmin"],
                                    **k1_entry(torch, x, c, check, "the build's final assignment"))
    del x
    torch.cuda.empty_cache()

    # K2 bf16: one query tile of the n_probe-8 stream program, as it
    # launches it (valid rows only), and every lane for comparison.
    dec = resolve(idx, nq, 8, k=K, method="stream")
    qt = xq_dev[: dec.q_tile]
    tb = idx._stream_table()
    grid = stream_grid(qt, tb, c, c_sq, lay.lengths, 8, "l2")
    name = "stream_distances[bf16]"
    entry = dict(phase3=results[name])
    for nval in (False, True):
        ok, err = check_k2(qt, tb, grid, "l2", nval)
        check(ok, f"K2 {name} vs plain at the main path's shape (q_tile={len(qt)} of nq={nq}, "
                  f"n_probe=8, t_fixed={grid['t_fixed']}, chunk={tb.chunk}, "
                  f"{'valid rows only' if nval else 'every lane'}): max |err| {err:.3e}")
        kw = k2_kw(tb, grid, "l2", nval)
        ms = graph_ms(torch, lambda: bs.stream_distances(*k2_args(qt, tb, grid), **kw))
        if nval:
            entry.update(
                max_abs_err=max(err, entry["max_abs_err"]), ms=ms,
                events_ms=cuda_ms(torch, lambda: bs.stream_distances(*k2_args(qt, tb, grid), **kw)),
                plain_ms=cuda_ms(torch, lambda: bs.stream_distances_reference(
                    *k2_args(qt, tb, grid), **kw), reps=2),
                library_ms=None, library_call=None,
                **stream_bound(qt, tb, grid, len(qt) * grid["t_fixed"] * tb.chunk * 4),
                shape=f"q_tile={len(qt)} t_fixed={grid['t_fixed']} chunk={tb.chunk} (n_probe=8; "
                      f"{-(-nq // len(qt))} launches per batch of {nq}; ms: valid rows only)")
        else:
            entry.update(max_abs_err=err, all_lanes_ms=ms)
    results[name] = entry
    log(f"  K2 {name} main shape: kernel {entry['ms']:.3f} ms (graph replay; every lane "
        f"{entry['all_lanes_ms']:.3f}; event loop {entry['events_ms']:.3f}), "
        f"plain {entry['plain_ms']:.3f} ms, bound {entry['bound_ms']:.4f} ms ({entry['bound_by']}); "
        f"{entry['shape']}")

    n_probe = min(128, idx.num_clusters)
    block_run, c_ord, c_sq_ord = idx._run_tables()
    s_ord, nearest = programs._probe_sets(xq_dev, c_ord, c_sq_ord, n_probe)
    perm = torch.argsort(nearest, stable=True)
    qs = xq_dev[perm]
    tabs = idx._sweep_int8_tables()
    methods = {"highest": "dense_fused", "int8": "dense_int8", "int8x1": "dense_int8x1"}
    for prec, method in methods.items():
        w, _, C = resolve(idx, nq, n_probe, k=K, method=method).plan
        mask = programs._sweep_mask(s_ord[perm], block_run, -(-n_rows // (fs.S * w)) * fs.S * w // 8)
        name = "flat_sweep_topk_plane" + ("" if prec == "highest" else f"[{prec}]")
        entry = dict(phase3=results[name])
        for label, m in (("masked", mask), ("flat", None)):
            args = (qs, lay.vectors, lay.row_norms, m) if prec == "highest" else (
                qs, tabs[0], lay.row_norms, m, tabs[1] if prec == "int8" else None, tabs[2])
            kw = dict(metric="l2", w=w, c_groups=C, precision=prec)
            ok, n_mism, err = compare_planes(qs, lay.vectors, lay.row_norms,
                                             fs.flat_sweep_topk_plane(*args, **kw),
                                             fs.flat_sweep_topk_plane_reference(*args, **kw),
                                             "l2", exact_ties=prec != "highest")
            check(ok, f"K3 {name} vs plain at the main path's shape ({label}, nq={nq}, "
                      f"n_rows={n_rows}, w={w}, C={C}{f', n_probe={n_probe}' if m is not None else ''}): "
                      f"{n_mism} row differences, all {'at equal values' if prec != 'highest' else 'near-ties'}; "
                      f"max |err| {err:.3e}")
            ms = cuda_ms(torch, lambda: fs.flat_sweep_topk_plane(*args, **kw))
            plain_ms = cuda_ms(torch, lambda: fs.flat_sweep_topk_plane_reference(*args, **kw), reps=2)
            b = sweep_bound(qs, n_rows, m, prec, nq * 2 * C * fs.S * 8)
            log(f"  K3 {name} main shape {label}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
                f"bound {b['bound_ms']:.3f} ms ({b['bound_by']})")
            if label == "masked":
                entry.update(max_abs_err=err, ms=ms, plain_ms=plain_ms, **b,
                             shape=f"nq={nq} n_rows={n_rows} w={w} C={C} masked at n_probe={n_probe} "
                                   f"(queries ordered by nearest probe), 1 launch per batch")
            else:
                entry.update(flat_ms=ms, flat_plain_ms=plain_ms, flat_bound_ms=b["bound_ms"],
                             max_abs_err=max(entry["max_abs_err"], err))
        if prec == "highest":
            entry.update(library(torch, lambda: torch.matmul(qs, lay.vectors.T),
                                 "torch.matmul(q, x.T), dense product only"))
        else:
            q8 = fs.quantize_queries_int8(qs)[0]
            entry.update(library(torch, lambda: torch._int_mm(q8, tabs[0].T),
                                 "torch._int_mm(q8, x8.T), the q8.x8 product only"))
        torch.cuda.empty_cache()
        results[name] = entry
    del tabs

    # K4: one query tile of the n_probe-32 stream program, as it launches it.
    dec = resolve(idx, nq, 32, k=K, method="stream")
    qt = xq_dev[: dec.q_tile]
    for mode, tb in (("bf16", idx._stream_table()),
                     ("int8", bs.build_stream_table(lay, idx.centroids, torch.int8, chunk=dec.chunk))):
        name = f"stream_fused_plane[{mode}]"
        grid = stream_grid(qt, tb, c, c_sq, lay.lengths, 32, "l2")
        ok, n_mism, err = check_k4(qt, tb, grid, "l2")
        G = bs.pick_stream_groups(tb.chunk)
        check(ok, f"K4 {name} vs plain at the main path's shape (q_tile={len(qt)} of nq={nq}, "
                  f"n_probe=32, t_fixed={grid['t_fixed']}, chunk={tb.chunk}, G={G}): {n_mism} slot "
                  f"differences, all near-ties; max |err| {err:.3e}")
        kw = dict(chunk=tb.chunk, groups=G, metric="l2", scales=tb.scales)
        b = stream_bound(qt, tb, grid, len(qt) * 2 * G * tb.chunk * 8)
        results[name] = dict(
            phase3=results[name], max_abs_err=err,
            ms=cuda_ms(torch, lambda: bs.stream_fused_plane(*k4_args(qt, tb, grid), **kw)),
            plain_ms=cuda_ms(torch, lambda: bs.stream_fused_plane_reference(*k4_args(qt, tb, grid), **kw),
                             reps=2),
            library_ms=None, library_call=None, **b,
            shape=f"q_tile={len(qt)} t_fixed={grid['t_fixed']} chunk={tb.chunk} G={G} "
                  f"(n_probe=32; {-(-nq // len(qt))} launches per batch of {nq})",
        )
        log(f"  K4 {name} main shape: kernel {results[name]['ms']:.3f} ms, plain "
            f"{results[name]['plain_ms']:.3f} ms, bound {b['bound_ms']:.3f} ms ({b['bound_by']}); "
            f"{results[name]['shape']}")


def shared_n_probe(lengths, nlist: int, chunk: int):
    """The smallest power-of-two n_probe (capped at nlist) at which the
    shared gate opens for a 1024-query batch, or None."""
    from vector_indexer_tpu_torch.index import dispatch

    msr = dispatch.mean_slot_rows_of(lengths, chunk)
    p = 1
    while True:
        if dispatch.shared_gate(NQ_SHARED, min(p, nlist), msr):
            return min(p, nlist)
        if p >= nlist:
            return None
        p *= 2


# ---------------------------------------------------------------------------
# Phase 4: the main path
# ---------------------------------------------------------------------------


def main_phase(torch, np, xb, xq, check, dev, work, kernel_results):
    from vector_indexer_tpu_torch import bindings
    from vector_indexer_tpu_torch.api import SearchRequest
    from vector_indexer_tpu_torch.index.dispatch import resolve
    from vector_indexer_tpu_torch.index.programs import shortlist_k
    from vector_indexer_tpu_torch.kernels import build as kb
    from vector_indexer_tpu_torch.ops.block_stream import fused_engages
    from vector_indexer_tpu_torch.ops.topk import brute_force_topk
    from vector_indexer_tpu_torch.utils import tracing

    k, nq = K, xq.shape[0]
    tracing.reset_phases()
    torch.cuda.reset_peak_memory_stats(dev)
    kb.reset_launch_counts()  # counts from here on belong to the main path

    t0 = time.perf_counter()
    vi = bindings.build(xb, str(work), device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    ph = {p: v["total_s"] for p, v in tracing.phase_report().items()}
    log(f"  build: {build_s:.2f}s total; fit.kmeans {ph.get('fit.kmeans', 0):.2f}s, "
        f"fit.super_kmeans {ph.get('fit.super_kmeans', 0):.2f}s, fit.layout "
        f"{ph.get('fit.layout', 0):.2f}s, save.shards {ph.get('save.shards', 0):.2f}s; "
        f"nlist={vi.nlist}")
    t0 = time.perf_counter()
    vi = bindings.load(str(work / "index"), str(work / "shards"), xb.shape[1], device=dev)
    torch.cuda.synchronize()
    log(f"  load: {time.perf_counter() - t0:.2f}s; nlist={vi.nlist} n={vi.index.layout.n}")
    check(vi.index.layout.n == xb.shape[0], "load restores every vector")

    xq_dev = torch.as_tensor(xq, device=dev)
    t0 = time.perf_counter()
    _, gt = brute_force_topk(xq_dev, torch.as_tensor(xb, device=dev), k)
    gt = gt.cpu().numpy()
    log(f"  exact ground truth (matmul + topk in chunks) on the card: {time.perf_counter() - t0:.2f}s")

    # n_probe values from the port's own dispatch on the built index.
    routes = {}
    for n_probe in (4, 8, 16, 32, 64, 128):
        dec = resolve(vi.index, nq, n_probe, k=k)
        if dec.program == "stream":
            kk = shortlist_k(k, dec.t_fixed, dec.chunk)
            route = "stream/K4" if fused_engages(dec.t_fixed, dec.chunk, kk) else "stream/K2"
        else:
            route = dec.program + ("/K3" if dec.program == "dense_fused" else "")
        routes[n_probe] = (route, dec)
    log("  auto routes: " + ", ".join(f"n_probe={p}: {r[0]}" for p, r in routes.items()))

    table, results = [], {}
    for n_probe, (route, dec) in routes.items():
        D, R = vi.search_device(xq_dev, k, n_probe)  # warm-up (builds the stream table once)
        torch.cuda.synchronize()
        ms = cuda_ms(torch, lambda: vi.search_device(xq_dev, k, n_probe), reps=3)
        I = vi.rows_to_external(R)
        Dn = D.cpu().numpy()
        results[n_probe] = (Dn, R.cpu().numpy())
        fin_ok = bool(np.isfinite(Dn).all()) and Dn.shape == (nq, k)
        rec = {r: float((I[:, :r] == gt[:, :1]).any(axis=1).mean()) for r in (1, 10, 100)}
        # Whole result sets: the share of the exact top-k that came back.
        overlap = float(np.mean([len(np.intersect1d(a, b)) for a, b in zip(I, gt)]) / k)
        table.append((n_probe, route, ms, rec, overlap))
        log(f"  n_probe={n_probe:4d} program={dec.program:11s} route={route:16s} "
            f"batch {ms:8.3f} ms  QPS {nq / ms * 1e3:10.1f}  R@1 {rec[1]:.4f} "
            f"R@10 {rec[10]:.4f} R@100 {rec[100]:.4f} top-{k} overlap {overlap:.4f}"
            + (f"  t_fixed={dec.t_fixed} chunk={dec.chunk}" if dec.program == "stream" else "")
            + (f"  plan(w,_,C)={dec.plan}" if dec.plan else ""))
        check(fin_ok, f"n_probe={n_probe}: finite (nq, k) = ({nq}, {k}) result")
    check(table[-1][3][10] >= 0.9,
          f"recall@10 {table[-1][3][10]:.4f} >= 0.9 at the largest n_probe ({table[-1][0]})")
    check(table[-1][4] >= OVERLAP_FLOOR,
          f"top-{k} overlap with the exact top-{k} {table[-1][4]:.4f} >= {OVERLAP_FLOOR} "
          f"at the largest n_probe ({table[-1][0]})")

    res = vi.indexer.search_sync(SearchRequest(query=xb[7], k=10, n_probe=32))
    check(len(res) > 0 and res[0].external_id == 7,
          f"single-query VectorIndexer.search_sync self-hit (got {res[0].external_id if res else None})")
    torch.cuda.synchronize()
    counts = kb.launch_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    log(f"  launch counts in the main path: {counts}")
    log(f"  peak device memory (max_memory_allocated): {peak / 2**30:.3f} GiB")
    for name in MAIN_KERNELS:
        check(counts[name] > 0, f"{name} launched in the main path ({counts[name]}x)")

    log("  -- K1-K4 at the main path's shapes (after the launch counts were read)")
    t0 = time.perf_counter()
    main_shape_kernels(torch, vi, xb, xq_dev, check, kernel_results)
    log(f"  main-shape kernel checks: {time.perf_counter() - t0:.2f}s")
    hierarchical_vs_k1(torch, torch.as_tensor(xb, device=dev), check)

    # The same search on the CPU, where each kernel's wrapper runs its plain
    # version: the card's results (ranks 1..k) must be the plain path's.
    t0 = time.perf_counter()
    vc = bindings.load(str(work / "index"), str(work / "shards"), xb.shape[1], device="cpu")
    qs = xq[:NQ_TWIN]
    max_norm = float(np.max(np.sum(xb * xb, axis=1)))
    scale = np.sum(qs * qs, axis=1) + max_norm  # |q|^2 + max |x|^2
    seen = set()
    for n_probe, (route, dec) in routes.items():
        if route in seen and n_probe != max(routes):
            continue
        seen.add(route)
        Dp, Rp = vc.index.search_batch_device(qs, k, n_probe, method=dec.method)
        Dp, Rp = Dp.numpy(), Rp.numpy()
        Dc, Rc = (a[:NQ_TWIN] for a in results[n_probe])
        # Rank by rank (both ascending), so a row swapped for a near-tie
        # passes and a missing or misranked neighbour does not.
        err = np.abs(Dc - Dp)
        same = (np.sort(Rc, 1) == np.sort(Rp, 1)).all(axis=1).mean()
        check(bool(np.isfinite(Dp).all()) and bool((err <= RTOL * scale[:, None]).all())
              and same >= TWIN_SAME_FLOOR,
              f"n_probe={n_probe} ({route}): card vs plain versions on the CPU, {NQ_TWIN} "
              f"queries: every rank's distance within {RTOL:g}*(|q|^2+max|x|^2) (max |err| "
              f"{float(err.max()):.3e}); equal top-{k} row sets on {same:.4f} of queries "
              f"(>= {TWIN_SAME_FLOOR})")
    log(f"  CPU comparison: {time.perf_counter() - t0:.2f}s")
    return counts, {n_probe: overlap for n_probe, _, _, _, overlap in table}, gt


# ---------------------------------------------------------------------------
# Phase 5: offload, the shared stream and the exact stream
# ---------------------------------------------------------------------------


def extra_queries(np, n: int):
    """``n`` more queries of the corpus's distribution:
    benchmarks/datasets.py::clustered(N, 128, NQ, seed=42) draws its
    centers first from default_rng(42); new queries are drawn around those
    centers by a second generator."""
    ncent = max(64, min(1024, N // 1000))  # clustered()'s default
    centers = np.random.default_rng(42).normal(0, 4.0, size=(ncent, 128)).astype(np.float32)
    g = np.random.default_rng(43)
    return (centers[g.integers(0, ncent, n)] + g.normal(0, 1.0, (n, 128))).astype(np.float32)


def quality(np, I, gt, k: int):
    """(R@1, R@10, R@100, top-k overlap) of external ids I against gt."""
    rec = [float((I[:, :r] == gt[:, :1]).any(axis=1).mean()) for r in (1, 10, 100)]
    overlap = float(np.mean([len(np.intersect1d(a, b)) for a, b in zip(I, gt)]) / k)
    return (*rec, overlap)


def host_ms(torch, fn, reps: int = 3) -> float:
    """Mean host-clock milliseconds of fn() over ``reps`` after one warm-up
    (fn returns host arrays, so each call ends synchronised)."""
    fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps * 1e3


def exact_dist(np, xb, q, I):
    """Exact squared L2 (f64) of queries q to the rows I (-1: nan)."""
    x = xb[np.clip(I, 0, None)].astype(np.float64)
    d = ((x - q[:, None, :].astype(np.float64)) ** 2).sum(-1)
    return np.where(I >= 0, d, np.nan)


def offload_phase(torch, np, xb, xq, check, dev, work, p4_overlap):
    import gc

    from vector_indexer_tpu_torch import bindings
    from vector_indexer_tpu_torch.index.dispatch import resolve
    from vector_indexer_tpu_torch.index.ivf import load_index_from
    from vector_indexer_tpu_torch.index.programs import shortlist_k
    from vector_indexer_tpu_torch.kernels import build as kb
    from vector_indexer_tpu_torch.ops.block_stream import fused_engages
    from vector_indexer_tpu_torch.ops.topk import brute_force_topk

    k, d, nq = K, xb.shape[1], xq.shape[0]
    idx_dir, sh_dir = str(work / "index"), str(work / "shards")
    xq_all = np.concatenate([xq, extra_queries(np, NQ_SHARED - nq)])
    xb_dev = torch.as_tensor(xb, device=dev)
    _, gt = brute_force_topk(torch.as_tensor(xq_all, device=dev), xb_dev, k)
    gt = gt.cpu().numpy()
    del xb_dev
    gc.collect()
    torch.cuda.empty_cache()
    max_norm = float(np.max(np.sum(xb * xb, axis=1)))
    scale = np.sum(xq_all * xq_all, axis=1) + max_norm  # |q|^2 + max |x|^2
    kb.reset_launch_counts()  # counts from here on belong to phase 5

    # 5.1 bindings.load(resident='offload'), exact host re-rank.
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    vo = bindings.load(idx_dir, sh_dir, d, resident="offload", device=dev)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) - base
    ix = vo.index
    f32_bytes = ix._n_pad * d * 4
    st = ix._stream_table()
    log(f"  offload load: {load_s:.2f}s; f32 table {f32_bytes / 2**20:.1f} MiB (host only), "
        f"int8 stream table + norms {st.nbytes / 2**20:.1f} MiB; peak device memory over "
        f"the load {peak / 2**20:.1f} MiB above the {base / 2**20:.1f} MiB held before it")
    vec = ix.layout.vectors
    check(not (isinstance(vec, torch.Tensor) and vec.is_cuda),
          "offload load: layout.vectors is not a CUDA tensor")
    check(peak < f32_bytes, f"offload load: peak device memory over the load {peak} B < the "
                            f"f32 table's {f32_bytes} B")
    host_res = {}
    for n_probe in (8, 32):
        dec = resolve(ix, nq // 2, n_probe, k=2 * k)  # the stream program of each half
        kk = shortlist_k(2 * k, dec.t_fixed, dec.chunk, wide=4)
        kern = ("stream_fused_plane[int8]" if fused_engages(dec.t_fixed, dec.chunk, kk)
                else "stream_distances[int8]")
        route = "K4 int8" if kern.startswith("stream_fused") else "K2 int8"
        before = kb.launch_counts()[kern]
        ms = host_ms(torch, lambda: vo.search_sync(xq, k, n_probe))
        D, I = vo.search_sync(xq, k, n_probe)
        check(kb.launch_counts()[kern] > before, f"offload auto n_probe={n_probe} ran {kern}")
        r1, r10, r100, ov = quality(np, I, gt[:nq], k)
        host_res[n_probe] = (D, I, ov)
        log(f"  offload host n_probe={n_probe:3d} auto={ix.choose_method(nq, n_probe)} ({route}, "
            f"t_fixed={dec.t_fixed}): {ms:8.3f} ms/batch host clock, QPS {nq / ms * 1e3:9.1f}  "
            f"R@1 {r1:.4f} R@10 {r10:.4f} R@100 {r100:.4f} top-{k} overlap {ov:.4f}")
        err = np.abs(D.astype(np.float64) - exact_dist(np, xb, xq, I))
        check(bool(np.isfinite(D).all()) and bool((err <= RTOL * scale[:nq, None]).all()),
              f"offload host n_probe={n_probe}: distances are the exact f32 distances of the "
              f"returned ids within {RTOL:g}*(|q|^2+max|x|^2) (max |err| {np.nanmax(err):.3e})")
        check(ov >= p4_overlap[n_probe] - OFFLOAD_OVERLAP_SLACK,
              f"offload host n_probe={n_probe}: overlap {ov:.4f} >= device-resident "
              f"{p4_overlap[n_probe]:.4f} - {OFFLOAD_OVERLAP_SLACK}")

    # 5.2 'auto' takes K5 int8 at 1024 queries and a huge probed footprint.
    p_sh = next((p for p in (2 ** i for i in range(16)) if p <= 2 * ix.num_clusters
                 and ix.choose_method(NQ_SHARED, p) == "stream_shared"), None)
    check(p_sh is not None, f"offload: choose_method returns 'stream_shared' at nq {NQ_SHARED} "
                            f"(smallest power-of-two n_probe {p_sh})")
    if p_sh is not None:
        before = kb.launch_counts()["stream_shared_plane[int8]"]
        t0 = time.perf_counter()
        _, Ish = vo.search_sync(xq_all, k, p_sh)
        sh_s = time.perf_counter() - t0
        launched = kb.launch_counts()["stream_shared_plane[int8]"] - before
        t0 = time.perf_counter()
        _, Ist = vo.search_sync(xq_all, k, p_sh, method="stream")
        st_s = time.perf_counter() - t0
        ov_sh, ov_st = quality(np, Ish, gt, k)[3], quality(np, Ist, gt, k)[3]
        log(f"  offload host nq={NQ_SHARED} n_probe={p_sh}: auto (stream_shared, K5 int8, "
            f"{launched} launches) {sh_s * 1e3:.1f} ms overlap {ov_sh:.4f}; 'stream' "
            f"{st_s * 1e3:.1f} ms overlap {ov_st:.4f} (host clock, one batch each)")
        check(launched > 0, f"offload auto at n_probe {p_sh}: K5 int8 launched ({launched}x)")
        check(ov_sh >= ov_st - SHARED_OVERLAP_SLACK,
              f"offload shared overlap {ov_sh:.4f} >= stream {ov_st:.4f} - {SHARED_OVERLAP_SLACK}")

    # 5.3 load_index_from(resident='offload', offload_rerank='device').
    t0 = time.perf_counter()
    ixd = load_index_from(idx_dir, sh_dir, resident="offload", device=dev,
                          offload_rerank="device")
    log(f"  offload load with the device re-rank: {time.perf_counter() - t0:.2f}s; correction "
        f"table {ixd._corr_table.nbytes / 2**20:.1f} MiB")
    for n_probe in (8, 32):
        ms = host_ms(torch, lambda: ixd.search_batch(xq, k, n_probe))
        D, Ii = ixd.search_batch(xq, k, n_probe)
        I = np.where(Ii >= 0, ixd.external_ids[np.clip(Ii, 0, None)].astype(np.int64), -1)
        ex = exact_dist(np, xb, xq, I)
        rel = np.abs(D - ex) / np.maximum(ex, 1e-12)
        p99 = float(np.nanpercentile(rel, 99))
        ov = quality(np, I, gt[:nq], k)[3]
        log(f"  offload device n_probe={n_probe:3d}: {ms:8.3f} ms/batch host clock, QPS "
            f"{nq / ms * 1e3:9.1f}; p99 relative distance error {p99:.3e}, top-{k} overlap "
            f"{ov:.4f}")
        check(p99 <= DEVICE_RERANK_P99_REL, f"device re-rank n_probe={n_probe}: p99 relative "
                                            f"error {p99:.3e} <= {DEVICE_RERANK_P99_REL:g}")
        check(ov >= host_res[n_probe][2] - OFFLOAD_OVERLAP_SLACK,
              f"device re-rank n_probe={n_probe}: overlap {ov:.4f} >= host "
              f"{host_res[n_probe][2]:.4f} - {OFFLOAD_OVERLAP_SLACK}")
    del ixd

    # 5.4 VectorIndex.offload(rerank='none') on a device-resident load that
    # has served a batch (so it holds its bf16 stream table, as in serving).
    vr = bindings.load(idx_dir, sh_dir, d, device=dev)
    xq_dev = torch.as_tensor(xq, device=dev)
    vr.search_device(xq_dev, k, 8)
    torch.cuda.synchronize()
    gc.collect()
    before = torch.cuda.memory_allocated(dev)
    vr.offload(rerank="none")
    gc.collect()
    torch.cuda.synchronize()
    after = torch.cuda.memory_allocated(dev)
    log(f"  offload_main_table: device memory {before / 2**20:.1f} -> {after / 2**20:.1f} MiB "
        f"(f32 table {f32_bytes / 2**20:.1f} MiB and the bf16 stream table freed, int8 table "
        f"{vr.index._stream_table().nbytes / 2**20:.1f} MiB built)")
    check(before - after >= f32_bytes, f"offload(rerank='none') frees >= the f32 table's bytes "
                                       f"({before - after} >= {f32_bytes})")
    for n_probe in (8, 32):
        ms = host_ms(torch, lambda: vr.search_sync(xq, k, n_probe))
        _, I = vr.search_sync(xq, k, n_probe)
        r1, r10, r100, ov = quality(np, I, gt[:nq], k)
        log(f"  offload none n_probe={n_probe:3d}: {ms:8.3f} ms/batch host clock, QPS "
            f"{nq / ms * 1e3:9.1f}; R@1 {r1:.4f} R@10 {r10:.4f} R@100 {r100:.4f} "
            f"top-{k} overlap {ov:.4f}")
        check(r10 >= NONE_R10_FLOOR, f"offload none n_probe={n_probe}: R@10 {r10:.4f} >= "
                                     f"{NONE_R10_FLOOR}")
    del vr

    # 5.5 device-resident 'stream_shared' (K5 bf16), 'stream_shared_exact'
    # (K5 f32) and 'stream_exact' (K2 f32) against 'stream'. 'stream' itself
    # drops rows by design (K4's top-2-per-lane planes, t_fixed, bf16
    # rounding at the 100th rank), so the gate is the share of 'stream''s
    # rows returned; whole-set equality and the exact overlap are printed.
    vdv = bindings.load(idx_dir, sh_dir, d, device=dev)
    xq_all_dev = torch.as_tensor(xq_all, device=dev)
    ref_sets = {}
    for method, n_probe in (("stream_shared", p_sh), ("stream_shared_exact", p_sh),
                            ("stream_exact", 8)):
        if n_probe is None:
            continue
        qd = xq_all_dev if method.startswith("stream_shared") else xq_dev
        if n_probe not in ref_sets:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, Rs = vdv.search_device(qd, k, n_probe, method="stream")
            Rs = Rs.cpu().numpy()
            log(f"  device-resident stream n_probe={n_probe} nq={len(qd)}: "
                f"{(time.perf_counter() - t0) * 1e3:.1f} ms (host clock, one batch)")
            ref_sets[n_probe] = (Rs, quality(np, vdv.rows_to_external(Rs), gt[: len(qd)], k)[3])
        Rs, ov_s = ref_sets[n_probe]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, R = vdv.search_device(qd, k, n_probe, method=method)
        R = R.cpu().numpy()
        m_s = time.perf_counter() - t0
        same = float((np.sort(R, 1) == np.sort(Rs, 1)).all(axis=1).mean())
        shared_rows = float(np.mean([len(np.intersect1d(a, b)) for a, b in zip(R, Rs)]) / k)
        ov = quality(np, vdv.rows_to_external(R), gt[: len(qd)], k)[3]
        log(f"  device-resident {method} n_probe={n_probe} nq={len(qd)}: {m_s * 1e3:.1f} ms "
            f"(host clock, one batch); top-{k} overlap {ov:.4f} ('stream' {ov_s:.4f}); "
            f"'stream''s rows returned {shared_rows:.4f}; identical sets on {same:.4f}")
        check(shared_rows >= TWIN_SAME_FLOOR and ov >= ov_s - SHARED_OVERLAP_SLACK,
              f"{method} n_probe={n_probe}: returns {shared_rows:.4f} of 'stream''s rows "
              f"(>= {TWIN_SAME_FLOOR}) and overlap {ov:.4f} >= 'stream' {ov_s:.4f} - "
              f"{SHARED_OVERLAP_SLACK}")
    del vdv
    torch.cuda.synchronize()
    counts = kb.launch_counts()
    log(f"  launch counts in phase 5: {counts}")
    for name in OFFLOAD_KERNELS:
        check(counts[name] > 0, f"{name} launched in phase 5 ({counts[name]}x)")

    # 5.6 The same offloaded searches on the CPU (plain versions), modes
    # 'host' (search_batch) and 'none' (the sweep's own ranking,
    # search_batch_device, which is what a rerank='none' index serves).
    t0 = time.perf_counter()
    vc = bindings.load(idx_dir, sh_dir, d, resident="offload", device="cpu")
    qs = xq[:NQ_TWIN]
    for n_probe in (8, 32):
        for mode in ("host", "none"):
            if mode == "host":
                Dc, Ic = (a[:NQ_TWIN] for a in host_res[n_probe][:2])
                Dp, Ip = vc.search_sync(qs, k, n_probe)
            else:
                Dc, Rc = ix.search_batch_device(qs, k, n_probe)
                Dc, Ic = Dc.cpu().numpy(), vo.rows_to_external(Rc)
                Dp, Rp = vc.index.search_batch_device(qs, k, n_probe)
                Dp, Ip = Dp.numpy(), vc.rows_to_external(Rp)
            err = np.abs(Dc - Dp)
            same = (np.sort(Ic, 1) == np.sort(Ip, 1)).all(axis=1).mean()
            check(bool(np.isfinite(Dp).all()) and bool((err <= RTOL * scale[:NQ_TWIN, None]).all())
                  and same >= TWIN_SAME_FLOOR,
                  f"offload {mode} n_probe={n_probe}: card vs plain versions on the CPU, "
                  f"{NQ_TWIN} queries: every rank within {RTOL:g}*(|q|^2+max|x|^2) (max |err| "
                  f"{float(err.max()):.3e}); equal top-{k} sets on {same:.4f} (>= {TWIN_SAME_FLOOR})")
    log(f"  CPU comparison: {time.perf_counter() - t0:.2f}s")
    return {name: counts[name] for name in OFFLOAD_KERNELS}


# ---------------------------------------------------------------------------
# Phase 6: the exhaustive, int8 and gather methods
# ---------------------------------------------------------------------------


def flat_gather_phase(torch, np, xb, xq, check, dev, work, gt):
    """The methods of the flat / int8 / gather slice on the index phase 4
    saved, each through ``search_device(method=...)``: QPS (CUDA events),
    recall and overlap against ``gt``, the gates, the launch check, and a
    CPU twin of 200 queries for each run in PHASE6_TWINS."""
    from vector_indexer_tpu_torch import bindings
    from vector_indexer_tpu_torch.index.dispatch import resolve
    from vector_indexer_tpu_torch.kernels import build as kb

    k, d, nq = K, xb.shape[1], xq.shape[0]
    vi = bindings.load(str(work / "index"), str(work / "shards"), d, device=dev)
    xq_dev = torch.as_tensor(xq, device=dev)
    kb.reset_launch_counts()  # counts from here on belong to phase 6
    got = {}
    for method, n_probe in PHASE6_RUNS:
        dec = resolve(vi.index, nq, n_probe, k=k, method=method)
        D, R = vi.search_device(xq_dev, k, n_probe, method=method)  # warm-up (int8 tables once)
        torch.cuda.synchronize()
        ms = cuda_ms(torch, lambda: vi.search_device(xq_dev, k, n_probe, method=method), reps=3)
        Dn, Rn = D.cpu().numpy(), R.cpu().numpy()
        I = vi.rows_to_external(Rn)
        r1, r10, r100, ov = quality(np, I, gt, k)
        ov10 = float(np.mean([len(np.intersect1d(a[:10], b[:10])) for a, b in zip(I, gt)]) / 10)
        got[(method, n_probe)] = (Dn, Rn, dict(r1=r1, r10=r10, ov=ov, ov10=ov10))
        log(f"  {method:12s} n_probe={n_probe:4d} program={dec.program:11s} "
            f"precision={dec.precision:7s} batch {ms:8.3f} ms  QPS {nq / ms * 1e3:10.1f}  "
            f"R@1 {r1:.4f} R@10 {r10:.4f} R@100 {r100:.4f} top-10 overlap {ov10:.4f} "
            f"top-{k} overlap {ov:.4f}" + (f"  plan(w,_,C)={dec.plan}" if dec.plan else "")
            + (f"  budget={dec.budget}" if dec.budget else ""))
        check(bool(np.isfinite(Dn).all()) and Dn.shape == (nq, k),
              f"{method} n_probe={n_probe}: finite (nq, k) = ({nq}, {k}) result")
    q6 = {key: v[2] for key, v in got.items()}
    check(q6[("flat_exact", 1)]["ov"] >= FLAT_EXACT_FLOOR,
          f"flat_exact top-{k} overlap {q6[('flat_exact', 1)]['ov']:.4f} >= {FLAT_EXACT_FLOOR}")
    check(q6[("flat", 1)]["r1"] >= FLAT_R1_FLOOR and q6[("flat", 1)]["ov"] >= OVERLAP_FLOOR,
          f"flat R@1 {q6[('flat', 1)]['r1']:.4f} >= {FLAT_R1_FLOOR} and top-{k} overlap "
          f"{q6[('flat', 1)]['ov']:.4f} >= {OVERLAP_FLOOR}")
    for method, floor in INT8_TOP10_FLOORS.items():
        check(q6[(method, 1)]["ov10"] >= floor,
              f"{method} top-10 overlap {q6[(method, 1)]['ov10']:.4f} >= {floor}")
    for n_probe in (8, 32):
        (Dg, Rg, _), (Dd, Rd, _) = got[("gather", n_probe)], got[("gather_dma", n_probe)]
        same = float((np.sort(Rg, 1) == np.sort(Rd, 1)).all(axis=1).mean())
        err = np.abs(Dg - Dd)
        scale = np.sum(xq * xq, axis=1) + float(np.max(np.sum(xb * xb, axis=1)))
        check(same >= GATHER_SAME_FLOOR and bool((err <= RTOL * scale[:, None]).all()),
              f"gather_dma n_probe={n_probe} returns gather's sets on {same:.4f} of queries "
              f"(>= {GATHER_SAME_FLOOR}), distances within {RTOL:g}*(|q|^2+max|x|^2) (max |err| "
              f"{float(err.max()):.3e})")
    torch.cuda.synchronize()
    counts = kb.launch_counts()
    log(f"  launch counts in phase 6: {counts}")
    for name in PHASE6_KERNELS + ("flat_sweep_topk_plane",):
        check(counts[name] > 0, f"{name} launched in phase 6 ({counts[name]}x)")

    t0 = time.perf_counter()
    vc = bindings.load(str(work / "index"), str(work / "shards"), d, device="cpu")
    qs = xq[:NQ_TWIN]
    scale = np.sum(qs * qs, axis=1) + float(np.max(np.sum(xb * xb, axis=1)))
    for method, n_probe in PHASE6_TWINS:
        Dp, Rp = (a.numpy() for a in vc.index.search_batch_device(qs, k, n_probe, method=method))
        Dc, Rc = (a[:NQ_TWIN] for a in got[(method, n_probe)][:2])
        err = np.abs(Dc - Dp)
        same = (np.sort(Rc, 1) == np.sort(Rp, 1)).all(axis=1).mean()
        check(bool(np.isfinite(Dp).all()) and bool((err <= RTOL * scale[:, None]).all())
              and same >= TWIN_SAME_FLOOR,
              f"{method} n_probe={n_probe}: card vs plain versions on the CPU, {NQ_TWIN} "
              f"queries: every rank's distance within {RTOL:g}*(|q|^2+max|x|^2) (max |err| "
              f"{float(err.max()):.3e}); equal top-{k} row sets on {same:.4f} of queries "
              f"(>= {TWIN_SAME_FLOOR})")
    log(f"  CPU comparison: {time.perf_counter() - t0:.2f}s")
    return {name: counts[name] for name in PHASE6_KERNELS}


def main() -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernels-only", action="store_true", help="stop after phase 3")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on a GPU", file=sys.stderr)
        return 1
    import numpy as np

    sys.path.insert(0, str(ROOT))
    from vector_indexer_tpu_torch.kernels import build as kb

    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions are full f32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    check = Check()

    log("== 1. environment")
    log(f"  python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"devices {torch.cuda.device_count()}")
    print(gpu_line(), flush=True)

    log("== 2. build")
    t0 = time.perf_counter()
    path = kb.build_library()
    kb.library()
    info = kb.build_info()
    log(f"  nvcc build {info.get('seconds', 0.0):.2f}s ({time.perf_counter() - t0:.2f}s with load): {path}")
    for line in info.get("log", "").splitlines():
        if "warning" in line.lower() or "error" in line.lower():
            log(f"  nvcc: {line.strip()}")

    ds = load_datasets()
    t0 = time.perf_counter()
    xb, xq = ds.clustered(N, 128, NQ, seed=42)
    log(f"  corpus clustered({N}, 128, {NQ}, seed=42) in {time.perf_counter() - t0:.2f}s")

    log("== 3. kernels vs plain versions")
    results = {}
    kernel_phase(torch, np, xb, xq, check, results, dev)
    if args.kernels_only:
        if check.failures:
            log(f"FAILED: {len(check.failures)} check(s): {check.failures}")
        return 1 if check.failures else 0

    log("== 4. main path")
    work = ROOT / "build" / "chip_smoke_work"
    shutil.rmtree(work, ignore_errors=True)
    try:
        counts, overlaps, gt = main_phase(torch, np, xb, xq, check, dev, work, results)
        log("== 5. offload and the other stream methods")
        t0 = time.perf_counter()
        counts.update(offload_phase(torch, np, xb, xq, check, dev, work, overlaps))
        log(f"  phase 5: {time.perf_counter() - t0:.2f}s")
        log("== 6. the exhaustive, int8 and gather methods")
        t0 = time.perf_counter()
        counts.update(flat_gather_phase(torch, np, xb, xq, check, dev, work, gt))
        log(f"  phase 6: {time.perf_counter() - t0:.2f}s")
    finally:
        shutil.rmtree(work, ignore_errors=True)

    counts["flat_sweep_minreduce"] = results["flat_sweep_minreduce"]["launches"]  # phase 3
    kernels = [
        dict(name=name, route="cuda", source=src, replaces=rep, launches=counts[name],
             **{key: results[name][key] for key in (
                 "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                 "library_call", "shape")})
        for name, (src, rep) in SOURCES.items()
    ]
    if check.failures:
        log(f"FAILED: {len(check.failures)} check(s): {check.failures}")
        return 1
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
