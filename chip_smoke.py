#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA GPU and check it.

    python3 chip_smoke.py            # on the first CUDA device

Phases (each prints its own lines; any failure exits non-zero):

0. No CUDA device: exit 1 without a result.
1. Environment: torch / CUDA versions and the card's name and power limit.
2. Build: compile vector_indexer_tpu_torch/csrc with nvcc (seconds printed).
3. Kernels: each CUDA kernel of the main path (K1 assign_argmin, K2
   stream_distances, K4 stream_fused_plane, K3 flat_sweep_topk_plane) vs its
   plain PyTorch version on the same device inputs at main-path shapes, with
   the tolerance stated beside it, timed with CUDA events.
4. Main path: ``bindings.build`` on a SIFT1M-shaped corpus (1M x 128 f32,
   clustered, seed 42), ``bindings.load``, then ``search_device`` with
   method 'auto' at the n_probe values whose resolved programs cover K2, K4
   and K3; recall and the share of the exact top-100 returned, against an
   exact ground truth computed on the card; a single-query
   ``VectorIndexer.search_sync`` self-hit; the peak device memory. The launch counters are reset just before this phase and read
   just after it: every kernel must have run inside it. Then 200 of the
   queries are searched again on the CPU, where every kernel runs its
   plain version, at one n_probe per route and the largest: the card's
   results must agree rank by rank.

The line before the last is a JSON object describing each kernel; the last
line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import importlib.util
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

SOURCES = {
    "assign_argmin": ("vector_indexer_tpu_torch/csrc/assign.cu",
                      "vector_indexer_tpu/ops/pallas/assign.py:80"),
    "stream_distances": ("vector_indexer_tpu_torch/csrc/block_stream.cu",
                         "vector_indexer_tpu/ops/pallas/block_stream.py:611"),
    "stream_fused_plane": ("vector_indexer_tpu_torch/csrc/block_stream.cu",
                           "vector_indexer_tpu/ops/pallas/block_stream.py:773"),
    "flat_sweep_topk_plane": ("vector_indexer_tpu_torch/csrc/flat_sweep.cu",
                              "vector_indexer_tpu/ops/pallas/flat_sweep.py:473"),
}
RTOL = 1e-5  # of the magnitude of the terms each distance is summed from
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


def stream_grid(q, table, c, c_sq, lengths, n_probe: int, metric: str):
    """The stream program's task grid for these queries, and the magnitude
    of the terms each distance is summed from (l2 |q-c|^2 + |r|^2, which
    bounds 2|q-c||r|; ip |q.c| + |q||r|)."""
    import torch
    from vector_indexer_tpu_torch.index import programs
    from vector_indexer_tpu_torch.ops import block_stream as bs

    t_fixed = bs.per_query_slots(lengths, n_probe, chunk=table.chunk)
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


def k2_args(q, table, grid):
    return (q, table.cent, grid["cid"], grid["blk"], grid["bias"], table.vecs, table.norms)


def k4_args(q, table, grid):
    return (q, table.cent, grid["cid"], grid["blk"], grid["nval"], grid["bias"],
            table.vecs, table.norms)


def check_k2(q, table, grid, metric: str):
    """K2 vs its plain version on the valid lanes. -> (ok, max |err|)."""
    import torch
    from vector_indexer_tpu_torch.ops import block_stream as bs

    args = k2_args(q, table, grid)
    dist_k = bs.stream_distances(*args, chunk=table.chunk, metric=metric)
    dist_p = bs.stream_distances_reference(*args, chunk=table.chunk, metric=metric)
    torch.cuda.synchronize()
    valid = grid["valid"]
    err = (dist_k - dist_p).abs()[valid]
    return bool((err <= RTOL * grid["term"][valid]).all()), float(err.max())


def check_k4(q, table, grid, metric: str):
    """K4 vs its plain version: planes within RTOL of the query's term
    scale, and a different slot only where its distance is a near-tie.
    -> (ok, slot differences, max |err|)."""
    import torch
    from vector_indexer_tpu_torch.ops import block_stream as bs

    kw = dict(chunk=table.chunk, groups=bs.pick_stream_groups(table.chunk), metric=metric)
    pk, sk = bs.stream_fused_plane(*k4_args(q, table, grid), **kw)
    pp, sp = bs.stream_fused_plane_reference(*k4_args(q, table, grid), **kw)
    dist_p = bs.stream_distances_reference(*k2_args(q, table, grid), chunk=table.chunk,
                                           metric=metric)
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


def check_k3(q, vectors, row_norms, mask, metric: str, w: int, C: int):
    """K3 vs its plain version: values within RTOL of |x|^2 + 2|q||x|, and a
    different row only where its distance is a near-tie.
    -> (ok, row differences, max |err|)."""
    import torch
    from vector_indexer_tpu_torch.ops import flat_sweep as fs

    real = row_norms < 1e29
    max_norm = float(row_norms[real].max())
    scale = (max_norm + 2 * q.norm(dim=1) * max_norm ** 0.5)[:, None]
    kw = dict(metric=metric, w=w, c_groups=C)
    vk, rk = fs.flat_sweep_topk_plane(q, vectors, row_norms, mask, **kw)
    vp, rp = fs.flat_sweep_topk_plane_reference(q, vectors, row_norms, mask, **kw)
    torch.cuda.synchronize()
    fin = torch.isfinite(vp)
    same_fin = bool((torch.isfinite(vk) == fin).all())
    ok = fin & (vp < 1e29)
    err = (vk - vp).abs()[ok]
    vals_ok = bool((err <= RTOL * scale.expand_as(vp)[ok]).all())
    mism = torch.nonzero((rk != rp) & ok)
    qi, col = mism[:, 0], mism[:, 1]
    ra, rb = rk[qi, col].long(), rp[qi, col].long()
    qd = q[qi].double()
    wgt = 2.0 if metric == "l2" else 1.0
    na = row_norms[ra].double() if metric == "l2" else 0.0
    nb = row_norms[rb].double() if metric == "l2" else 0.0
    da = na - wgt * (qd * vectors[ra].double()).sum(1)
    db = nb - wgt * (qd * vectors[rb].double()).sum(1)
    ties_ok = bool(((da - db).abs() <= 2 * RTOL * scale[qi, 0].double()).all())
    return same_fin and vals_ok and ties_ok, len(mism), float(err.max()) if err.numel() else 0.0


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


def kernel_phase(torch, np, xb, xq, check, results, dev):
    from vector_indexer_tpu_torch.index.ivf import IvfIndex
    from vector_indexer_tpu_torch.ops import assign, block_stream as bs, flat_sweep as fs
    from vector_indexer_tpu_torch.storage.vector_store import VectorStore

    # K1 at the build's final-assignment shape: 65,536 points x 4,000 x 128.
    x = torch.as_tensor(xb[:65536], device=dev)
    g = torch.Generator(device=dev).manual_seed(1)
    cent = x[torch.randperm(x.shape[0], generator=g, device=dev)[:4000]]
    cent = cent + 0.1 * torch.randn(cent.shape, generator=g, device=dev)
    ok, n_diff, err = check_k1(x, cent)
    check(ok, f"K1 assign_argmin vs plain: {n_diff} label differences, all near-ties "
              f"(|score gap| <= {RTOL:g}*(|x|^2+|c|^2)); max |dist err| {err:.3e}")
    results["assign_argmin"] = dict(
        max_abs_err=err,
        ms=cuda_ms(torch, lambda: assign.assign_argmin(x, cent)),
        plain_ms=cuda_ms(torch, lambda: assign.assign_argmin_reference(x, cent)),
        shape=f"{x.shape[0]} x 4000 x 128",
    )
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
    # (timed), then the same inputs under ip (checked only).
    for metric in ("l2", "ip"):
        for n_probe, name in ((8, "stream_distances"), (32, "stream_fused_plane")):
            grid = stream_grid(q, table, c, c_sq, idx.layout.lengths, n_probe, metric)
            what = (f"({metric}, nq={nqk}, n_probe={n_probe}, t_fixed={grid['t_fixed']}, "
                    f"chunk={table.chunk})")
            if name == "stream_distances":
                ok, err = check_k2(q, table, grid, metric)
                check(ok, f"K2 stream_distances vs plain {what}: |err| <= {RTOL:g}*(term "
                          f"magnitude) on valid lanes; max |err| {err:.3e}")
                kw = dict(chunk=table.chunk, metric=metric)
                fn_k = lambda: bs.stream_distances(*k2_args(q, table, grid), **kw)
                fn_p = lambda: bs.stream_distances_reference(*k2_args(q, table, grid), **kw)
            else:
                ok, n_mism, err = check_k4(q, table, grid, metric)
                G = bs.pick_stream_groups(table.chunk)
                check(ok, f"K4 stream_fused_plane vs plain {what}, G={G}: planes within "
                          f"{RTOL:g}*(query term scale), {n_mism} slot differences all "
                          f"near-ties; max |err| {err:.3e}")
                kw = dict(chunk=table.chunk, groups=G, metric=metric)
                fn_k = lambda: bs.stream_fused_plane(*k4_args(q, table, grid), **kw)
                fn_p = lambda: bs.stream_fused_plane_reference(*k4_args(q, table, grid), **kw)
            if metric == "l2":
                results[name] = dict(
                    max_abs_err=err, ms=cuda_ms(torch, fn_k), plain_ms=cuda_ms(torch, fn_p),
                    shape=f"nq={nqk} t_fixed={grid['t_fixed']} chunk={table.chunk} d=128",
                )

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
    results["flat_sweep_topk_plane"] = dict(
        max_abs_err=max(errs), ms=times["masked"][0], plain_ms=times["masked"][1],
        shape=f"nq={nqk} n_rows={n_rows} w={w} C={C} (ms: masked, n_probe=64)",
    )
    for name in ("assign_argmin", "stream_distances", "stream_fused_plane"):
        r = results[name]
        log(f"  {name}: kernel {r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms ({r['shape']})")


# ---------------------------------------------------------------------------
# Phase 4: the main path
# ---------------------------------------------------------------------------


def main_phase(torch, np, xb, xq, check, dev, work):
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
    for name, c in counts.items():
        check(c > 0, f"{name} launched in the main path ({c}x)")

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
    return counts


def main() -> int:
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
        if "registers" in line or "spill" in line or "error" in line.lower():
            log(f"  ptxas: {line.strip()}")

    ds = load_datasets()
    t0 = time.perf_counter()
    xb, xq = ds.clustered(N, 128, NQ, seed=42)
    log(f"  corpus clustered({N}, 128, {NQ}, seed=42) in {time.perf_counter() - t0:.2f}s")

    log("== 3. kernels vs plain versions")
    results = {}
    kernel_phase(torch, np, xb, xq, check, results, dev)

    log("== 4. main path")
    work = ROOT / "build" / "chip_smoke_work"
    shutil.rmtree(work, ignore_errors=True)
    try:
        counts = main_phase(torch, np, xb, xq, check, dev, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    kernels = [
        dict(name=name, route="cuda", source=src, replaces=rep, launches=counts[name],
             max_abs_err=results[name]["max_abs_err"], ms=results[name]["ms"],
             plain_ms=results[name]["plain_ms"])
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
