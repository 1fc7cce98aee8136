#!/usr/bin/env python3
"""Profile the PyTorch port's build and 'auto' search on one NVIDIA GPU.

    python3 tools/torch_profile.py [--out FILE]

Uses chip_smoke.py's corpus (SIFT1M shape: clustered 1M x 128 f32, seed 42;
1000 queries, k = 100). ``bindings.build`` is profiled once with
torch.profiler. For each n_probe, 10 search batches are profiled after 2
warm-ups, and 10 more are timed unprofiled on the host clock. Per phase it
prints the wall ms per batch, the device ms per batch (the sum of the
device-side events the profiler recorded: kernels, copies, memsets), the
device busy share (device ms / unprofiled wall ms) and the device events
that take the most time. ``--out`` also writes the profiler's own tables.

Then the fused sweep (K3, f32) at the n_probe-128 route's plan: the share
of (64-query tile, 128-row tile) pairs the masked sweep must compute, in
the dense program's nearest-probe query order and in arrival order, and
the sweep's CUDA-event ms (mean of 5 after a warm-up, three rounds in
alternating order) with its steps split over 1 block per group and over
``sweep_splits``' count, at nq 256 and 1000, masked and unmasked, and at
chip_smoke.py's phase-3 shape (nq 256 over 269,848 random rows, w 16, C
8). Last, the unmasked sweep at rows wide enough that its query tile
streams through the ring (f32 d 384, 'int8' d 2048) beside the widest
rows where it stays resident (d 320, 1280): nq 1000 over 262,144 random
rows, w 32, C 8, ms and the product's rate, beside the bound
(chip_smoke.sweep_bound), the plain version and one library call of the
product alone (torch.matmul; torch._int_mm for 'int8').
"""

from __future__ import annotations

import argparse
import collections
import shutil
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402

N_PROBES = (8, 32, 128)  # one per route at this shape: K2, K4, K3
BATCHES, WARMUP = 10, 2


def device_events(prof):
    """(name, device microseconds) of every device-side event."""
    from torch.autograd import DeviceType

    return [(e.name, e.time_range.elapsed_us()) for e in prof.events()
            if e.device_type == DeviceType.CUDA]


def summarize(title, prof, batches, wall_ms, unprofiled_ms, top=8):
    ev = device_events(prof)
    per = collections.defaultdict(lambda: [0.0, 0])
    for name, us in ev:
        per[name][0] += us
        per[name][1] += 1
    dev_ms = sum(us for _, us in ev) / 1e3 / batches
    lines = [f"== {title}: wall {wall_ms:.3f} ms/batch profiled, "
             + (f"{unprofiled_ms:.3f} ms/batch unprofiled, " if unprofiled_ms else "")
             + f"device {dev_ms:.3f} ms/batch"
             + (f", busy share {dev_ms / unprofiled_ms:.3f}" if unprofiled_ms else "")]
    if not ev:
        lines.append("   the profiler recorded no device events")
    total = max(sum(v[0] for v in per.values()), 1e-9)
    for name, (us, calls) in sorted(per.items(), key=lambda kv: -kv[1][0])[:top]:
        lines.append(f"   {us / 1e3 / batches:9.3f} ms/batch {us / total:6.1%} {calls:6d}x  {name[:100]}")
    return "\n".join(lines)


def sweep_section(torch, vi, q) -> None:
    """Live tiles of the masked sweep and its time per split count."""
    from vector_indexer_tpu_torch.index import programs
    from vector_indexer_tpu_torch.index.dispatch import resolve
    from vector_indexer_tpu_torch.ops import flat_sweep as fs

    idx = vi.index
    lay = idx.layout
    n_rows = lay.vectors.shape[0]
    w, _, c_groups = resolve(idx, q.shape[0], 128, k=chip_smoke.K).plan
    block_run, c_ord, c_sq = idx._run_tables()
    mcols = -(-n_rows // (fs.S * w)) * fs.S * w // fs.MASK_ALIGN

    def ordered(qq):  # the dense program's order and mask
        s_ord, nearest = programs._probe_sets(qq, c_ord, c_sq, 128)
        perm = torch.argsort(nearest, stable=True)
        return qq[perm], programs._sweep_mask(s_ord[perm], block_run, mcols), s_ord

    qo, mask, s_ord = ordered(q)
    nqt = -(-q.shape[0] // 64)
    for label, m in (("nearest-probe order", mask),
                     ("arrival order", programs._sweep_mask(s_ord, block_run, mcols))):
        m = torch.cat([m, m.new_zeros((nqt * 64 - q.shape[0], mcols))])
        live = m.reshape(nqt, 64, mcols).any(1).reshape(nqt, mcols // 16, 16).any(2)
        print(f"== K3 live (query tile, 128-row tile) pairs at n_probe 128, {label}: "
              f"{float(live.float().mean()):.4f}", flush=True)

    g = torch.Generator(device=q.device).manual_seed(0)
    xr = torch.randn((269_848, 128), generator=g, device=q.device)
    qr = torch.randn((256, 128), generator=g, device=q.device)
    cases = []  # (label, queries, table, norms, mask, w, C)
    for nq in (256, q.shape[0]):
        qn, mn, _ = ordered(q[:nq])
        cases.append((f"main nq {nq} masked", qn, lay.vectors, lay.row_norms, mn, w, c_groups))
        cases.append((f"main nq {nq} flat", q[:nq], lay.vectors, lay.row_norms, None, w,
                      c_groups))
    cases.append(("phase-3 nq 256 flat", qr, xr, (xr * xr).sum(1), None, 16, 8))
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    chosen = fs.sweep_splits
    try:
        for label, qq, x, nrm, m, ww, cc in cases:
            counts = {"1": 1, "sweep_splits": chosen(qq.shape[0], x.shape[0], ww, cc, sms)}
            ms = {k: [] for k in counts}
            for r in range(3):
                for k in (list(counts) if r % 2 == 0 else list(counts)[::-1]):
                    fs.sweep_splits = lambda *a, s=counts[k]: s
                    ms[k].append(chip_smoke.cuda_ms(torch, lambda: fs.flat_sweep_topk_plane(
                        qq, x, nrm, m, metric="l2", w=ww, c_groups=cc)))
            print(f"== K3 splits, {label} (w {ww}, C {cc}): " + "; ".join(
                f"{k} = {counts[k]}: " + " / ".join(f"{v:.3f}" for v in ms[k]) + " ms"
                for k in counts), flush=True)
    finally:
        fs.sweep_splits = chosen
    del xr, qr
    for prec, d, mode in (("highest", 320, "resident"), ("highest", 384, "streamed"),
                          ("int8", 1280, "resident"), ("int8", 2048, "streamed")):
        x = torch.randn((262_144, d), generator=g, device=q.device)
        qq = torch.randn((1000, d), generator=g, device=q.device)
        nrm = (x * x).sum(1)
        if prec == "highest":
            args = (qq, x, nrm, None)
            lib = lambda: torch.matmul(qq, x.T)  # noqa: E731
        else:
            x8, r8, sx = fs.quantize_table_int8(x)
            args = (qq, x8, nrm, None, r8, sx)
            q8 = fs.quantize_queries_int8(qq)[0]
            lib = lambda: torch._int_mm(q8, x8.T)  # noqa: E731
        kw = dict(metric="l2", w=32, c_groups=8, precision=prec)
        ms = chip_smoke.cuda_ms(torch, lambda: fs.flat_sweep_topk_plane(*args, **kw))
        plain_ms = chip_smoke.cuda_ms(torch, lambda: fs.flat_sweep_topk_plane_reference(*args, **kw),
                                      reps=2)
        lib_ms = chip_smoke.library(torch, lib, "product only")["library_ms"]
        b = chip_smoke.sweep_bound(qq, x.shape[0], None, prec, 1000 * 2 * 8 * fs.S * 8)
        ops = 3 * 2.0 * 1000 * 262_144 * d  # three products in both precisions
        print(f"== K3 {prec} d {d} ({mode} query tile), nq 1000 x 262,144 rows, flat: "
              f"{ms:.3f} ms, {ops / ms / 1e9:.1f} T(FL)OP/s; bound {b['bound_ms']:.3f} ms "
              f"({b['bound_by']}), plain {plain_ms:.3f} ms, library "
              f"({'torch.matmul' if prec == 'highest' else 'torch._int_mm q8.x8'}) {lib_ms} ms",
              flush=True)
        del x, qq, nrm, args, lib


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="also write the profiler's tables to this file")
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("torch_profile: no CUDA device", file=sys.stderr)
        return 1
    from vector_indexer_tpu_torch import bindings
    from vector_indexer_tpu_torch.kernels import build as kb
    from vector_indexer_tpu_torch.utils import tracing

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    print(chip_smoke.gpu_line(), flush=True)
    kb.library()  # nvcc outside the profile
    xb, xq = chip_smoke.load_datasets().clustered(chip_smoke.N, 128, chip_smoke.NQ, seed=42)
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    tables = []
    work = ROOT / "build" / "torch_profile_work"
    shutil.rmtree(work, ignore_errors=True)
    try:
        tracing.reset_phases()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile(activities=acts) as prof:
            vi = bindings.build(xb, str(work), device=dev)
            torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        phases = {p: round(v["total_s"], 3) for p, v in tracing.phase_report().items()}
        print(summarize("build", prof, 1, wall, None, top=12), flush=True)
        print(f"   trace phases (s, profiled): {phases}", flush=True)
        tables.append(("build", prof.key_averages().table(sort_by="self_device_time_total",
                                                          row_limit=25)))
        q = torch.as_tensor(xq, device=dev)
        k = chip_smoke.K
        for n_probe in N_PROBES:
            for _ in range(WARMUP):
                vi.search_device(q, k, n_probe)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with profile(activities=acts) as prof:
                for _ in range(BATCHES):
                    vi.search_device(q, k, n_probe)
                torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / BATCHES
            t0 = time.perf_counter()
            for _ in range(BATCHES):
                vi.search_device(q, k, n_probe)
            torch.cuda.synchronize()
            unprof_ms = (time.perf_counter() - t0) * 1e3 / BATCHES
            print(summarize(f"search n_probe={n_probe}", prof, BATCHES, wall, unprof_ms),
                  flush=True)
            tables.append((f"search n_probe={n_probe}", prof.key_averages().table(
                sort_by="self_device_time_total", row_limit=25)))
        sweep_section(torch, vi, q)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "w") as f:
            f.write(chip_smoke.gpu_line() + "\n")
            for title, table in tables:
                f.write(f"== {title}\n{table}\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
