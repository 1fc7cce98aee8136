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
