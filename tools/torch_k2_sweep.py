#!/usr/bin/env python3
"""Sweep the sizes of K2's split launch (wide rows) on one NVIDIA GPU.

    python3 tools/torch_k2_sweep.py

Builds chip_smoke.py phase 11's two wide corpora on the card (100,000 x
16,384, seed 11; 262,144 x 1,536, seed 13; Lloyd at WIDE_ITERS iterations)
and, at each (table type, nq, n_probe) below, checks K2 (valid rows only)
against its plain version, splits one call's device time between its two
kernels with torch.profiler at nq 1 (the partial-dot kernel and the finish
kernel, which waits inside for the partial kernel's completion, so its
device time includes that wait), then times K2 by graph replay
(chip_smoke.graph_ms) with the plan's sizes as shipped and with one
constant of ``ops/block_stream.py`` changed at a time (K2_LANE_BYTES,
K2_SLICE_ELEMS), beside the per-query bound (each query's valid rows,
norms and output over 3.35 TB/s). One JSON line per (shape, variant);
exits 1 if a check fails. Needs one CUDA device.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

VARIANTS = (("shipped", {}), ("K2_LANE_BYTES=256K", {"K2_LANE_BYTES": 256 << 10}),
            ("K2_LANE_BYTES=1M", {"K2_LANE_BYTES": 1 << 20}),
            ("K2_SLICE_ELEMS=1024", {"K2_SLICE_ELEMS": 1024}),
            ("K2_SLICE_ELEMS=4096", {"K2_SLICE_ELEMS": 4096}))
SHAPES_16K = (("bf16", 1, 8), ("bf16", 1, 20), ("bf16", 1, 64), ("bf16", 16, 8),
              ("bf16", 16, 20), ("bf16", 256, 8), ("int8", 1, 8), ("int8", 1, 20),
              ("int8", 16, 8), ("int8", 256, 8), ("f32", 16, 8))
SHAPES_1536 = (("bf16", 1, 8), ("bf16", 1, 20), ("bf16", 16, 8), ("bf16", 16, 20),
               ("bf16", 256, 8), ("bf16", 256, 20))


def main() -> int:
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from vector_indexer_tpu_torch.index.ivf import IvfIndex
    from vector_indexer_tpu_torch.kernels import build as kb
    from vector_indexer_tpu_torch.ops import block_stream as bs
    from vector_indexer_tpu_torch.storage.vector_store import VectorStore

    if not torch.cuda.is_available():
        print("torch_k2_sweep: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    kb.build_library()
    kb.library()
    gpu = cs.gpu_line()
    print(gpu, flush=True)
    check = cs.Check()
    dtypes = {"bf16": torch.bfloat16, "int8": torch.int8, "f32": torch.float32}

    def sweep(n, d, seed, shapes):
        xb_dev, xq = cs.clustered_on_card(torch, n, d, 256, seed, dev)
        xb = xb_dev.cpu().numpy()
        del xb_dev
        idx = IvfIndex.fit(VectorStore(external_ids=np.arange(n, dtype=np.uint64), vectors=xb),
                           seed=42, max_iters=cs.WIDE_ITERS, device=dev)
        del xb
        c, c_sq = idx._device_tables()
        for mode, nq, n_probe in shapes:
            tb = idx._stream_table(dtypes[mode])
            q = xq[:nq]
            grid = cs.stream_grid(q, tb, c, c_sq, idx.layout.lengths, n_probe, "l2")
            kw = cs.k2_kw(tb, grid, "l2", True)
            fn = lambda: bs.stream_distances(*cs.k2_args(q, tb, grid), **kw)
            ok, err = cs.check_k2(q, tb, grid, "l2", True)
            check(ok, f"K2 {mode} d={d} nq={nq} n_probe={n_probe}: max |err| {err:.3e}")
            bound = cs.stream_bound(q, tb, grid, nq * grid["t_fixed"] * tb.chunk * 4,
                                    per_query=True)["bound_ms"]
            if nq == 1:
                fn()
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    for _ in range(10):
                        fn()
                    torch.cuda.synchronize()
                us = {ev.key.split("::")[-1].split("<")[0]: ev.device_time_total / ev.count
                      for ev in prof.key_averages() if ev.device_time_total > 0}
                print(json.dumps(dict(d=d, table=mode, nq=nq, n_probe=n_probe,
                                      device_us_per_call=us, gpu=gpu)), flush=True)
            for name, consts in VARIANTS:
                saved = {k: getattr(bs, k) for k in consts}
                for k, v in consts.items():
                    setattr(bs, k, v)
                plan = bs.stream_distances_split_plan(d, tb.vecs.element_size(), tb.chunk, nq,
                                                      grid["t_fixed"], kb.sm_count(dev))
                ms = cs.graph_ms(torch, fn)
                for k, v in saved.items():
                    setattr(bs, k, v)
                print(json.dumps(dict(
                    d=d, table=mode, nq=nq, n_probe=n_probe, t_fixed=grid["t_fixed"],
                    variant=name, blocks=plan.blocks, parts=plan.parts, n_slices=plan.n_slices,
                    ms=ms, per_query_bound_ms=bound, share=bound / ms, gpu=gpu)), flush=True)
        del idx
        cs.gc_collect(torch)

    t0 = time.perf_counter()
    sweep(cs.WIDE_N, cs.WIDE_D, cs.WIDE_SEED, SHAPES_16K)
    sweep(cs.W1536_N, cs.W1536_D, cs.W1536_SEED, SHAPES_1536)
    print(f"{check.n} checks, {len(check.failures)} failed, {time.perf_counter() - t0:.1f}s",
          flush=True)
    return 1 if check.failures else 0


if __name__ == "__main__":
    sys.exit(main())
