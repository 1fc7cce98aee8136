#!/usr/bin/env python3
"""Check and time the port's multi-device layer across several cards.

    python3 tools/torch_mesh_check.py      # every card present (>= 2)

Builds the smoke's corpus (``benchmarks/datasets.py::clustered(1M, 128,
1000, seed=42)``, nlist from the heuristics) on card 0 in a work directory
it removes at the end, then compares a ``ShardedSearcher`` over the n cards
present with one over card 0 named n times: for each body at n_probe 8 /
32 / 128 the n-card mesh must return the one-card mesh's results (the same
tables and kernels on other cards: equal id sets on >= 0.999 of queries,
distances within 1e-5 of |q|^2 + max|x|^2); both are timed (host clock
around ``search_batch``, which ends in a copy to the host after the merge
on card 0; mean of 3 after a warm-up). Then it runs phase 9's own checks of
``chip_smoke.py`` on the n cards: the per-device loop under the sync debug
mode, ``Sharded2DSearcher`` and ``MultiHostSearcher`` on a 2 x (n/2) grid,
and the data-parallel Lloyd beside the single-device one. The last line is
a JSON object with every timing, the card names and power limits. Exits 1
on a failed check, without two cards, or without a card.
"""

from __future__ import annotations

import importlib.util
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

N = 1_000_000
N_PROBES = (8, 32, 128)
RTOL = 1e-5
SAME_FLOOR = 0.999
K, NQ = 100, 1000


def host_ms(fn, reps: int = 3) -> float:
    fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps * 1e3


def run(torch, np, xb, xq, index, multi, single, check) -> dict:
    """The n cards ``multi`` against card 0 n times (``single``), then
    phase 9's sync, grid and data-parallel checks on ``multi``."""
    import chip_smoke as smoke
    from vector_indexer_tpu_torch.parallel import Mesh, ShardedSearcher

    out = {"searches": []}
    scale = np.sum(xq * xq, axis=1) + float(np.max(np.sum(xb * xb, axis=1)))
    s_multi = ShardedSearcher(index, Mesh(multi, ("shards",)))
    s_single = ShardedSearcher(index, Mesh(single, ("shards",)))
    for method in ("dense", "dense_fused", "stream"):
        for n_probe in N_PROBES:
            row = dict(method=method, n_probe=n_probe)
            res = {}
            for name, s in (("multi", s_multi), ("single", s_single)):
                s.method = method
                row[f"{name}_ms"] = host_ms(lambda: s.search_batch(xq, K, n_probe))
                res[name] = s.search_batch(xq, K, n_probe)
            (Dm, Im), (Ds, Is) = res["multi"], res["single"]
            same = smoke.sets_equal_share(np, Im, Is)
            err = float(np.abs(Dm - Ds).max())
            row.update(body=s_multi.last_method, same=same, max_err=err)
            out["searches"].append(row)
            smoke.log(f"  {method:11s} n_probe={n_probe:4d}: {len(multi)} cards "
                      f"{row['multi_ms']:9.3f} ms, card 0 x{len(single)} {row['single_ms']:9.3f} "
                      f"ms; equal sets {same:.4f}, max |err| {err:.3e}")
            check(same >= SAME_FLOOR and bool((np.abs(Dm - Ds) <= RTOL * scale[:, None]).all()),
                  f"{method} n_probe={n_probe}: {len(multi)} cards return card 0's results")
    smoke.sync_check(torch, s_multi, xq, K, check)

    s_multi.method = "dense"
    _, I1 = s_multi.search_batch(xq, K, 32)
    flat_list = s_multi.last_merge_bytes["shards"] // (s_multi.n_dev - 1)
    if len(multi) % 2 == 0:
        out["grid"] = smoke.grid_check(torch, np, index, multi, xq, K, I1, flat_list, check)
    del s_multi, s_single
    smoke.gc_collect(torch)
    xb_dev = torch.as_tensor(xb, device=multi[0])
    out["dp"] = smoke.dp_lloyd_check(torch, xb, xb_dev, index.num_clusters,
                                     Mesh(multi, ("shards",)), check)
    return out


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        print("torch_mesh_check: needs two or more CUDA devices", file=sys.stderr)
        return 1
    import chip_smoke as smoke
    from vector_indexer_tpu_torch import bindings

    torch.backends.cuda.matmul.allow_tf32 = False
    n_dev = torch.cuda.device_count()
    multi = [torch.device("cuda", i) for i in range(n_dev)]
    single = [torch.device("cuda", 0)] * n_dev
    cards = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                           capture_output=True, text=True, check=True).stdout.strip().splitlines()
    print("\n".join(cards), flush=True)
    spec = importlib.util.spec_from_file_location("datasets", ROOT / "benchmarks" / "datasets.py")
    ds = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ds)
    xb, xq = ds.clustered(N, 128, NQ, seed=42)
    work = ROOT / "build" / "mesh_check_work"
    check = smoke.Check()
    try:
        t0 = time.perf_counter()
        vi = bindings.build(xb, str(work), device=multi[0])
        print(f"build on card 0: {time.perf_counter() - t0:.2f}s, nlist {vi.nlist}", flush=True)
        out = run(torch, np, xb, xq, vi.index, multi, single, check)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    out.update(cards=cards, n=N, n_dev=n_dev, failures=check.failures)
    print(json.dumps(out), flush=True)
    return 1 if check.failures else 0


if __name__ == "__main__":
    sys.exit(main())
