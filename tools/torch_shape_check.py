#!/usr/bin/env python3
"""Check the PyTorch port's CUDA kernels at shapes off the main path.

    python3 tools/torch_shape_check.py

chip_smoke.py checks each kernel at the SIFT1M main path's shapes; this
script runs the same checks (chip_smoke's ``check_k1`` .. ``check_k3``, same
tolerances) over odd sizes, dimensions, chunks, windows, group counts and
both metrics, then searches one saved index on the card and on the CPU
(where every kernel runs its plain version) for each search method of the
slice and both metrics, and compares the results rank by rank. Exits 1 if
any check fails. Needs one CUDA device.
"""

from __future__ import annotations

import itertools
import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from chip_smoke import RTOL, check_k1, check_k2, check_k3, check_k4, stream_grid  # noqa: E402

K1_SHAPES = ((1, 1, 8), (1000, 600, 64), (777, 3, 130), (5000, 513, 96), (64, 4000, 128))
STREAM_DIMS = (32, 64, 96, 128)
STREAM_CHUNKS = (256, 512, 1024)
STREAM_PROBES = (1, 5, 17)
SWEEP_DIMS = (16, 64, 128)
SWEEP_WC = ((8, 1), (16, 2), (32, 8), (8, 8))  # (w, C)
SWEEP_NQ = (1, 37, 300)


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_shape_check: no CUDA device", file=sys.stderr)
        return 1
    from vector_indexer_tpu_torch import bindings
    from vector_indexer_tpu_torch.index.ivf import IvfIndex
    from vector_indexer_tpu_torch.ops.block_stream import build_stream_table
    from vector_indexer_tpu_torch.storage.vector_store import VectorStore

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    print(chip_smoke.gpu_line(), flush=True)
    check = chip_smoke.Check()
    ds = chip_smoke.load_datasets()
    g = torch.Generator(device=dev).manual_seed(3)

    print("== K1 assign_argmin", flush=True)
    for n, k, d in K1_SHAPES:
        x = torch.randn((n, d), generator=g, device=dev)
        cent = torch.randn((k, d), generator=g, device=dev)
        ok, n_diff, err = check_k1(x, cent)
        check(ok, f"K1 n={n} k={k} d={d}: {n_diff} near-tie label differences, max |err| {err:.3e}")

    print("== K2 stream_distances / K4 stream_fused_plane", flush=True)
    for d in STREAM_DIMS:
        xb, xq = ds.clustered(40_000, d, 64, seed=d)
        store = VectorStore(external_ids=np.arange(len(xb), dtype=np.uint64), vectors=xb)
        idx = IvfIndex.fit(store, seed=1, nlist=64, max_iters=5, device=dev)
        c, c_sq = idx._device_tables()
        q = torch.as_tensor(xq, device=dev)
        for chunk in STREAM_CHUNKS:
            table = build_stream_table(idx.layout, idx.centroids, chunk=chunk)
            for n_probe, metric in itertools.product(STREAM_PROBES, ("l2", "ip")):
                grid = stream_grid(q, table, c, c_sq, idx.layout.lengths, n_probe, metric)
                what = f"d={d} chunk={chunk} n_probe={n_probe} t_fixed={grid['t_fixed']} {metric}"
                ok, err = check_k2(q, table, grid, metric)
                check(ok, f"K2 {what}: max |err| {err:.3e}")
                ok, n_mism, err = check_k4(q, table, grid, metric)
                check(ok, f"K4 {what}: {n_mism} near-tie slot differences, max |err| {err:.3e}")

    print("== K3 flat_sweep_topk_plane", flush=True)
    for d in SWEEP_DIMS:
        xb, xq = ds.clustered(30_000, d, max(SWEEP_NQ), seed=100 + d)
        store = VectorStore(external_ids=np.arange(len(xb), dtype=np.uint64), vectors=xb)
        idx = IvfIndex.fit(store, seed=1, nlist=64, max_iters=5, device=dev)
        lay = idx.layout
        for (w, C), nq, metric in itertools.product(SWEEP_WC, SWEEP_NQ, ("l2", "ip")):
            q = torch.as_tensor(xq[:nq], device=dev)
            for label, mask in (("flat", None), ("masked", chip_smoke.sweep_mask(q, idx, 8, w))):
                ok, n_mism, err = check_k3(q, lay.vectors, lay.row_norms, mask, metric, w, C)
                check(ok, f"K3 d={d} w={w} C={C} nq={nq} {metric} {label}: {n_mism} near-tie "
                          f"row differences, max |err| {err:.3e}")

    print("== search: card vs CPU on one saved index", flush=True)
    xb, xq = ds.clustered(60_000, 128, 100, seed=5)
    work = ROOT / "build" / "torch_shape_check_work"
    for metric in ("l2", "cosine"):
        shutil.rmtree(work, ignore_errors=True)
        try:
            bindings.build(xb, str(work), metric=metric, device=dev)
            on = {name: bindings.load(str(work / "index"), str(work / "shards"), 128, device=name)
                  for name in ("cuda", "cpu")}
        finally:
            shutil.rmtree(work, ignore_errors=True)
        if metric == "cosine":
            scale = np.full(len(xq), 2.0)  # unit vectors: |q.x| + |q||x| <= 2
        else:
            scale = np.sum(xq * xq, axis=1) + float(np.max(np.sum(xb * xb, axis=1)))
        for method in ("stream", "dense", "dense_exact", "auto"):
            Dc, Rc = (t.cpu().numpy() for t in on["cuda"].index.search_batch_device(
                xq, 50, 8, method=method))
            Dp, Rp = (t.numpy() for t in on["cpu"].index.search_batch_device(
                xq, 50, 8, method=method))
            fin = np.isfinite(Dp)
            err = np.abs(np.where(fin, Dc - Dp, 0.0))
            same = (np.sort(Rc, 1) == np.sort(Rp, 1)).all(axis=1).mean()
            check(bool((np.isfinite(Dc) == fin).all()) and bool((err <= RTOL * scale[:, None]).all())
                  and same >= chip_smoke.TWIN_SAME_FLOOR,
                  f"search {metric} {method}: ranks within {RTOL:g}*scale (max |err| "
                  f"{float(err.max()):.3e}), equal row sets on {same:.4f} of queries")

    if check.failures:
        print(f"FAILED: {len(check.failures)} check(s)", flush=True)
        return 1
    print("all shape checks passed", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
