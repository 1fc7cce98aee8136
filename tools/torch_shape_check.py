#!/usr/bin/env python3
"""Check the PyTorch port's CUDA kernels at shapes off the main path.

    python3 tools/torch_shape_check.py

chip_smoke.py checks each kernel at the SIFT1M paths' shapes; this script
runs the same checks (chip_smoke's ``check_k1`` .. ``check_k7``, same
tolerances) over odd sizes (K1 also with every centroid duplicated, where
the lower id must win each exact tie), dimensions, chunks, table types
(K2 with and without the slots' valid counts; K2 bf16 /
int8 / f32, K4 bf16 / int8, K5 bf16 / int8 / f32 at every stream d, with
rows that are not 16-byte multiples and panels of 16 rows; K2, K4 and K5 on
rows too wide for K5's 16-row ring (8- and 4-row panels) and past each
kernel's wide-row mode change (K4's panels past ~13,500 dims, K5's
K-panels past ~14,400-57,800, K2's panels past ~50,000) up to d 65,536,
odd widths included; K4 also at nq 1, its split launch; K3 f32 / int8 /
int8x1, at d on both sides of each
kernel's mode changes), windows, group counts, list lengths (K6: short and
long lists, empty probes, its item launch past d 12,288 or ~1 MB of a
segment's rows, and the query in panels past 57,344 dims) and both
metrics, then searches one saved index on the card
and on the CPU (where every kernel runs its plain version) for each search
method of the port, and offloaded in each re-rank mode, for both metrics,
and compares the results rank by rank. Exits 1 if any check fails. Needs
one CUDA device.
"""

from __future__ import annotations

import itertools
import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from chip_smoke import (  # noqa: E402
    RTOL,
    check_k1,
    check_k2,
    check_k3,
    check_k4,
    check_k5,
    check_k6,
    check_k7,
    shared_tasks,
    stream_grid,
)

# K1 at ragged shapes: n past a 128-point tile, k past a 64-centroid tile
# and below one, d not a multiple of 4 (padded) and past the resident point
# tile (d > 160 streams it through the ring).
K1_N = (1, 63, 65_537)
K1_K = (1, 63, 513, 8192)
K1_D = (20, 100, 128, 768)
# K4 reads rows in 16-byte chunks: d 20 (bf16 rows of 40 B) takes its
# element-wise path, d 512 / 1024 two and four chunks per lane, d > 1024 its
# wide mode (bf16 and int8; d 1100: rows that are not 16-byte multiples).
STREAM_DIMS = (20, 32, 64, 96, 128, 512, 1024, 1100, 1536, 2048)
STREAM_CHUNKS = (256, 512, 1024)
STREAM_PROBES = (1, 5, 17)
QUANT_DIMS = (32, 96, 128, 1024)  # dims of the int8 / f32 tables (K5 runs at every d)
# Wide rows: (d, table types). K5's two 16-row stages pass the 227 KB of
# shared memory past f32 d ~1800, bf16 ~3600, int8 ~7200 (f32 d 7200 takes
# one 8-row stage, d 10,000 one 4-row stage) and it takes K-panels past f32
# d ~14,400, bf16 ~28,900, int8 ~57,800 and at odd int8 widths past ~7200;
# K4 (bf16, int8) takes panels past bf16 ~13,500 and int8 ~18,000; K2 past
# ~50,000; K6 keeps 12,288 query elements in shared memory. 12,289, 16,385
# and 65,535 give rows that are no 16-byte multiple in every type.
K5_WIDE = ((2048, ("f32",)), (4096, ("bf16", "f32")), (7200, ("bf16", "int8", "f32")),
           (7201, ("int8",)), (10_000, ("f32",)), (12_289, ("bf16", "int8", "f32")),
           (16_384, ("bf16", "int8", "f32")), (16_385, ("bf16", "int8", "f32")),
           (20_000, ("bf16", "int8", "f32")), (32_768, ("bf16", "int8", "f32")),
           (65_535, ("bf16", "int8", "f32")), (65_536, ("bf16", "int8", "f32")))
SEARCH_METHODS = ("stream", "stream_exact", "stream_shared", "stream_shared_exact", "dense",
                  "dense_exact", "auto", "flat", "flat_exact", "flat_fused", "flat_int8",
                  "flat_int8x1", "dense_int8", "dense_int8x1", "gather", "gather_dma")
# K3 f32 keeps the query tile resident up to d 320 and streams it beyond;
# past d 128 it adds its partial sums every 128 dims.
SWEEP_DIMS = (16, 64, 128, 320, 384, 768, 2048)
SWEEP_WC = ((8, 1), (16, 2), (32, 8), (8, 8))  # (w, C)
SWEEP_NQ = (1, 37, 300)
# K3's int8 modes and K7; 'int8' streams its query tile past d 1280.
INT8_DIMS = (128, 256, 1280, 2048)
K7_WINDOWS = (8, 16, 32)
# K6: (d, max_len, probes per query, every how many lists is empty); one
# block per (query, probe) where d <= 12,288 and one ~1 MB item holds a
# segment (d 128 up to 2,048 slots), items past that (d 128 at 4,100 slots,
# d 2048 at 2,000), the query in panels past 57,344 dims.
K6_CASES = ((16, 40, 4, 3), (96, 300, 8, 5), (128, 700, 32, 4), (128, 2000, 6, 2),
            (128, 4100, 6, 2), (2048, 2000, 6, 3), (12_289, 300, 8, 5), (16_384, 700, 8, 4),
            (16_385, 200, 6, 3), (57_345, 40, 4, 3), (65_536, 300, 4, 3))


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_shape_check: no CUDA device", file=sys.stderr)
        return 1
    from vector_indexer_tpu_torch import bindings
    from vector_indexer_tpu_torch.index.ivf import IvfIndex, load_index_from
    from vector_indexer_tpu_torch.ops import block_stream as bs
    from vector_indexer_tpu_torch.ops.block_stream import build_stream_table
    from vector_indexer_tpu_torch.ops.gather import candidate_budget
    from vector_indexer_tpu_torch.storage.vector_store import VectorStore

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    print(chip_smoke.gpu_line(), flush=True)
    check = chip_smoke.Check()
    ds = chip_smoke.load_datasets()
    g = torch.Generator(device=dev).manual_seed(3)

    print("== K1 assign_argmin", flush=True)
    from vector_indexer_tpu_torch.ops.assign import assign_argmin

    for n, k, d in itertools.product(K1_N, K1_K, K1_D):
        x = torch.randn((n, d), generator=g, device=dev)
        cent = torch.randn((k, d), generator=g, device=dev)
        ok, n_diff, err = check_k1(x, cent)
        check(ok, f"K1 n={n} k={k} d={d}: {n_diff} near-tie label differences, max |err| {err:.3e}")
        if k > 1:  # centroid 2i + 1 repeats centroid 2i: the even id wins every tie
            cent[1::2] = cent[0::2][: k // 2]
            ok, n_diff, err = check_k1(x, cent)
            even = bool((assign_argmin(x, cent)[0] % 2 == 0).all())
            check(ok and even, f"K1 n={n} k={k} d={d}, duplicated centroids: {n_diff} near-tie "
                               f"label differences, lower id on every tie {even}, max |err| {err:.3e}")

    print("== K2 stream_distances / K4 stream_fused_plane / K5 stream_shared_plane", flush=True)
    for d in STREAM_DIMS:
        xb, xq = ds.clustered(40_000, d, 64, seed=d)
        store = VectorStore(external_ids=np.arange(len(xb), dtype=np.uint64), vectors=xb)
        idx = IvfIndex.fit(store, seed=1, nlist=64, max_iters=5, device=dev)
        c, c_sq = idx._device_tables()
        q = torch.as_tensor(xq, device=dev)
        lengths = idx.layout.lengths
        modes = ((torch.bfloat16, torch.int8, torch.float32) if d in QUANT_DIMS
                 else (torch.bfloat16, torch.int8) if d > 1024 else (torch.bfloat16,))
        for chunk, dtype in itertools.product(STREAM_CHUNKS, modes):
            table = build_stream_table(idx.layout, idx.centroids, dtype, chunk=chunk)
            for n_probe, metric in itertools.product(STREAM_PROBES, ("l2", "ip")):
                exact = dtype == torch.float32
                grid = stream_grid(q, table, c, c_sq, lengths, n_probe, metric, worst_case=exact)
                what = (f"{dtype} d={d} chunk={chunk} n_probe={n_probe} "
                        f"t_fixed={grid['t_fixed']} {metric}")
                for nval in (False, True):
                    ok, err = check_k2(q, table, grid, metric, nval)
                    check(ok, f"K2 {what}{' nval2d' if nval else ''}: max |err| {err:.3e}")
                if not exact:
                    ok, n_mism, err = check_k4(q, table, grid, metric)
                    check(ok, f"K4 {what}: {n_mism} near-tie slot differences, max |err| {err:.3e}")
                t_cap = bs.shared_task_cap(lengths, n_probe, len(q), grid["t_fixed"],
                                           worst_case=exact, chunk=chunk)
                tasks = shared_tasks(q, table, c, c_sq, lengths, n_probe, grid["t_fixed"],
                                     t_cap, metric)
                ok, err = check_k5(table, tasks, metric)
                check(ok, f"K5 {what} t_cap={t_cap}: max |err| {err:.3e}")

    dtypes = {"bf16": torch.bfloat16, "int8": torch.int8, "f32": torch.float32}
    for d, types in K5_WIDE:
        n = 8192 if d <= 20_000 else 4096
        xb, xq = chip_smoke.clustered_on_card(torch, n, d, 16, d, dev)
        store = VectorStore(external_ids=np.arange(n, dtype=np.uint64), vectors=xb.cpu().numpy())
        del xb
        idx = IvfIndex.fit(store, seed=1, nlist=16, max_iters=3, device=dev)
        c, c_sq = idx._device_tables()
        q = xq
        lengths = idx.layout.lengths
        for chunk, mode in itertools.product((256, 1024), types):
            table = build_stream_table(idx.layout, idx.centroids, dtypes[mode], chunk=chunk)
            exact = mode == "f32"
            item = table.vecs.element_size()
            plans = (f"K2 panel {bs.stream_distances_plan(d, item, 16, chunk).panel}, K4 panel "
                     f"{bs.stream_fused_plan(d, item, chunk).panel}, K5 {bs.stream_shared_plan(d, item, chunk)[:3]}")
            for metric in ("l2", "ip"):
                grid = stream_grid(q, table, c, c_sq, lengths, 5, metric, worst_case=exact)
                what = f"wide rows {mode} d={d} chunk={chunk} n_probe=5 {metric} ({plans})"
                for nval in (False, True):
                    ok, err = check_k2(q, table, grid, metric, nval)
                    check(ok, f"K2 {what}{' nval2d' if nval else ''}: max |err| {err:.3e}")
                if not exact:
                    ok, n_mism, err = check_k4(q, table, grid, metric)
                    check(ok, f"K4 {what}: {n_mism} near-tie slot differences, max |err| {err:.3e}")
                    g1 = stream_grid(q[:1], table, c, c_sq, lengths, 5, metric)
                    ok, n_mism, err = check_k4(q[:1], table, g1, metric)
                    check(ok, f"K4 {what} nq=1 ({chip_smoke.k4_launch(q[:1], table, g1['t_fixed'])}"
                              f"): {n_mism} near-tie slot differences, max |err| {err:.3e}")
                t_cap = bs.shared_task_cap(lengths, 5, len(q), grid["t_fixed"], worst_case=exact,
                                           chunk=chunk)
                tasks = shared_tasks(q, table, c, c_sq, lengths, 5, grid["t_fixed"], t_cap, metric)
                ok, err = check_k5(table, tasks, metric)
                check(ok, f"K5 {what} t_cap={t_cap}: max |err| {err:.3e}")
            del table, tasks, grid
        del idx, store
        chip_smoke.gc_collect(torch)

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

    print("== K3 int8 / int8x1 and K7 flat_sweep_minreduce", flush=True)
    for d in INT8_DIMS:
        xb, xq = ds.clustered(30_000, d, max(SWEEP_NQ), seed=200 + d)
        store = VectorStore(external_ids=np.arange(len(xb), dtype=np.uint64), vectors=xb)
        idx = IvfIndex.fit(store, seed=1, nlist=64, max_iters=5, device=dev)
        lay = idx.layout
        tabs = idx._sweep_int8_tables()
        for (w, C), nq, metric in itertools.product(SWEEP_WC, SWEEP_NQ, ("l2", "ip")):
            q = torch.as_tensor(xq[:nq], device=dev)
            for label, mask in (("flat", None), ("masked", chip_smoke.sweep_mask(q, idx, 8, w))):
                for prec in ("int8", "int8x1"):
                    ok, n_mism, err = check_k3(q, lay.vectors, lay.row_norms, mask, metric, w, C,
                                               prec, tabs)
                    check(ok, f"K3 [{prec}] d={d} w={w} C={C} nq={nq} {metric} {label}: "
                              f"{n_mism} equal-value row differences, max |err| {err:.3e}")
        for w, nq, metric in itertools.product(K7_WINDOWS, SWEEP_NQ, ("l2", "ip")):
            q = torch.as_tensor(xq[:nq], device=dev)
            for label, mask in (("flat", None), ("masked", chip_smoke.sweep_mask(q, idx, 8, w))):
                ok, n_mism, err = check_k7(q, lay.vectors, lay.row_norms, mask, metric, w)
                check(ok, f"K7 d={d} w={w} nq={nq} {metric} {label}: {n_mism} near-tie row "
                          f"differences, max |err| {err:.3e}")

    print("== K6 ivf_gather_distances", flush=True)
    for case, (d, max_len, p, empty_every) in enumerate(K6_CASES):
        gen = np.random.default_rng(case)
        lens = gen.integers(1, max_len + 1, 64)
        lens[::empty_every] = 0
        lens[0] = max_len
        starts = np.concatenate([[0], np.cumsum(-(-lens // 8) * 8)[:-1]])
        vectors = torch.randn((int(starts[-1] + lens[-1]) + 8, d), generator=g, device=dev)
        for nq, metric in itertools.product((1, 37, 300), ("l2", "ip")):
            probe = np.stack([gen.permutation(64)[:p] for _ in range(nq)])
            st = torch.as_tensor(starts[probe], device=dev)
            ln = torch.as_tensor(lens[probe], device=dev)
            budget = candidate_budget(lens, p)
            q = torch.randn((nq, d), generator=g, device=dev)
            ok, err = check_k6(q, vectors, st, ln, max_len, budget, metric)
            check(ok, f"K6 d={d} max_len={max_len} p={p} nq={nq} {metric} (empty probes "
                      f"{int((ln == 0).sum())}): max |err| {err:.3e}")

    print("== search: card vs CPU on one saved index", flush=True)
    xb, xq = ds.clustered(60_000, 128, 100, seed=5)
    work = ROOT / "build" / "torch_shape_check_work"

    def compare(what, card, cpu, scale):
        (Dc, Rc), (Dp, Rp) = card, cpu
        fin = np.isfinite(Dp)
        err = np.abs(np.where(fin, Dc - Dp, 0.0))
        same = (np.sort(Rc, 1) == np.sort(Rp, 1)).all(axis=1).mean()
        check(bool((np.isfinite(Dc) == fin).all()) and bool((err <= RTOL * scale[:, None]).all())
              and same >= chip_smoke.TWIN_SAME_FLOOR,
              f"search {what}: ranks within {RTOL:g}*scale (max |err| {float(err.max()):.3e}), "
              f"equal row sets on {same:.4f} of queries")

    for metric in ("l2", "cosine"):
        shutil.rmtree(work, ignore_errors=True)
        try:
            bindings.build(xb, str(work), metric=metric, device=dev)
            on = {name: bindings.load(str(work / "index"), str(work / "shards"), 128, device=name)
                  for name in ("cuda", "cpu")}
            off = {(name, rr): load_index_from(work / "index", work / "shards", resident="offload",
                                               device=name, offload_rerank=rr)
                   for name in ("cuda", "cpu") for rr in ("host", "device", "none")}
        finally:
            shutil.rmtree(work, ignore_errors=True)
        if metric == "cosine":
            scale = np.full(len(xq), 2.0)  # unit vectors: |q.x| + |q||x| <= 2
        else:
            scale = np.sum(xq * xq, axis=1) + float(np.max(np.sum(xb * xb, axis=1)))
        for method in SEARCH_METHODS:
            card, cpu = ([t.cpu().numpy() for t in on[name].index.search_batch_device(
                xq, 50, 8, method=method)] for name in ("cuda", "cpu"))
            compare(f"{metric} {method}", card, cpu, scale)
        for rr in ("host", "device", "none"):
            for n_probe in (8, 32):
                compare(f"{metric} offload rerank={rr} n_probe={n_probe}",
                        off[("cuda", rr)].search_batch(xq, 50, n_probe),
                        off[("cpu", rr)].search_batch(xq, 50, n_probe), scale)

    if check.failures:
        print(f"FAILED: {len(check.failures)} check(s)", flush=True)
        return 1
    print("all shape checks passed", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
