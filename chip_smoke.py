#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA GPU and check it.

    python3 chip_smoke.py                  # on the first CUDA device
    python3 chip_smoke.py --kernels-only   # phases 1-3 only
    python3 chip_smoke.py --wide-only      # phases 1-2 and 11, no CPU twins

``--kernels-only`` stops after phase 3 and prints no JSON lines;
``--wide-only`` runs phase 11 alone without its CPU twins and offloaded
runs, and prints its K2 / K4 / K5 / K6 timings as JSON lines. Copied into
the root of another checkout (an unpacked commit whose wrappers have the
same plan functions), the script builds, checks and times that
checkout's kernels with this script's code: the way two kernel designs
are compared in one call.

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
7. Spill (on phase 4's corpus): ``bindings.build(xb, spill=1)`` (build
   seconds; 2n posting entries), the secondary cells of 1,024 sampled
   points against an f64 SOAR argmin on the card (near-ties aside),
   ``auto`` at n_probe 8 / 32 / 128 (the (1+spill)k-wide routes; QPS by
   CUDA events, R@1/10/100 against phase 4's ground truth, no repeated id
   in a row, R@10 at n_probe 8 >= phase 4's unspilled R@10 - 0.01), K3
   on the doubled table (``dense_fused`` at k 50: at k 100 the 200-wide
   shortlist has no fused plan in either package), the peak device memory,
   the saved index loaded back (the same results), offloaded with the
   host and device re-ranks (phase 5's gates, no repeated id) and with
   none, a launch check (K1, K2 bf16 / int8, K4 bf16 / int8, K3) and 200
   queries again on the CPU.
8. Host residency (same corpus): ``IvfIndex.fit(resident='host',
   train_sample=500,000)`` (fit seconds, peak device memory; afterwards
   the device holds < 1/4 of the f32 table's bytes; K1 launched in the
   fit), the saved index loaded with ``resident='host'`` and served
   ``staged`` in f32 at n_probe 8 / 32, nq 1000 and 16 (QPS by host clock,
   packing included; staged MiB per batch), held to the device-resident
   exact dense program's sets (>= 0.99 of queries, distances within
   RTOL), bf16 and int8 staging (>= 0.99 top-100 overlap with f32 after
   the exact host re-rank), phase 7's spilled index staged (no repeated
   id) and 200 queries again on the CPU.
9. Trainers and the mesh (phase 4's corpus and index): ``IvfIndex.fit``
   with ``trainer='mini_batch'`` and ``'balanced'`` (fit seconds, inertia
   against phase 4's Lloyd, max / mean list length, R@10 of ``auto`` at
   n_probe 32; gates: inertia <= 1.5x Lloyd's, K1 launched in the
   mini-batch fit, the balanced lists' max / mean at or below Lloyd's, a
   second balanced fit's centroids equal to the first's bit for bit);
   the data-parallel Lloyd over a 4-entry mesh (the cards present, else
   card 0 four times) beside the single-device Lloyd (inertia ratio <=
   1.001, label agreement >= 0.98); the 1-D ``ShardedSearcher`` on that
   mesh with 'dense', 'dense_fused', 'stream' and 'auto' at n_probe 8 /
   32 / 128 (batch ms by CUDA events, the body 'auto' picks, the kernels
   each launched;
   'dense' returns ``dense_exact``'s sets, 'dense_fused' (K3) and 'stream'
   (K2 / K4) the single-device routes' overlap within 0.01; the
   per-device loop of each body makes no host synchronisation, under
   ``torch.cuda.set_sync_debug_mode("error")``), phase 7's
   spilled index sharded without repeated ids, the 2-D (2 x 2) and
   multi-host (2 x 2) searchers against the 1-D searcher's sets, the
   multi-host merge's cross-host bytes S-fold below a flat merge's, and
   200 queries again on a CPU mesh. Four mesh entries on one card measure
   correctness and per-shard cost, not a parallel speedup.
10. Surface (on the index phase 4 saved): the native shard reader
   (``storage/native``, built by g++) is available, and its ``read_file``
   and ``mmap_view`` equal Python's reads of every shard file; the index
   loaded with native and with numpy shard reads (``load.stage_shards``
   ms, host clock); ``read_centroid_vectors`` of the lists that the first
   200 queries probe at n_probe 8, grouped by shard, equals the card's
   layout rows (vectors and internal ids, copied back once), with its
   host-clock ms beside the whole-shard load's; ``stage_queries`` (1000
   queries padded to 1024) gives ``search_device`` results equal to the
   unstaged call's (rows, and distances bit for bit) at n_probe 8 / 32 /
   128; ``device_profiler`` around one ``auto`` batch at each of those
   n_probe writes a Chrome trace holding K2's, K4's and K3's kernels, as
   many kernel events as the launch counters counted, and the device ms
   per batch it gives; ``examples/demo_torch.py`` at its defaults (50,000
   x 128) builds, then loads, on the card with the same ids as this
   process's ``VectorIndexer.load`` + ``search_sync``; K2 bf16, K4 bf16
   and K3 launched in the phase.
11. Wide rows: K2 (with and without nval2d, at 1, 8 and 40 queries, and
   twice, bit for bit), K4, K5 in every table type they take, and K6,
   against their plain versions at d 1,536, 16,384, 20,000 and 65,536 on
   small tables (l2 and ip; 8 queries; K4 also at 1 and 40, in its split
   launch, which it takes at every nq past d 1024; each check names its
   launch plan), and nvcc's report of every K2 instantiation (no spill);
   then a 100,000 x 16,384 clustered corpus drawn on the card (seed 11)
   and built with ``IvfIndex.fit`` (Lloyd, 10 iterations, and K1 at that
   width): ``auto`` at nq 1 (16 single-query calls) and 16 at n_probe 8 /
   20 / 32 / 64 (plus the first n_probe that ``resolve`` sends to K4 where
   none of those does; the routes logged), ``gather_dma`` (K6)
   and ``stream_shared_exact`` (K5 f32) at nq 16, n_probe 8, and, after
   ``offload_main_table(rerank='device')``, ``search_batch`` at n_probe 8
   and K4's n_probe (K2 / K4 int8); each run against a CPU twin (the same
   tables copied to the CPU), rank by rank; a launch check of each part;
   K4 bf16 (at every (nq, n_probe) of those runs that took it), K6, K5's
   K-panels (f32, nq 16, n_probe 8) and K2 bf16 / int8 (n_probe 8 / 20 at
   nq 1 / 16 / 256, checked and run twice) at those shapes, timed by graph
   replay beside their bounds (K2: per query and over distinct rows) and
   sharing factors; then a
   262,144 x 1,536 corpus drawn on the card (seed 13) and built the same
   way, ``auto`` at nq 1 / 16 / 1000 and n_probe 8 / 20 (routes logged)
   against a CPU twin of 16 queries, and K2 bf16 timed at those shapes
   (nq 1000: its 256-query tile) (``wide_rows`` in the kernels line).

The line before the last is a JSON object describing each kernel (its
``launches`` from the phase that must launch it, and ``launches_by_phase``
for phases 4-11); the last line is {"ok": true, "device": {...}}.
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
                 "stream_fused_plane_kernel", "stream_partial_kernel",
                 "stream_distances_finish_kernel", "stream_fused_fold_kernel",
                 "stream_shared_plane_kernel", "ivf_gather_kernel", "ivf_gather_items_kernel")
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
# Phase 7 (spill): the n_probe values of 'auto', the spill check's sample,
# how far the spilled R@10 at n_probe 8 may trail the unspilled one, and the
# k at which the masked sweep (K3) runs on the doubled table (at k 100 the
# widened shortlist of 200 has no fused plan, in either package).
SPILL_N_PROBES = (8, 32, 128)
SOAR_POINTS = 1024
SPILL_R10_SLACK = 0.01
SPILL_K3_K = 50
SPILL_KERNELS = ("assign_argmin", "stream_distances[bf16]", "stream_distances[int8]",
                 "stream_fused_plane[bf16]", "stream_fused_plane[int8]", "flat_sweep_topk_plane")
# Phase 8 (host residency): the host fit's training sample; staged f32 must
# return the device-resident exact dense program's sets on this share of
# queries, and bf16 / int8 staging (after the exact host re-rank) this
# top-100 overlap with f32 staging.
HOST_TRAIN_SAMPLE = 500_000
STAGED_SAME_FLOOR = 0.99
STAGED_QUANT_FLOOR = 0.99
FLAT_EXACT_FLOOR = 0.999
FLAT_R1_FLOOR = 0.99
INT8_TOP10_FLOORS = {"flat_int8": 0.97, "flat_int8x1": 0.85}
GATHER_SAME_FLOOR = 0.99
# Phase 9 (trainers, mesh): the trainers' inertia bound against Lloyd's
# (the reference's, tests/test_kmeans.py); the data-parallel Lloyd's
# inertia against the single-device run's and its label agreement (same
# init, same sweeps: only summation order and the empty-cell draws differ;
# the limits lie between the readings of a correct run and of one that
# drops one slice's partial, PERF.md); the sharded searcher's n_probe
# values; the share of queries on which 'dense' (and the 2-D / multi-host
# searchers) must return the single-device exact sets; how far the K3 /
# stream bodies' top-100 overlap may trail their single-device routes';
# the CPU twins.
TRAINER_INERTIA_BOUND = 1.5
DP_INERTIA_BOUND = 1.001
DP_AGREE_FLOOR = 0.98
SHARD_N_PROBES = (8, 32, 128)
SHARD_SAME_FLOOR = 0.99
SHARD_OVERLAP_SLACK = 0.01
SHARD_TWINS = (("stream", 8), ("stream", 32), ("dense_fused", 128))
# Phase 10 (surface): the queries whose probed lists are read selectively;
# the n_probe of each profiled 'auto' batch and the kernel its route runs
# (K2, K4, K3), with the device ms per batch of PERF.md section 5's profile
# (tools/torch_profile.py, nq 1000) beside it; each launch counter's CUDA
# kernel; the trace's device-side events.
NQ_SELECT = 200
PROFILE_N_PROBES = {8: "stream_distances_kernel", 32: "stream_fused_plane_kernel",
                    128: "flat_sweep_kernel"}
PROFILE_DEVICE_MS = {8: 1.503, 32: 2.595, 128: 4.979}
TRACE_KERNELS = {"assign_argmin": "assign_argmin_kernel",
                 "stream_distances": "stream_distances_kernel",
                 "stream_fused_plane": "stream_fused_plane_kernel",
                 "stream_shared_plane": "stream_shared_plane_kernel",
                 "flat_sweep_topk_plane": "flat_sweep_kernel",
                 "flat_sweep_minreduce": "flat_sweep_kernel",
                 "ivf_gather_distances": "ivf_gather_kernel"}
DEVICE_EVENT_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
PHASE10_KERNELS = ("stream_distances[bf16]", "stream_fused_plane[bf16]", "flat_sweep_topk_plane")
# Phase 11 (wide rows): the widths of the kernel checks on small tables (K2
# and K5 change modes past ~50,000 and ~14,400-57,800 dims, K4 past
# ~13,500-18,000, K6 past 12,288; 20,000 is no power of two); the wide
# corpus (its width is the hidden size of a 16,384-wide model), its seed
# and the Lloyd iterations of its build (cut from the default 50 to fit
# the phase); the n_probe values of 'auto' and the other routes (where the
# corpus's lists send none of these to K4, the first n_probe that does is
# added); the batch sizes; the queries of each CPU twin; the kernels the
# phase must launch.
WIDE_DIMS = (1_536, 16_384, 20_000, 65_536)
WIDE_N, WIDE_D, WIDE_SEED, WIDE_ITERS = 100_000, 16_384, 11, 10
WIDE_N_PROBES = (8, 20, 32, 64)
WIDE_NQ = (1, 16)
WIDE_TWIN = 16
# Queries drawn with each wide corpus: the runs take the first WIDE_TWIN,
# 'auto' on the 1,536 corpus and the K2 timings up to the stream program's
# 256-query tile take more.
WIDE_QUERIES = 1000
# K2 timed at 'auto''s K2 shapes (n_probe 8 and 20 at nq 1 and 16; nq 256,
# the stream program's tile, where 'auto' takes the dense program, timed
# at that shape directly), bf16 and int8 (the offload's table).
WIDE_K2_N_PROBES = (8, 20)
WIDE_K2_NQ = (1, 16, 256)
# The second wide corpus: 262,144 x 1,536 (the width of OpenAI's
# text-embedding-ada-002 / -3-small vectors, as served in DBpedia-OpenAI-1M),
# drawn on the card (seed 13), 2,048 lists of ~128 rows; 'auto' at nq 1 /
# 16 / 1000.
W1536_N, W1536_D, W1536_SEED = 262_144, 1_536, 13
W1536_NQ = (1, 16, 1000)
# The K2 instantiations whose nvcc report must show no spill.
K2_PTXAS = ("stream_distances_kernel", "stream_partial_kernel", "stream_distances_finish_kernel")
# K2 and K4 at the kernel checks' widths: 1, 8 and WIDE_CHECK_NQ queries.
WIDE_CHECK_NQ = 40
WIDE_KERNELS = ("assign_argmin", "stream_distances[bf16]", "stream_fused_plane[bf16]",
                "ivf_gather_distances", "stream_shared_plane[f32]")
WIDE_OFFLOAD_KERNELS = ("stream_distances[int8]", "stream_fused_plane[int8]")


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


def distinct_rows(table, grid) -> int:
    """The valid rows of a stream task grid's distinct probed blocks."""
    import torch

    nval = grid["nval"].clamp_min(0)
    used = nval > 0
    rows = torch.zeros(table.vecs.shape[0] // table.chunk, dtype=torch.int64,
                       device=nval.device)
    rows.scatter_(0, grid["blk"][used].long(), nval[used].long())  # a block's count is its own
    return int(rows.sum())


def stream_bound(q, table, grid, out_bytes: int, per_query: bool = False) -> dict:
    """K2 / K4: each probed block's valid rows (and norms) read once, the
    queries, the outputs; 2 d operations per valid (query, row) pair.
    ``per_query``: each query's valid rows read once for that query (the
    least a design that shares no list across queries moves)."""
    d = q.shape[1]
    rows = int(grid["nval"].clamp_min(0).sum()) if per_query else distinct_rows(table, grid)
    nbytes = rows * (d * table.vecs.element_size() + 4) + q.numel() * 4 + out_bytes
    return bound(nbytes, 2.0 * float(grid["nval"].clamp_min(0).sum()) * d, F32_FLOP_S)


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
        self.n = 0

    def __call__(self, ok: bool, what: str) -> None:
        self.n += 1
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


def check_k2_spills(check, log_text: str) -> None:
    """nvcc's report of every K2 instantiation (K2_PTXAS) shows no register
    spill."""
    lines = ptxas_lines(log_text, K2_PTXAS)
    spills = [ln for ln in lines if ", 0 bytes spill stores, 0 bytes spill loads" not in ln]
    check(bool(lines) and not spills,
          f"nvcc: {len(lines)} K2 instantiations, none spills registers {spills or ''}")


def kernel_phase(torch, np, xb, xq, check, results, dev):
    from vector_indexer_tpu_torch.index import dispatch
    from vector_indexer_tpu_torch.index.ivf import IvfIndex
    from vector_indexer_tpu_torch.kernels import build as kb
    from vector_indexer_tpu_torch.ops import assign, block_stream as bs, flat_sweep as fs
    from vector_indexer_tpu_torch.storage.vector_store import VectorStore

    for line in ptxas_lines(kb.build_info().get("log", ""), PTXAS_KERNELS):
        log(f"  ptxas {line}")
    check_k2_spills(check, kb.build_info().get("log", ""))
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
    int (Lin1E: -1) and row-type template arguments)."""
    body = mangled_tail[1:].split("EEv", 1)[0] + "E"
    body = body.replace("13__nv_bfloat16", "bf16,").replace("Lb1E", "true,").replace("Lb0E", "false,")
    body = re.sub(r"(^|,)([af])(?=Li|true|false|E|$)",
                  lambda m: m.group(1) + {"a": "int8", "f": "f32"}[m.group(2)] + ",", body)
    body = re.sub(r"Li(n?)(\d+)E", lambda m: ("-" if m.group(1) else "") + m.group(2) + ",", body)
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


def route_of(dec, k: int) -> str:
    """The kernel route of a resolved Decision: stream/K4 or stream/K2
    (the approximate stream program, as fused_engages decides at its
    shortlist's width), stream/K2 (exact), stream_shared/K5,
    dense_fused/K3, gather_dma/K6, or the plain program's name."""
    from vector_indexer_tpu_torch.index.programs import shortlist_k
    from vector_indexer_tpu_torch.ops.block_stream import fused_engages

    if dec.program == "stream" and not dec.exact:
        kk = shortlist_k(k, dec.t_fixed, dec.chunk)
        return "stream/K4" if fused_engages(dec.t_fixed, dec.chunk, kk) else "stream/K2"
    return {"stream": "stream/K2", "stream_shared": "stream_shared/K5",
            "dense_fused": "dense_fused/K3", "gather_dma": "gather_dma/K6"}.get(
        dec.program, dec.program)


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
    from vector_indexer_tpu_torch.kernels import build as kb
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
        routes[n_probe] = (route_of(dec, k), dec)
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
    return counts, {n_probe: overlap for n_probe, _, _, _, overlap in table}, gt, \
        {n_probe: rec[10] for n_probe, _, _, rec, _ in table}


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
    return counts


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
    return counts


# ---------------------------------------------------------------------------
# Phase 7: a spilled (SOAR) index
# ---------------------------------------------------------------------------


def no_dup_rows(np, I) -> bool:
    """No row of an (nq, k) id array repeats an id (-1 holes aside)."""
    s = np.sort(I, axis=1)
    return not bool(((s[:, 1:] == s[:, :-1]) & (s[:, 1:] >= 0)).any())


def soar_check(torch, np, xb, idx, check, dev, npts: int = SOAR_POINTS):
    """The spill cells of ``npts`` sampled points against an f64 SOAR argmin
    on the card. A point's two cells come from the layout; its primary is
    the one nearer in f64 (the build's K1 label, up to a near-tie)."""
    lay = idx.layout
    sample = np.random.default_rng(7).choice(xb.shape[0], npts, replace=False)
    lengths = lay.lengths.astype(np.int64)
    first_entry = np.cumsum(lengths) - lengths
    rows = np.repeat(lay.offsets[:-1] - first_entry, lengths) + np.arange(int(lengths.sum()))
    cells_of_entry = np.repeat(np.arange(len(lengths)), lengths)
    ids = lay.perm[rows]
    where = {int(i): [] for i in sample}
    for e in np.flatnonzero(np.isin(ids, sample)):
        where[int(ids[e])].append(int(cells_of_entry[e]))
    two = all(len(v) == 2 and v[0] != v[1] for v in where.values())
    check(two, f"spill: each of {npts} sampled points sits in two different cells")
    if not two:
        return
    x = torch.as_tensor(xb[sample], device=dev, dtype=torch.float64)
    c = torch.as_tensor(idx.centroids, device=dev, dtype=torch.float64)
    # f64 expansion: its rounding (~1e-12 of the terms) is far below RTOL.
    d = (x * x).sum(1)[:, None] - 2.0 * (x @ c.T) + (c * c).sum(1)[None, :]  # (npts, kc)
    cells = torch.as_tensor(np.array([where[int(i)] for i in sample]), device=dev)
    dp = d.gather(1, cells)
    first = dp[:, 0] <= dp[:, 1]
    prim = torch.where(first, cells[:, 0], cells[:, 1])
    sec = torch.where(first, cells[:, 1], cells[:, 0])
    r = x - c[prim]
    proj = (x * r).sum(1)[:, None] - r @ c.T
    lam = 1.0  # the build's spill_lambda
    score = d + lam * proj * proj / (r * r).sum(1).clamp_min(1e-12)[:, None]
    score[torch.arange(npts, device=dev), prim] = float("inf")
    best = score.argmin(1)
    scale = (x * x).sum(1) + (c * c).sum(1).max()  # the terms' magnitude
    gap_p = dp.min(1).values - d.min(1).values
    gap_s = score.gather(1, sec[:, None])[:, 0] - score.gather(1, best[:, None])[:, 0]
    tie = RTOL * scale
    agree = int((best == sec).sum())
    bad = int(((gap_p > tie) | ((best != sec) & (gap_s > tie))).sum())
    log(f"  SOAR check on {npts} points (f64 on the card): secondary = f64 SOAR argmin on "
        f"{agree}, near-ties (score gap <= {RTOL:g}*(|x|^2+max|c|^2)) on {npts - agree - bad}")
    check(bad == 0, f"spill: every secondary differs from its primary and is the f64 SOAR "
                    f"argmin but for near-ties ({bad} not)")


def spill_phase(torch, np, xb, xq, check, dev, work, p4):
    """Phase 7: ``bindings.build(xb, spill=1)`` on phase 4's corpus, then
    ``auto`` at n_probe 8 / 32 / 128 and K3 on the doubled table, the save
    / load round trip, the offloaded re-ranks, the launch check and a CPU
    twin. Returns the phase's launch counts; the index stays in ``work``
    for phase 8."""
    from vector_indexer_tpu_torch import bindings
    from vector_indexer_tpu_torch.index.dispatch import resolve
    from vector_indexer_tpu_torch.index.ivf import load_index_from
    from vector_indexer_tpu_torch.index.programs import shortlist_k
    from vector_indexer_tpu_torch.kernels import build as kb
    from vector_indexer_tpu_torch.ops.block_stream import fused_engages
    from vector_indexer_tpu_torch.utils import tracing

    k, d, nq, n = K, xb.shape[1], xq.shape[0], xb.shape[0]
    gt = p4["gt"]
    idx_dir, sh_dir = str(work / "index"), str(work / "shards")
    gc_collect(torch)
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    tracing.reset_phases()
    kb.reset_launch_counts()  # counts from here on belong to phase 7

    t0 = time.perf_counter()
    vi = bindings.build(xb, str(work), spill=1, device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    ph = {p: v["total_s"] for p, v in tracing.phase_report().items()}
    ix = vi.index
    lay = ix.layout
    log(f"  spilled build: {build_s:.2f}s total; fit.kmeans {ph.get('fit.kmeans', 0):.2f}s, "
        f"fit.spill {ph.get('fit.spill', 0):.2f}s, fit.layout {ph.get('fit.layout', 0):.2f}s, "
        f"save.shards {ph.get('save.shards', 0):.2f}s; nlist={ix.num_clusters}; "
        f"{int(lay.lengths.sum())} posting entries, {lay.vectors.shape[0]} table rows, "
        f"max list {lay.max_list_len}")
    check(int(lay.lengths.sum()) == 2 * n and lay.n == n,
          f"spill: {int(lay.lengths.sum())} posting entries = 2n = {2 * n}")
    soar_check(torch, np, xb, ix, check, dev)

    xq_dev = torch.as_tensor(xq, device=dev)
    max_norm = float(np.max(np.sum(xb * xb, axis=1)))
    scale = np.sum(xq * xq, axis=1) + max_norm
    res = {}
    for n_probe in SPILL_N_PROBES:
        dec = resolve(ix, nq, n_probe, k=2 * k)
        if dec.program == "stream":
            kk = shortlist_k(2 * k, dec.t_fixed, dec.chunk)
            route = "stream/K4" if fused_engages(dec.t_fixed, dec.chunk, kk) else "stream/K2"
        else:
            route = dec.program + ("/K3" if dec.program == "dense_fused" else "")
        D, R = vi.search_device(xq_dev, k, n_probe)  # warm-up (builds the bf16 table once)
        torch.cuda.synchronize()
        ms = cuda_ms(torch, lambda: vi.search_device(xq_dev, k, n_probe), reps=3)
        Dn, Rn = D.cpu().numpy(), R.cpu().numpy()
        I = vi.rows_to_external(Rn)
        r1, r10, r100, ov = quality(np, I, gt, k)
        res[n_probe] = (Dn, Rn, r10, ov)
        log(f"  spilled auto n_probe={n_probe:4d} (kk {2 * k}) program={dec.program:11s} "
            f"route={route:16s} batch {ms:8.3f} ms  QPS {nq / ms * 1e3:10.1f}  R@1 {r1:.4f} "
            f"R@10 {r10:.4f} R@100 {r100:.4f} top-{k} overlap {ov:.4f}  (unspilled R@10 "
            f"{p4['r10'].get(n_probe, float('nan')):.4f}, overlap "
            f"{p4['overlap'].get(n_probe, float('nan')):.4f})"
            + (f"  t_fixed={dec.t_fixed}" if dec.program == "stream" else ""))
        check(bool(np.isfinite(Dn).all()) and Dn.shape == (nq, k) and no_dup_rows(np, I),
              f"spilled n_probe={n_probe}: finite ({nq}, {k}) result, no repeated id in a row")
    r10_8, base_8 = res[8][2], p4["r10"][8]
    check(r10_8 >= base_8 - SPILL_R10_SLACK,
          f"spilled R@10 at n_probe 8 {r10_8:.4f} >= unspilled {base_8:.4f} - {SPILL_R10_SLACK}")
    # R@10 is 1.0 unspilled on this corpus; the top-100 overlap at n_probe
    # 32 is where the secondary cells show.
    ov_32, base_ov_32 = res[32][3], p4["overlap"][32]
    check(ov_32 >= base_ov_32,
          f"spilled top-{k} overlap at n_probe 32 {ov_32:.4f} >= unspilled {base_ov_32:.4f}")

    # K3 on the doubled table. At k 100 the widened shortlist (200) has no
    # fused plan in either package (the plane's tail-loss bound fails at
    # C 8), so 'auto' takes K3 only at k <= 50; the masked f32 sweep runs
    # here at k 50 (kk 100) through the same entry point.
    k3 = SPILL_K3_K
    dec3 = resolve(ix, nq, 128, k=2 * k3, method="dense_fused")
    D3, R3 = vi.search_device(xq_dev, k3, 128, method="dense_fused")
    torch.cuda.synchronize()
    ms3 = cuda_ms(torch, lambda: vi.search_device(xq_dev, k3, 128, method="dense_fused"), reps=3)
    D3n, R3n = D3.cpu().numpy(), R3.cpu().numpy()
    I3 = vi.rows_to_external(R3n)
    ov3 = float(np.mean([len(np.intersect1d(a, b[:k3])) for a, b in zip(I3, gt)]) / k3)
    log(f"  spilled dense_fused n_probe=128 k={k3} (kk {2 * k3}) program={dec3.program} "
        f"plan(w,_,C)={dec3.plan}: batch {ms3:8.3f} ms  QPS {nq / ms3 * 1e3:10.1f}  top-{k3} "
        f"overlap {ov3:.4f}")
    check(dec3.program == "dense_fused" and bool(np.isfinite(D3n).all()) and no_dup_rows(np, I3)
          and ov3 >= OVERLAP_FLOOR,
          f"spilled K3 (masked, {lay.vectors.shape[0]} rows): finite, no repeated id, top-{k3} "
          f"overlap {ov3:.4f} >= {OVERLAP_FLOOR}")
    peak = torch.cuda.max_memory_allocated(dev) - base
    log(f"  peak device memory (max_memory_allocated) over the spilled build and searches: "
        f"{peak / 2**30:.3f} GiB above the {base / 2**30:.3f} GiB held at the phase's start "
        f"(the f32 table alone: {lay.vectors.shape[0] * d * 4 / 2**30:.3f} GiB)")

    # Save (the build did) and load back: the same results.
    vl = bindings.load(idx_dir, sh_dir, d, device=dev)
    check(vl.index.spill == 1 and int(vl.index.layout.lengths.sum()) == 2 * n,
          "spilled load: spill 1 and 2n posting entries")
    for n_probe in (8, 32):
        D, R = vl.search_device(xq_dev, k, n_probe)
        Dn, In = D.cpu().numpy(), vl.rows_to_external(R)
        Ib = vi.rows_to_external(res[n_probe][1])
        same = float((np.sort(In, 1) == np.sort(Ib, 1)).all(axis=1).mean())
        err = float(np.abs(Dn - res[n_probe][0]).max())
        check(same >= GATHER_SAME_FLOOR and err <= RTOL * float(scale.min()),
              f"spilled load n_probe={n_probe}: the built index's sets on {same:.4f} of queries "
              f"(>= {GATHER_SAME_FLOOR}), max |dD| {err:.3e}")
    del vl

    # Offloaded: host and device re-ranks (K2 int8: the (1+spill) x 400-row
    # shortlist is past K4's groups), then 'none' (K2 / K4 int8).
    host_ov, off_twin = {}, {}
    for rerank in ("host", "device"):
        ixo = load_index_from(idx_dir, sh_dir, resident="offload", device=dev,
                              offload_rerank=rerank)
        for n_probe in (8, 32):
            ms = host_ms(torch, lambda: ixo.search_batch(xq, k, n_probe))
            D, Ii = ixo.search_batch(xq, k, n_probe)
            I = np.where(Ii >= 0, ixo.external_ids[np.clip(Ii, 0, None)].astype(np.int64), -1)
            r1, r10, r100, ov = quality(np, I, gt, k)
            ex = exact_dist(np, xb, xq, I)
            err = np.abs(D.astype(np.float64) - ex)
            rel = float(np.nanpercentile(err / np.maximum(ex, 1e-12), 99))
            log(f"  spilled offload {rerank:6s} n_probe={n_probe:3d}: {ms:8.3f} ms/batch host "
                f"clock, QPS {nq / ms * 1e3:9.1f}  R@10 {r10:.4f} top-{k} overlap {ov:.4f} "
                f"(device-resident {res[n_probe][3]:.4f}); p99 relative error {rel:.3e}")
            # Phase 5's gates: the host re-rank is exact and keeps the
            # device-resident overlap; the device re-rank is within its p99
            # error and keeps the host re-rank's overlap.
            if rerank == "host":
                host_ov[n_probe] = ov
                off_twin[("host", n_probe)] = (D[:NQ_TWIN], Ii[:NQ_TWIN])
                dist_ok = bool((err <= RTOL * scale[:, None]).all())
                what = f"exact distances, overlap {ov:.4f} >= device-resident"
                ov_ref = res[n_probe][3]
            else:
                dist_ok = rel <= DEVICE_RERANK_P99_REL
                what = (f"p99 relative error <= {DEVICE_RERANK_P99_REL:g}, overlap {ov:.4f} "
                        ">= host re-rank")
                ov_ref = host_ov[n_probe]
            check(no_dup_rows(np, I) and dist_ok and ov >= ov_ref - OFFLOAD_OVERLAP_SLACK,
                  f"spilled offload {rerank} n_probe={n_probe}: no repeated id, {what} "
                  f"{ov_ref:.4f} - {OFFLOAD_OVERLAP_SLACK}")
        del ixo
    ixn = load_index_from(idx_dir, sh_dir, resident="offload", device=dev,
                          offload_rerank="none")
    for n_probe in (8, 32):
        _, Ii = ixn.search_batch(xq, k, n_probe)
        I = np.where(Ii >= 0, ixn.external_ids[np.clip(Ii, 0, None)].astype(np.int64), -1)
        r10 = quality(np, I, gt, k)[1]
        check(no_dup_rows(np, I) and r10 >= NONE_R10_FLOOR,
              f"spilled offload none n_probe={n_probe}: no repeated id, R@10 {r10:.4f} >= "
              f"{NONE_R10_FLOOR}")
        Dc, Rc = ixn.search_batch_device(xq[:NQ_TWIN], k, n_probe)
        off_twin[("none", n_probe)] = (Dc.cpu().numpy(), ixn.rows_to_internal(Rc.cpu().numpy()))
    del ixn
    torch.cuda.synchronize()
    counts = kb.launch_counts()
    log(f"  launch counts in phase 7: {counts}")
    for name in SPILL_KERNELS:
        check(counts[name] > 0, f"{name} launched in phase 7 ({counts[name]}x)")

    # The same searches on the CPU (plain versions), rank by rank.
    t0 = time.perf_counter()
    vc = bindings.load(idx_dir, sh_dir, d, device="cpu")
    qs = xq[:NQ_TWIN]
    runs = [(n_probe, k, "auto", res[n_probe][:2]) for n_probe in (8, 32)]
    runs.append((128, k3, "dense_fused", (D3n, R3n)))
    for n_probe, kq, method, (Dc, Rc) in runs:
        Dp, Rp = (a.numpy() for a in vc.index.search_batch_device(qs, kq, n_probe,
                                                                  method=method))
        Dc, Rc = Dc[:NQ_TWIN], Rc[:NQ_TWIN]
        err = np.abs(Dc - Dp)
        # Ids, not rows: a vector's two rows score within rounding of each
        # other, so the card and the CPU may keep different copies.
        Ic, Ip = ix.rows_to_internal(Rc), vc.index.rows_to_internal(Rp)
        same = (np.sort(Ic, 1) == np.sort(Ip, 1)).all(axis=1).mean()
        check(bool(np.isfinite(Dp).all()) and bool((err <= RTOL * scale[:NQ_TWIN, None]).all())
              and same >= TWIN_SAME_FLOOR,
              f"spilled {method} n_probe={n_probe} k={kq}: card vs plain versions on the CPU, "
              f"{NQ_TWIN} queries: every rank within {RTOL:g}*(|q|^2+max|x|^2) (max |err| "
              f"{float(err.max()):.3e}); equal sets on {same:.4f} (>= {TWIN_SAME_FLOOR})")
    del vc
    # The offloaded index: 'host' (search_batch) and 'none' (the int8
    # sweep's own ranking, search_batch_device), as in phase 5.
    vco = load_index_from(idx_dir, sh_dir, resident="offload", device="cpu")
    for (mode, n_probe), (Dc, Ic) in off_twin.items():
        if mode == "host":
            Dp, Ip = vco.search_batch(qs, k, n_probe)
        else:
            Dp, Rp = vco.search_batch_device(qs, k, n_probe)
            Dp, Ip = Dp.numpy(), vco.rows_to_internal(Rp.numpy())
        err = np.abs(Dc - Dp)
        same = (np.sort(Ic, 1) == np.sort(Ip, 1)).all(axis=1).mean()
        check(bool(np.isfinite(Dp).all()) and bool((err <= RTOL * scale[:NQ_TWIN, None]).all())
              and same >= TWIN_SAME_FLOOR and no_dup_rows(np, Ip),
              f"spilled offload {mode} n_probe={n_probe}: card vs plain versions on the CPU, "
              f"{NQ_TWIN} queries: every rank within {RTOL:g}*(|q|^2+max|x|^2) (max |err| "
              f"{float(err.max()):.3e}); equal id sets on {same:.4f} (>= {TWIN_SAME_FLOOR}); no "
              f"repeated id")
    del vco
    log(f"  CPU comparison: {time.perf_counter() - t0:.2f}s")
    return counts


# ---------------------------------------------------------------------------
# Phase 8: the host-resident build and staged serving
# ---------------------------------------------------------------------------


def host_phase(torch, np, xb, xq, check, dev, work, spill_work, gt):
    """Phase 8: ``IvfIndex.fit(resident='host', train_sample=...)`` with its
    device memory, then staged serving of the saved index (f32, bf16,
    int8) against the device-resident exact dense program, phase 7's
    spilled index staged, and a CPU twin. Returns the phase's counts."""
    from vector_indexer_tpu_torch import bindings
    from vector_indexer_tpu_torch.index.ivf import IvfIndex
    from vector_indexer_tpu_torch.kernels import build as kb
    from vector_indexer_tpu_torch.storage.vector_store import VectorStore

    k, d, n = K, xb.shape[1], xb.shape[0]
    idx_dir, sh_dir = str(work / "index"), str(work / "shards")
    gc_collect(torch)
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    kb.reset_launch_counts()  # counts from here on belong to phase 8

    store = VectorStore(external_ids=np.arange(n, dtype=np.uint64), vectors=xb)
    t0 = time.perf_counter()
    hix = IvfIndex.fit(store, resident="host", train_sample=HOST_TRAIN_SAMPLE, device=dev)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    gc_collect(torch)
    peak = torch.cuda.max_memory_allocated(dev) - base
    held = torch.cuda.memory_allocated(dev) - base
    table = hix.layout.vectors.shape[0] * d * 4
    k1 = kb.launch_counts()["assign_argmin"]
    log(f"  host fit: {fit_s:.2f}s (train_sample {HOST_TRAIN_SAMPLE}); nlist={hix.num_clusters}; "
        f"peak device memory over the fit {peak / 2**20:.1f} MiB, held after it "
        f"{held / 2**20:.1f} MiB; the f32 table {table / 2**20:.1f} MiB stays on the host; "
        f"K1 launched {k1}x")
    check(hix.host_resident and isinstance(hix.layout.vectors, np.ndarray),
          "host fit: a host-resident index whose layout is a host array")
    check(held < table / 4, f"host fit: device memory held after the fit {held} B < 1/4 of the "
                            f"f32 table's {table} B")
    check(k1 > 0, f"assign_argmin launched in the host fit ({k1}x)")
    hix.save_to(idx_dir, sh_dir)
    del hix

    vh = bindings.load(idx_dir, sh_dir, d, resident="host", device=dev)
    ih = vh.index
    vd = bindings.load(idx_dir, sh_dir, d, device=dev)
    qsets = {NQ: xq, 16: xq[:16]}
    f32 = {}
    for n_probe in (8, 32):
        for nq, q in qsets.items():
            ms = host_ms(torch, lambda: vh.search_sync(q, k, n_probe))
            D, I = vh.search_sync(q, k, n_probe)
            mb = ih._last_stage_bytes / 2**20
            f32[(n_probe, nq)] = (D, I)
            r1, r10, r100, ov = quality(np, I, gt[:nq], k)
            log(f"  staged f32 n_probe={n_probe:3d} nq={nq:5d}: {ms:9.3f} ms/batch host clock "
                f"(packing included), QPS {nq / ms * 1e3:9.1f}; staged {mb:8.1f} MiB per batch; "
                f"R@1 {r1:.4f} R@10 {r10:.4f} R@100 {r100:.4f} top-{k} overlap {ov:.4f}")
        D, I = f32[(n_probe, NQ)]
        Dd, Id = vd.search_sync(xq, k, n_probe, method="dense_exact")
        same = float((np.sort(I, 1) == np.sort(Id, 1)).all(axis=1).mean())
        scale = np.sum(xq * xq, axis=1) + float(np.max(np.sum(xb * xb, axis=1)))
        err = np.abs(D - Dd)
        check(same >= STAGED_SAME_FLOOR and bool((err <= RTOL * scale[:, None]).all()),
              f"staged f32 n_probe={n_probe}: the device-resident dense program's sets on "
              f"{same:.4f} of queries (>= {STAGED_SAME_FLOOR}), distances within {RTOL:g}*"
              f"(|q|^2+max|x|^2) (max |err| {float(err.max()):.3e})")
    del vd
    for sd in (torch.bfloat16, torch.int8):
        ih.stage_dtype = sd
        ms = host_ms(torch, lambda: vh.search_sync(xq, k, 8))
        D, I = vh.search_sync(xq, k, 8)
        mb = ih._last_stage_bytes / 2**20
        ov = float(np.mean([len(np.intersect1d(a, b)) for a, b in zip(I, f32[(8, NQ)][1])]) / k)
        log(f"  staged {str(sd).split('.')[-1]:8s} n_probe=  8 nq={NQ}: {ms:9.3f} ms/batch host "
            f"clock, QPS {NQ / ms * 1e3:9.1f}; staged {mb:8.1f} MiB per batch; top-{k} overlap "
            f"with f32 staging {ov:.4f}")
        check(ov >= STAGED_QUANT_FLOOR, f"staged {sd} after the exact host re-rank: top-{k} "
                                        f"overlap with f32 staging {ov:.4f} >= {STAGED_QUANT_FLOOR}")
    ih.stage_dtype = torch.float32

    vs = bindings.load(str(spill_work / "index"), str(spill_work / "shards"), d,
                       resident="host", device=dev)
    D, I = vs.search_sync(xq, k, 8)
    r10 = quality(np, I, gt, k)[1]
    check(vs.index.spill == 1 and no_dup_rows(np, I),
          f"staged spilled index n_probe=8: no repeated id in a row (R@10 {r10:.4f})")
    del vs
    torch.cuda.synchronize()
    counts = kb.launch_counts()
    log(f"  launch counts in phase 8: {counts}")

    t0 = time.perf_counter()
    vc = bindings.load(idx_dir, sh_dir, d, resident="host", device="cpu")
    qs = xq[:NQ_TWIN]
    scale = np.sum(qs * qs, axis=1) + float(np.max(np.sum(xb * xb, axis=1)))
    for n_probe in (8, 32):
        Dp, Ip = vc.search_sync(qs, k, n_probe)
        Dc, Ic = (a[:NQ_TWIN] for a in f32[(n_probe, NQ)])
        err = np.abs(Dc - Dp)
        same = (np.sort(Ic, 1) == np.sort(Ip, 1)).all(axis=1).mean()
        check(bool(np.isfinite(Dp).all()) and bool((err <= RTOL * scale[:, None]).all())
              and same >= TWIN_SAME_FLOOR,
              f"staged n_probe={n_probe}: card vs CPU, {NQ_TWIN} queries: every rank within "
              f"{RTOL:g}*(|q|^2+max|x|^2) (max |err| {float(err.max()):.3e}); equal sets on "
              f"{same:.4f} (>= {TWIN_SAME_FLOOR})")
    log(f"  CPU comparison: {time.perf_counter() - t0:.2f}s")
    return counts


# ---------------------------------------------------------------------------
# Phase 9: the other trainers and the multi-device layer
# ---------------------------------------------------------------------------


def layout_labels(np, idx):
    """(n,) cell of every point of an unspilled index, from its layout."""
    lay = idx.layout
    lengths = np.asarray(lay.lengths).astype(np.int64)
    rows = np.concatenate([np.arange(s, s + m) for s, m in zip(np.asarray(lay.offsets[:-1]),
                                                                lengths)])
    labels = np.empty(lay.n, np.int64)
    labels[lay.perm[rows]] = np.repeat(np.arange(len(lengths)), lengths)
    return labels


def inertia_of(torch, xb_dev, centroids, labels) -> float:
    """Sum of squared distances of the points to their cells (f64 sum of
    per-chunk f32 sums, on the card)."""
    from vector_indexer_tpu_torch.models.kmeans import compute_inertia

    c = torch.as_tensor(centroids, dtype=torch.float32, device=xb_dev.device)
    lbl = torch.as_tensor(labels, device=xb_dev.device)
    step = 1 << 18
    return sum(compute_inertia(xb_dev[s : s + step], c, lbl[s : s + step])
               for s in range(0, xb_dev.shape[0], step))


def mesh_devices(torch, n: int):
    """The first n cards when there are that many, else card 0 n times (a
    one-card mesh measures correctness and per-shard cost, not speedup)."""
    count = torch.cuda.device_count()
    return [torch.device("cuda", i if count >= n else 0) for i in range(n)]


def sets_equal_share(np, a, b) -> float:
    return float((np.sort(a, 1) == np.sort(b, 1)).all(axis=1).mean())


def trainer_check(torch, np, store, xb_dev, xq, gt, lloyd_i: float, lloyd_skew: float,
                  trainer: str, dev, check) -> dict:
    """``IvfIndex.fit(store, trainer=trainer)`` on the card: build s, inertia
    against the Lloyd index's ``lloyd_i``, max / mean list length against
    ``lloyd_skew``, R@10 of ``auto`` at n_probe 32, and the gates (inertia
    <= 1.5x; K1 launched in the mini-batch fit; the balanced skew at or
    below Lloyd's, and a second balanced fit equal to the first)."""
    from vector_indexer_tpu_torch.index.ivf import IvfIndex
    from vector_indexer_tpu_torch.kernels import build as kb

    gc_collect(torch)
    k1 = kb.launch_counts()["assign_argmin"]
    t0 = time.perf_counter()
    idx = IvfIndex.fit(store, trainer=trainer, device=dev)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    k1 = kb.launch_counts()["assign_argmin"] - k1
    ratio = inertia_of(torch, xb_dev, idx.centroids, layout_labels(np, idx)) / lloyd_i
    ln = np.asarray(idx.layout.lengths)
    skew = float(ln.max() / ln.mean())
    _, I = idx.search_batch(xq, K, 32)
    r10 = quality(np, I, gt, K)[1]
    log(f"  fit(trainer={trainer!r}): {fit_s:.2f}s, nlist={idx.num_clusters}, inertia "
        f"{ratio!r}x Lloyd's, max/mean list length {skew:.4f} (Lloyd {lloyd_skew:.4f}), "
        f"auto n_probe=32 R@10 {r10:.4f}, K1 launched {k1}x")
    check(ratio <= TRAINER_INERTIA_BOUND,
          f"{trainer}: inertia {ratio:.4f}x Lloyd's <= {TRAINER_INERTIA_BOUND}")
    if trainer == "mini_batch":
        check(k1 > 0, f"assign_argmin launched in the mini-batch fit ({k1}x)")
    else:
        check(skew <= lloyd_skew, f"balanced: max/mean list length {skew:.4f} <= Lloyd's "
                                  f"{lloyd_skew:.4f}")
        # Its controller and clone-split amplify any rounding that differs
        # between runs, so the card's statistics must be deterministic.
        again = IvfIndex.fit(store, trainer=trainer, device=dev)
        check(torch.equal(torch.as_tensor(again.centroids).cpu(),
                          torch.as_tensor(idx.centroids).cpu()),
              "balanced: a second fit of the same seed gives the same centroids bit for bit")
        del again
    del idx
    return dict(fit_s=fit_s, inertia_ratio=ratio, skew=skew, r10=r10, k1=k1)


def dp_lloyd_check(torch, xb, xb_dev, nlist: int, mesh, check, iters: int = 20) -> dict:
    """``run_kmeans_lloyd_dp`` over ``mesh`` beside the single-device Lloyd
    (same seed and iterations) on ``xb_dev``'s card: wall seconds, the
    inertia ratio and the label agreement, held to DP_INERTIA_BOUND and
    DP_AGREE_FLOOR."""
    from vector_indexer_tpu_torch.models.kmeans import run_kmeans_lloyd
    from vector_indexer_tpu_torch.parallel import run_kmeans_lloyd_dp

    t0 = time.perf_counter()
    dp = run_kmeans_lloyd_dp(xb, nlist, iters, mesh, seed=42)
    for dv in set(mesh.devices.flat):
        torch.cuda.synchronize(dv)
    dp_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    single = run_kmeans_lloyd(xb_dev, nlist, iters, seed=42)
    torch.cuda.synchronize()
    single_s = time.perf_counter() - t0
    ratio = inertia_of(torch, xb_dev, dp.centroids, dp.labels) / inertia_of(
        torch, xb_dev, single.centroids, single.labels)
    agree = float((dp.labels.cpu() == single.labels.cpu()).float().mean())
    log(f"  data-parallel Lloyd over {mesh}: {dp_s:.2f}s, {dp.iterations} iterations; "
        f"single-device {single_s:.2f}s, {single.iterations}; inertia ratio {ratio!r}, "
        f"label agreement {agree!r}")
    check(ratio <= DP_INERTIA_BOUND and agree >= DP_AGREE_FLOOR,
          f"data-parallel Lloyd: inertia {ratio:.6f}x the single-device run's <= "
          f"{DP_INERTIA_BOUND}, label agreement {agree:.6f} >= {DP_AGREE_FLOOR}")
    return dict(dp_s=dp_s, single_s=single_s, inertia_ratio=ratio, agreement=agree)


def sync_check(torch, ss, xq, k: int, check) -> None:
    """The per-device loop of ``ShardedSearcher`` ``ss`` only enqueues work,
    so that distinct cards overlap: any synchronising call inside it (a size
    read, .item(), a copy to the host) raises under the sync debug mode.
    Checked in every body at n_probe 32."""
    method = ss.method
    for body in ("dense", "dense_fused", "stream"):
        ss.method = body
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            ss.run([(j, dv, xq) for j, dv in enumerate(ss.devices)], k, 32, len(xq))
            err = None
        except RuntimeError as e:
            err = str(e).splitlines()[0]
        finally:
            torch.cuda.set_sync_debug_mode(0)
        for dv in set(ss.devices):
            torch.cuda.synchronize(dv)
        check(err is None, f"sharded {body}: the per-device loop makes no host "
                           f"synchronisation ({err or 'none raised'})")
    ss.method = method


def grid_check(torch, np, index, devs, xq, k: int, ref_I, flat_list: int, check) -> dict:
    """``Sharded2DSearcher`` and ``MultiHostSearcher`` ('dense', n_probe 32)
    on a 2 x (len(devs) / 2) grid of ``devs``: batch ms, merge bytes, the
    1-D searcher's sets ``ref_I`` on >= SHARD_SAME_FLOOR of queries, and
    the multi-host stage-2 bytes S-fold below a flat merge's cross-host
    bytes (``flat_list``: one device's list in bytes)."""
    from vector_indexer_tpu_torch.parallel import Mesh, MultiHostSearcher, Sharded2DSearcher

    half = len(devs) // 2
    grid = np.empty((2, half), dtype=object)
    for i, dv in enumerate(devs):
        grid[i // half, i % half] = dv
    out = {}
    for name, key, searcher in (
            (f"Sharded2DSearcher (2 x {half})", "2d",
             Sharded2DSearcher(index, Mesh(grid, ("queries", "shards")))),
            (f"MultiHostSearcher (2 hosts x {half} shards)", "multihost",
             MultiHostSearcher(index, Mesh(grid, ("hosts", "shards")), method="dense"))):
        ms = cuda_ms(torch, lambda: searcher.search_batch(xq, k, 32), reps=3)
        _, I = searcher.search_batch(xq, k, 32)
        same = sets_equal_share(np, I, ref_I)
        out[key] = dict(ms=ms, merge_bytes=searcher.last_merge_bytes, same=same)
        log(f"  {name} dense n_probe=32: batch {ms:9.3f} ms, merge bytes "
            f"{searcher.last_merge_bytes}")
        check(same >= SHARD_SAME_FLOOR, f"{name}: the 1-D searcher's sets on {same:.4f} of "
                                        f"queries (>= {SHARD_SAME_FLOOR})")
        if key == "multihost":
            H, S = searcher.grid.shape
            flat_cross = flat_list * (H - 1) * S
            hosts = searcher.last_merge_bytes["hosts"]
            check(flat_cross == S * hosts,
                  f"multi-host merge: stage-2 (cross-host) bytes {hosts} = a flat merge's "
                  f"cross-host {flat_cross} / S ({S})")
        del searcher
    return out


def parallel_phase(torch, np, xb, xq, check, dev, work, spill_work, gt):
    """Phase 9 on phase 4's corpus and saved index: the mini-batch and
    balanced fits, the data-parallel Lloyd beside the single-device one,
    the 1-D sharded searcher (four mesh entries) in each body, the 2-D and
    multi-host searchers, and a CPU twin. Returns the phase's counts."""
    from vector_indexer_tpu_torch import bindings
    from vector_indexer_tpu_torch.kernels import build as kb
    from vector_indexer_tpu_torch.parallel import Mesh, ShardedSearcher
    from vector_indexer_tpu_torch.storage.vector_store import VectorStore

    k, d, n = K, xb.shape[1], xb.shape[0]
    idx_dir, sh_dir = str(work / "index"), str(work / "shards")
    kb.reset_launch_counts()  # counts from here on belong to phase 9
    xb_dev = torch.as_tensor(xb, device=dev)
    vl = bindings.load(idx_dir, sh_dir, d, device=dev)
    lloyd_i = inertia_of(torch, xb_dev, vl.index.centroids, layout_labels(np, vl.index))
    ln = np.asarray(vl.index.layout.lengths)
    lloyd_skew = float(ln.max() / ln.mean())
    log(f"  phase 4's Lloyd index: inertia {lloyd_i:.6e}, max/mean list length {lloyd_skew:.4f}")

    # (a) the mini-batch and balanced trainers.
    store = VectorStore(external_ids=np.arange(n, dtype=np.uint64), vectors=xb)
    for trainer in ("mini_batch", "balanced"):
        trainer_check(torch, np, store, xb_dev, xq, gt, lloyd_i, lloyd_skew, trainer, dev, check)

    # (b) the data-parallel Lloyd beside the single-device one.
    gc_collect(torch)
    mesh = Mesh(mesh_devices(torch, 4), ("shards",))
    dp_lloyd_check(torch, xb, xb_dev, vl.index.num_clusters, mesh, check)
    gc_collect(torch)

    # (c) the 1-D sharded searcher, each body, beside the single-device routes.
    single_routes = {"dense": "dense_exact", "dense_fused": "dense_fused", "stream": "stream"}
    ref = {}
    xq_dev = torch.as_tensor(xq, device=dev)
    for n_probe in SHARD_N_PROBES:
        for m, route in single_routes.items():
            Ds, Rs = vl.search_device(xq_dev, k, n_probe, method=route)
            ref[(m, n_probe)] = (Ds.cpu().numpy(), vl.rows_to_external(Rs))
    t0 = time.perf_counter()
    ss = ShardedSearcher(vl.index, mesh, method="dense")
    log(f"  ShardedSearcher over {mesh}: {time.perf_counter() - t0:.2f}s to build the local "
        f"tables; {ss._host_tables.local_vecs.shape[1]} rows per slice")
    perm = ss.local_perm[ss.local_perm >= 0]
    check(len(perm) == n and len(np.unique(perm)) == n,
          f"local_perm covers every row exactly once ({len(perm)} entries, "
          f"{len(np.unique(perm))} distinct)")
    scale = np.sum(xq * xq, axis=1) + float(np.max(np.sum(xb * xb, axis=1)))
    results = {}
    for method in ("dense", "dense_fused", "stream", "auto"):
        ss.method = method
        for n_probe in SHARD_N_PROBES:
            before = kb.launch_counts()
            ms = cuda_ms(torch, lambda: ss.search_batch(xq, k, n_probe), reps=3)
            D, I = ss.search_batch(xq, k, n_probe)
            after = kb.launch_counts()
            used = {kname: after[kname] - before[kname] for kname in after
                    if after[kname] > before[kname]}
            results[(method, n_probe)] = (D, I)
            r1, r10, r100, ov = quality(np, I, gt, k)
            log(f"  sharded {method:11s} n_probe={n_probe:4d} (body {ss.last_method}): batch "
                f"{ms:9.3f} ms (CUDA events), QPS {NQ / ms * 1e3:9.1f}; R@1 {r1:.4f} R@10 "
                f"{r10:.4f} R@100 {r100:.4f} top-{k} overlap {ov:.4f}; kernels {used}")
            body = ss.last_method
            if method == "dense":
                Dr, Ir = ref[("dense", n_probe)]
                same = sets_equal_share(np, I, Ir)
                err = np.abs(D - Dr)
                check(same >= SHARD_SAME_FLOOR and bool((err <= RTOL * scale[:, None]).all()),
                      f"sharded dense n_probe={n_probe}: dense_exact's sets on {same:.4f} of "
                      f"queries (>= {SHARD_SAME_FLOOR}), distances within {RTOL:g}*(|q|^2+"
                      f"max|x|^2) (max |err| {float(err.max()):.3e})")
            elif method in ("dense_fused", "stream"):
                ov_single = quality(np, ref[(method, n_probe)][1], gt, k)[3]
                check(ov >= ov_single - SHARD_OVERLAP_SLACK,
                      f"sharded {method} n_probe={n_probe}: top-{k} overlap {ov:.4f} >= the "
                      f"single-device {single_routes[method]}'s {ov_single:.4f} - "
                      f"{SHARD_OVERLAP_SLACK}")
                kernels = (("flat_sweep_topk_plane",) if method == "dense_fused" else
                           ("stream_distances[bf16]", "stream_fused_plane[bf16]"))
                check(body == method and any(used.get(kname, 0) for kname in kernels),
                      f"sharded {method} n_probe={n_probe}: body {body}, launched one of "
                      f"{kernels}")
    flat_list = ss.last_merge_bytes["shards"] // (ss.n_dev - 1)
    sync_check(torch, ss, xq, k, check)

    sp = bindings.load(str(spill_work / "index"), str(spill_work / "shards"), d, device=dev)
    for method in ("dense_fused", "stream"):
        sps = ShardedSearcher(sp.index, mesh, method=method)
        _, I = sps.search_batch(xq, k, 32)
        check(no_dup_rows(np, I), f"phase 7's spilled index sharded ({method}, n_probe 32): no "
                                  f"repeated id in a row (R@10 {quality(np, I, gt, k)[1]:.4f})")
        del sps
    del sp

    # (d) the 2-D and multi-host searchers, against the 1-D searcher's sets.
    grid_check(torch, np, vl.index, mesh_devices(torch, 4), xq, k, results[("dense", 32)][1],
               flat_list, check)
    del ss
    torch.cuda.synchronize()
    counts = kb.launch_counts()
    log(f"  launch counts in phase 9: {counts}")

    # (e) the 1-D searcher again on the CPU (the plain versions).
    t0 = time.perf_counter()
    vc = bindings.load(idx_dir, sh_dir, d, device="cpu")
    cpu = torch.device("cpu")
    qs = xq[:NQ_TWIN]
    sc = ShardedSearcher(vc.index, Mesh([cpu] * 4, ("shards",)))
    for method, n_probe in SHARD_TWINS:
        sc.method = method
        Dp, Ip = sc.search_batch(qs, k, n_probe)
        Dc, Ic = (a[:NQ_TWIN] for a in results[(method, n_probe)])
        err = np.abs(Dc - Dp)
        same = sets_equal_share(np, Ic, Ip)
        check(bool(np.isfinite(Dp).all()) and bool((err <= RTOL * scale[:NQ_TWIN, None]).all())
              and same >= TWIN_SAME_FLOOR,
              f"sharded {method} n_probe={n_probe}: card vs CPU, {NQ_TWIN} queries: every rank "
              f"within {RTOL:g}*(|q|^2+max|x|^2) (max |err| {float(err.max()):.3e}); equal "
              f"sets on {same:.4f} (>= {TWIN_SAME_FLOOR})")
    log(f"  CPU comparison: {time.perf_counter() - t0:.2f}s")
    return counts


# ---------------------------------------------------------------------------
# Phase 10: the surface (native shard I/O, selective reads, staged queries,
# the device profiler, the demo)
# ---------------------------------------------------------------------------


def trace_kernel_counts(trace: dict, names) -> dict:
    """Per kernel name, the number of the Chrome trace's CUDA kernel events
    whose (demangled) name holds it as a whole word."""
    pats = {n: re.compile(rf"\b{re.escape(n)}\b") for n in names}
    out = dict.fromkeys(names, 0)
    for e in trace.get("traceEvents", []):
        if str(e.get("cat", "")).lower() != "kernel":
            continue
        for n, pat in pats.items():
            if pat.search(str(e.get("name", ""))):
                out[n] += 1
    return out


def trace_device_ms(trace: dict) -> float:
    """Milliseconds of the trace's device-side events (kernels, copies and
    memsets; one stream, so they do not overlap)."""
    return sum(float(e.get("dur", 0.0)) for e in trace.get("traceEvents", [])
               if str(e.get("cat", "")).lower() in DEVICE_EVENT_CATS) / 1e3


def kernel_launch_totals(counts: dict) -> dict:
    """Launch counters summed per CUDA kernel (the counters split a kernel
    by table type or precision: ``stream_distances[bf16]`` ...)."""
    out = dict.fromkeys(TRACE_KERNELS.values(), 0)
    for name, c in counts.items():
        out[TRACE_KERNELS[name.split("[")[0]]] += c
    return out


def surface_phase(torch, np, xb, xq, check, dev, work):
    """Phase 10 on phase 4's saved index: the native shard reader against
    Python's reads, selective per-centroid reads against the card's layout
    rows, native vs numpy load times, staged queries against unstaged ones,
    ``device_profiler`` traces against the launch counters, and the demo
    on the card. Returns the phase's launch counts."""
    from vector_indexer_tpu_torch import bindings
    from vector_indexer_tpu_torch.api import VectorIndexer, VectorIndexerConfig
    from vector_indexer_tpu_torch.kernels import build as kb
    from vector_indexer_tpu_torch.ops.topk import brute_force_topk
    from vector_indexer_tpu_torch.storage import read_centroid_vectors
    from vector_indexer_tpu_torch.storage import shard_format as sf
    from vector_indexer_tpu_torch.storage.layout import cluster_starts
    from vector_indexer_tpu_torch.storage.native import shardio
    from vector_indexer_tpu_torch.utils import tracing

    k, d, nq = K, xb.shape[1], xq.shape[0]
    idx_dir, sh_dir = work / "index", work / "shards"
    kb.reset_launch_counts()  # counts from here on belong to phase 10
    gpu = gpu_line()

    # (a) native I/O: present, and byte-equal to Python's reads.
    check(shardio.available(), "native shard I/O library built by g++ and loaded "
          f"({shardio.library_path().name})")
    files = sorted(sh_dir.glob("shard_*.bin"))
    same, nbytes = 0, 0
    for p in files:
        raw = p.read_bytes()
        with shardio.mmap_view(str(p)) as mv:
            mapped = bytes(mv)
        same += shardio.read_file(str(p)) == raw and mapped == raw
        nbytes += len(raw)
    check(len(files) > 0 and same == len(files),
          f"read_file and mmap_view equal open().read() on {same} of {len(files)} shard "
          f"files ({nbytes / 2**20:.1f} MiB)")

    # (b) whole-shard loads, native then numpy then native (host clock).
    stage_ms = {}
    for path in ("native", "numpy", "native"):
        saved = sf._native
        if path == "numpy":
            sf._native = lambda: None
        try:
            tracing.reset_phases()
            t0 = time.perf_counter()
            vi = bindings.load(str(idx_dir), str(sh_dir), d, device=dev)
            torch.cuda.synchronize()
            load_ms = (time.perf_counter() - t0) * 1e3
        finally:
            sf._native = saved
        ms = tracing.phase_report()["load.stage_shards"]["total_s"] * 1e3
        stage_ms.setdefault(path, []).append(ms)
        log(f"  load ({path} shard reads): load.stage_shards {ms:.1f} ms, whole load "
            f"{load_ms:.1f} ms (host clock; {gpu})")
        if path == "numpy":
            del vi
            gc_collect(torch)
    idx, lay = vi.index, vi.index.layout

    # (c) selective reads of the first NQ_SELECT queries' probed lists
    # (n_probe 8) against the card's layout rows, copied back once.
    cent = torch.as_tensor(idx.centroids, dtype=torch.float32, device=dev)
    _, probes = brute_force_topk(torch.as_tensor(xq[:NQ_SELECT], device=dev), cent, 8)
    lists = np.unique(probes.cpu().numpy())
    by_shard = {}
    for cid in lists:
        by_shard.setdefault(int(idx.centroids_to_shard[cid]), []).append(int(cid))
    t0 = time.perf_counter()
    read = {}
    for sid, cids in by_shard.items():
        read.update(read_centroid_vectors(sf.shard_path(sh_dir, sid), sid, cids))
    sel_ms = (time.perf_counter() - t0) * 1e3
    starts, lengths = cluster_starts(lay), np.asarray(lay.lengths)
    rows = np.concatenate([np.arange(starts[c], starts[c] + lengths[c]) for c in lists])
    vecs = lay.vectors[torch.as_tensor(rows, device=dev)].cpu().numpy()
    internal = lay.perm[rows]
    ok, off = 0, 0
    for c in lists:
        m, cl = int(lengths[c]), read[int(c)]
        ok += (np.array_equal(cl.vectors, vecs[off:off + m])
               and np.array_equal(cl.internal_ids.astype(np.int64), internal[off:off + m]))
        off += m
    check(ok == len(lists), f"read_centroid_vectors equals the card's layout rows (vectors and "
          f"internal ids) for {ok} of {len(lists)} probed lists of {NQ_SELECT} queries "
          f"(n_probe 8, {len(by_shard)} shards, {rows.size} rows)")
    log(f"  selective read of those {len(lists)} lists ({rows.size} rows): {sel_ms:.1f} ms, "
        f"against the whole-shard load.stage_shards {stage_ms['native'][0]:.1f} / "
        f"{stage_ms['native'][1]:.1f} ms native, {stage_ms['numpy'][0]:.1f} ms numpy "
        f"(host clock; {gpu})")

    # (d) staged queries change nothing.
    xs = vi.stage_queries(xq, pad_to=1024)
    torch.cuda.synchronize()
    check(tuple(xs.shape) == (1024, d) and xs.device == dev
          and torch.equal(xs[:nq].cpu(), torch.as_tensor(xq)) and not xs[nq:].any(),
          f"stage_queries: {nq} queries on {xs.device}, zero-padded to {xs.shape[0]}")
    for n_probe in PROFILE_N_PROBES:
        D0, R0 = vi.search_device(xq, k, n_probe)
        D1, R1 = vi.search_device(xs, k, n_probe)
        check(torch.equal(R1[:nq], R0) and torch.equal(D1[:nq], D0),
              f"n_probe={n_probe}: staged search_device equals the unstaged call's {nq} "
              f"rows (rows equal, distances bit-equal)")

    # (e) device_profiler sees the hand-written kernels, as many as counted.
    for n_probe, kern in PROFILE_N_PROBES.items():
        before = kb.launch_counts()
        with tracing.device_profiler(work / "profile") as path:
            vi.search_device(xs, k, n_probe)
        after = kb.launch_counts()
        counted = kernel_launch_totals({n: c - before.get(n, 0) for n, c in after.items()})
        trace = json.loads(Path(path).read_text())
        seen = trace_kernel_counts(trace, counted)
        dev_ms = trace_device_ms(trace)
        check(seen[kern] > 0 and seen == counted,
              f"n_probe={n_probe}: the profiler's trace holds {kern} ({seen[kern]}x); its "
              f"kernel events {({n: c for n, c in seen.items() if c})} equal the launch "
              f"counters' {({n: c for n, c in counted.items() if c})}")
        log(f"  n_probe={n_probe} ({kern}): device ms per batch from the trace {dev_ms:.3f} "
            f"(PERF.md section 5's profile: {PROFILE_DEVICE_MS[n_probe]}); {gpu}")

    # (f) the demo on the card: builds, then loads, with the same ids as
    # this process's load + search_sync.
    demo_dir = work / "demo"
    cmd = [sys.executable, str(ROOT / "examples" / "demo_torch.py"), "--work-dir", str(demo_dir)]
    outs = []
    for want in ("building index...", "loaded existing index"):
        t0 = time.perf_counter()
        res = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=600)
        ids = [int(m) for m in re.findall(r"external_id=(\d+)", res.stdout)]
        log(f"  demo ({want}) {time.perf_counter() - t0:.2f}s: exit {res.returncode}, ids {ids}")
        check(res.returncode == 0 and want in res.stdout and len(ids) > 0,
              f"examples/demo_torch.py on the card prints '{want}' and its results"
              + ("" if res.returncode == 0 else f"; stderr: {res.stderr[-2000:]}"))
        outs.append(ids)
    cfg = (VectorIndexerConfig(d).with_index_dir(demo_dir / "index")
           .with_shards_dir(demo_dir / "shards").with_device(dev))
    ix = VectorIndexer.load(cfg)
    query = np.random.default_rng(7).uniform(-1, 1, d).astype(np.float32)
    mine = [r.external_id for r in ix.search_sync(ix.search_request(query))]
    check(outs[0] == outs[1] == mine,
          f"the demo's two runs and this process's load + search_sync give the same ids ({mine})")

    torch.cuda.synchronize()
    counts = kb.launch_counts()
    log(f"  launch counts in phase 10: {counts}")
    for name in PHASE10_KERNELS:
        check(counts.get(name, 0) > 0, f"{name} launched in phase 10 ({counts.get(name, 0)}x)")
    return counts


# ---------------------------------------------------------------------------
# Phase 11: wide rows
# ---------------------------------------------------------------------------


def clustered_on_card(torch, n: int, d: int, nq: int, seed: int, dev):
    """benchmarks/datasets.py::clustered's distribution (ncent Gaussian
    centers at scale 4, unit-variance points and queries around them),
    drawn on the card from ``seed`` (torch's generator, not numpy's)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    ncent = max(64, min(1024, n // 1000))
    centers = 4.0 * torch.randn((ncent, d), generator=g, device=dev)
    xb = torch.empty((n, d), device=dev)
    step = max(1, (1 << 28) // (4 * d))
    for s in range(0, n, step):
        e = min(n, s + step)
        lab = torch.randint(0, ncent, (e - s,), generator=g, device=dev)
        xb[s:e] = centers[lab] + torch.randn((e - s, d), generator=g, device=dev)
    lab = torch.randint(0, ncent, (nq,), generator=g, device=dev)
    return xb, centers[lab] + torch.randn((nq, d), generator=g, device=dev)


def stream_sharing(table, grid) -> float:
    """Probed rows over distinct rows of a stream task grid: how many
    queries read a probed row on average (the bound counts each once)."""
    return float(grid["nval"].clamp_min(0).sum()) / max(distinct_rows(table, grid), 1)


def k4_launch(q, table, t_fixed: int) -> str:
    """Which K4 launch these operands take: the split plan (slices of d x
    parts of each query's rows), or one block per (query, group)."""
    from vector_indexer_tpu_torch.kernels import build as kb
    from vector_indexer_tpu_torch.ops import block_stream as bs

    G = bs.pick_stream_groups(table.chunk)
    p = bs.stream_fused_split_plan(q.shape[1], table.vecs.element_size(), table.chunk,
                                   q.shape[0], G, t_fixed, kb.sm_count(q.device))
    if p is None:
        return f"one block per (query, group): {q.shape[0] * G} blocks"
    return (f"split: {p.n_slices} slices of {p.slice} x {p.parts} parts of the rows, "
            f"{p.blocks} blocks, {p.sub_rows} rows a stage")


def k6_launch(d: int, max_len: int) -> str:
    """Which K6 launch rows of d take: items (rows per item, items per
    probe, query panel) or one block per (query, probe)."""
    from vector_indexer_tpu_torch.ops import ivf_gather as ig

    p = ig.ivf_gather_item_plan(d, ig.max_len_pad(max_len))
    if p is None:
        return f"one block per (query, probe), {ig.ivf_gather_plan(d).qres} query elements in " \
               f"shared memory"
    return f"items of {p.rows} rows, {p.items} per probe, query panel {p.panel}"


def k2_launch(q, table, grid) -> str:
    """Which K2 launch these operands take: the split plan (slices of d x
    parts of each query's valid rows, the bytes its stages keep in flight an
    SM), or one block per run of a query's slots (16-byte words in flight)."""
    from vector_indexer_tpu_torch.kernels import build as kb
    from vector_indexer_tpu_torch.ops import block_stream as bs

    nq, d = q.shape
    item, t_fixed = table.vecs.element_size(), grid["t_fixed"]
    p = bs.stream_distances_split_plan(d, item, table.chunk, nq, t_fixed, kb.sm_count(q.device))
    if p is None:
        base = bs.stream_distances_plan(d, item, t_fixed, table.chunk)
        return (f"one block per (query, run of {base.spb} slots): "
                f"{nq * -(-t_fixed // base.spb)} blocks, 32 KB in flight a block")
    rows = float(grid["nval"].clamp_min(0).sum()) / nq / p.parts
    per_sm = 2 if p.smem <= bs.SPLIT_SMEM else 1
    return (f"split: {p.n_slices} slices of {p.slice} x {p.parts} parts of ~{rows:.1f} rows, "
            f"{p.blocks} blocks, {p.sub_rows} rows a stage, "
            f"{per_sm * bs.SPLIT_STAGES * p.stage_bytes // 1024} KB in flight an SM")


def wide_kernel_checks(torch, np, check, dev):
    """K2 (with and without nval2d; bf16 / int8 / f32), K4 (bf16 / int8), K5
    (bf16 / int8 / f32) and K6 against their plain versions at each d of
    WIDE_DIMS, l2 and ip, on a small index of that width (2,048 points, 8
    lists, chunk 256, 8 queries probing 3 lists; K2 and K4 also at 1 and
    WIDE_CHECK_NQ queries; K2 run twice, bit for bit); each check names the
    launch plan (K2's and K4's split or not, rows, stages; K6's items) its
    kernel took."""
    from vector_indexer_tpu_torch.index.ivf import IvfIndex
    from vector_indexer_tpu_torch.kernels import build as kb
    from vector_indexer_tpu_torch.ops import block_stream as bs
    from vector_indexer_tpu_torch.storage.vector_store import VectorStore

    n, nq, n_probe, chunk = 2048, 8, 3, 256
    for d in WIDE_DIMS:
        t0 = time.perf_counter()
        xb, q_all = clustered_on_card(torch, n, d, WIDE_CHECK_NQ, d, dev)
        q = q_all[:nq]
        store = VectorStore(external_ids=np.arange(n, dtype=np.uint64), vectors=xb.cpu().numpy())
        del xb
        idx = IvfIndex.fit(store, seed=1, nlist=8, max_iters=3, device=dev)
        c, c_sq = idx._device_tables()
        lengths = idx.layout.lengths
        for dtype in (torch.bfloat16, torch.int8, torch.float32):
            tb = bs.build_stream_table(idx.layout, idx.centroids, dtype, chunk=chunk)
            item, mode = tb.vecs.element_size(), kb.ROW_TYPES[dtype][1]
            exact = dtype == torch.float32
            for metric in ("l2", "ip"):
                grid = stream_grid(q, tb, c, c_sq, lengths, n_probe, metric, worst_case=exact)
                what = f"{mode} d={d} {metric} t_fixed={grid['t_fixed']}"
                for qs in (q[:1], q, q_all):
                    g2 = grid if qs is q else stream_grid(qs, tb, c, c_sq, lengths, n_probe,
                                                          metric, worst_case=exact)
                    launch = k2_launch(qs, tb, g2)
                    for nval in (False, True):
                        ok, err = check_k2(qs, tb, g2, metric, nval)
                        check(ok, f"K2 wide {what} nq={len(qs)}{' nval2d' if nval else ''} "
                                  f"({launch}): |err| <= {RTOL:g}*(term magnitude); max |err| "
                                  f"{err:.3e}")
                kw2 = k2_kw(tb, grid, metric, True)
                runs2 = [bs.stream_distances(*k2_args(q, tb, grid), **kw2) for _ in range(2)]
                check(torch.equal(*runs2), f"K2 wide {what} nq={len(q)} nval2d: two runs "
                                           f"bit-equal")
                del runs2
                if not exact:
                    for qs in (q[:1], q, q_all):
                        g4 = grid if qs is q else stream_grid(qs, tb, c, c_sq, lengths, n_probe,
                                                              metric)
                        ok, n_mism, err = check_k4(qs, tb, g4, metric)
                        check(ok, f"K4 wide {what} nq={len(qs)} ({k4_launch(qs, tb, g4['t_fixed'])}"
                                  f"): planes within {RTOL:g}*(query term scale), {n_mism} slot "
                                  f"differences all near-ties; max |err| {err:.3e}")
                t_cap = bs.shared_task_cap(lengths, n_probe, nq, grid["t_fixed"],
                                           worst_case=exact, chunk=chunk)
                tasks = shared_tasks(q, tb, c, c_sq, lengths, n_probe, grid["t_fixed"], t_cap,
                                     metric)
                p5 = bs.stream_shared_plan(d, item, chunk)
                ok, err = check_k5(tb, tasks, metric)
                check(ok, f"K5 wide {what} t_cap={t_cap} (K-panel {p5.kpanel}, {p5.panel_rows} "
                          f"rows, {p5.stages} stages): |err| <= {RTOL:g}*(|qc|^2+|r|^2); "
                          f"max |err| {err:.3e}")
            del tb
        starts, lens, max_len, budget = gather_operands(q, idx, n_probe)
        for metric in ("l2", "ip"):
            ok, err = check_k6(q, idx.layout.vectors, starts, lens, max_len, budget, metric)
            check(ok, f"K6 wide d={d} {metric} ({k6_launch(d, max_len)}): equal rows and "
                      f"holes, distances within {RTOL:g}*(terms); max |err| {err:.3e}")
        del idx, q, q_all
        gc_collect(torch)
        log(f"  wide kernel checks at d={d}: {time.perf_counter() - t0:.2f}s")


def cpu_twin(torch, idx):
    """A copy of an IvfIndex whose tables (layout, stream tables, the
    correction table) are copied to the CPU, where every kernel wrapper
    runs its plain version: the same index state without a second build."""
    import copy
    import dataclasses

    def to_cpu(obj):
        if obj is None:
            return None
        return dataclasses.replace(obj, **{
            f.name: getattr(obj, f.name).cpu() for f in dataclasses.fields(obj)
            if isinstance(getattr(obj, f.name), torch.Tensor)})

    tw = copy.copy(idx)
    tw.device = torch.device("cpu")
    tw.layout = to_cpu(idx.layout)
    tw._stream_tables = {dt: to_cpu(st) for dt, st in idx._stream_tables.items()}
    tw._corr_table = to_cpu(idx._corr_table)
    tw._dev = tw._runs = tw._perm_inv = tw._perm_dev = tw._sweep_q = tw._lists = None
    tw._budgets = None
    return tw


def twin_check(np, check, what, card, cpu, scale):
    """Card vs CPU results rank by rank: finite where the CPU's are, every
    rank's distance within RTOL * scale, and equal row sets on >=
    TWIN_SAME_FLOOR of the queries, where a query whose sets differ only
    by near-tie swaps at the last rank (every row in one set and not the
    other within 2 RTOL * scale of that query's k-th distance) counts as
    equal: the floor's allowance for those swaps is less than one query of
    WIDE_TWIN, so each difference is held to being such a swap instead."""
    (Dc, Rc), (Dp, Rp) = card, cpu
    fin = np.isfinite(Dp)
    err = np.abs(np.where(fin, Dc - Dp, 0.0))
    equal = (np.sort(Rc, 1) == np.sort(Rp, 1)).all(axis=1)
    tie = np.zeros_like(equal)
    for i in np.flatnonzero(~equal):
        dk = max(Dc[i, -1], Dp[i, -1])
        swapped = np.concatenate([Dc[i][~np.isin(Rc[i], Rp[i])], Dp[i][~np.isin(Rp[i], Rc[i])]])
        tie[i] = bool((np.abs(swapped - dk) <= 2 * RTOL * scale[i]).all())
    same = float((equal | tie).mean())
    check(bool((np.isfinite(Dc) == fin).all()) and bool((err <= RTOL * scale[:, None]).all())
          and same >= TWIN_SAME_FLOOR,
          f"{what}: card vs plain versions on the CPU, {len(Dc)} queries: every rank's distance "
          f"within {RTOL:g}*(|q|^2+max|x|^2) (max |err| {float(err.max()):.3e}); equal row "
          f"sets on {float(equal.mean()):.4f} of queries, {int(tie.sum())} more differing only "
          f"by near-tie swaps at rank {Dc.shape[1]} ({same:.4f} >= {TWIN_SAME_FLOOR})")


def k2_wide_entry(torch, check, q, table, c, c_sq, lengths, n_probe: int, route: str) -> dict:
    """K2 at one of the wide runs' shapes (l2, valid rows only): checked
    against its plain version and run twice (bit-equal), timed by graph
    replay beside the per-query bound (each query's valid rows, norms and
    output) and the distinct-rows bound with the sharing factor between
    them, the plain version's time, and the launch it took."""
    from vector_indexer_tpu_torch.kernels import build as kb
    from vector_indexer_tpu_torch.ops import block_stream as bs

    nq, d = q.shape
    mode = kb.ROW_TYPES[table.dtype][1]
    grid = stream_grid(q, table, c, c_sq, lengths, n_probe, "l2")
    kw = k2_kw(table, grid, "l2", True)
    fn = lambda: bs.stream_distances(*k2_args(q, table, grid), **kw)
    ok, err = check_k2(q, table, grid, "l2", True)
    same = torch.equal(fn(), fn())
    launch = k2_launch(q, table, grid)
    shape = f"{mode} nq={nq} n_probe={n_probe} t_fixed={grid['t_fixed']} chunk={table.chunk} d={d}"
    check(ok and same, f"K2 {shape} ('auto': {route}; {launch}): |err| <= {RTOL:g}*(term "
                       f"magnitude), +inf past nval; max |err| {err:.3e}; two runs bit-equal: "
                       f"{same}")
    out_bytes = nq * grid["t_fixed"] * table.chunk * 4
    sharing = stream_sharing(table, grid)
    return dict(
        max_abs_err=err, ms=graph_ms(torch, fn),
        plain_ms=cuda_ms(torch, lambda: bs.stream_distances_reference(
            *k2_args(q, table, grid), **kw), reps=1),
        per_query_bound_ms=stream_bound(q, table, grid, out_bytes, per_query=True)["bound_ms"],
        sharing=sharing, launch=launch, route=route, table=mode,
        shape=f"{shape}, sharing factor {sharing:.3f}",
        **stream_bound(q, table, grid, out_bytes))


def log_k2_entries(entries, gpu: str) -> None:
    """One line per K2 timing: the kernel against both bounds."""
    for r in entries:
        pq = r["per_query_bound_ms"]
        log(f"  wide_k2: kernel {r['ms']:.4f} ms (graph replay), plain {r['plain_ms']:.3f} ms, "
            f"per-query bound {pq:.4f} ms ({pq / r['ms']:.3f} of it), distinct-rows bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}) ({r['shape']}; {r['launch']}; 'auto': "
            f"{r['route']}; {gpu})")


def k5_kpanel_entry(torch, check, idx, xq_dev, nq: int, n_probe: int) -> dict:
    """K5 f32 at 'stream_shared_exact''s shape on the wide index (its
    K-panel mode at d 16,384): checked, timed by graph replay beside its
    bound."""
    from vector_indexer_tpu_torch.index import dispatch
    from vector_indexer_tpu_torch.ops import block_stream as bs

    tb = idx._stream_table(torch.float32)
    c, c_sq = idx._device_tables()
    dec = dispatch.resolve(idx, nq, n_probe, k=K, method="stream_shared_exact")
    qs = xq_dev[:nq]
    tasks = shared_tasks(qs, tb, c, c_sq, idx.layout.lengths, n_probe, dec.t_fixed, dec.t_cap,
                         "l2")
    p5 = bs.stream_shared_plan(qs.shape[1], 4, tb.chunk)
    used = int((tasks.blk >= 0).sum())
    launch = (f"K-panel {p5.kpanel}, {p5.panel_rows} rows, {p5.stages} stages, {dec.t_cap} "
              f"tasks ({used} used)")
    ok, err = check_k5(tb, tasks, "l2")
    shape = f"f32 nq={nq} n_probe={n_probe} t_fixed={dec.t_fixed} t_cap={dec.t_cap} d={qs.shape[1]}"
    check(ok, f"K5 {shape} ({launch}): |err| <= {RTOL:g}*(|qc|^2+|r|^2); max |err| {err:.3e}")
    kw = dict(chunk=tb.chunk, metric="l2")
    return dict(max_abs_err=err,
                ms=graph_ms(torch, lambda: bs.stream_shared_plane(*k5_args(tb, tasks), **kw)),
                plain_ms=cuda_ms(torch, lambda: bs.stream_shared_plane_reference(
                    *k5_args(tb, tasks), **kw), reps=1),
                sharing=int(tasks.written.sum()) / max(1, int(torch.unique(
                    tasks.blk[tasks.blk >= 0]).numel())),
                launch=launch, shape=shape, **shared_bound(tb, tasks))


def wide_search(torch, ix, method, nq, n_probe, qs, k: int = K):
    """``search_batch_device`` of ``qs`` at batch ``nq`` (nq 1: one call per
    query, nq 1's program for each) -> (D, internal ids) numpy."""
    if nq == 1:
        outs = [ix.search_batch_device(qs[i:i + 1], k, n_probe, method=method)
                for i in range(len(qs))]
        D, R = (torch.cat([o[j] for o in outs]) for j in (0, 1))
    else:
        D, R = ix.search_batch_device(qs, k, n_probe, method=method)
    return D.cpu().numpy(), ix.rows_to_internal(R.cpu().numpy())


def wide_phase(torch, np, check, dev, results, twins: bool = True):
    """Phase 11 (wide rows): the kernels against their plain versions at
    WIDE_DIMS, then a WIDE_N x WIDE_D clustered corpus built on the card
    (Lloyd and K1 at that width) and served through 'auto' at nq 1 and 16
    (K2 and K4 bf16), 'gather_dma' (K6), 'stream_shared_exact' (K5 f32)
    and, offloaded with rerank='device', 'auto' (K2 / K4 int8); each run
    against a CPU twin of WIDE_TWIN queries (``twins``); K4 (at nq 16 and
    at nq 1 for each n_probe 'auto' sends there), K2 (bf16 and int8 at
    WIDE_K2_N_PROBES x WIDE_K2_NQ), K6 and K5's K-panels timed at their
    shapes by graph replay beside their bounds and sharing factors (into
    ``results``); then the 1,536-wide corpus (``wide_1536``). Returns the launch counts of the builds and the
    searches."""
    from vector_indexer_tpu_torch.index.dispatch import resolve
    from vector_indexer_tpu_torch.index.ivf import IvfIndex
    from vector_indexer_tpu_torch.kernels import build as kb
    from vector_indexer_tpu_torch.ops import block_stream as bs
    from vector_indexer_tpu_torch.storage.vector_store import VectorStore

    t_ph = time.perf_counter()
    wide_kernel_checks(torch, np, check, dev)
    gpu = gpu_line()
    k, n, d = K, WIDE_N, WIDE_D

    kb.reset_launch_counts()  # counts from here on belong to phase 11's runs
    t0 = time.perf_counter()
    xb_dev, xq_all = clustered_on_card(torch, n, d, WIDE_QUERIES, WIDE_SEED, dev)
    xq_dev = xq_all[:WIDE_TWIN]
    xb, xq = xb_dev.cpu().numpy(), xq_dev.cpu().numpy()
    del xb_dev
    gc_collect(torch)
    log(f"  wide corpus {n} x {d} f32 ({xb.nbytes / 1e9:.2f} GB) and {WIDE_QUERIES} queries "
        f"drawn on the card (seed {WIDE_SEED}): {time.perf_counter() - t0:.2f}s")
    t0 = time.perf_counter()
    store = VectorStore(external_ids=np.arange(n, dtype=np.uint64), vectors=xb)
    idx = IvfIndex.fit(store, seed=42, max_iters=WIDE_ITERS, device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    k1 = kb.launch_counts()["assign_argmin"]
    log(f"  wide build (Lloyd {WIDE_ITERS} iterations, K1): {build_s:.2f}s; nlist "
        f"{idx.num_clusters}, max list {idx.layout.max_list_len}, K1 launches {k1}")
    scale = np.sum(xq * xq, axis=1) + float(np.max(np.sum(xb * xb, axis=1)))

    # Routes from the port's own dispatch on the built index.
    runs = []
    for nq in WIDE_NQ:
        routes = {p: route_of(resolve(idx, nq, p, k=k), k) for p in WIDE_N_PROBES}
        if "stream/K4" not in routes.values():
            extra = next((p for p in range(1, idx.num_clusters + 1)
                          if route_of(resolve(idx, nq, p, k=k), k) == "stream/K4"), None)
            if extra is not None:
                routes[extra] = "stream/K4"
        log(f"  auto routes at nq={nq}: " + ", ".join(f"n_probe={p}: {r}" for p, r in routes.items()))
        runs += [("auto", nq, p, r) for p, r in routes.items()]
    dec = resolve(idx, 16, 8, k=k, method="gather_dma")
    runs.append(("gather_dma", 16, 8, route_of(dec, k)))
    dec = resolve(idx, 16, 8, k=k, method="stream_shared_exact")
    runs.append(("stream_shared_exact", 16, 8, route_of(dec, k)))
    check(runs[-2][3] == "gather_dma/K6" and runs[-1][3] == "stream_shared/K5",
          f"resolve: gather_dma -> {runs[-2][3]}, stream_shared_exact -> {runs[-1][3]}")

    card = {}
    for method, nq, n_probe, route in runs:
        wide_search(torch, idx, method, nq, n_probe, xq_dev)  # warm-up: builds the tables
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        card[(method, nq, n_probe)] = wide_search(torch, idx, method, nq, n_probe, xq_dev)
        ms = (time.perf_counter() - t0) * 1e3
        D = card[(method, nq, n_probe)][0]
        log(f"  {method} nq={nq} n_probe={n_probe} ({route}): {ms:.2f} ms for {WIDE_TWIN} "
            f"queries (host clock{', one call per query' if nq == 1 else ''})")
        check(D.shape == (WIDE_TWIN, k) and bool(np.isfinite(D).all()),
              f"wide {method} nq={nq} n_probe={n_probe} ({route}): finite ({WIDE_TWIN}, {k})")
    routes_seen = {r for *_, r in runs}
    check({"stream/K4", "stream/K2"} <= routes_seen,
          f"the wide runs take both stream routes (K2 and K4): {sorted(routes_seen)}")
    k2_runs = {(nq, p): r for m, nq, p, r in runs if m == "auto" and p in WIDE_K2_N_PROBES}
    log(f"  'auto' at n_probe {WIDE_K2_N_PROBES}, nq {WIDE_NQ}: {k2_runs} (K2 is timed at each "
        f"of these shapes below, whichever route 'auto' takes)")
    torch.cuda.synchronize()
    counts = kb.launch_counts()  # the build and the runs; comparisons below do not count
    for name in WIDE_KERNELS:
        check(counts[name] > 0, f"{name} launched in phase 11's device-resident runs "
                                f"({counts[name]}x)")

    # K4, K2, K6 and K5's K-panels at this width, timed by graph replay
    # beside their bounds.
    c, c_sq = idx._device_tables()
    tb = idx._stream_table()
    lengths = idx.layout.lengths
    G = bs.pick_stream_groups(tb.chunk)
    kw = dict(chunk=tb.chunk, groups=G, metric="l2", scales=tb.scales)

    def k4_entry(nq, n_probe):
        qs = xq_dev[:nq]
        grid = stream_grid(qs, tb, c, c_sq, lengths, n_probe, "l2")
        launch = k4_launch(qs, tb, grid["t_fixed"])
        ok, n_mism, err = check_k4(qs, tb, grid, "l2")
        check(ok, f"K4 bf16 at a wide run's shape (nq={nq}, n_probe={n_probe}, t_fixed="
                  f"{grid['t_fixed']}, d={d}; {launch}): planes within {RTOL:g}*(query term "
                  f"scale), {n_mism} slot differences all near-ties; max |err| {err:.3e}")
        sharing = stream_sharing(tb, grid)
        return dict(
            max_abs_err=err, ms=graph_ms(torch, lambda: bs.stream_fused_plane(
                *k4_args(qs, tb, grid), **kw)),
            plain_ms=cuda_ms(torch, lambda: bs.stream_fused_plane_reference(
                *k4_args(qs, tb, grid), **kw), reps=1),
            sharing=sharing, launch=launch,
            shape=f"nq={nq} n_probe={n_probe} t_fixed={grid['t_fixed']} chunk={tb.chunk} d={d}, "
                  f"sharing factor {sharing:.3f}",
            **stream_bound(qs, tb, grid, nq * 2 * G * tb.chunk * 8))

    # K4's shapes: each (nq, n_probe) of the runs that took K4 ('auto' at
    # nq 1 and 16), the batched one first.
    k4_runs = sorted({(nq, p) for m, nq, p, r in runs if r == "stream/K4"},
                     key=lambda r: (-r[0], r[1]))
    results["wide_k4"] = [k4_entry(nq, p) for nq, p in k4_runs or [(WIDE_TWIN, max(WIDE_N_PROBES))]]
    p4 = max(p for _, p in k4_runs) if k4_runs else max(WIDE_N_PROBES)
    starts, lens, max_len, budget = gather_operands(xq_dev, idx, 8)
    ok, err = check_k6(xq_dev, idx.layout.vectors, starts, lens, max_len, budget, "l2")
    check(ok, f"K6 at the wide runs' shape (nq={WIDE_TWIN}, n_probe=8, d={d}; "
              f"{k6_launch(d, max_len)}): equal rows and holes, distances within {RTOL:g}*(terms); "
              f"max |err| {err:.3e}")
    results["wide_k6"] = [dict(k6_entry(torch, xq_dev, idx.layout.vectors, starts, lens, max_len,
                                        budget, err), launch=k6_launch(d, max_len))]
    del starts, lens
    results["wide_k5"] = [k5_kpanel_entry(torch, check, idx, xq_dev, WIDE_TWIN, 8)]
    for name in ("wide_k4", "wide_k6", "wide_k5"):
        for r in results[name]:
            log(f"  {name}: kernel {r['ms']:.4f} ms (graph replay), plain {r['plain_ms']:.3f} ms, "
                f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}), {r['bound_ms'] / r['ms']:.3f} of "
                f"the bound ({r['shape']}; {r['launch']}; {gpu})")

    # K2 bf16 and int8 (the offload's table, built on the card) at 'auto''s
    # K2 shapes; nq 256 is the stream program's tile.
    tb8 = idx._stream_table(torch.int8)
    results["wide_k2"] = [
        k2_wide_entry(torch, check, xq_all[:nq], table, c, c_sq, lengths, p,
                      route_of(resolve(idx, nq, p, k=k), k))
        for table in (tb, tb8) for p in WIDE_K2_N_PROBES for nq in WIDE_K2_NQ]
    log_k2_entries(results["wide_k2"], gpu)
    del tb8

    if twins:
        # The CPU twin: the same tables, the plain versions.
        t0 = time.perf_counter()
        tw = cpu_twin(torch, idx)
        log(f"  CPU twin (tables copied): {time.perf_counter() - t0:.2f}s")
        for method, nq, n_probe, route in runs:
            t0 = time.perf_counter()
            twin_check(np, check, f"wide {method} nq={nq} n_probe={n_probe} ({route})",
                       card[(method, nq, n_probe)], wide_search(torch, tw, method, nq, n_probe, xq),
                       scale)
            log(f"  twin of {method} nq={nq} n_probe={n_probe}: {time.perf_counter() - t0:.2f}s")
        del tw

        # Offloaded, with the device re-rank: 'auto' over the int8 table (the
        # counts are read around each search alone).
        t0 = time.perf_counter()
        idx.offload_main_table(rerank="device")
        gc_collect(torch)
        log(f"  offload_main_table(rerank='device'): {time.perf_counter() - t0:.2f}s")
        off = {}
        for n_probe in sorted({8, p4}):
            before = kb.launch_counts()
            D, I = idx.search_batch(xq, k, n_probe)
            torch.cuda.synchronize()
            ran = {name: c - before[name] for name, c in kb.launch_counts().items()
                   if name in WIDE_OFFLOAD_KERNELS and c > before[name]}
            for name, c in ran.items():
                counts[name] += c
            off[n_probe] = (D, I, ran)
            log(f"  offload (device re-rank) n_probe={n_probe}: launched {ran}")
            check(D.shape == (WIDE_TWIN, k) and bool(np.isfinite(D).all()),
                  f"wide offload (device re-rank) n_probe={n_probe}: finite ({WIDE_TWIN}, {k})")
        for name in WIDE_OFFLOAD_KERNELS:
            check(counts[name] > 0,
                  f"{name} launched in phase 11's offloaded runs ({counts[name]}x)")
        tw = cpu_twin(torch, idx)
        for n_probe, (D, I, ran) in off.items():
            t1 = time.perf_counter()
            twin_check(np, check, f"wide offload (device re-rank) n_probe={n_probe} "
                                  f"({', '.join(ran)})", (D, I), tw.search_batch(xq, k, n_probe),
                       scale)
            log(f"  twin of the offloaded n_probe={n_probe}: {time.perf_counter() - t1:.2f}s")
        del tw
    del idx, tb, xq_all, c, c_sq
    gc_collect(torch)
    log(f"  phase 11 at d {d}: {time.perf_counter() - t_ph:.2f}s")
    for name, n_l in wide_1536(torch, np, check, dev, results, twins, gpu).items():
        counts[name] += n_l
    log(f"  launch counts in phase 11{'' if twins else ' (no CPU twins)'}: {counts}; phase 11 "
        f"{time.perf_counter() - t_ph:.2f}s")
    return counts


def wide_1536(torch, np, check, dev, results, twins: bool, gpu: str) -> dict:
    """Phase 11's second corpus: W1536_N x W1536_D drawn on the card (seed
    W1536_SEED; f32 1.6 GB, its bf16 table ~0.8 GB, far past L2), built with
    Lloyd at WIDE_ITERS iterations (K1), served by 'auto' at W1536_NQ x
    WIDE_K2_N_PROBES (routes logged: K2 at nq 1 / 16, the dense program at
    nq 1000) and held to a CPU twin of WIDE_TWIN queries (``twins``; the
    nq-1000 runs by their first WIDE_TWIN rows, searched with the method
    'auto' resolved to); K2 timed at those shapes (nq 1000: its 256-query
    tile), into results["wide_k2"]. Returns the launch counts of the build
    and the searches."""
    from vector_indexer_tpu_torch.index.dispatch import resolve
    from vector_indexer_tpu_torch.index.ivf import IvfIndex
    from vector_indexer_tpu_torch.kernels import build as kb
    from vector_indexer_tpu_torch.storage.vector_store import VectorStore

    t_ph = time.perf_counter()
    k, n, d = K, W1536_N, W1536_D
    before = kb.launch_counts()
    xb_dev, xq_all = clustered_on_card(torch, n, d, WIDE_QUERIES, W1536_SEED, dev)
    xb = xb_dev.cpu().numpy()
    del xb_dev
    idx = IvfIndex.fit(VectorStore(external_ids=np.arange(n, dtype=np.uint64), vectors=xb),
                       seed=42, max_iters=WIDE_ITERS, device=dev)
    torch.cuda.synchronize()
    log(f"  corpus {n} x {d} f32 ({xb.nbytes / 1e9:.2f} GB, seed {W1536_SEED}) drawn and built "
        f"(Lloyd {WIDE_ITERS} iterations, K1): {time.perf_counter() - t_ph:.2f}s; nlist "
        f"{idx.num_clusters}, max list {idx.layout.max_list_len}")
    xq = xq_all[:WIDE_TWIN].cpu().numpy()
    scale = np.sum(xq * xq, axis=1) + float(np.max(np.sum(xb * xb, axis=1)))
    del xb
    runs = [(nq, p, resolve(idx, nq, p, k=k)) for nq in W1536_NQ for p in WIDE_K2_N_PROBES]
    log(f"  auto routes at d {d}: " + ", ".join(
        f"nq={nq} n_probe={p}: {route_of(dec, k)} ({dec.method})" for nq, p, dec in runs))
    card = {}
    for nq, p, dec in runs:
        qs = xq_all[:max(nq, WIDE_TWIN)] if nq > 1 else xq_all[:WIDE_TWIN]
        wide_search(torch, idx, "auto", nq, p, qs)  # warm-up: builds the tables
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        D, R = wide_search(torch, idx, "auto", nq, p, qs)
        ms = (time.perf_counter() - t0) * 1e3
        card[(nq, p)] = (D[:WIDE_TWIN], R[:WIDE_TWIN])
        log(f"  auto nq={nq} n_probe={p} ({route_of(dec, k)}) at d {d}: {ms:.2f} ms for "
            f"{len(qs)} queries (host clock{', one call per query' if nq == 1 else ''})")
        check(D.shape == (len(qs), k) and bool(np.isfinite(D).all()),
              f"wide d={d} auto nq={nq} n_probe={p} ({route_of(dec, k)}): finite ({len(qs)}, {k})")
    torch.cuda.synchronize()
    counts = {name: c - before[name] for name, c in kb.launch_counts().items()}
    for name in ("assign_argmin", "stream_distances[bf16]"):
        check(counts[name] > 0, f"{name} launched in the d {d} build and runs ({counts[name]}x)")

    c, c_sq = idx._device_tables()
    tb = idx._stream_table()
    entries = [k2_wide_entry(torch, check, xq_all[:min(nq, 256)], tb, c, c_sq,
                             idx.layout.lengths, p, route_of(dec, k)) for nq, p, dec in runs]
    log_k2_entries(entries, gpu)
    results["wide_k2"] += entries
    del tb, c, c_sq
    if twins:
        t0 = time.perf_counter()
        tw = cpu_twin(torch, idx)
        for nq, p, dec in runs:
            method = "auto" if nq <= WIDE_TWIN else dec.method
            twin_check(np, check, f"wide d={d} auto nq={nq} n_probe={p} ({route_of(dec, k)}; twin: "
                                  f"{method} at nq {min(nq, WIDE_TWIN)})", card[(nq, p)],
                       wide_search(torch, tw, method, min(nq, WIDE_TWIN), p, xq), scale)
        log(f"  twins at d {d}: {time.perf_counter() - t0:.2f}s")
        del tw
    del idx, xq_all
    gc_collect(torch)
    log(f"  d {d} corpus: {time.perf_counter() - t_ph:.2f}s")
    return counts


def gc_collect(torch):
    import gc

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()



def main() -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernels-only", action="store_true", help="stop after phase 3")
    ap.add_argument("--wide-only", action="store_true",
                    help="run phase 11 alone (its kernel checks, corpus, build, searches and "
                         "kernel timings) without the CPU twins and the offloaded runs")
    args = ap.parse_args()
    t_start = time.perf_counter()
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

    if args.wide_only:
        for line in ptxas_lines(info.get("log", ""), PTXAS_KERNELS):
            log(f"  ptxas {line}")
        check_k2_spills(check, info.get("log", ""))
        log("== 11. wide rows (alone, no CPU twins)")
        results = {}
        t0 = time.perf_counter()
        counts = wide_phase(torch, np, check, dev, results, twins=False)
        log(f"  phase 11: {time.perf_counter() - t0:.2f}s")
        for name in ("wide_k2", "wide_k4", "wide_k6", "wide_k5"):
            print(json.dumps({name: results[name]}), flush=True)
        log(f"== {check.n} checks in {time.perf_counter() - t_start:.1f}s")
        if check.failures:
            log(f"FAILED: {len(check.failures)} check(s): {check.failures}")
        return 1 if check.failures else 0

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
    by_phase = {}
    try:
        counts, overlaps, gt, r10 = main_phase(torch, np, xb, xq, check, dev, work, results)
        by_phase["4"] = dict(counts)
        log("== 5. offload and the other stream methods")
        t0 = time.perf_counter()
        by_phase["5"] = offload_phase(torch, np, xb, xq, check, dev, work, overlaps)
        counts.update({name: by_phase["5"][name] for name in OFFLOAD_KERNELS})
        log(f"  phase 5: {time.perf_counter() - t0:.2f}s")
        log("== 6. the exhaustive, int8 and gather methods")
        t0 = time.perf_counter()
        by_phase["6"] = flat_gather_phase(torch, np, xb, xq, check, dev, work, gt)
        counts.update({name: by_phase["6"][name] for name in PHASE6_KERNELS})
        log(f"  phase 6: {time.perf_counter() - t0:.2f}s")
        log("== 7. a spilled (SOAR) index")
        t0 = time.perf_counter()
        by_phase["7"] = spill_phase(torch, np, xb, xq, check, dev, work / "spill",
                                    dict(gt=gt, r10=r10, overlap=overlaps))
        log(f"  phase 7: {time.perf_counter() - t0:.2f}s")
        log("== 8. the host-resident build and staged serving")
        t0 = time.perf_counter()
        by_phase["8"] = host_phase(torch, np, xb, xq, check, dev, work / "host",
                                   work / "spill", gt)
        log(f"  phase 8: {time.perf_counter() - t0:.2f}s")
        log("== 9. the mini-batch and balanced trainers, the mesh (data-parallel Lloyd, "
            "sharded, 2-D and multi-host search)")
        t0 = time.perf_counter()
        by_phase["9"] = parallel_phase(torch, np, xb, xq, check, dev, work, work / "spill", gt)
        log(f"  phase 9: {time.perf_counter() - t0:.2f}s")
        log("== 10. the surface: native shard I/O, selective reads, staged queries, the "
            "device profiler, the demo")
        t0 = time.perf_counter()
        by_phase["10"] = surface_phase(torch, np, xb, xq, check, dev, work)
        log(f"  phase 10: {time.perf_counter() - t0:.2f}s")
        log("== 11. wide rows: the kernels at d 16,384-65,536, a 100,000 x 16,384 index")
        t0 = time.perf_counter()
        by_phase["11"] = wide_phase(torch, np, check, dev, results)
        log(f"  phase 11: {time.perf_counter() - t0:.2f}s")
    finally:
        shutil.rmtree(work, ignore_errors=True)

    counts["flat_sweep_minreduce"] = results["flat_sweep_minreduce"]["launches"]  # phase 3
    wide = {"stream_fused_plane[bf16]": results["wide_k4"],
            "ivf_gather_distances": results["wide_k6"],
            "stream_shared_plane[f32]": results["wide_k5"],
            **{f"stream_distances[{m}]": [e for e in results["wide_k2"] if e["table"] == m]
               for m in ("bf16", "int8")}}
    wide_keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "per_query_bound_ms",
                 "sharing", "launch", "route", "shape")
    kernels = [
        dict(name=name, route="cuda", source=src, replaces=rep, launches=counts[name],
             launches_by_phase={p: c.get(name, 0) for p, c in by_phase.items()},
             **{key: results[name][key] for key in (
                 "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                 "library_call", "shape")},
             **({"wide_rows": [{key: e[key] for key in wide_keys if key in e}
                               for e in wide[name]]} if name in wide else {}))
        for name, (src, rep) in SOURCES.items()
    ]
    log(f"== {check.n} checks in {time.perf_counter() - t_start:.1f}s")
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
