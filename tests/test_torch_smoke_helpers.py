"""chip_smoke.py's bookkeeping, checked on the CPU: the kernels' bounds
(bytes over the memory rate or operations over the peak of their type, as
this run's data needs them) and the nvcc register / spill report."""

import numpy as np
import pytest
import torch

import chip_smoke as cs


def test_bound_takes_the_larger_of_bytes_and_operations():
    b = cs.bound(3.35e9, 0.0, cs.F32_FLOP_S)
    assert b == dict(bound_ms=pytest.approx(1.0), bound_by="bytes")
    b = cs.bound(0.0, 67e9, cs.F32_FLOP_S)
    assert b == dict(bound_ms=pytest.approx(1.0), bound_by="operations")


def test_sweep_bound_counts_only_the_probed_pairs():
    q = torch.zeros((4, 128))
    n_rows = 8 * 100
    mask = torch.zeros((4, 100), dtype=torch.bool)
    mask[0, :10] = True
    mask[1, 5:15] = True  # rows of blocks 0-14 probed, 20 (query, block) pairs
    dense = cs.sweep_bound(q, n_rows, None, "highest", 0)
    sparse = cs.sweep_bound(q, n_rows, mask, "highest", 0)
    pairs_ops = 2.0 * 20 * 8 * 128
    bytes_ = 15 * 8 * (4 * 128 + 4) + mask.numel() + q.numel() * 4
    # f32 is three TF32 products on the tensor cores (3xTF32).
    assert sparse["bound_ms"] == pytest.approx(max(bytes_ / cs.HBM_BYTES_S,
                                                   3 * pairs_ops / cs.TF32_FLOP_S) * 1e3)
    big = torch.zeros((1000, 128))
    assert cs.sweep_bound(big, 10**6, None, "highest", 0) == dict(
        bound_ms=pytest.approx(3 * 2.0 * 1000 * 10**6 * 128 / cs.TF32_FLOP_S * 1e3),
        bound_by="operations")
    assert dense["bound_ms"] > sparse["bound_ms"]
    # 'int8' runs three s8 products on the tensor cores, 'int8x1' one.
    i8 = cs.sweep_bound(q, n_rows, None, "int8", 0)
    i8x1 = cs.sweep_bound(q, n_rows, None, "int8x1", 0)
    assert i8["bound_ms"] >= i8x1["bound_ms"]


def test_ptxas_report_names_each_instantiation():
    log = "\n".join([
        "ptxas info    : Compiling entry function '_ZN2k17flat_sweep_kernelILb1ELb0ELi2ELb1EEEv14CUtensorMap_st' for 'sm_90a'",
        "ptxas info    : Function properties for _ZN2k17flat_sweep_kernelILb1ELb0ELi2ELb1EEEv14CUtensorMap_st",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 162 registers, used 1 barriers",
        "ptxas info    : Function properties for _ZN2k16assign_argmin_kernelEPKf",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 40 registers, used 1 barriers",
        "ptxas info    : Function properties for _ZN2k25stream_fused_plane_kernelILb0EaLi1ELb1EEEvPKf",
        "    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads",
        "ptxas info    : Used 72 registers, used 2 barriers",
    ])
    lines = cs.ptxas_lines(log)
    assert len(lines) == 2
    assert lines[0].startswith("flat_sweep_kernel<true,false,2,true>: Used 162 registers")
    assert lines[1].startswith("stream_fused_plane_kernel<false,int8,1,true>: Used 72 registers")
    assert "4 bytes spill stores" in lines[1]


@pytest.mark.parametrize("dtype, products", [(torch.bfloat16, 2), (torch.int8, 2),
                                             (torch.float32, 3)])
def test_shared_bound_counts_distinct_blocks_and_tf32_products(dtype, products):
    from types import SimpleNamespace

    chunk, d, t_cap = 256, 128, 6
    table = SimpleNamespace(chunk=chunk, vecs=torch.zeros((10 * chunk, d), dtype=dtype))
    # Four used tasks over blocks 3, 3, 7 and 1; two unused tasks at the end.
    tasks = SimpleNamespace(qc=torch.zeros((t_cap, 8, d)),
                            blk=torch.tensor([3, 3, 7, 1, -1, -1], dtype=torch.int32))
    item = table.vecs.element_size()
    nbytes = 3 * chunk * (d * item + 4) + 4 * 8 * d * 4 + t_cap * 8 * chunk * 4
    ops = products * 2.0 * 4 * 8 * chunk * d
    b = cs.shared_bound(table, tasks)
    assert b["bound_ms"] == pytest.approx(max(nbytes / cs.HBM_BYTES_S, ops / cs.TF32_FLOP_S) * 1e3)
    assert b["bound_by"] == "bytes"  # at d 128 the tensor cores outrun the plane's bytes


def test_trace_kernel_counts_match_launch_counters():
    # A hand-made Chrome trace as torch.profiler writes it: CPU ops, the
    # runtime's launch calls, and device events with demangled names.
    ev = [
        dict(ph="X", cat="cpu_op", name="aten::topk", dur=40.0),
        dict(ph="X", cat="cuda_runtime", name="cudaLaunchKernel", dur=5.0),
        dict(ph="X", cat="kernel", name="void (anonymous namespace)::stream_distances_kernel"
             "<true, __nv_bfloat16, 4>(float const*, float const*, int)", dur=60.0),
        dict(ph="X", cat="Kernel", name="void k::stream_distances_kernel<false, signed char, 1>"
             "(float const*)", dur=40.0),
        dict(ph="X", cat="kernel", name="void k::flat_sweep_kernel<true, true, 0, true>"
             "(CUtensorMap_st, Args)", dur=1000.0),
        dict(ph="X", cat="kernel", name="void k::merge_top2_kernel(float const*, int const*)",
             dur=20.0),
        dict(ph="X", cat="kernel", name="void at::native::sbtopk::gatherTopK<float>()", dur=300.0),
        dict(ph="X", cat="gpu_memcpy", name="Memcpy HtoD (Pinned -> Device)", dur=80.0),
        dict(ph="X", cat="gpu_memset", name="Memset (Device)", dur=0.5),
        dict(ph="f", cat="ac2g", name="ac2g", id=3),
    ]
    trace = {"traceEvents": ev}
    names = ("stream_distances_kernel", "stream_fused_plane_kernel", "flat_sweep_kernel")
    assert cs.trace_kernel_counts(trace, names) == {
        "stream_distances_kernel": 2, "stream_fused_plane_kernel": 0, "flat_sweep_kernel": 1}
    # A name inside a longer identifier does not count.
    assert cs.trace_kernel_counts(trace, ("sweep_kernel", "top2_kernel")) == {
        "sweep_kernel": 0, "top2_kernel": 0}
    assert cs.trace_device_ms(trace) == pytest.approx((60 + 40 + 1000 + 20 + 300 + 80 + 0.5) / 1e3)
    counts = {"stream_distances[bf16]": 1, "stream_distances[int8]": 1,
              "stream_fused_plane[bf16]": 0, "flat_sweep_topk_plane": 1,
              "flat_sweep_topk_plane[int8]": 0, "assign_argmin": 0}
    totals = cs.kernel_launch_totals(counts)
    assert cs.trace_kernel_counts(trace, totals) == totals
    assert totals["stream_distances_kernel"] == 2 and totals["flat_sweep_kernel"] == 1


def test_ptxas_report_names_the_panel_mode():
    """K4's panel mode is NCH = -1, mangled Lin1E."""
    log = "\n".join([
        "ptxas info    : Function properties for _ZN2k25stream_fused_plane_kernelILb1E13__nv_bfloat16Lin1ELb0EEEvPKf",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 56 registers, used 2 barriers",
    ])
    assert cs.ptxas_lines(log)[0].startswith("stream_fused_plane_kernel<true,bf16,-1,false>: Used 56")


def test_twin_check_passes_only_near_tie_swaps_at_the_last_rank():
    """Phase 11's twin check: a query whose sets differ by a swap at rank k
    within 2 RTOL * scale passes; a lost row above the boundary fails."""
    scale = np.full(2, 1e4)
    D = np.array([[1.0, 2.0, 3.0, 4.0], [1.0, 2.0, 3.0, 4.0]])
    R = np.array([[0, 1, 2, 3], [0, 1, 2, 3]])
    tie = R.copy()
    tie[1, 3] = 9  # rank 4 swapped for a row at an equal distance (within 0.2)
    lost = R.copy()
    lost[1] = [0, 1, 3, 9]  # row 2 (distance 3, far above 2 RTOL * scale of 4) lost
    for other, ok in ((tie, True), (lost, False)):
        check = cs.Check()
        Dp = D.copy()
        Dp[1, 3] = 4.1
        cs.twin_check(np, check, "t", (D, R), (Dp, other), scale)
        assert (not check.failures) == ok
