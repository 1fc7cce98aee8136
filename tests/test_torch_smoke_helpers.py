"""chip_smoke.py's bookkeeping, checked on the CPU: the kernels' bounds
(bytes over the memory rate or operations over the peak of their type, as
this run's data needs them) and the nvcc register / spill report."""

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
