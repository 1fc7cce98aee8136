"""K1 (nearest-centroid assignment) on the CPU: a model of the kernel's
3xTF32 arithmetic (csrc/assign.cu) against the exact scores and the plain
version, the wrapper's layout step, the tie rule, and the smoke's K1
bookkeeping. The kernel itself runs only on the card (chip_smoke.py)."""

import numpy as np
import pytest
import torch
from torch_parity import t, tensor_core_cross, tf32_rna

import chip_smoke as cs
from benchmarks.datasets import clustered
from vector_indexer_tpu_torch.ops.assign import assign_argmin, assign_argmin_reference, pad_dim

RTOL = cs.RTOL  # the smoke's K1 tolerance: 1e-5 of |x|^2 + |c|^2


def _corpus(n, k, d, seed):
    """The smoke's K1 inputs, reduced: a clustered corpus and k centroids
    drawn from it with a little noise."""
    x, _ = clustered(n, d, 1, seed=seed, ncent=max(8, n // 1000))
    g = np.random.default_rng(seed)
    c = (x[g.permutation(n)[:k]] + 0.1 * g.normal(size=(k, d))).astype(np.float32)
    return x, c


def _kernel_scores(x, c):
    """K1's scores as the kernel computes them: the cross term from the
    3xTF32 tensor-core model (points as A, centroids as B, partial sums
    promoted every 128 dims), then |c|^2 - 2 acc rounded once to f32."""
    xb, cb = tf32_rna(x), tf32_rna(c)
    xs, csm = tf32_rna(x - xb), tf32_rna(c - cb)
    cross = tensor_core_cross(xb, xs, cb, csm, 128).astype(np.float64)
    c_sq = (c.astype(np.float64) ** 2).sum(1).astype(np.float32)
    return (c_sq.astype(np.float64)[None, :] - 2.0 * cross).astype(np.float32), cross


@pytest.mark.parametrize("seed", [0, 1])
def test_3xtf32_labels_differ_only_at_near_ties(seed):
    x, c = _corpus(20_000, 200, 128, seed)
    f64 = np.float64
    scores, cross = _kernel_scores(x, c)
    labels = np.argmin(scores, axis=1)  # first index among equal minima, as the kernel
    exact = (c.astype(f64) ** 2).sum(1)[None, :] - 2.0 * x.astype(f64) @ c.astype(f64).T
    # The stated bound on the cross term (csrc/assign.cu, flat_sweep.cu).
    mag = np.abs(x).astype(f64) @ np.abs(c).astype(f64).T
    stated = 3 * 2.0**-22 * (1 + 2.0**-10) + 48 * 2.0**-23 + 2.0**-24
    assert (np.abs(cross - x.astype(f64) @ c.astype(f64).T) <= stated * mag).all()
    x_sq = (x.astype(f64) ** 2).sum(1)
    c_sq = (c.astype(f64) ** 2).sum(1)
    rows = np.arange(len(x))
    for other in (np.argmin(exact, axis=1),
                  assign_argmin_reference(t(x), t(c))[0].numpy().astype(np.int64)):
        diff = np.nonzero(labels != other)[0]
        assert len(diff) <= 1e-3 * len(x)
        gap = np.abs(exact[diff, labels[diff]] - exact[diff, other[diff]])
        assert (gap <= RTOL * (x_sq[diff] + c_sq[other[diff]])).all()
    # The kernel's minimum score is within the tolerance of the exact one.
    best = scores[rows, labels].astype(f64)
    assert (np.abs(best - exact.min(1)) <= RTOL * (x_sq + c_sq[labels])).all()


@pytest.mark.parametrize("d", [3, 20, 100, 128])
def test_pad_dim_keeps_the_scores(d):
    g = np.random.default_rng(d)
    x = t(g.normal(size=(50, d)).astype(np.float32))
    c = t(g.normal(size=(7, d)).astype(np.float32))
    xp, cp = pad_dim(x, c)
    assert xp.shape[1] % 4 == 0 and cp.shape[1] == xp.shape[1]
    assert xp.shape[1] - d < 4 and not xp[:, d:].any() and not cp[:, d:].any()
    assert xp.data_ptr() % 16 == 0 and cp.data_ptr() % 16 == 0
    la, da = assign_argmin_reference(x, c)
    lb, db = assign_argmin_reference(xp, cp)
    assert torch.equal(la, lb)
    torch.testing.assert_close(da, db, rtol=1e-6, atol=1e-5)


def test_duplicated_centroids_give_the_lower_id():
    g = np.random.default_rng(5)
    c = g.normal(size=(9, 16)).astype(np.float32)
    c[1::2] = c[0::2][:4]  # centroid 2i + 1 repeats centroid 2i
    x = (c[g.integers(0, 9, 300)] + 0.05 * g.normal(size=(300, 16))).astype(np.float32)
    labels, _ = assign_argmin(t(x), t(c))
    assert (labels.numpy() % 2 == 0).all()
    scores, _ = _kernel_scores(x, c)  # the model keeps equal columns equal
    assert np.array_equal(scores[:, 1::2], scores[:, 0:8:2])
    assert (np.argmin(scores, axis=1) % 2 == 0).all()


def test_assign_bound_is_three_tf32_products():
    b = cs.assign_bound(65_536, 4000, 128)
    assert b["bound_by"] == "operations"
    assert b["bound_ms"] == pytest.approx(3 * 2.0 * 65_536 * 4000 * 128 / cs.TF32_FLOP_S * 1e3)
    assert b["bound_ms"] == pytest.approx(0.4067, abs=1e-4)
    assert cs.assign_bound(1_000_000, 4000, 128)["bound_ms"] == pytest.approx(6.206, abs=1e-3)
    # Few centroids: the bytes of x bound it.
    assert cs.assign_bound(10**6, 1, 128)["bound_by"] == "bytes"


def test_ptxas_report_names_k1_and_k2_instantiations():
    log = "\n".join([
        "ptxas info    : Function properties for _ZN12_GLOBAL__N_120assign_argmin_kernelILb0EEEv14CUtensorMap_st",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 168 registers, used 16 barriers",
        "ptxas info    : Function properties for _ZN12_GLOBAL__N_123stream_distances_kernelILb1EfLi4ELb1EEEvPKf",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 72 registers, used 1 barriers",
        "ptxas info    : Function properties for _ZN12_GLOBAL__N_123stream_distances_kernelILb0EaLi0ELb0EEEvPKf",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 40 registers, used 1 barriers",
    ])
    lines = cs.ptxas_lines(log, cs.PTXAS_KERNELS)
    assert [ln.split(":")[0] for ln in lines] == [
        "assign_argmin_kernel<false>", "stream_distances_kernel<true,f32,4,true>",
        "stream_distances_kernel<false,int8,0,false>"]
