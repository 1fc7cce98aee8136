"""K1 (nearest-centroid assignment): the port's plain version vs the
reference kernel in interpret mode, and the wrapper's CPU routing."""

import numpy as np
import pytest
import torch
from torch_parity import near_tie_ok, t

from vector_indexer_tpu.ops.pallas.assign import assign_argmin_pallas
from vector_indexer_tpu_torch.kernels import build as kb
from vector_indexer_tpu_torch.ops.assign import assign_argmin, assign_argmin_reference


def _inputs(n, k, d, seed):
    g = np.random.default_rng(seed)
    c = g.normal(0, 4, (k, d)).astype(np.float32)
    x = (c[g.integers(0, k, n)] + g.normal(0, 1, (n, d))).astype(np.float32)
    return x, c


@pytest.mark.parametrize("d", [64, 128])
def test_assign_matches_reference_kernel(d):
    # k = 600 spans two of the reference kernel's 512-wide centroid tiles.
    x, c = _inputs(1000, 600, d, seed=d)
    labels, dists = assign_argmin(t(x), t(c))
    rl, rd = assign_argmin_pallas(x, c, interpret=True)
    rl, rd = np.asarray(rl), np.asarray(rd)
    labels = labels.numpy()
    c_sq = np.sum(c.astype(np.float64) ** 2, 1)

    def score(i, j):  # the ranked score |c|^2 - 2 x.c, in f64
        return c_sq[j] - 2.0 * float(x[i].astype(np.float64) @ c[j])

    assert near_tie_ok(labels, rl, score, rel=1e-5) <= 2
    np.testing.assert_allclose(dists.numpy(), rd, rtol=1e-5, atol=1e-4)


def test_assign_lowest_index_wins_ties():
    c = np.zeros((5, 8), np.float32)
    c[3] = 1.0
    x = np.full((4, 8), 0.25, np.float32)
    labels, _ = assign_argmin(t(x), t(c))
    rl, _ = assign_argmin_pallas(x, c, interpret=True)
    np.testing.assert_array_equal(labels.numpy(), np.zeros(4))
    np.testing.assert_array_equal(np.asarray(rl), np.zeros(4))


def test_assign_exact_hits_and_clamp():
    x, c = _inputs(64, 16, 32, seed=3)
    labels, dists = assign_argmin(t(c), t(c))
    np.testing.assert_array_equal(labels.numpy(), np.arange(16))
    assert (dists.numpy() >= 0).all() and dists.numpy().max() < 1e-3


def test_cpu_wrapper_takes_plain_version_without_counting():
    x, c = _inputs(100, 20, 16, seed=4)
    kb.reset_launch_counts()
    a = assign_argmin(t(x), t(c))
    b = assign_argmin_reference(t(x), t(c))
    assert kb.launch_counts()["assign_argmin"] == 0
    torch.testing.assert_close(a[0], b[0])
    torch.testing.assert_close(a[1], b[1])


def test_assign_rejects_bad_input():
    with pytest.raises(TypeError):
        assign_argmin(torch.zeros(4, 3, dtype=torch.float64), torch.zeros(2, 3))
    with pytest.raises(ValueError):
        assign_argmin(torch.zeros(4, 3), torch.zeros(2, 5))
