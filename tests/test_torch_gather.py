"""The gather slice vs the JAX reference: packed candidate rows and budgets,
K6 (``ivf_gather_distances``, reference in interpret mode) slot by slot,
and the exact packed-gather and range-gather programs on the same index."""

import jax.numpy as jnp
import numpy as np
import pytest
from torch_parity import CPU, reference_arrays, reference_search, set_overlap, t

from benchmarks.datasets import clustered
from vector_indexer_tpu.index import dispatch as jd
from vector_indexer_tpu.index.ivf import IvfIndex as JaxIndex
from vector_indexer_tpu.ops import gather as jg
from vector_indexer_tpu.ops.pallas import ivf_gather as jig
from vector_indexer_tpu.storage import VectorStore
from vector_indexer_tpu_torch.convert import index_from_reference_arrays
from vector_indexer_tpu_torch.index.dispatch import resolve
from vector_indexer_tpu_torch.kernels import build as kb
from vector_indexer_tpu_torch.ops import gather as tg
from vector_indexer_tpu_torch.ops import ivf_gather as tig

N, D, NQ, NLIST, K = 8192, 128, 16, 64, 10


def _lists(seed, nq, p, n_lists=40, max_len=300, zero_every=5):
    """Random (starts, lengths) of nq queries x p probes over lists laid out
    head to tail, with some empty lists."""
    g = np.random.default_rng(seed)
    lens = g.integers(1, max_len + 1, n_lists)
    lens[::zero_every] = 0
    starts = np.concatenate([[0], np.cumsum(-(-lens // 8) * 8)[:-1]])
    probe = np.stack([g.permutation(n_lists)[:p] for _ in range(nq)])
    return starts[probe].astype(np.int32), lens[probe].astype(np.int32), int(starts[-1] + lens[-1])


@pytest.mark.parametrize("seed,p,budget", [(0, 4, 2048), (1, 12, 640), (2, 1, 128), (3, 30, 16384)])
def test_packed_candidate_rows_match(seed, p, budget):
    """Equal rows and validity, including budgets that truncate the probes."""
    starts, lens, _ = _lists(seed, 9, p)
    rows, valid = tg.packed_candidate_rows(t(starts), t(lens), budget, pad_row=123_456)
    rrows, rvalid = jg.packed_candidate_rows(jnp.asarray(starts), jnp.asarray(lens), budget, 123_456)
    np.testing.assert_array_equal(rows.numpy(), np.asarray(rrows))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(rvalid))


def test_candidate_budget_matches():
    g = np.random.default_rng(4)
    for lens in (g.integers(1, 400, 300), np.maximum(1, g.lognormal(5, 1.2, 500).astype(int)),
                 np.array([1]), np.full(64, 128)):
        for n_probe in (1, 2, 3, 8, 32, 1000):
            assert tg.candidate_budget(lens, n_probe) == jg.candidate_budget(lens, n_probe)


def _k6_case(seed, nq, p, d, max_len):
    starts, lens, used = _lists(seed, nq, p, max_len=max_len)
    g = np.random.default_rng(seed + 100)
    mlp = tig.max_len_pad(max_len)
    vectors = np.zeros((used + mlp + 8, d), np.float32)  # the reference's tail pad
    vectors[:used] = g.normal(0, 2, (used, d)).astype(np.float32)
    queries = g.normal(0, 2, (nq, d)).astype(np.float32)
    return queries, vectors, starts, lens


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("seed,nq,p,d,max_len,budget", [
    (0, 3, 3, 16, 300, None),     # short lists
    (1, 4, 8, 128, 700, None),    # max_len > 512: two reference DMA chunks per probe
    (2, 2, 6, 32, 200, 256),      # budget below the probed sum: slots clamp
])
def test_k6_matches_reference_kernel(metric, seed, nq, p, d, max_len, budget):
    """Slot by slot: the same rows (and holes) everywhere; distances within
    1e-5 of |q|^2 + |x|^2 (l2) or |q||x| (ip), the terms' scale, where the
    two f32 sums differ only in order."""
    q, x, starts, lens = _k6_case(seed, nq, p, d, max_len)
    budget = budget or jg.candidate_budget(lens.ravel(), p)
    kb.reset_launch_counts()
    dist, rows = tig.ivf_gather_distances(t(q), t(x), t(starts), t(lens), max_len=max_len,
                                          budget=budget, metric=metric)
    assert kb.launch_counts()["ivf_gather_distances"] == 0  # CPU: plain version
    rdist, rrows = (np.asarray(a) for a in jig.ivf_gather_distances(
        jnp.asarray(q), jnp.asarray(x), jnp.asarray(starts), jnp.asarray(lens),
        max_len=max_len, budget=budget, metric=metric, interpret=True))
    dist, rows = dist.numpy(), rows.numpy()
    assert dist.shape == rdist.shape == (nq, tig.output_width(p, max_len, budget))
    np.testing.assert_array_equal(rows, rrows)
    fin = rrows >= 0
    np.testing.assert_array_equal(np.isinf(dist), ~fin)
    xr = x[np.maximum(rows, 0)]
    if metric == "l2":
        scale = np.sum(q * q, 1)[:, None] + np.sum(xr * xr, -1)
    else:
        scale = np.linalg.norm(q, axis=1)[:, None] * np.linalg.norm(xr, axis=-1)
    assert np.all(np.abs(dist[fin] - rdist[fin]) <= 1e-5 * scale[fin] + 1e-6)


def test_k6_zero_lengths():
    q = np.random.default_rng(5).normal(size=(1, 8)).astype(np.float32)
    x = np.zeros((64, 8), np.float32)
    z = np.zeros((1, 4), np.int32)
    dist, rows = tig.ivf_gather_distances(t(q), t(x), t(z), t(z), max_len=16, budget=32)
    rdist, rrows = jig.ivf_gather_distances(jnp.asarray(q), jnp.asarray(x), jnp.asarray(z),
                                            jnp.asarray(z), max_len=16, budget=32, interpret=True)
    np.testing.assert_array_equal(dist.numpy(), np.asarray(rdist))
    np.testing.assert_array_equal(rows.numpy(), np.asarray(rrows))
    assert np.isinf(dist.numpy()).all() and (rows.numpy() == -1).all()


def test_k6_output_width_matches_reference():
    for max_len in (1, 7, 8, 100, 512, 513, 700, 1500):
        for p, budget in ((1, 128), (8, 4096), (32, 20_480)):
            want = jig._round_up(budget + p * 128 + jig._round_up(
                max(max_len, 8), jig._chunk_for(max_len)), 128)
            assert tig.output_width(p, max_len, budget) == want
            assert tig._chunk_for(max_len) == jig._chunk_for(max_len)


@pytest.fixture(scope="module")
def pair():
    xb, xq = clustered(N, D, NQ, seed=11, ncent=40)
    store = VectorStore(external_ids=np.arange(N, dtype=np.uint64), vectors=xb)
    ref = JaxIndex.fit(store, seed=42, nlist=NLIST)
    return ref, index_from_reference_arrays(reference_arrays(ref), device=CPU), xq


@pytest.mark.parametrize("method", ["gather", "gather_dma"])
@pytest.mark.parametrize("n_probe", [2, 6])
def test_gather_programs_match(pair, method, n_probe):
    """The port's program (resolved through its dispatch) and the
    reference's, called directly on the same state: equal sets; distances
    within 2e-6 of |q|^2 + max|x|^2 (f32 expansions summed in other
    orders)."""
    ref, ours, xq = pair
    dec = resolve(ours, NQ, n_probe, k=K, method=method)
    assert (dec.program, dec.budget) == (method, ref._budget_for(n_probe))
    kb.reset_launch_counts()
    D_, R = (a.numpy() for a in ours.search_batch_device(xq, K, n_probe, method=method))
    rD, rR = reference_search(ref, dec.program, xq, K, n_probe)
    assert set_overlap(R, rR).min() == 1.0
    terms = np.sum(xq * xq, 1)[:, None] + np.asarray(ref.layout.row_norms)[: ref.layout.rows_used].max()
    assert np.all(np.abs(D_ - rD) <= 2e-6 * terms)


def test_gather_dma_past_the_reference_gates():
    """Where the reference's gather_dma falls back to 'gather' (here its
    12 MB VMEM scratch gate: p x max_len_pad x d x 4 B), the port still
    runs K6, and both return the sets of the reference's 'gather'
    program. Wide rows and few long lists open the gate at a small n_probe."""
    d, nlist = 256, 16
    xb, xq = clustered(N, d, NQ, seed=12, ncent=64)
    store = VectorStore(external_ids=np.arange(N, dtype=np.uint64), vectors=xb)
    ref = JaxIndex.fit(store, seed=42, nlist=nlist)
    ours = index_from_reference_arrays(reference_arrays(ref), device=CPU)
    lay = ref.layout
    n_probe = next(p for p in range(1, nlist + 1)
                   if jig.scratch_bytes(p, max(1, lay.max_list_len), d) > jig.VMEM_SCRATCH_CAP)
    assert jd.resolve(ref, NQ, n_probe, k=K, method="gather_dma").program == "gather"
    assert resolve(ours, NQ, n_probe, k=K, method="gather_dma").program == "gather_dma"
    kb.reset_launch_counts()
    D_, R = (a.numpy() for a in ours.search_batch_device(xq, K, n_probe, method="gather_dma"))
    rD, rI = ref.search_batch(xq, K, n_probe, method="gather_dma")
    assert set_overlap(ours.rows_to_internal(R), rI).min() == 1.0
    terms = np.sum(xq * xq, 1)[:, None] + np.asarray(lay.row_norms)[: lay.rows_used].max()
    assert np.all(np.abs(D_ - rD) <= 2e-6 * terms)
