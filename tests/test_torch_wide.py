"""Rows of any width: the launch plans of kernels K2, K4, K5 and K6 (each
CUDA launcher checks the plan its wrapper gives it) fit a block's shared
memory and cover every d up to 65,536 in every row type; and at d 16,384
the port serves the routes its dispatch picks (``auto`` at nq 1 through
K4's stream route, ``gather_dma`` through K6) with the JAX reference's
results (plain versions on the CPU; the reference's Pallas kernels in
interpret mode)."""

import numpy as np
import pytest
from torch_parity import CPU, reference_arrays, reference_search, set_overlap

from benchmarks.datasets import clustered
from vector_indexer_tpu.index import dispatch as jd
from vector_indexer_tpu.index.ivf import IvfIndex as JaxIndex
from vector_indexer_tpu.ops.pallas import ivf_gather as jig
from vector_indexer_tpu.storage import VectorStore
from vector_indexer_tpu_torch.convert import index_from_reference_arrays
from vector_indexer_tpu_torch.index.dispatch import resolve
from vector_indexer_tpu_torch.index.programs import shortlist_k
from vector_indexer_tpu_torch.kernels import build as kb
from vector_indexer_tpu_torch.ops import block_stream as bs
from vector_indexer_tpu_torch.ops import ivf_gather as ig

MAX_D = 65_536
CHUNKS = (256, 512, 1024)


def _widths(mode_of):
    """Every 61st d in 1..MAX_D, MAX_D itself, and every d between two
    sampled widths whose plans differ in mode (so each mode change is
    tested at its exact edge)."""
    ds = sorted(set(range(1, MAX_D + 1, 61)) | {MAX_D})
    out = set(ds)
    for a, b in zip(ds, ds[1:]):
        if mode_of(a) != mode_of(b):
            out.update(range(a, b + 1))
    return sorted(out)


@pytest.mark.parametrize("itemsize", [1, 2, 4], ids=["int8", "bf16", "f32"])
def test_k2_plan_covers_every_width(itemsize):
    """Up to K2_MAX_CHUNKS 16-byte chunks a row, the one-block-per-run plan
    (lanes, slots, shared memory within the opt-in); past them none, and the
    split plan instead, whose shared memory fits two blocks an SM."""
    epc = 16 // itemsize
    for chunk in CHUNKS:
        for d in _widths(lambda d: bs.stream_distances_plan(d, itemsize, 8, chunk) is None):
            width = -(-d // epc) * epc
            for t_fixed in range(1, 9):  # slots per block grouped from 1..8 slots
                plan = bs.stream_distances_plan(d, itemsize, t_fixed, chunk)
                split = bs.stream_distances_split_plan(d, itemsize, chunk, 1, t_fixed, 132)
                if width // epc > bs.K2_MAX_CHUNKS:
                    assert plan is None and split is not None
                    assert split.smem <= bs.SPLIT_SMEM or split.sub_rows == 1
                    continue
                assert split is None
                lpr, spb, smem = plan
                assert lpr in (1, 2, 4, 8, 16, 32) and lpr * 4 >= width // epc
                assert 1 <= spb <= min(bs.K2_SLOTS_PER_BLOCK, t_fixed)
                assert smem == 4 * spb * (width + chunk) <= bs.SMEM_LIMIT


@pytest.mark.parametrize("itemsize", [1, 2], ids=["int8", "bf16"])
def test_k4_plan_covers_every_width(itemsize):
    """In the register modes (d <= 1024), the one-block-per-(query, group)
    plan (1, 2 or 4 chunks a lane, 4 only for bf16; lanes, stages, shared
    memory within the opt-in); past them none, and the split plan at every
    nq instead, whose shared memory fits two blocks an SM."""
    epc = 16 // itemsize
    for chunk in CHUNKS:
        for d in _widths(lambda d: bs.stream_fused_plan(d, itemsize, chunk) is None):
            p = bs.stream_fused_plan(d, itemsize, chunk)
            cpr, row_bytes = -(-d // epc), d * itemsize
            splits = [bs.stream_fused_split_plan(d, itemsize, chunk, nq, 4, 8, 132)
                      for nq in (1, 256, 1000)]
            if d > 1024:
                assert p is None and None not in splits
                assert all(sp.smem <= bs.SPLIT_SMEM or sp.sub_rows == 1 for sp in splits)
                continue
            assert splits == [None] * 3
            assert p.nch in (1, 2) or (p.nch == 4 and itemsize == 2)
            assert p.lpr in (1, 2, 4, 8, 16, 32) and p.lpr * p.nch >= cpr
            assert 1 <= p.sub_rows <= chunk and p.sub_rows % p.row_align == 0
            assert (p.row_align * row_bytes) % 16 == 0 and p.stage_bytes % 128 == 0
            assert p.stage_bytes >= p.sub_rows * row_bytes
            pairs = 16 * chunk + 16 * bs.K4_STAGES  # the four planes' arrays, the barriers
            assert p.smem == bs.K4_STAGES * p.stage_bytes + pairs <= bs.SMEM_LIMIT


@pytest.mark.parametrize("itemsize", [1, 2, 4], ids=["int8", "bf16", "f32"])
def test_k5_plan_covers_every_width(itemsize):
    for chunk in CHUNKS:
        for d in _widths(lambda d: bs.stream_shared_plan(d, itemsize, chunk)[:2]
                         + (bs.stream_shared_plan(d, itemsize, chunk).kpanel < d,)):
            rows, stages, kpanel, smem = bs.stream_shared_plan(d, itemsize, chunk)
            row_bytes = d * itemsize
            assert chunk % rows == 0 and 1 <= stages <= bs.K5_MAX_STAGES and 1 <= kpanel <= d
            if kpanel < d:  # K-panels: 128-byte groups, one item (32 rows) per task
                assert (kpanel * itemsize) % 128 == 0 and rows <= 32
                stride = kpanel * itemsize + (0 if row_bytes % 16 == 0 else 32)
                assert smem == stages * rows * stride + 4 * 16 * 8 * 32
            else:  # whole rows: a stage is a 16-byte multiple
                assert (rows * row_bytes) % 16 == 0 and smem == stages * rows * row_bytes
            assert smem <= bs.K5_RING_BYTES <= bs.SMEM_LIMIT


def test_k6_plan_covers_every_width():
    for d in range(1, MAX_D + 1):
        qres, smem = ig.ivf_gather_plan(d)
        assert qres == d or (qres < d and qres % 32 == 0)
        assert smem == 4 * qres <= 48 * 1024  # no opt-in past 48 KB


# ---------------------------------------------------------------------------
# d 16,384 against the reference
# ---------------------------------------------------------------------------

WD, WN, WLISTS, K = 16_384, 5_000, 40, 100


@pytest.fixture(scope="module")
def wide_pair():
    """A 5,000 x 16,384 corpus in 40 lists of <= 256 rows (one 256-row
    stream block each), so that 'auto' at nq 1 takes the stream program
    and, past 32 probes, K4's route."""
    xb, xq = clustered(WN, WD, 4, seed=5, ncent=WLISTS)
    store = VectorStore(external_ids=np.arange(WN, dtype=np.uint64), vectors=xb)
    ref = JaxIndex.fit(store, seed=42, nlist=WLISTS, max_iters=5)
    ours = index_from_reference_arrays(reference_arrays(ref), device=CPU)
    return xb, xq, ref, ours


def test_auto_nq1_takes_k4_at_d16384(wide_pair):
    """Where the port's resolve sends 'auto' at nq 1 to the stream program
    with K4 engaged, the port returns the reference stream program's sets.
    Tolerance: distances within 1e-5 of each query's largest returned
    distance (the reference's bf16 hi/lo query split leaves ~2^-17
    |q-c||r| in its cross term, as in test_torch_stream)."""
    xb, xq, ref, ours = wide_pair
    n_probe = next(p for p in range(1, WLISTS + 1)
                   if (dec := resolve(ours, 1, p, k=K)).program == "stream"
                   and bs.fused_engages(dec.t_fixed, dec.chunk, shortlist_k(K, dec.t_fixed, dec.chunk)))
    assert resolve(ours, 1, n_probe, k=K, method="auto").method == "stream"
    kb.reset_launch_counts()
    for q in xq[:2]:
        D, R = (a.numpy() for a in ours.search_batch_device(q[None], K, n_probe))
        rD, rR = reference_search(ref, "stream", q[None], K, n_probe)
        assert set_overlap(R, rR).min() == 1.0
        assert np.array_equal(np.isfinite(D), np.isfinite(rD))
        fin = np.isfinite(rD)
        scale = np.max(np.where(fin, np.abs(rD), 0), axis=1, keepdims=True)
        assert np.all(np.abs(D - rD)[fin] <= (1e-5 * (np.abs(rD) + scale))[fin])
    assert sum(kb.launch_counts().values()) == 0  # CPU: plain versions


def test_stream_table_matches_at_d16384(wide_pair):
    """The port's stream table build, in row tiles bounded by bytes (4,096
    rows at this width), equals the reference's: bf16 rows bit for bit,
    norms within 1e-6 relative."""
    import jax.numpy as jnp
    import torch

    _, _, ref, ours = wide_pair
    jt, tt = ref._stream_table(jnp.bfloat16), ours._stream_table()
    assert tt.m_pad == jt.m_pad > 2 * (bs._TILE_BYTES // (4 * WD))
    np.testing.assert_array_equal(tt.vecs.view(torch.int16).numpy(),
                                  np.asarray(jt.vecs).view(np.int16))
    np.testing.assert_allclose(tt.norms.numpy(), np.asarray(jt.norms), rtol=1e-6)


def test_gather_dma_at_d16384_where_the_reference_gathers(wide_pair):
    """At d 16,384 the reference's gather_dma falls back to 'gather' (its 12
    MB VMEM scratch gate); the port runs K6's program and returns the
    reference 'gather' program's sets. Tolerance: distances within 2e-6 of
    |q|^2 + max |x|^2 (f32 summation order over 16,384 terms)."""
    xb, xq, ref, ours = wide_pair
    n_probe = 8
    assert jig.scratch_bytes(n_probe, max(1, ref.layout.max_list_len), WD) > jig.VMEM_SCRATCH_CAP
    assert jd.resolve(ref, len(xq), n_probe, k=K, method="gather_dma").program == "gather"
    assert resolve(ours, len(xq), n_probe, k=K, method="gather_dma").program == "gather_dma"
    D, R = (a.numpy() for a in ours.search_batch_device(xq, K, n_probe, method="gather_dma"))
    rD, rR = reference_search(ref, "gather", xq, K, n_probe)
    assert set_overlap(R, rR).min() == 1.0
    terms = np.sum(xq * xq, 1)[:, None] + float(np.max(np.sum(xb * xb, 1)))
    fin = np.isfinite(rD)
    assert np.array_equal(np.isfinite(D), fin)
    assert np.all(np.abs(D - rD)[fin] <= 2e-6 * terms.repeat(K, 1)[fin])
