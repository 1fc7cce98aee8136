"""K2 past its one-block-per-run rows (more than 128 16-byte chunks: bf16 d
> 1024, int8 > 2048, f32 > 512): the split launch's plan for every width,
the parts it cuts each query's valid rows into, the split rule written as
a plain function (``stream_distances_split_reference``: partial dots per
d-slice summed in slice order) held to K2's plain version, and ``auto``
through K2's route on a 1,536-wide index held to the JAX reference's stream
program (Pallas in interpret mode)."""

import numpy as np
import pytest
import torch
from test_torch_wide import CHUNKS, _widths
from torch_parity import CPU, reference_arrays, reference_search, set_overlap

from benchmarks.datasets import clustered
from vector_indexer_tpu.index.ivf import IvfIndex as JaxIndex
from vector_indexer_tpu.storage import VectorStore
from vector_indexer_tpu_torch.convert import index_from_reference_arrays
from vector_indexer_tpu_torch.index.dispatch import resolve
from vector_indexer_tpu_torch.index.programs import shortlist_k
from vector_indexer_tpu_torch.kernels import build as kb
from vector_indexer_tpu_torch.ops import block_stream as bs

N_SM = 132  # the H100's SMs
NQS = (1, 2, 16, 64, 256)  # 256: the stream program's query tile
T_FIXED = (16, 64, 256)
RTOL = 1e-5  # K2's tolerance: of the magnitude of the terms a distance is summed from


def _mode(itemsize, chunk):
    def mode_of(d):
        p = bs.stream_distances_split_plan(d, itemsize, chunk, 1, 16, N_SM)
        return None if p is None else (-(-d * itemsize // bs.SPLIT_SLICE_BYTES), p.n_slices)
    return mode_of


@pytest.mark.parametrize("itemsize", [1, 2, 4], ids=["int8", "bf16", "f32"])
def test_k2_split_plan_covers_every_width(itemsize):
    """For every d to 65,536 (every 61st and every d around a change of
    mode or slice count), chunks 256 / 512 / 1024, nq 1-256, t_fixed 16-256
    on 132 SMs: none where the one-block-per-run launch stays (at most 128
    16-byte chunks a row); elsewhere a plan the launcher takes: slices of
    whole 16-byte chunks covering d, parts of the rows, stages holding
    their segments, shared memory within the opt-in and, past one segment a
    stage, within two blocks an SM, at least two blocks an SM, and about
    one block per K2_LANE_BYTES of slot lanes."""
    epc = 16 // itemsize
    for chunk in CHUNKS:
        for d in _widths(_mode(itemsize, chunk)):
            narrow = bs.stream_distances_plan(d, itemsize, 16, chunk) is not None
            assert narrow == (-(-d // epc) <= bs.K2_MAX_CHUNKS)
            for nq in NQS:
                for t_fixed in T_FIXED:
                    p = bs.stream_distances_split_plan(d, itemsize, chunk, nq, t_fixed, N_SM)
                    if narrow:
                        assert p is None, (d, chunk, nq, t_fixed)
                        continue
                    assert p.slice >= epc and p.slice % epc == 0
                    assert p.n_slices == -(-d // p.slice) and (p.n_slices - 1) * p.slice < d
                    assert 1 <= p.parts <= t_fixed * chunk // bs.K2_PART_ROWS
                    stride = p.slice * itemsize + (0 if (d * itemsize) % 16 == 0 else 32)
                    assert 1 <= p.sub_rows <= chunk and p.stage_bytes % 128 == 0
                    assert p.stage_bytes >= p.sub_rows * stride
                    assert p.smem == bs.SPLIT_STAGES * p.stage_bytes + 16 * bs.SPLIT_STAGES \
                        + 8 * p.slice <= bs.SMEM_LIMIT
                    if p.sub_rows > 1:
                        assert p.smem <= bs.SPLIT_SMEM
                    assert p.blocks == nq * p.parts * p.n_slices >= 2 * N_SM, (d, nq, t_fixed, p)
                    # About one block per K2_LANE_BYTES of the batch's lanes, within
                    # [one resident wave, SPLIT_BLOCKS_PER_SM an SM]; more only by
                    # rounding up to whole parts and slices.
                    lanes = nq * t_fixed * chunk * d * itemsize
                    target = min(bs.SPLIT_BLOCKS_PER_SM * N_SM,
                                 max(2 * N_SM, lanes // bs.K2_LANE_BYTES))
                    assert p.parts == t_fixed * chunk // bs.K2_PART_ROWS or \
                        nq * (p.parts - 1) * p.n_slices < max(target, 2 * N_SM)
    # The main path's width keeps its launch at every batch.
    for nq in NQS:
        assert bs.stream_distances_split_plan(128, itemsize, 256, nq, 32, N_SM) is None


@pytest.mark.parametrize("t_fixed,chunk", [(16, 256), (64, 256), (16, 1024), (256, 512)])
def test_k2_split_parts_cover_every_row_once(t_fixed, chunk):
    """The parts the kernel cuts a query's valid rows into, at the plan's
    part count and at counts past the rows: every valid (slot, row) lies in
    exactly one part, each part's runs are consecutive and in slot order,
    parts hold ceil(total / parts) rows (the last fewer), and no run
    touches a row past its slot's valid count. With d slices, block (part,
    slice) writes the 4-byte partial of each of its rows once, so every
    scratch cell of a valid row has one writer and no store spans two
    parts; the finish kernel alone writes the distance rows, one lane each.
    Valid counts: empty slots, full slots, and lists shorter than a part."""
    g = np.random.default_rng(t_fixed + chunk)
    plan = bs.stream_distances_split_plan(2048, 2, chunk, 1, t_fixed, N_SM)
    for trial in range(12):
        nvalid = g.integers(0, chunk + 1, t_fixed)
        nvalid[g.random(t_fixed) < 0.3] = 0
        nvalid[g.random(t_fixed) < 0.2] = chunk
        if trial == 0:
            nvalid[:] = 0
        if trial == 1:
            nvalid[:] = 0
            nvalid[t_fixed // 2] = 3  # one short list
        total = int(nvalid.sum())
        for parts in sorted({1, 3, plan.parts, total + 5}):
            cover = [np.zeros(int(n), np.int64) for n in nvalid]
            per = -(-total // parts) if total else 0
            runs_of = bs.split_parts(nvalid, parts)
            assert len(runs_of) == parts
            for p, runs in enumerate(runs_of):
                assert sum(n for _, _, n in runs) == max(0, min(per, total - p * per))
                flat = [(s, r + i) for s, r, n in runs for i in range(n)]
                assert flat == sorted(flat)
                for s, r, n in runs:
                    assert 0 <= r and n > 0 and r + n <= nvalid[s]
                    cover[s][r:r + n] += 1
            assert all((c == 1).all() for c in cover)


def _k2_problem(dtype, metric, d, seed, nq=3, t_fixed=8, chunk=16):
    """A small K2 problem: random rows in ``n_blocks`` blocks of ``chunk``
    rows (int8: integer rows and random per-cluster scales; pad rows with
    the sentinel norm), slots drawing blocks at random, valid counts with
    empty slots, full slots and lists shorter than a part."""
    g = np.random.default_rng(seed)
    n_blocks, kc = 6, 4
    q = g.normal(size=(nq, d)).astype(np.float32)
    cent = g.normal(size=(kc, d)).astype(np.float32)
    rows = g.normal(size=(n_blocks * chunk, d)).astype(np.float32)
    block_cid = np.arange(n_blocks) % kc
    if dtype == torch.int8:
        vecs = torch.as_tensor(np.clip(np.round(40 * rows), -127, 127)).to(torch.int8)
        scales = torch.as_tensor(g.choice([0.01, 0.02, 0.05], kc).astype(np.float32))
        deq = vecs.float() * scales[torch.as_tensor(np.repeat(block_cid, chunk))][:, None]
    else:
        vecs = torch.as_tensor(rows).to(dtype)
        scales, deq = None, vecs.float()
    norms = (deq * deq).sum(1)
    norms[chunk - 2:chunk] = 1e30  # sentinel pad rows at the end of block 0
    blk = g.integers(0, n_blocks, (nq, t_fixed))
    cid = block_cid[blk]
    nval = g.integers(0, chunk + 1, (nq, t_fixed))
    nval[:, 0] = chunk
    nval[:, 1] = 0
    nval[0, 2:] = [1, 2, 0, chunk, 3, chunk][: t_fixed - 2]
    qt, ct, cid_t = torch.as_tensor(q), torch.as_tensor(cent), torch.as_tensor(cid)
    if metric == "l2":
        bias = ((qt[:, None, :] - ct[cid_t]) ** 2).sum(-1)
    else:
        bias = -(qt[:, None, :] * ct[cid_t]).sum(-1)
    args = (qt, ct, cid_t, torch.as_tensor(blk), bias, vecs, norms)
    # Term magnitude of each distance (as chip_smoke.stream_grid bounds it).
    nrm = norms.view(-1, chunk)[torch.as_tensor(blk)]
    if metric == "l2":
        term = bias[:, :, None].abs() + nrm
    else:
        term = bias[:, :, None].abs() + qt.norm(dim=1)[:, None, None] * nrm.sqrt()
    return args, dict(chunk=chunk, metric=metric, scales=scales), torch.as_tensor(nval), term


@pytest.mark.parametrize("d", [1031, 2056])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8, torch.float32],
                         ids=["bf16", "int8", "f32"])
@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("nval", [True, False], ids=["nval2d", "every_lane"])
def test_k2_split_rule_matches_plain_version(d, dtype, metric, nval):
    """The split rule (each part's rows' partial dots slice by slice, summed
    in slice order, then the scale, bias and norm) against K2's plain
    version, at odd widths (1,031: no 16-byte multiple in bf16 / f32; 2,056)
    with the launch's own plan and with slices and parts that cut rows and
    lists unevenly (parts past the rows included): +inf exactly where the
    plain version has it (lanes past nval2d), every row written (no NaN
    from the scratch plane), values within RTOL of the terms' magnitude
    (f32 summation order)."""
    args, kw, nval2d, term = _k2_problem(dtype, metric, d, seed=d)
    nv = nval2d if nval else None
    plain = bs.stream_distances_reference(*args, nval2d=nv, **kw)
    itemsize = torch.empty((), dtype=dtype).element_size()
    p = bs.split_plan(d, itemsize, kw["chunk"], 3, 8, N_SM)
    for slice_, parts in ((p.slice, p.parts), (8 * 17, 3), (d, 1), (64, 500)):
        got = bs.stream_distances_split_reference(*args, nval2d=nv, slice_=slice_, parts=parts,
                                                  **kw)
        assert not torch.isnan(got).any()
        assert torch.equal(torch.isinf(got), torch.isinf(plain))
        fin = torch.isfinite(plain) & (plain.abs() < 1e29)
        assert bool(((got - plain).abs()[fin] <= RTOL * term[fin]).all()), (slice_, parts)
        sentinel = torch.isfinite(plain) & ~fin  # pad rows: the sentinel norm dominates
        assert bool((got[sentinel] >= 1e29).all())


# ---------------------------------------------------------------------------
# auto through K2's route at d 1,536 against the reference
# ---------------------------------------------------------------------------

D_WIDE, N_WIDE, LISTS, K = 1_536, 8_192, 64, 50


@pytest.fixture(scope="module")
def pair_1536():
    """An 8,192 x 1,536 corpus (the width of OpenAI's text-embedding-3-small
    vectors) in 64 lists of ~128 rows, one 256-row stream block each (at
    fewer rows 'auto' at nq 16 takes the dense program at every n_probe)."""
    xb, xq = clustered(N_WIDE, D_WIDE, 16, seed=3, ncent=LISTS)
    store = VectorStore(external_ids=np.arange(N_WIDE, dtype=np.uint64), vectors=xb)
    ref = JaxIndex.fit(store, seed=42, nlist=LISTS, max_iters=5)
    ours = index_from_reference_arrays(reference_arrays(ref), device=CPU)
    return xb, xq, ref, ours


def _k2_n_probe(ours, nq):
    """The largest of n_probe 8 / 4 / 2 that the port's 'auto' sends to the
    stream program with K2 (not K4) at this batch."""
    for p in (8, 4, 2):
        dec = resolve(ours, nq, p, k=K)
        if dec.program == "stream" and not bs.fused_engages(
                dec.t_fixed, dec.chunk, shortlist_k(K, dec.t_fixed, dec.chunk)):
            return p
    raise AssertionError("no n_probe takes K2's route")


@pytest.mark.parametrize("rule", ["plain", "split"])
@pytest.mark.parametrize("nq", [1, 16])
def test_auto_takes_k2_at_d1536(pair_1536, nq, rule, monkeypatch):
    """'auto' at nq 1 and 16 through K2's route (the split launch's rows on
    the card) returns the reference stream program's sets, with K2 as the
    CPU runs it ('plain') and with the split rule at the card's plan for
    this batch ('split'). Tolerance: distances within 1e-5 of each query's
    largest returned distance (the reference's bf16 hi/lo query split
    leaves ~2^-17 |q-c||r| in its cross term, as in test_torch_stream)."""
    xb, xq, ref, ours = pair_1536
    n_probe = _k2_n_probe(ours, nq)
    calls = []
    if rule == "split":
        def split_k2(queries, cent, cid2d, blk2d, bias2d, vecs, norms, **kw):
            calls.append(1)
            p = bs.stream_distances_split_plan(queries.shape[1], vecs.element_size(), kw["chunk"],
                                               queries.shape[0], blk2d.shape[1], N_SM)
            assert p is not None
            return bs.stream_distances_split_reference(
                queries, cent, cid2d, blk2d, bias2d, vecs, norms, slice_=p.slice, parts=p.parts,
                **kw)

        monkeypatch.setattr(bs, "stream_distances", split_k2)
    kb.reset_launch_counts()
    q = xq[:nq]
    D, R = (a.numpy() for a in ours.search_batch_device(q, K, n_probe))
    rD, rR = reference_search(ref, "stream", q, K, n_probe)
    assert rule == "plain" or calls
    assert set_overlap(R, rR).min() == 1.0
    assert np.array_equal(np.isfinite(D), np.isfinite(rD))
    fin = np.isfinite(rD)
    scale = np.max(np.where(fin, np.abs(rD), 0), axis=1, keepdims=True)
    assert np.all(np.abs(D - rD)[fin] <= (1e-5 * (np.abs(rD) + scale))[fin])
    assert sum(kb.launch_counts().values()) == 0  # CPU: plain versions
