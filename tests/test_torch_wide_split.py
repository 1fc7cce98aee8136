"""Wide rows at small batches: the launch plans that spread a few queries
over every SM (K4's split launch, K6's items), the rules those launches
follow written as plain functions (K4: each row's dot summed slice by
slice, then the reference's fold; K6: each probe's slot range cut into
items), held against the plain versions, and the split rule held against
the JAX reference's fused stream search (Pallas in interpret mode)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import make_gaussian_clusters
from test_torch_wide import CHUNKS, MAX_D, _widths
from torch_parity import CPU, reference_arrays, set_overlap, t

from vector_indexer_tpu.index import IvfIndex as JaxIndex
from vector_indexer_tpu.ops.pallas import block_stream as jbs
from vector_indexer_tpu.storage import VectorStore
from vector_indexer_tpu_torch.convert import index_from_reference_arrays
from vector_indexer_tpu_torch.ops import block_stream as bs
from vector_indexer_tpu_torch.ops import ivf_gather as ig
from vector_indexer_tpu_torch.ops.gather import candidate_budget

N_SM = 132  # the H100's SMs
NQS = (1, 2, 16, 131, 263, 264, 1000)  # to past the stream program's 256-query tile
T_FIXED = (16, 64, 256)


def _split_mode(itemsize, chunk):
    def mode_of(d):
        p = bs.stream_fused_plan(d, itemsize, chunk)
        return p and p.nch
    return mode_of


@pytest.mark.parametrize("itemsize", [1, 2], ids=["int8", "bf16"])
def test_k4_split_plan_covers_every_width(itemsize):
    """For every d to 65,536 (the existing stride and every mode edge),
    chunks 256 / 512 / 1024, nq 1 / 2 / 16 / 131 / 263 / 264 / 1000: no
    split where the register modes run (d <= 1024); past them, at every
    nq, a plan the launcher takes (slices of 16-byte chunks covering d,
    parts of the rows, stages holding their segments, shared memory within
    the opt-in and, past one segment a stage, within two blocks an SM), no
    fewer blocks than one per (query, group) up to the plan's target
    (SPLIT_BLOCKS_PER_SM an SM), and at nq 1 at least 128 blocks."""
    epc = 16 // itemsize
    for chunk in CHUNKS:
        G = bs.pick_stream_groups(chunk)
        for d in _widths(_split_mode(itemsize, chunk)):
            base = bs.stream_fused_plan(d, itemsize, chunk)
            for nq in NQS:
                for t_fixed in T_FIXED:
                    p = bs.stream_fused_split_plan(d, itemsize, chunk, nq, G, t_fixed, N_SM)
                    if base is not None:
                        assert p is None, (d, chunk, nq, t_fixed)
                        continue
                    assert p is not None
                    assert p.slice >= epc and p.slice % epc == 0
                    assert p.n_slices == -(-d // p.slice) and (p.n_slices - 1) * p.slice < d
                    assert 1 <= p.parts <= t_fixed * chunk // bs.SPLIT_PART_ROWS
                    stride = p.slice * itemsize + (0 if (d * itemsize) % 16 == 0 else 32)
                    assert 1 <= p.sub_rows <= chunk and p.stage_bytes % 128 == 0
                    assert p.stage_bytes >= p.sub_rows * stride
                    assert p.smem == bs.SPLIT_STAGES * p.stage_bytes + 16 * bs.SPLIT_STAGES \
                        + 8 * p.slice <= bs.SMEM_LIMIT
                    if p.sub_rows > 1:  # two blocks an SM
                        assert p.smem <= bs.SPLIT_SMEM
                    assert p.blocks == nq * p.parts * p.n_slices >= min(
                        nq * G, bs.SPLIT_BLOCKS_PER_SM * N_SM)
                    if nq == 1:
                        assert p.blocks >= 128, (d, chunk, t_fixed, p)
    # The main path's batch (d 128) never splits; wide rows split at any nq.
    assert bs.stream_fused_split_plan(128, itemsize, 256, 1000, 4, 96, N_SM) is None
    for d in (1100, 16_384, MAX_D):
        assert bs.stream_fused_split_plan(d, itemsize, 256, 1000, 4, 96, N_SM) is not None


def test_k4_split_threshold_follows_the_readings():
    """Wide rows (chunk 256, G 4) take the split launch at every nq, the
    stream program's 256-query tile and larger direct calls alike: on the
    H100 one block per (query, group) read slower at every nq from 33 to
    1000 on rows of 16,384 (bf16 and int8) and at most 4.5% faster (nq 512
    and 1000) on rows of 1,536; the register modes never split."""
    G = bs.pick_stream_groups(256)
    assert G == 4
    for itemsize in (1, 2):
        for d in (1025, 1536, 2056, 16_384, MAX_D):
            for nq in (1, 33, 131, 192, 256, 263, 264, 512, 1000, 4096):
                assert bs.stream_fused_split_plan(d, itemsize, 256, nq, G, 64, N_SM) is not None
        for nq in (1, 264, 4096):
            assert bs.stream_fused_split_plan(1024 // itemsize, itemsize, 256, nq, G, 64,
                                              N_SM) is None
            assert bs.stream_fused_plan(1024 // itemsize, itemsize, 256) is not None


def _tie_problem(dtype, metric, seed, integer):
    """A small K4 problem (nq 3, chunk 16, t_fixed 32, d 40) with exact
    ties. Group 0 folds slots 0, 8, 16, 24, 1, 9, 17, 25 in that order; for
    query 0, slots 0 and 8 read the same block, slot 16 a copy of it moved
    one step nearer the query at every element, and the other five are
    empty, so at every lane the fold sees [1a, 1b, 0c]. Elsewhere the
    slots draw blocks at random (repeats among them tie too).
    ``integer``: small integer entries and unit int8 scales, so every dot
    is exact in f32."""
    g = np.random.default_rng(seed)
    nq, t_fixed, chunk, d, n_blocks, kc = 3, 32, 16, 40, 6, 4
    if integer:
        def draw(*shape):
            return g.integers(-3, 4, shape).astype(np.float32)
    else:
        def draw(*shape):
            return g.normal(size=shape).astype(np.float32)
    q, cent = draw(nq, d), draw(kc, d)
    rows = draw(n_blocks * chunk, d)
    if dtype == torch.int8 and not integer:
        rows = np.clip(np.round(40 * rows), -127, 127)
    blk = g.integers(0, n_blocks, (nq, t_fixed))
    blk[0, 8] = blk[0, 0]
    blk[0, 16] = n_blocks  # the nearer copy
    cid = blk % kc
    cid[0, 16] = cid[0, 0]
    b0 = rows[blk[0, 0] * chunk:(blk[0, 0] + 1) * chunk]
    qc0 = q[0] - cent[cid[0, 0]] if metric == "l2" else q[0]
    step = np.sign(qc0[None, :] - b0) if metric == "l2" else np.sign(qc0)[None, :].repeat(chunk, 0)
    rows = np.concatenate([rows, b0 + step])
    block_cid = np.concatenate([np.arange(n_blocks) % kc, [cid[0, 0]]])
    if dtype == torch.int8:
        vecs = torch.as_tensor(np.clip(rows, -127, 127)).to(torch.int8)
        scales = torch.as_tensor(np.ones(kc, np.float32) if integer else
                                 g.choice([0.5, 1.0, 2.0], kc).astype(np.float32))
        deq = vecs.float() * scales[torch.as_tensor(np.repeat(block_cid, chunk))][:, None]
    else:
        vecs = torch.as_tensor(rows).to(torch.bfloat16)
        scales, deq = None, vecs.float()
    norms = (deq * deq).sum(1)
    nval = g.integers(0, chunk + 1, (nq, t_fixed))
    nval[0, [0, 8, 16]] = chunk
    nval[0, [24, 1, 9, 17, 25]] = 0
    qt, ct, cid_t = torch.as_tensor(q), torch.as_tensor(cent), torch.as_tensor(cid)
    if metric == "l2":
        bias = ((qt[:, None, :] - ct[cid_t]) ** 2).sum(-1)
    else:
        bias = -(qt[:, None, :] * ct[cid_t]).sum(-1)
    args = (qt, ct, cid_t, torch.as_tensor(blk), torch.as_tensor(nval), bias, vecs, norms)
    return args, dict(chunk=chunk, groups=4, metric=metric, scales=scales)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8], ids=["bf16", "int8"])
@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_k4_split_rule_keeps_the_fold_on_exact_ties(dtype, metric):
    """The split launch's rule (partial dots per d-slice summed in slice
    order, then the reference's fold) against K4's plain version on
    integer data, where every sum is exact: equal planes, value for value
    and slot for slot, also where candidates tie exactly ([1a, 1b, 0c] at
    every lane of query 0's group 0: the fold keeps b as second, not the
    lexicographic a)."""
    args, kw = _tie_problem(dtype, metric, 1, integer=True)
    pv, ps = bs.stream_fused_plane_reference(*args, **kw)
    for slice_ in (8, 16, 40):
        sv, ss = bs.stream_fused_plane_split_reference(*args, slice_=slice_, **kw)
        assert torch.equal(sv, pv) and torch.equal(ss, ps)
    # The injected case: slot 16 is best at every lane, and the second is
    # slot 8 (the later of the two equal candidates that preceded it).
    chunk, width = kw["chunk"], 4 * kw["chunk"]
    assert (ps[0, :chunk] == 16).all() and (ps[0, width:width + chunk] == 8).all()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8], ids=["bf16", "int8"])
@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_k4_split_rule_on_random_planes(dtype, metric):
    """On random data the split rule sums each dot in another order:
    values within 1e-5 of the problem's term scale, and a different slot
    only where the two slots' distances tie within that tolerance."""
    args, kw = _tie_problem(dtype, metric, 2, integer=False)
    pv, ps = bs.stream_fused_plane_reference(*args, **kw)
    dist = bs.stream_distances_reference(*args[:4], args[5], *args[6:], chunk=kw["chunk"],
                                         metric=metric, scales=kw["scales"])
    scale = float(dist[torch.isfinite(dist)].abs().max())
    sv, ss = bs.stream_fused_plane_split_reference(*args, slice_=8, **kw)
    fin = torch.isfinite(pv)
    assert torch.equal(torch.isfinite(sv), fin)
    assert float((sv - pv).abs()[fin].max()) <= 1e-5 * scale
    qi, col = torch.nonzero((ss != ps) & fin, as_tuple=True)
    alt = dist[qi, ss[qi, col].long(), col % kw["chunk"]]
    assert bool(((alt - pv[qi, col]).abs() <= 1e-5 * scale).all())


@pytest.fixture(scope="module")
def pair():
    data, _, _ = make_gaussian_clusters(16, 400, 32, spread=0.4, separation=8.0, seed=7)
    store = VectorStore(external_ids=np.arange(len(data), dtype=np.uint64), vectors=data)
    ref = JaxIndex.fit(store, seed=42)
    ours = index_from_reference_arrays(reference_arrays(ref), device=CPU)
    return data, ref, ours, ref._stream_table(jnp.bfloat16), ours._stream_table()


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_split_rule_search_matches_reference(pair, metric, monkeypatch):
    """block_stream_search with K4's planes taken by the split rule
    (slices of 8 of d 32) returns the JAX reference's fused stream search:
    the same sets, distances within 1e-5 of each query's scale (the
    reference's bf16 hi/lo query split, as in test_torch_stream)."""
    data, ref, ours, jt, tt = pair
    q = data[:24] + 0.01
    if metric == "ip":
        q = q / np.linalg.norm(q, axis=1, keepdims=True)
    d2 = ((q[:, None, :].astype(np.float64) - ref.centroids[None]) ** 2).sum(-1)
    probe = np.argsort(d2, axis=1, kind="stable")[:, :4].astype(np.int32)
    k = 40
    t_fixed = bs.per_query_slots(ours.layout.lengths, 4, chunk=tt.chunk)
    calls = []

    def split_planes(*a, **kw):
        calls.append(1)
        return bs.stream_fused_plane_split_reference(*a, slice_=8, **kw)

    monkeypatch.setattr(bs, "stream_fused_plane", split_planes)
    D, R = bs.block_stream_search(t(q), tt, t(probe).long(), k, t_fixed=t_fixed, metric=metric,
                                  fused=True)
    assert calls
    rD, rR = jbs.block_stream_search(jnp.asarray(q), jt, jnp.asarray(probe), k, t_fixed=t_fixed,
                                     metric=metric, approx=False, fused=True, interpret=True)
    D, R, rD, rR = D.numpy(), R.numpy(), np.asarray(rD), np.asarray(rR)
    assert set_overlap(R, rR).min() == 1.0
    scale = np.max(np.where(np.isfinite(rD), np.abs(rD), 0), axis=1, keepdims=True)
    fin = np.isfinite(rD)
    assert np.array_equal(np.isfinite(D), fin)
    assert np.all(np.abs(D - rD)[fin] <= (1e-5 * (np.abs(rD) + scale))[fin])


# ---------------------------------------------------------------------------
# K6: items
# ---------------------------------------------------------------------------

MAX_LENS = (1, 8, 511, 512, 777, 4096)


def test_k6_item_plan_covers_every_width():
    """For every d to 65,536 and segment lengths from 8 to 4,096 slots: the
    narrow launch where d keeps within K6_RESIDENT_D and one item holds a
    segment (d 128 up to 2,048 slots), elsewhere items that cover the
    segment within the grid's 65,535, the query in shared memory within
    the opt-in (whole, or panels of a multiple of 4 with one row per
    warp), and items of at most ~1 MB of rows."""
    for mlp in (8, 104, 512, 1024, 2048, 4096):
        for d in range(1, MAX_D + 1, 7):
            p = ig.ivf_gather_item_plan(d, mlp)
            if p is None:
                rows = max(ig.K6_WARPS, ig.K6_ITEM_BYTES // (4 * d))
                assert d <= ig.K6_RESIDENT_D and rows >= mlp
                continue
            assert p.items * p.rows >= mlp and (p.items - 1) * p.rows < mlp and p.items <= 65_535
            assert p.smem == 4 * p.panel <= 232_448 and 1 <= p.panel <= d
            assert p.panel == d or (p.panel % 4 == 0 and p.rows <= ig.K6_WARPS)
            assert p.rows == ig.K6_WARPS or p.rows * 4 * d <= ig.K6_ITEM_BYTES
    assert ig.ivf_gather_item_plan(128, 1024) is None  # the main path's launch stays
    assert ig.ivf_gather_item_plan(16_384, 1024) == (16, 64, 16_384, 65_536)


def _k6_operands(seed, max_len, p=6, nq=5, n_lists=24):
    g = np.random.default_rng(seed)
    lens = g.integers(0, max_len + 1, n_lists)
    lens[::5] = 0
    lens[1] = max_len
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]])
    probe = np.stack([g.permutation(n_lists)[:p] for _ in range(nq)])
    probe[0, 0] = 1  # the longest list
    budget = candidate_budget(lens, p)
    return torch.as_tensor(starts[probe]), torch.as_tensor(lens[probe]), budget, int(lens.sum())


@pytest.mark.parametrize("max_len", MAX_LENS)
def test_k6_items_cover_every_slot_once(max_len):
    """The item rule covers every slot of [0, width) exactly once, each
    with the owner the clamped slot_offsets give it (the last probe whose
    segment starts at or before it), for R at 1, the plan's R and past
    max_len_pad; random lengths with empty lists."""
    starts, lens, budget, _ = _k6_operands(max_len, max_len)
    mlp = ig.max_len_pad(max_len)
    width = ig.output_width(lens.shape[1], max_len, budget)
    offs = ig.slot_offsets(lens, max_len, budget)
    plan = ig.ivf_gather_item_plan(16_384, mlp)
    for rows in (1, plan.rows, mlp + 1):
        items = -(-mlp // rows)
        for qi in range(offs.shape[0]):
            cover = np.zeros(width, np.int64)
            owner = np.full(width, -1)
            for j, lo, hi in ig.item_slots(offs[qi].tolist(), width, rows, items):
                assert 0 <= lo < hi <= width and hi - lo <= max(rows, width)
                cover[lo:hi] += 1
                owner[lo:hi] = j
            assert (cover == 1).all()
            want = np.searchsorted(offs[qi].numpy(), np.arange(width), side="right") - 1
            np.testing.assert_array_equal(owner, want)


@pytest.mark.parametrize("max_len", MAX_LENS)
def test_k6_item_rule_matches_plain_version(max_len):
    """Each item scores its valid slots (rows start + t for t below the
    probe's length and max_len_pad) and writes +inf / -1 over the rest of
    its slots; assembled, the items give the plain version's rows and
    holes slot for slot and its distances within 1e-5 of |q|^2 + |x|^2."""
    starts, lens, budget, n_rows = _k6_operands(100 + max_len, max_len)
    g = np.random.default_rng(max_len)
    d = 24
    vectors = torch.as_tensor(g.normal(size=(n_rows + 8, d)).astype(np.float32))
    q = torch.as_tensor(g.normal(size=(lens.shape[0], d)).astype(np.float32))
    kw = dict(max_len=max_len, budget=budget, metric="l2")
    pd, pr = ig.ivf_gather_distances_reference(q, vectors, starts, lens, **kw)
    mlp = ig.max_len_pad(max_len)
    width = ig.output_width(lens.shape[1], max_len, budget)
    offs = ig.slot_offsets(lens, max_len, budget)
    for rows in (1, 3, mlp + 1):
        items = -(-mlp // rows)
        dist = torch.full((q.shape[0], width), float("nan"))
        out = torch.full((q.shape[0], width), -7, dtype=torch.int32)
        for qi in range(q.shape[0]):
            for j, lo, hi in ig.item_slots(offs[qi].tolist(), width, rows, items):
                off = int(offs[qi, j])
                n_valid = min(int(lens[qi, j]), mlp)
                for s in range(lo, hi):
                    tt = s - off
                    if tt < n_valid:
                        x = vectors[int(starts[qi, j]) + tt]
                        dist[qi, s] = max(float(q[qi] @ q[qi] - 2 * (q[qi] @ x) + x @ x), 0.0)
                        out[qi, s] = int(starts[qi, j]) + tt
                    else:
                        dist[qi, s], out[qi, s] = float("inf"), -1
        assert torch.equal(out, pr)
        assert torch.equal(torch.isinf(dist), torch.isinf(pd))
        fin = torch.isfinite(pd)
        xn = (vectors * vectors).sum(1)[pr.clamp_min(0).long()]
        term = (q * q).sum(1)[:, None] + xn
        assert bool(((dist - pd).abs()[fin] <= 1e-5 * term[fin]).all())
