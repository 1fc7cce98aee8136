"""Port dispatch model vs the JAX reference: sizing rules and the byte model
give the same answers over a grid of (lengths, nq, n_probe, k)."""

import numpy as np
import pytest
import torch

from vector_indexer_tpu.index import dispatch as jd
from vector_indexer_tpu.ops import gather as jg
from vector_indexer_tpu.ops.pallas import block_stream as jbs
from vector_indexer_tpu.ops.pallas import flat_sweep as jfs
from vector_indexer_tpu_torch.index import dispatch as td
from vector_indexer_tpu_torch.index.programs import shortlist_k
from vector_indexer_tpu_torch.index.tables import DeviceTables
from vector_indexer_tpu_torch.ops import block_stream as tbs


def _lengths(kind, kc=500, seed=0):
    g = np.random.default_rng(seed)
    if kind == "balanced":
        return g.integers(200, 300, kc)
    if kind == "skewed":
        return np.maximum(1, g.lognormal(5, 1.2, kc).astype(np.int64))
    return g.integers(1, 40, kc)  # small lists


KINDS = ["balanced", "skewed", "small"]


@pytest.mark.parametrize("kind", KINDS)
def test_pick_chunk_and_slots_match(kind):
    ln = _lengths(kind)
    for d in (32, 128, 256):
        for itemsize in (1, 2, 4):
            assert tbs.pick_chunk(ln, d, itemsize) == jbs.pick_chunk(ln, d, itemsize)
    for chunk in (256, 512, 1024):
        for n_probe in (1, 4, 8, 32, 100, 600):
            for worst in (False, True):
                assert tbs.per_query_slots(ln, n_probe, worst, chunk) == jbs.per_query_slots(
                    ln, n_probe, worst, chunk
                )
            assert tbs.expected_tasks_per_query(ln, n_probe, chunk) == pytest.approx(
                jbs.expected_tasks_per_query(ln, n_probe, chunk)
            )
        assert tbs.pick_stream_groups(chunk) == jbs.pick_stream_groups(chunk)


@pytest.mark.parametrize("kind", KINDS)
def test_choose_sweep_body_matches(kind):
    ln = _lengths(kind)
    n_rows = int(ln.sum() * 1.05)
    for nq in (1, 100, 1000, 4096):
        for n_probe in (1, 8, 32, 64, 256):
            for scale in (1, 40):  # the same lists at a 40x larger corpus
                args = (ln * scale, n_rows * scale, 128, 2, nq, n_probe, 256)
                for shared in (False, True):
                    assert td.choose_sweep_body(*args, allow_shared=shared) == \
                        jd.choose_sweep_body(*args, allow_shared=shared)
    assert td.mean_slot_rows_of(ln, 256) == jd.mean_slot_rows_of(ln, 256)


@pytest.mark.parametrize("kind", KINDS)
def test_stream_params_match(kind):
    """(chunk, t_fixed, q_tile, t_cap) equal the reference's for the plain,
    exact, shared and shared-exact programs and every table itemsize."""
    ln = _lengths(kind)
    for nq in (1, 37, 256, 1000, 4096):
        for n_probe in (1, 8, 32, 128):
            for chunk in (None, 512):
                for itemsize in (1, 2, 4):
                    for exact in (False, True):
                        for shared in (False, True):
                            kw = dict(exact=exact, shared=shared, chunk=chunk)
                            assert td.stream_params(ln, 128, itemsize, nq, n_probe, **kw) == \
                                jd.stream_params(ln, 128, itemsize, nq, n_probe, **kw)


def test_pick_q_tile_and_gates_match():
    for nq in (1, 9, 256, 1000, 5000):
        for budget in (100, 10_000, 10**6):
            assert td.pick_q_tile(nq, budget, 128) == jd.pick_q_tile(nq, budget, 128)
        for n_probe in (8, 64, 2048):
            assert td.shared_gate(nq, n_probe, 300.0) == jd.shared_gate(nq, n_probe, 300.0)
    assert (td.STREAM_FIXED_QBYTES, td.SHARED_MIN_PROBED_ROWS, td.SHARED_MIN_NQ) == (
        jd.STREAM_FIXED_QBYTES, jd.SHARED_MIN_PROBED_ROWS, jd.SHARED_MIN_NQ
    )


class _Core:
    """Minimal stand-in for an IvfIndex: what ``resolve`` reads."""

    def __init__(self, lengths, d=128, n=None):
        from vector_indexer_tpu_torch.index.ivf import IvfIndex

        self.dimension = d
        self.layout = type("L", (), {})()
        self.layout.lengths = np.asarray(lengths, np.int32)
        self.layout.n = int(np.sum(lengths)) if n is None else n
        self.layout.vectors = torch.empty((int(np.sum(lengths) * 1.05) + 8, 0))
        self.layout.table_shape = tuple(self.layout.vectors.shape)
        self.num_clusters = len(lengths)
        self.stream_dtype = torch.bfloat16
        self.offloaded = False
        self.choose_method = lambda nq, n_probe: IvfIndex.choose_method(self, nq, n_probe)
        self.tables = lambda: DeviceTables(self.layout, None, None, torch.device("cpu"))


def test_resolve_routes_the_sift1m_shape():
    """At the SIFT1M shape (1M rows, nlist 4000, nq 1000, k 100) 'auto'
    routes to the unfused stream (K2), the fused stream (K4) and the
    fused dense sweep (K3) as n_probe grows."""
    ln = np.random.default_rng(0).integers(200, 300, 4000)
    core = _Core(ln * 1_000_000 // ln.sum())
    got = {}
    for n_probe in (8, 32, 64):
        dec = td.resolve(core, 1000, n_probe, k=100)
        kk = shortlist_k(100, dec.t_fixed, dec.chunk)
        got[n_probe] = (dec.program, dec.program == "stream" and tbs.fused_engages(dec.t_fixed, dec.chunk, kk))
    assert got == {8: ("stream", False), 32: ("stream", True), 64: ("dense_fused", False)}


def test_resolve_small_table_takes_plain_dense():
    core = _Core(np.full(50, 100))
    assert td.resolve(core, 10, 4, k=10, method="dense").program == "dense_torch"
    assert td.resolve(core, 10, 4, k=10, method="dense_fused").program in ("dense_fused", "dense_torch")


def _reference_decision(ln, n_rows, n, method, nq, n_probe, k, d=128):
    """(program, plan, precision, budget) the port must resolve ``method``
    to: the reference's branches (dispatch.py:248-290, :331-366) on its own
    plan_fused / candidate_budget, with the TPU gate dropped, the plain
    programs named flat_torch / dense_torch, and gather_dma never falling
    back to gather."""
    prec = {"flat_int8": "int8", "dense_int8": "int8", "flat_int8x1": "int8x1",
            "dense_int8x1": "int8x1"}.get(method)
    if prec:
        plan = jfs.plan_fused(n_rows, d, nq, k, precision=prec) if d % 128 == 0 else None
        if plan is not None:
            return ("flat_fused" if method.startswith("flat") else "dense_fused", plan, prec, 0)
        method = "flat" if method.startswith("flat") else "dense"
    if method in ("gather", "gather_dma"):
        return (method, None, "highest", jg.candidate_budget(ln, n_probe))
    fused = (method != "flat_exact" and n > 50_000) if method.startswith("flat") else n > 50_000
    plan = jfs.plan_fused(n_rows, d, nq, k) if fused and d % 128 == 0 else None
    kind = "flat" if method.startswith("flat") else "dense"
    return (f"{kind}_fused" if plan else f"{kind}_torch", plan, "highest", 0)


SIZES = {"small": 50, "sift1m": 4000}  # lists of ~250 rows: 12.5k and 1M rows


@pytest.mark.parametrize("size", list(SIZES))
@pytest.mark.parametrize("method", ["gather", "gather_dma", "flat", "dense_int8", "flat_exact",
                                    "flat_fused", "flat_int8", "flat_int8x1", "dense_int8x1"])
def test_resolve_serves_the_slice_methods(method, size):
    """Every method of the flat, int8 and gather slice resolves to the
    reference's program, fused plan, precision and budget, at a small table
    (the plain and fused fallbacks) and at the SIFT1M shape (the fused and
    int8 sweeps)."""
    ln = np.random.default_rng(2).integers(200, 300, SIZES[size])
    core = _Core(ln)
    n_rows = core.layout.vectors.shape[0]
    for nq, n_probe, k in ((10, 4, 10), (1000, 32, 100)):
        dec = td.resolve(core, nq, n_probe, k=k, method=method)
        assert (dec.program, dec.plan, dec.precision, dec.budget) == _reference_decision(
            ln, n_rows, core.layout.n, method, nq, n_probe, k)
        if dec.budget:
            assert dec.q_tile == td.pick_q_tile(nq, dec.budget, 128)


def test_int8_methods_fall_back_where_no_plan_fits():
    """Past the int32 accumulator bound (d > 2048) the int8 methods take
    their f32 twins, as in the reference."""
    core = _Core(np.full(400, 3000), d=4096)
    assert td.resolve(core, 100, 8, k=10, method="flat_int8").program == "flat_torch"
    assert td.resolve(core, 100, 8, k=10, method="dense_int8x1").program == "dense_torch"


@pytest.mark.parametrize("method,d", [("flat", 384), ("flat_fused", 768), ("dense_fused", 512),
                                      ("flat_int8", 2048), ("dense_int8", 1536),
                                      ("dense_int8x1", 2048)])
def test_resolve_keeps_the_fused_sweep_at_wide_rows(method, d):
    """The fused sweep kernel takes any d (its query tile streams through
    the ring where it does not stay resident), so wide rows resolve to the
    reference's fused program and plan, not to the plain programs."""
    ln = np.random.default_rng(3).integers(200, 300, SIZES["sift1m"])
    core = _Core(ln, d=d)
    dec = td.resolve(core, 1000, 32, k=100, method=method)
    assert dec.program.endswith("_fused")
    assert (dec.program, dec.plan, dec.precision, dec.budget) == _reference_decision(
        ln, core.layout.vectors.shape[0], core.layout.n, method, 1000, 32, 100, d=d)


@pytest.mark.parametrize("method", ["staged"])
def test_unported_methods_raise(method):
    """'staged' needs a host-resident index: elsewhere it raises, as the
    reference's resolve does; a host-resident index resolves every method
    to it."""
    core = _Core(np.full(50, 100))
    with pytest.raises(RuntimeError, match="resident='host'"):
        td.resolve(core, 10, 4, k=10, method=method)
    core.host_resident = True
    for m in (method, "auto", "dense"):
        assert td.resolve(core, 10, 4, k=10, method=m).program == "staged"


def test_unknown_method_raises():
    with pytest.raises(ValueError):
        td.resolve(_Core(np.full(50, 100)), 10, 4, method="nope")


@pytest.mark.parametrize("method", ["stream", "stream_exact", "stream_shared", "stream_shared_exact"])
def test_resolve_stream_methods_size_like_the_reference(method):
    """Every stream method resolves to the reference's program and sizing;
    the exact ones size an f32 table, the others the index's stream type."""
    ln = np.random.default_rng(1).integers(200, 300, 600)
    core = _Core(ln)
    dec = td.resolve(core, 1500, 64, k=100, method=method)
    exact, shared = method.endswith("_exact"), method.startswith("stream_shared")
    ref = jd.stream_params(ln, 128, 4 if exact else 2, 1500, 64, exact=exact, shared=shared)
    assert dec.program == ("stream_shared" if shared else "stream") and dec.exact == exact
    assert (dec.chunk, dec.t_fixed, dec.q_tile, dec.t_cap) == ref
    core.stream_dtype = torch.int8
    dec = td.resolve(core, 1500, 64, k=100, method=method)
    ref = jd.stream_params(ln, 128, 4 if exact else 1, 1500, 64, exact=exact, shared=shared)
    assert (dec.chunk, dec.t_fixed, dec.q_tile, dec.t_cap) == ref


@pytest.mark.parametrize("kind", KINDS)
def test_shared_task_cap_matches(kind):
    ln = _lengths(kind)
    for nq_tile in (8, 64, 1024):
        for t_fixed in (16, 96, 3072):
            for worst in (False, True):
                for chunk in (256, 1024):
                    assert tbs.shared_task_cap(ln, 64, nq_tile, t_fixed, worst, chunk) == \
                        jbs.shared_task_cap(ln, 64, nq_tile, t_fixed, worst, chunk)
    assert tbs.Q_SHARE == jbs.Q_SHARE
