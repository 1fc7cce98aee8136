"""Port dispatch model vs the JAX reference: sizing rules and the byte model
give the same answers over a grid of (lengths, nq, n_probe, k)."""

import numpy as np
import pytest
import torch

from vector_indexer_tpu.index import dispatch as jd
from vector_indexer_tpu.ops.pallas import block_stream as jbs
from vector_indexer_tpu_torch.index import dispatch as td
from vector_indexer_tpu_torch.index.programs import shortlist_k
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
    ln = _lengths(kind)
    for nq in (1, 37, 256, 1000):
        for n_probe in (1, 8, 32, 128):
            for chunk in (None, 512):
                # The reference's 4th field (t_cap) belongs to the unported
                # shared program and is 0 here.
                ref = jd.stream_params(ln, 128, 2, nq, n_probe, exact=False, shared=False,
                                       chunk=chunk)
                assert ref[3] == 0
                assert td.stream_params(ln, 128, 2, nq, n_probe, chunk=chunk) == ref[:3]


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
        self.num_clusters = len(lengths)
        self.choose_method = lambda nq, n_probe: IvfIndex.choose_method(self, nq, n_probe)


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


@pytest.mark.parametrize("method", ["gather", "stream_shared", "flat", "dense_int8", "staged", "stream_exact"])
def test_unported_methods_raise(method):
    core = _Core(np.full(50, 100))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        td.resolve(core, 10, 4, k=10, method=method)


def test_unknown_method_raises():
    with pytest.raises(ValueError):
        td.resolve(_Core(np.full(50, 100)), 10, 4, method="nope")
