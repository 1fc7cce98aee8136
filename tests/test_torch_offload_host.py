"""An index larger than its card, offloaded from a host layout: the int8
residual table built on the device from staged host rows
(``build_stream_table_from_rows``, ``offload_from_host``), the host layout
that is never gathered on the way, the re-rank's norms from that pass, and
the deployment end to end (a host fit on a one-entry mesh, then
``offload_from_host(rerank="host")``, then ``search_batch``) against the
benchmark's plain reference (``portbench/reference.py``, float64). No JAX
here."""

import copy
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import datagen, reference  # noqa: E402
from portbench.harness import port_labels  # noqa: E402
from vector_indexer_tpu_torch.index import offload  # noqa: E402
from vector_indexer_tpu_torch.index.ivf import IvfIndex  # noqa: E402
from vector_indexer_tpu_torch.ops import block_stream as bs  # noqa: E402
from vector_indexer_tpu_torch.parallel import Mesh  # noqa: E402
from vector_indexer_tpu_torch.storage import layout as layout_mod  # noqa: E402
from vector_indexer_tpu_torch.storage import staging  # noqa: E402
from vector_indexer_tpu_torch.storage.layout import PostingLayout  # noqa: E402
from vector_indexer_tpu_torch.storage.vector_store import VectorStore  # noqa: E402
from vector_indexer_tpu_torch.utils import tracing  # noqa: E402

CPU = torch.device("cpu")
N, D, NLIST, SAMPLE = 6000, 32, 48, 2500


def corpus(n=N, d=D, nq=700, seed=11):
    xb, xq = datagen.clustered(n, d, nq, seed, CPU, 12, 4.0)
    return xb.numpy(), xq.numpy()


def host_fit(xb, metric="l2", nlist=NLIST):
    """The deployment's build: a host fit on a mesh of one entry."""
    store = VectorStore(external_ids=np.arange(len(xb), dtype=np.uint64) * 3 + 5, vectors=xb)
    return IvfIndex.fit(store, seed=42, nlist=nlist, metric=metric,
                        mesh=Mesh([CPU], ("shards",)), resident="host", train_sample=SAMPLE,
                        device="cpu")


@pytest.fixture(scope="module", params=["l2", "cosine"])
def fitted(request):
    xb, xq = corpus()
    return xb, xq, host_fit(xb, request.param)


def device_twin(lay: PostingLayout) -> PostingLayout:
    """The same layout with its table gathered into a CPU tensor (the
    device-resident layout ``build_stream_table`` reads)."""
    rows = np.zeros(lay.table_shape, np.float32)
    lay.rows_into(0, rows.shape[0], rows)
    twin = copy.copy(lay)
    twin.vectors = torch.from_numpy(rows)  # also drops the copy's pending gather
    return twin


def test_a_host_fit_leaves_its_table_ungathered(fitted):
    xb, _, idx = fitted
    lay = idx.layout
    assert lay.on_host and lay._pending is not None
    assert lay.table_shape == (lay.table_shape[0], D) and lay.dim == D
    part = np.empty((500, D), np.float32)
    lay.rows_into(100, 600, part)
    assert lay._pending is not None  # reading rows does not gather the table
    gathered = copy.copy(lay)
    full = gathered.vectors  # the first read gathers the whole table
    assert gathered._pending is None and isinstance(full, np.ndarray)
    np.testing.assert_array_equal(full[100:600], part)
    real = lay.perm >= 0
    np.testing.assert_array_equal(full[: lay.rows_used][real], idx._host_data[lay.perm[real]])
    assert (full[: lay.rows_used][~real] == 0).all() and (full[lay.rows_used:] == 0).all()
    np.testing.assert_allclose(gathered.row_norms[: lay.rows_used][real],
                               (full[: lay.rows_used][real] ** 2).sum(1), rtol=1e-5)


@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16, torch.float32])
@pytest.mark.parametrize("rows", [37, 333, 1 << 20])
def test_the_staged_build_equals_the_device_build(fitted, monkeypatch, dtype, rows):
    """Codes and scales equal ``build_stream_table``'s on the same layout,
    norms within f32 summation order, at staging chunks that end inside
    lists, one smaller than the longest list, and one over the whole
    table."""
    _, _, idx = fitted
    lay = idx.layout
    if rows < 1 << 20:
        assert lay.lengths.max() > rows  # chunks end inside lists
    monkeypatch.setattr(staging, "STAGE_BYTES", rows * 4 * lay.dim)
    chunks = staging.staged_rows(lay.rows_used, lay.dim, lay.rows_into, False)
    got, row_sq = bs.build_stream_table_from_rows(lay, idx.centroids, chunks, dtype,
                                                  device="cpu")
    assert lay._pending is not None
    twin = device_twin(lay)
    want = bs.build_stream_table(twin, idx.centroids, dtype)
    assert got.chunk == want.chunk and got.m_pad == want.m_pad
    # (== holds the device build's -0.0 on pad rows equal to the +0.0 here.)
    assert torch.equal(got.vecs.float(), want.vecs.float())
    assert torch.equal(got.scales, want.scales)
    for name in ("to_main", "sblk0", "lengths", "blk_cid"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    np.testing.assert_array_max_ulp(got.norms.numpy(), want.norms.numpy(), maxulp=4)
    x = twin.vectors[: lay.rows_used].double()
    np.testing.assert_allclose(row_sq.double().numpy(), (x * x).sum(1).numpy(), rtol=1e-6)


class F32RowsMade(TorchDispatchMode):
    """The most rows of any 2-D float32 tensor an operation made."""

    def __init__(self):
        super().__init__()
        self.most = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in out if isinstance(out, (tuple, list)) else (out,):
            if isinstance(t, torch.Tensor) and t.dim() == 2 and t.dtype == torch.float32:
                self.most = max(self.most, t.shape[0])
        return out


def test_the_build_converts_a_tile_at_a_time(fitted, monkeypatch):
    """Rows that arrive 2,000 at a time are converted 64 at a time: no
    float32 transient comes near an arriving chunk (on a card the transient
    stays far below the f32 table the build avoids), and the table is the
    device build's."""
    _, _, idx = fitted
    lay = idx.layout
    full = np.empty((lay.rows_used, lay.dim), np.float32)
    lay.rows_into(0, lay.rows_used, full)
    chunks = [(lo, min(lo + 2000, lay.rows_used), torch.from_numpy(full[lo:lo + 2000]))
              for lo in range(0, lay.rows_used, 2000)]
    assert len(chunks) > 2
    monkeypatch.setattr(bs, "_ROW_TILE_BYTES", 64 * 4 * lay.dim)
    with F32RowsMade() as spy:
        got, _ = bs.build_stream_table_from_rows(lay, idx.centroids, iter(chunks), torch.int8,
                                                 device="cpu")
    assert spy.most < 1000
    want = bs.build_stream_table(device_twin(lay), idx.centroids, torch.int8)
    assert torch.equal(got.vecs, want.vecs) and torch.equal(got.scales, want.scales)


def test_an_empty_list_beside_a_full_one(monkeypatch):
    """Lists sharing a start (an empty list placed next to a full one) are
    built as the device build builds them, whatever the chunking."""
    rng = np.random.default_rng(5)
    lengths = np.array([5, 0, 9, 0, 0, 3], np.int32)
    starts = np.array([0, 16, 8, 16, 32, 16], np.int64)  # empty lists 1 and 3 start at 16
    rows_used = 32
    perm = np.full(rows_used, -1, np.int64)
    src = rng.normal(size=(17, 4)).astype(np.float32)
    ids = iter(range(17))
    for c in range(6):
        perm[starts[c]: starts[c] + lengths[c]] = [next(ids) for _ in range(lengths[c])]
    n_pad = rows_used + 512 + 8
    rowmap = np.full(n_pad, -1, np.int64)
    rowmap[:rows_used] = perm
    offsets = np.append(starts, rows_used).astype(np.int32)
    lay = PostingLayout(vectors=None, row_norms=None, offsets=offsets, lengths=lengths,
                        perm=perm, n=17, max_list_len=9)
    lay._pending = (src, rowmap)
    cent = rng.normal(size=(6, 4)).astype(np.float32)
    want = bs.build_stream_table(device_twin(lay), cent, torch.int8)
    for rows in (1, 3, 8, 40):
        monkeypatch.setattr(staging, "STAGE_BYTES", rows * 4 * 4)
        chunks = staging.staged_rows(rows_used, 4, lay.rows_into, False)
        got, _ = bs.build_stream_table_from_rows(lay, cent, chunks, torch.int8, device="cpu")
        assert torch.equal(got.vecs, want.vecs) and torch.equal(got.scales, want.scales), rows


def test_row_norms_read_during_the_first_gather(monkeypatch):
    """Threads that read ``row_norms`` while another's read of ``vectors``
    gathers the table all get the gathered norms; the pending gather is
    dropped only once both tables are in place."""
    xb, _ = corpus(n=3000)
    lay = host_fit(xb).layout
    want = copy.copy(lay).row_norms
    dropped = []

    class Watched(PostingLayout):
        def __setattr__(self, name, value):
            if name == "_pending" and value is None and self._pending is not None:
                dropped.append([self.__dict__.get(k) is not None
                                for k in ("_vectors", "_row_norms")])
            super().__setattr__(name, value)

    lay = copy.copy(lay)
    lay.__class__ = Watched
    gathering = threading.Event()
    gather = layout_mod._host_gather

    def slow(*args):
        gathering.set()
        time.sleep(0.05)  # the readers below start while the gather runs
        return gather(*args)

    monkeypatch.setattr(layout_mod, "_host_gather", slow)
    with ThreadPoolExecutor(9) as pool:
        first = pool.submit(lambda: lay.vectors)
        assert gathering.wait(10)
        readers = [pool.submit(lambda: lay.row_norms) for _ in range(8)]
        assert isinstance(first.result(), np.ndarray)
        for r in readers:
            np.testing.assert_array_equal(r.result(), want)
    assert dropped == [[True, True]]


def test_concurrent_row_reads_share_the_cores(monkeypatch):
    """Several threads reading a host layout's rows at once (one a card's
    packing) gather on as many cores as the process may use at the call,
    not on that many each."""
    xb, _ = corpus(n=3000)
    lay = host_fit(xb).layout
    monkeypatch.setattr(layout_mod, "host_workers", lambda: 3)
    monkeypatch.setattr(layout_mod, "_MIN_PART_ROWS", 64)
    lock, running, most = threading.Lock(), [0], [0]
    gather = layout_mod._gather_rows

    def counted(*args):
        with lock:
            running[0] += 1
            most[0] = max(most[0], running[0])
        time.sleep(0.01)
        gather(*args)
        with lock:
            running[0] -= 1

    monkeypatch.setattr(layout_mod, "_gather_rows", counted)
    rows = lay.rows_used
    outs = [np.empty((rows, D), np.float32) for _ in range(4)]
    with ThreadPoolExecutor(4) as pool:
        list(pool.map(lambda o: lay.rows_into(0, rows, o), outs))
    assert most[0] == 3
    want = copy.copy(lay).vectors[:rows]
    for o in outs:
        np.testing.assert_array_equal(o, want)


def test_staged_rows_covers_every_row_once(monkeypatch):
    seen = []
    def fill(lo, hi, out):
        out[:] = np.arange(lo, hi)[:, None]

    monkeypatch.setattr(staging, "STAGE_BYTES", 128 * 4 * 3)
    for lo, hi, buf in staging.staged_rows(1000, 3, fill, False):
        assert buf.shape == (hi - lo, 3) and (buf[:, 0].numpy() == np.arange(lo, hi)).all()
        seen.append((lo, hi))
    assert seen[0][0] == 0 and seen[-1][1] == 1000
    assert all(a[1] == b[0] for a, b in zip(seen, seen[1:]))


def test_offload_from_host_never_gathers_the_table(monkeypatch):
    xb, xq = corpus(n=3000)
    idx = host_fit(xb)

    def refuse(self):
        raise AssertionError("the host table was gathered")

    monkeypatch.setattr(PostingLayout, "_make_table", refuse)
    with tracing.recording():
        idx.offload_from_host(rerank="host")
        D, _ = idx.search_batch(xq[:600], 10, 8)
    assert "offload.table" in tracing.phase_report()
    assert idx.offloaded and idx.layout.vectors is None and np.isfinite(D[:, 0]).all()


def test_the_tables_owner_reads_no_host_table(monkeypatch):
    """The owner of the device tables takes a host layout's row count from
    its shape, not by gathering the table."""
    xb, _ = corpus(n=3000)
    idx = host_fit(xb)
    monkeypatch.setattr(PostingLayout, "_make_table",
                        lambda self: pytest.fail("the host table was gathered"))
    assert idx.tables().rows == idx.layout.table_shape[0]
    assert idx.layout._pending is not None


def test_the_rerank_reads_the_pass_s_norms(monkeypatch):
    """``DeviceTables.host_norms`` holds the norms the table's pass computed,
    by internal id; the re-rank reads them and never sums over the mirror."""
    xb, xq = corpus(n=3000)
    idx = host_fit(xb)
    idx.offload_from_host(rerank="host")
    norms = idx.tables().host_norms
    assert norms.shape == (len(xb),) and norms.dtype == np.float32
    np.testing.assert_allclose(norms, (xb.astype(np.float64) ** 2).sum(1), rtol=1e-6)
    monkeypatch.setattr(np, "einsum", lambda *a, **k: pytest.fail("einsum over the mirror"))
    D, I = idx.search_batch(xq[:100], 10, 8)
    assert (I >= 0).all()


def test_offload_main_table_s_norms_come_from_the_layout():
    xb, xq = corpus(n=3000)
    store = VectorStore(external_ids=np.arange(len(xb), dtype=np.uint64), vectors=xb)
    idx = IvfIndex.fit(store, seed=42, nlist=NLIST, device="cpu")
    want = idx.layout.row_norms[: idx.layout.rows_used].numpy()
    idx.offload_main_table(rerank="host")
    got = idx.tables().host_norms
    real = idx.layout.perm >= 0
    np.testing.assert_array_equal(got[idx.layout.perm[real]], want[real])


@pytest.mark.parametrize("nq", [600, 200])
def test_the_deployment_matches_the_plain_reference(nq):
    """Host fit on a one-entry mesh, offload with the host re-rank, then
    ``search_batch``: the ids equal the float64 reference's exact top-10
    over the same probed lists wherever the reference's distances are
    apart, the distances are the exact ones within float32, and each call
    gathers nq x 128 rows from the mirror (a 600-query batch in two
    halves)."""
    xb, xq = corpus()
    idx = host_fit(xb)
    idx.offload_from_host(rerank="host")
    k, n_probe = 10, 8
    tracing.reset_phases()
    with tracing.recording():
        D, I = idx.search_batch(xq[:nq], k, n_probe, external=True)
        rows = tracing.counter_report()["offload.rerank_rows"]
        phases = tracing.phase_report()
    tracing.reset_phases()
    assert rows == nq * 128
    halves = 2 if nq >= 512 else 1
    assert all(phases[s]["count"] == halves
               for s in ("offload.sweep", "offload.wait", "offload.rerank"))
    q = torch.as_tensor(xq[:nq])
    labels = torch.as_tensor(port_labels(idx.layout, len(xb)))
    ref_d, ref_i = reference.search_lists(q, torch.as_tensor(xb), labels,
                                          torch.as_tensor(idx.centroids), n_probe, k, "l2",
                                          torch.float64)
    ids = np.where(I >= 0, (I - 5) // 3, -1)  # external ids back to rows
    got = reference.exact(q, torch.as_tensor(xb), torch.as_tensor(ids), "l2").numpy()
    ref_d = ref_d.numpy()
    scale = np.maximum(ref_d[:, -1:], 1e-30)
    np.testing.assert_allclose(D, got, rtol=0, atol=float(2e-5 * scale.max()))
    np.testing.assert_allclose(got, ref_d, rtol=0, atol=float(2e-5 * scale.max()))
    gap = np.diff(ref_d, axis=1) / scale
    apart = np.ones_like(ref_d, bool)
    apart[:, 1:] &= gap > 1e-4
    apart[:, :-1] &= gap > 1e-4
    assert apart.mean() > 0.9
    np.testing.assert_array_equal(ids[apart], ref_i.numpy()[apart])


def test_offload_from_host_rejects_a_device_layout():
    xb, _ = corpus(n=2000)
    store = VectorStore(external_ids=np.arange(len(xb), dtype=np.uint64), vectors=xb)
    idx = IvfIndex.fit(store, seed=42, nlist=16, device="cpu")
    with pytest.raises(RuntimeError, match="offload_main_table"):
        offload.offload_from_host(idx)
