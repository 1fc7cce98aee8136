"""The id map of ``IvfIndex.search_batch`` on a device-resident index: one
gather through a cached device row table (``DeviceTables.row_internal`` for
internal ids, ``row_external`` for external ones) gives, bit for bit, what the
host pair ``internal_to_external(rows_to_internal(rows))`` gives (and
``rows_to_internal`` alone without ``external``): -1 on no result and on
gap rows, external ids at or above 2**63 wrapped to int64 as numpy's cast
wraps them, on fitted, loaded, spilled and offloaded ('none') indexes; and
the table follows the layout and the id column it was built from."""

import dataclasses

import numpy as np
import pytest
import torch
from conftest import make_gaussian_clusters

from vector_indexer_tpu_torch.index.ivf import IvfIndex, load_index_from
from vector_indexer_tpu_torch.storage.vector_store import VectorStore

KINDS = ["fitted", "loaded", "spilled", "offloaded"]
K, N_PROBE = 128, 1  # wider than a probed list: every result row ends in -1s


def _ids(which: str, n: int) -> np.ndarray:
    if which == "arange":
        return np.arange(n, dtype=np.uint64)
    g = np.random.default_rng(5)
    ids = g.integers(0, 2**64 - 1, size=n, dtype=np.uint64)
    ids[:3] = [2**63 - 1, 2**63, 2**64 - 2]  # both sides of int64's wrap
    return g.permutation(ids)


@pytest.fixture(scope="module")
def corpus():
    data, _, _ = make_gaussian_clusters(12, 100, 16, spread=0.5, separation=6.0)
    return data, data[::37] + 0.05


@pytest.fixture(scope="module")
def indexes(corpus, tmp_path_factory):
    """(kind, ids) -> index, built on first use."""
    data, _ = corpus
    built = {}

    def get(kind: str, which: str) -> IvfIndex:
        if (kind, which) not in built:
            store = VectorStore(external_ids=_ids(which, len(data)), vectors=data)
            idx = IvfIndex.fit(store, seed=3, nlist=24, spill=int(kind == "spilled"),
                               device="cpu")
            if kind == "loaded":
                wd = tmp_path_factory.mktemp(f"ids_{which}")
                idx.save_to(wd / "index", wd / "shards")
                idx = load_index_from(wd / "index", wd / "shards", device="cpu")
            elif kind == "offloaded":
                idx.offload_main_table(rerank="none")
            built[kind, which] = idx
        return built[kind, which]

    return get


def _host_pair(idx: IvfIndex, rows: np.ndarray, external: bool) -> np.ndarray:
    internal = idx.rows_to_internal(rows)
    return idx.internal_to_external(internal) if external else internal


@pytest.mark.parametrize("external", [True, False])
@pytest.mark.parametrize("which", ["arange", "wide"])
@pytest.mark.parametrize("kind", KINDS)
def test_device_map_matches_host_pair(indexes, corpus, kind, which, external):
    idx = indexes(kind, which)
    lay = idx.layout
    assert (lay.perm[: lay.rows_used] < 0).any()  # the layout has gap rows
    # Every used row (gaps among them) and no-result rows, through the table.
    rows = np.concatenate([np.arange(lay.rows_used), np.full(8 - lay.rows_used % 8 + 8, -1)])
    rows = rows.reshape(-1, 8)
    table = idx.tables().row_external if external else idx.tables().row_internal
    got = table[torch.as_tensor(rows)].numpy()
    want = _host_pair(idx, rows, external)
    assert got.dtype == want.dtype == np.int64
    np.testing.assert_array_equal(got, want)
    assert (got == -1).sum() > 16  # gap rows as well as the no-result rows
    if external and which == "wide":
        assert (got < -1).any()  # ids past 2**63 wrapped as the host cast wraps them

    # search_batch maps the program's own rows as the host pair did.
    _, xq = corpus
    dv, rv = idx.search_batch_device(xq, K, N_PROBE)
    D, ids = idx.search_batch(xq, K, N_PROBE, external=external)
    np.testing.assert_array_equal(D, dv.numpy())
    np.testing.assert_array_equal(ids, _host_pair(idx, rv.numpy(), external))
    assert (ids == -1).any() and (ids != -1).any()


@pytest.mark.parametrize("event", ["new_ids", "new_layout", "to_host_resident"])
def test_id_table_follows_layout_and_ids(corpus, event):
    data, xq = corpus
    store = VectorStore(external_ids=_ids("wide", len(data)), vectors=data)
    idx = IvfIndex.fit(store, seed=3, nlist=24, device="cpu")
    first = idx.tables().row_external
    assert idx.tables().row_external is first  # cached
    if event == "to_host_resident":
        idx.tables().row_internal
        idx.to_host_resident()
        assert idx._tables is None
        _, ids = idx.search_batch(xq, 10, 4, external=True)  # staged: mapped on the host
        assert "row_external" not in vars(idx.tables()) and (ids >= 0).any()
        return
    if event == "new_ids":  # fit and load assign a new id column
        idx.external_ids = idx.external_ids + np.uint64(7)
    else:  # and a new layout object
        idx.layout = dataclasses.replace(idx.layout)
    table = idx.tables().row_external
    assert table is not first
    _, rv = idx.search_batch_device(xq, K, N_PROBE)
    _, ids = idx.search_batch(xq, K, N_PROBE, external=True)
    np.testing.assert_array_equal(ids, _host_pair(idx, rv.numpy(), True))
