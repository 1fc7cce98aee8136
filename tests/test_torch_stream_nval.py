"""K2 (per-task stream distances) with the slots' valid counts, on the CPU:
``stream_distances(_reference)(..., nval2d=...)`` is the every-lane output
masked past each slot's count, in every row type and metric;
``block_stream_search`` (which now passes ``nval2d``) returns what the
every-lane plane masked by hand returned; and K2's launch plan
(csrc/block_stream.cu checks what ``stream_distances_plan`` gives it)."""

import numpy as np
import pytest
import torch
from torch_parity import t

from benchmarks.datasets import clustered
from vector_indexer_tpu_torch.index.ivf import IvfIndex
from vector_indexer_tpu_torch.ops import block_stream as bs
from vector_indexer_tpu_torch.ops.topk import topk_smallest
from vector_indexer_tpu_torch.storage.vector_store import VectorStore

DTYPES = [torch.bfloat16, torch.int8, torch.float32]


@pytest.fixture(scope="module")
def index():
    xb, xq = clustered(3000, 32, 12, seed=3, ncent=12)
    store = VectorStore(external_ids=np.arange(len(xb), dtype=np.uint64), vectors=xb)
    return IvfIndex.fit(store, seed=1, nlist=24, max_iters=4, device="cpu"), xq


def _grid(index, dtype, metric, n_probe=3):
    idx, xq = index
    table = bs.build_stream_table(idx.layout, idx.centroids, dtype, chunk=256)
    q = t(xq)
    c = t(idx.centroids)
    d2 = ((q[:, None, :] - c[None]) ** 2).sum(-1)
    probe = torch.argsort(d2, dim=1, stable=True)[:, :n_probe]
    t_fixed = bs.per_query_slots(idx.layout.lengths, n_probe, worst_case=True, chunk=table.chunk)
    return q, table, bs.build_task_grid(q, table, probe, t_fixed, metric)


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "int8", "f32"])
def test_nval_masks_the_every_lane_output(index, dtype, metric):
    q, table, (blk, cid, nval, bias) = _grid(index, dtype, metric)
    assert (nval == 0).any() and ((nval > 0) & (nval < table.chunk)).any()  # both kinds of slot
    args = (q, table.cent, cid, blk, bias, table.vecs, table.norms)
    kw = dict(chunk=table.chunk, metric=metric, scales=table.scales)
    every = bs.stream_distances_reference(*args, **kw)
    lane = torch.arange(table.chunk)
    masked = torch.where(lane[None, None, :] < nval[:, :, None], every, float("inf"))
    got = bs.stream_distances_reference(*args, **kw, nval2d=nval)
    assert torch.equal(got, masked)
    assert torch.isinf(got[nval == 0]).all()  # an empty slot is all +inf
    assert torch.isfinite(got[lane[None, None, :].expand_as(got) < nval[:, :, None]]).all()
    # The wrapper on a CPU tensor is the plain version, with and without.
    assert torch.equal(bs.stream_distances(*args, **kw, nval2d=nval), got)
    assert torch.equal(bs.stream_distances(*args, **kw), every)


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "int8", "f32"])
def test_search_equals_the_hand_masked_plane(index, dtype, metric):
    q, table, (blk, cid, nval, bias) = _grid(index, dtype, metric)
    nq, t_fixed = blk.shape
    idx, _ = index
    c = t(idx.centroids)
    d2 = ((q[:, None, :] - c[None]) ** 2).sum(-1)
    probe = torch.argsort(d2, dim=1, stable=True)[:, :3]
    k = 20
    D, R = bs.block_stream_search(q, table, probe, k, t_fixed=t_fixed, metric=metric,
                                  fused=False)
    every = bs.stream_distances_reference(q, table.cent, cid, blk, bias, table.vecs,
                                          table.norms, chunk=table.chunk, metric=metric,
                                          scales=table.scales)
    lane = torch.arange(table.chunk)
    every = torch.where(lane[None, None, :] < nval[:, :, None], every, float("inf"))
    dv, ci = topk_smallest(every.reshape(nq, t_fixed * table.chunk), k)
    rD, rR = bs._rows_of(dv, ci, blk, table)
    assert torch.equal(D, rD) and torch.equal(R, rR)


@pytest.mark.parametrize("itemsize", [1, 2, 4])
def test_plan_covers_every_row(itemsize):
    epc = 16 // itemsize
    for d in list(range(1, 70)) + [96, 100, 128, 255, 256, 512, 768, 1024, 1100, 1536, 2048,
                                   4096, 12288]:
        for t_fixed, chunk in ((1, 256), (16, 256), (48, 1024)):
            plan = bs.stream_distances_plan(d, itemsize, t_fixed, chunk)
            cpr = -(-d // epc)
            if plan is None:  # past 128 chunks: the split launch
                assert cpr > bs.K2_MAX_CHUNKS
                assert bs.stream_distances_split_plan(d, itemsize, chunk, 16, t_fixed, 132)
                continue
            lpr, spb, smem = plan
            assert lpr in (1, 2, 4, 8, 16, 32)
            assert lpr * 4 >= cpr and (lpr == 1 or (lpr // 2) * 4 < cpr)  # fewest lanes
            assert 1 <= spb <= min(bs.K2_SLOTS_PER_BLOCK, t_fixed)
            # The kernel's shared memory: q - c (the whole padded row) and
            # the distances of each slot.
            assert smem == 4 * spb * (cpr * epc + chunk) <= 227 * 1024
    # The main path's rows (d 128): 4 lanes per bf16 row, 2 per int8 row, 8 per f32 row.
    assert bs.stream_distances_plan(128, 2, 16, 256) == (4, 4, 6144)
    assert bs.stream_distances_plan(128, 1, 16, 256) == (2, 4, 6144)
    assert bs.stream_distances_plan(128, 4, 16, 256) == (8, 4, 6144)
    assert bs.stream_distances_plan(2048, 2, 16, 256) is None
