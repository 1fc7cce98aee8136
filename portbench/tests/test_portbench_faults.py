"""The comparison fails what it must: the timed path broken underneath a
run (an answer altered where it is produced; half of a batch left out; an
answer cut after its first rank; half of the lists probed; a Lloyd step
that returns its state unchanged), and the controls (the reference in the
program's place one precision below what the configuration states), each
at the cell's own limits; and it passes the port itself. The run's look for a card is
skipped: the port runs its plain versions on the CPU."""

import numpy as np
import pytest
import torch

from portbench import compare
from vector_indexer_tpu_torch import bindings
from vector_indexer_tpu_torch.models import kmeans

from .conftest import run_tiny

SEARCH_CELLS = ("sift1m.batch-np128", "dbpedia1m.batch-np8", "sift1m.online-np32")


def _size(workload):
    return 4000 if workload.startswith("dbpedia") else 20000


def _seconds(workload, other):
    """One query a call needs a longer window for some tens of calls to be
    judged, on a loaded CPU too."""
    return 2.0 if workload == "sift1m.online-np32" else other


@pytest.mark.parametrize("workload", SEARCH_CELLS + ("sift1m.build",))
def test_the_port_passes(man, workload):
    r = run_tiny(man, workload, n=_size(workload))
    assert r["correct"], r["checks"]


def _altered(orig):
    def search_sync(self, xq, k, n_probe, method="auto"):
        dist, ids = orig(self, xq, k, n_probe, method)
        ids = ids.copy()
        ids[-1, 0] = (ids[-1, 0] + 1) % 1000  # one answer's id, as produced
        return dist, ids
    return search_sync


def _half(orig):
    def search_sync(self, xq, k, n_probe, method="auto"):
        h = max(1, len(xq) // 2)  # answer the first half; repeat it for the rest
        dist, ids = orig(self, xq[:h], k, n_probe, method)
        rep = np.resize(np.arange(h), len(xq))
        return dist[rep], ids[rep]
    return search_sync


def _cut_after_first(orig):
    def search_sync(self, xq, k, n_probe, method="auto"):
        # Rank 1, then ranks k + 1 .. 2k - 1: ids distinct, each with its own
        # distance, ascending; only the whole answer against the reference
        # shows it.
        dist, ids = orig(self, xq, 2 * k, n_probe, method)
        keep = np.r_[0, k + 1:2 * k]
        return dist[:, keep], ids[:, keep]
    return search_sync


# One query a call has no second half to leave out.
BROKEN = [(w, f) for w in SEARCH_CELLS + ("sift1m.build",)
          for f in (_altered, _half, _cut_after_first)
          if not (f is _half and w == "sift1m.online-np32")]


@pytest.mark.parametrize("workload,fault", BROKEN)
def test_a_broken_search_fails(man, monkeypatch, workload, fault):
    monkeypatch.setattr(bindings.VectorIndex, "search_sync",
                        fault(bindings.VectorIndex.search_sync))
    r = run_tiny(man, workload, n=_size(workload))
    assert not r["correct"], r["checks"]


# Where each query's neighbours lie in its own cluster's few lists, as in the
# cells' data, probing half of n_probe lists returns the same answers; on
# thinly clustered data (a centre to every 1-4 vectors, more lists) it does
# not, and the comparison has to see it.
THIN = {"sift1m.batch-np128": (1024, 20000), "dbpedia1m.batch-np8": (64, 1000),
        "sift1m.online-np32": (512, 5000), "sift1m.build": (256, 5000)}


@pytest.mark.parametrize("workload", sorted(THIN))
def test_probing_half_the_lists_fails(man, monkeypatch, workload):
    orig = bindings.VectorIndex.search_sync

    def search_sync(self, xq, k, n_probe, method="auto"):
        return orig(self, xq, k, max(1, n_probe // 2), method)

    nlist, ncent = THIN[workload]
    assert run_tiny(man, workload, n=_size(workload), nlist=nlist, ncent=ncent,
                    seconds=_seconds(workload, 0.5))["correct"]
    monkeypatch.setattr(bindings.VectorIndex, "search_sync", search_sync)
    r = run_tiny(man, workload, n=_size(workload), nlist=nlist, ncent=ncent,
                 seconds=_seconds(workload, 0.5))
    assert not r["correct"], r["checks"]


def test_an_unchanged_lloyd_step_fails(man, monkeypatch):
    def unchanged(data, init_centroids, gen, k, max_iters, tol, chunk, spherical=False):
        return init_centroids.clone(), max_iters, False

    monkeypatch.setattr(kmeans, "_lloyd_loop", unchanged)
    r = run_tiny(man, "sift1m.build")
    assert not r["correct"]
    assert r["checks"]["lloyd_shift"]["value"] > r["checks"]["lloyd_shift"]["limit"]


# bfloat16 throughout is one step below the float32 corpus and centroids; an
# int8 residual table one step below the bfloat16 table that the stream
# routes read (every cell but the dense route's batch-np128). The int8 table
# is held on data of a centre to every 20 vectors (4 for DBpedia's 4,000):
# each list then mixes clusters and its int8 grid is coarser than in the
# cells, so that the few calls a CPU run judges show it. At the cells' own
# size the chip's readings show it (cells/<cell>.json).
CONTROLLED = ([(w, "bf16") for w in SEARCH_CELLS + ("sift1m.build",)]
              + [(w, "int8_table") for w in SEARCH_CELLS[1:] + ("sift1m.build",)])


@pytest.mark.parametrize("workload,kind", CONTROLLED)
def test_the_control_fails(man, monkeypatch, workload, kind):
    """A control answers in the port's place, over the port's own centroid
    table."""
    metric = "cosine" if workload.startswith("dbpedia") else "l2"

    def search_sync(self, xq, k, n_probe, method="auto"):
        idx = self.index
        _, dist, ids = compare.control(torch.as_tensor(idx._host_data), torch.as_tensor(xq),
                                       torch.as_tensor(idx.centroids), n_probe, k, metric,
                                       kind)
        return dist, ids

    monkeypatch.setattr(bindings.VectorIndex, "search_sync", search_sync)
    r = run_tiny(man, workload, n=_size(workload), seconds=_seconds(workload, 0.2),
                 ncent=1000 if kind == "int8_table" else 20)
    assert not r["correct"], r["checks"]


def test_judge():
    limits = {"answers_bad": 0, "dist_err": 1.0}
    assert compare.judge({"answers_bad": 0, "dist_err": 0.5}, limits)[0]
    assert not compare.judge({"answers_bad": 1}, {"answers_bad": 0})[0]
    assert not compare.judge({"nn_gap": 0.0}, {})[0]  # a number without a limit fails
