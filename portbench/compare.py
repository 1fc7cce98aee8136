"""The comparison that decides ``correct``: the numbers compared, and their limits.

Each number is worked out from what the timed path returned, against the
plain reference (``reference.py``) in float64:

* ``answers_bad``: answers with an id outside the corpus or -1, an id twice,
  a distance that is not finite, or distances out of ascending order (exact:
  limit 0);
* ``dist_err``: the widest gap between a returned distance and the exact
  distance of the id returned with it, over the query's scale
  (``reference.scale``);
* ``nn_gap``: the widest gap by which a query's first answer lies above the
  nearest vector of its probed lists, over the query's scale (the coarse
  quantizer, the list scan and the top-k together);
* ``top10_miss``: the answer's first 10 ranks against the exact top-10 over
  the probed lists: the mean, over the queries, of the share of that top-10
  with no returned row among the first 10 as near (a row counts as found
  where its exact distance is at most the reference's 10th, so exact ties
  count either way);
* ``kth_gap``: the answer's last rank: the mean, over the queries, of how
  far the exact distance of the answer's k-th nearest row lies above the
  reference's k-th, over the query's scale (with ``top10_miss``, the whole
  answer: a top-k that drops or swaps rows past rank 10, or stops early,
  moves it);
* ``membership_diff``: the share of corpus vectors whose list in the index
  is not their nearest centroid;
* ``lloyd_shift`` (builds only): ``reference.lloyd_shift`` of the trained
  centroid table.

The same numbers of the controls (``control``: the reference in the
program's place, one precision below what the configuration states) set
each limit's upper reading.
"""

from __future__ import annotations

import numpy as np
import torch

from . import reference as ref

TIE = 1e-9  # a distance within this share of the scale of the k-th counts as a tie


def answers_bad(dist: np.ndarray, ids: np.ndarray, n: int) -> int:
    """Rows of a (nq, k) answer with a bad id, a repeated id, a distance that
    is not finite or distances out of ascending order."""
    bad = (ids < 0).any(1) | (ids >= n).any(1) | ~np.isfinite(dist).all(1)
    bad |= (np.diff(dist, axis=1) < 0).any(1)
    srt = np.sort(ids, axis=1)
    bad |= (srt[:, 1:] == srt[:, :-1]).any(1)
    return int(bad.sum())


def answer_numbers(x: torch.Tensor, q: torch.Tensor, dist: np.ndarray, ids: np.ndarray,
                   centroids: torch.Tensor, labels: torch.Tensor, n_probe: int, k: int,
                   metric: str) -> dict:
    """``answers_bad``, ``dist_err``, ``nn_gap``, ``top10_miss`` and ``kth_gap`` of answers
    (``dist``, ``ids``, each (nq, k)) to queries ``q``, judged against the
    float64 reference over the lists ``labels`` of ``centroids``."""
    dev = x.device
    ref_d, _ = ref.search_lists(q, x, labels, centroids, n_probe, k, metric, torch.float64)
    ids_t = torch.as_tensor(ids, device=dev)
    valid = (ids_t >= 0) & (ids_t < x.shape[0])
    got = ref.exact(q, x, torch.where(valid, ids_t, -1), metric)
    sc = ref.scale(q, x, ref_d, metric)[:, None]
    d_t = torch.as_tensor(dist, dtype=torch.float64, device=dev)
    err = torch.where(valid & torch.isfinite(d_t), (d_t - got).abs() / sc, 0.0)
    first = torch.where(valid[:, 0], got[:, 0], float("inf"))
    gap = ((first - ref_d[:, 0]) / sc[:, 0]).clamp_min(0.0)
    return dict(answers_bad=answers_bad(dist, ids, x.shape[0]),
                dist_err=float(err.max()), nn_gap=float(gap.max()),
                top10_miss=topk_miss(got[:, :10], ref_d[:, :10], sc[:, 0]),
                kth_gap=kth_gap(got, ref_d, sc[:, 0]))


def kth_gap(got: torch.Tensor, ref_d: torch.Tensor, sc: torch.Tensor) -> float:
    """Mean over queries of how far the answer's k-th exact distance lies
    above the reference's k-th, over the scale."""
    kq = torch.isfinite(ref_d).sum(1)
    pos = (kq - 1).clamp_min(0)[:, None]
    gap = (got.sort(dim=1).values.gather(1, pos) - ref_d.gather(1, pos))[:, 0] / sc
    return float(torch.where(kq > 0, gap.clamp(0.0, 1e6), 0.0).mean())


def topk_miss(got: torch.Tensor, ref_d: torch.Tensor, sc: torch.Tensor) -> float:
    """Mean over queries of the share of the reference's top-k (``ref_d``,
    (nq, k), +inf past its candidates) not matched by a returned row whose
    exact distance (``got``, (nq, k)) is at most the reference's k-th."""
    kq = torch.isfinite(ref_d).sum(1)
    kth = ref_d.gather(1, (kq - 1).clamp_min(0)[:, None])
    found = (got <= kth + TIE * sc[:, None]).sum(1).clamp(max=kq)
    miss = torch.where(kq > 0, 1.0 - found / kq.clamp_min(1), 0.0)
    return float(miss.mean())


def membership_diff(ref_labels: torch.Tensor, labels: torch.Tensor) -> float:
    """Share of corpus rows whose list differs from the reference's."""
    return float((ref_labels != labels.to(ref_labels.device)).double().mean())


CONTROLS = ("bf16", "int8_table")


def control(x: torch.Tensor, q: torch.Tensor, centroids: torch.Tensor, n_probe: int, k: int,
            metric: str, kind: str):
    """A control in the program's place: (its lists of the corpus, its
    answers' distances (nq, k), ids (nq, k)) as numpy arrays for the
    answers. ``kind`` "bf16" is the reference in bfloat16 throughout (one
    step below the float32 corpus and centroids); "int8_table" keeps the
    float64 lists and reads the rows from an int8 residual table (one step
    below the bfloat16 residual table of the stream routes)."""
    if kind == "bf16":
        labels = ref.assign(x, centroids, metric, torch.bfloat16)
        dist, ids = ref.search_lists(q, x, labels, centroids, n_probe, k, metric,
                                     torch.bfloat16)
    else:
        labels = ref.assign(x, centroids, metric, torch.float64)
        dist, ids = ref.search_lists(q, x, labels, centroids, n_probe, k, metric,
                                     torch.float64, table="int8")
    return labels, dist.float().cpu().numpy(), ids.cpu().numpy()


def worst(numbers: list) -> dict:
    """Each number's worst reading over several judged parts (builds)."""
    return {key: max(n[key] for n in numbers) for key in numbers[0]}


def judge(numbers: dict, limits: dict) -> tuple:
    """(correct, [(name, value, limit)]): every number at or under its limit
    (an exact number, limit 0, must read 0); a number without a limit fails."""
    rows, ok = [], True
    for name, value in numbers.items():
        limit = limits.get(name)
        ok &= limit is not None and value <= limit
        rows.append((name, value, limit))
    return bool(ok), rows
