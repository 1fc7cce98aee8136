"""Closed-loop search over a corpus sharded across the cell's cards: one client
sends ``batch`` queries a call to ``parallel.ShardedSearcher.search_batch(xq,
k, n_probe)`` and waits for the answer before the next call.

Set-up builds the index from the host corpus over a mesh of the cell's cards,
as a deployment whose corpus no card holds builds it
(``IvfIndex.fit(..., mesh=, resident="host", train_sample=)``: the mesh
trains on the configuration's ``train_sample`` rows and assigns every row),
shares the posting lists out over the cards (``ShardedSearcher``, which
returns external ids) and warms the one shape. The build and the share-out
run with the port's spans recording, and their times go to standard error.
The window is ``search_closed_loop``'s: slices of the query pool in a seeded
order, each call's latency from the client's side, the full answers of the
calls at seeded instants.

No card holds the corpus, so the check works in blocks of rows, each card a
range of them (``Bench.corpus_rows``) from a thread of its own: every row's list against
its float64 nearest centroid (``labels64``: ``reference.assign``'s argmin in one
float64 product a block), and the sampled answers against
``reference.search_lists`` of each block in float64, merged over the blocks by
``reference.lowest``. ``control`` reads the controls the same way, with
``reference.assign`` one precision below. The numbers are ``compare``'s; the
driver judges L2 configurations.

``run.py`` pins the process to one core for the window's host clock. Set-up
and the check run on every core the machine gives the process
(``every_core``): the port spreads its host passes over the corpus (the
layout's gather, each card's staging copies) over threads, and the check
drives each card from a thread of its own. The window runs on the one core.
"""

from __future__ import annotations

import contextlib
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from portbench import compare, reference, stats
from portbench.harness import free
from vector_indexer_tpu_torch.utils import tracing

WARM_CALLS = 5
TRACE_SECONDS = 3.0
TRACE_MIN_CALLS = 20
BLOCK_ROWS = 1 << 20  # corpus rows a card takes at a time in the check
ASSIGN_ROWS = 1 << 12  # rows per assignment call: its (rows, nlist) float64 matrix


@contextlib.contextmanager
def every_core():
    """The calling thread, and the threads it starts inside the block, on
    every core the process may use; back on the cores it had after."""
    had = os.sched_getaffinity(0) if hasattr(os, "sched_setaffinity") else None
    if had is not None:
        try:
            os.sched_setaffinity(0, range(os.cpu_count() or 1))
        except OSError:
            pass
    try:
        yield
    finally:
        if had is not None:
            os.sched_setaffinity(0, had)


def setup(b) -> None:
    with every_core():
        _setup(b)


def _setup(b) -> None:
    from vector_indexer_tpu_torch.index.ivf import IvfIndex
    from vector_indexer_tpu_torch.parallel import Mesh, ShardedSearcher
    from vector_indexer_tpu_torch.storage.vector_store import VectorStore

    t, c = b.traffic, b.config
    if c["metric"] != "l2":
        raise ValueError("sharded_closed_loop judges L2 configurations")
    mesh = Mesh(b.devices, ("shards",))
    store = VectorStore(external_ids=np.arange(b.xb.shape[0], dtype=np.uint64), vectors=b.xb)
    pool = b.pool.shape[0]
    starts = np.arange(0, pool - t["batch"] + 1, t["batch"])
    b.state["order"] = starts[b.rng.permutation(len(starts))]
    with tracing.recording():
        t0 = time.perf_counter()
        b.index = IvfIndex.fit(store, seed=42, nlist=c["nlist"], metric=c["metric"], mesh=mesh,
                               resident="host", train_sample=c["train_sample"],
                               device=b.device)
        t1 = time.perf_counter()
        b.state["searcher"] = ShardedSearcher(b.index, mesh, method=t["method"])
        t2 = time.perf_counter()
        for i in range(WARM_CALLS):
            s = b.state["order"][i % len(starts)]
            b.state["searcher"].search_batch(b.pool[s:s + t["batch"]], t["k"], t["n_probe"])
        t3 = time.perf_counter()
    spans = {name: round(p["total_s"], 3) for name, p in tracing.phase_report().items()
             if name.startswith(("fit", "sharded.pack", "sharded.upload", "sharded.stream"))}
    print(f"sharded setup: fit {t1 - t0:.3f} s, ShardedSearcher {t2 - t1:.3f} s, warm calls "
          f"{t3 - t2:.3f} s, body {b.state['searcher'].last_method}, cores "
          f"{len(os.sched_getaffinity(0))}; spans {spans}", file=sys.stderr, flush=True)
    tracing.reset_phases()  # the window's traced calls alone fill the registry


def window(b) -> dict:
    t, ss, order = b.traffic, b.state["searcher"], b.state["order"]
    batch, k, n_probe = t["batch"], t["k"], t["n_probe"]
    # Instants in the window whose next call's full answer is judged.
    keep_at = np.sort(b.rng.random(-(-t["check_queries"] // batch))) * b.seconds
    lat, top10, starts, sample = [], [], [], []
    tw = b.trace_window(TRACE_SECONDS, TRACE_MIN_CALLS)
    j = 0
    t0 = time.perf_counter()
    now = t0
    while now - t0 < b.seconds or tw.active:
        tw.step(now - t0)
        s = int(order[len(starts) % len(order)])
        with tw.annotate("request"):
            c0 = time.perf_counter()
            dist, ids = ss.search_batch(b.pool[s:s + batch], k, n_probe)
            now = time.perf_counter()
        lat.append(now - c0)
        starts.append(s)
        top10.append(ids[:, :10].copy())
        if j < len(keep_at) and now - t0 > keep_at[j]:
            sample.append((s, dist, ids))
            j = int(np.searchsorted(keep_at, now - t0, side="right"))
    elapsed = now - t0
    tw.stop()
    calls = len(starts)
    e2e = {"qps": stats.qps(calls * batch, elapsed), "p95_ms": stats.p95_ms(lat)}
    if b.gt is not None:
        rec = [stats.recall_at(ids, b.gt[s:s + batch], 10) for s, ids in zip(starts, top10)]
        e2e["recall_at_10"] = float(np.concatenate(rec).mean() * 100.0)
    failed = sum(int((ids < 0).any(axis=1).sum()) for ids in top10)
    return {"e2e": e2e, "attempted": calls * batch, "failed": failed, "trace": tw.summary,
            "sample": sample, "requests": calls, "body": ss.last_method}


def release(b) -> None:
    """Keep what the comparison needs of the port's state (its centroid table
    and its lists), dropping the searcher and the index."""
    b.state["centroids"] = np.array(b.index.centroids, dtype=np.float32)
    lay = b.index.layout
    b.state.pop("searcher", None)
    b.index = None
    free(*b.devices)
    b.state["labels"] = port_lists(lay, b.xb.shape[0], b.device)


def port_lists(lay, n: int, dev) -> np.ndarray:
    """``harness.port_labels`` worked out on ``dev``: (n,) the list of each
    corpus row in the port's layout ``lay``, -1 for a row in no list (200M
    rows take numpy one core ~10 s)."""
    i64 = torch.int64
    lengths = torch.as_tensor(np.asarray(lay.lengths, np.int64), device=dev)
    starts = torch.as_tensor(np.asarray(lay.offsets[:-1], np.int64), device=dev)
    m = int(lengths.sum())
    lists = torch.repeat_interleave(torch.arange(len(lengths), device=dev), lengths,
                                    output_size=m)
    first = (torch.cumsum(lengths, 0) - lengths)[lists]
    rows = starts[lists].add_(torch.arange(m, dtype=i64, device=dev)).sub_(first)
    del first
    out = torch.full((n,), -1, dtype=i64, device=dev)
    out[torch.as_tensor(np.asarray(lay.perm), device=dev)[rows]] = lists
    return out.cpu().numpy()


def _on_cards(b, fn) -> list:
    """[fn(c) for each of the cell's cards c], each in a thread of its own
    with card c current: a thread that waits on its card (a full launch
    queue, a copy) leaves the other cards working. The CPU's slots (the
    tests') run in turn."""
    if b.device.type != "cuda":
        return [fn(c) for c in range(len(b.devices))]

    def run(c):
        with torch.cuda.device(b.devices[c]):
            return fn(c)

    with ThreadPoolExecutor(len(b.devices)) as pool:
        return list(pool.map(run, range(len(b.devices))))


def _blocks(b, c):
    """(start, end) of card c's blocks of corpus rows: of the m cards, card c
    takes rows [n c / m, n (c+1) / m), a block at a time."""
    n, m = b.xb.shape[0], len(b.devices)
    lo, hi = n * c // m, n * (c + 1) // m
    return [(s, min(s + BLOCK_ROWS, hi)) for s in range(lo, hi, BLOCK_ROWS)]


def _assign(x, centroids, dtype):
    """``reference.assign`` of the rows ``x`` in calls of ASSIGN_ROWS rows."""
    return torch.cat([reference.assign(x[s:s + ASSIGN_ROWS], centroids, "l2", dtype)
                      for s in range(0, x.shape[0], ASSIGN_ROWS)])


def augmented(centroids) -> torch.Tensor:
    """(nlist, w) float64 [-2 c, |c|^2, 0...] of every centroid c, for
    ``labels64``: w is d + 1 rounded up to 8, zero past |c|^2 (the float64
    tensor-core products take widths in steps of 8)."""
    c = centroids.to(torch.float64)
    d = c.shape[1]
    out = torch.zeros((c.shape[0], -(-(d + 1) // 8) * 8), dtype=torch.float64, device=c.device)
    out[:, :d] = c * -2.0
    out[:, d] = (c * c).sum(1)
    return out


def labels64(x, caug) -> torch.Tensor:
    """(rows,) int64 float64 nearest centroid of the rows ``x`` under squared
    L2, in calls of ASSIGN_ROWS rows: argmin over c of |c|^2 - 2 x.c, as the
    one float64 product [x, 1, 0...] [-2 c, |c|^2, 0...]^T (``caug``,
    ``augmented``). A row's own |x|^2 moves no argmin, so this is
    ``reference.assign``'s argmin in float64; its (rows, nlist) matrix is
    written and read once, where the norm expansion's passes read it eight
    times, which at 200M rows and nlist 56,572 took most of a card's check."""
    n, d = x.shape
    out = torch.empty(n, dtype=torch.int64, device=x.device)
    xa = torch.zeros((min(ASSIGN_ROWS, n), caug.shape[1]), dtype=torch.float64, device=x.device)
    xa[:, d] = 1.0
    for s in range(0, n, ASSIGN_ROWS):
        m = min(ASSIGN_ROWS, n - s)
        xa[:m, :d] = x[s:s + m]
        out[s:s + m] = torch.mm(xa[:m], caug.T).argmin(1)
    return out


def _pass(b, q, centroids, n_probe, k, kind):
    """One pass over the corpus blocks for the judged part ``kind``:
    "program" (the reference lists in float64, against the port's),
    "bf16" (the reference in bfloat16 throughout) or "int8_table" (the
    float64 lists, rows as an int8 residual table holds them). Returns (the
    share of rows whose list differs from the float64 reference's, the
    part's top-k over the probed lists of ``q``: distances (nq, k) float64,
    ids (nq, k)). The pass for "program" keeps the float64 lists, which the
    controls' passes read. Each card works through its own range of rows,
    and nothing is read back until its range is done."""
    n, devs = b.xb.shape[0], b.devices
    dtype = torch.bfloat16 if kind == "bf16" else torch.float64

    def ref_labels(s, e, dev):
        return torch.as_tensor(b.state["ref_labels"][s:e], device=dev).long()

    scales = None
    if kind == "int8_table":  # one scale a list, over every row of it
        def card_scales(c):
            dev, cents = devs[c], centroids.to(devs[c])
            smax = torch.zeros(centroids.shape[0], device=dev)
            for s, e in _blocks(b, c):
                smax = torch.maximum(smax, reference.int8_scales(
                    b.corpus_rows(s, e, dev), ref_labels(s, e, dev), cents, "l2"))
            return smax

        scales = torch.stack([m.to(devs[0]) for m in _on_cards(b, card_scales)]).amax(0)

    def card_pass(c):
        dev, cents, qc = devs[c], centroids.to(devs[c]), q.to(devs[c])
        caug = augmented(cents) if kind == "program" else None
        best_d = torch.empty((q.shape[0], 0), dtype=torch.float64, device=dev)
        best_i = torch.empty((q.shape[0], 0), dtype=torch.int64, device=dev)
        diff = torch.zeros((), dtype=torch.int64, device=dev)
        kept = []  # the program pass's float64 lists: (start, end, lists)
        for s, e in _blocks(b, c):
            x = b.corpus_rows(s, e, dev)
            if kind == "int8_table":
                lab = ref_labels(s, e, dev)
                rows = reference.int8_rows(x, lab, cents, scales.to(dev), "l2", torch.float64)
            else:
                lab = labels64(x, caug) if kind == "program" else _assign(x, cents, dtype)
                rows = x
                ours = (torch.as_tensor(b.state["labels"][s:e], device=dev) if kind == "program"
                        else ref_labels(s, e, dev))
                diff += (lab != ours).sum()
            if kind == "program":
                kept.append((s, e, lab.to(torch.int32)))
            bd, bi = reference.search_lists(qc, rows, lab, cents, n_probe, k, "l2", dtype)
            bi = torch.where(bi >= 0, bi + s, -1)
            best_d, best_i = reference.lowest(torch.cat([best_d, bd], 1),
                                              torch.cat([best_i, bi], 1), k)
        return best_d, best_i, int(diff), [(s, e, lab.cpu().numpy()) for s, e, lab in kept]

    outs = _on_cards(b, card_pass)
    if kind == "program":
        b.state["ref_labels"] = np.empty(n, np.int32)
        for s, e, lab in (part for out in outs for part in out[3]):
            b.state["ref_labels"][s:e] = lab
    root = devs[0]
    dist, ids = reference.lowest(torch.cat([out[0].to(root) for out in outs], 1),
                                 torch.cat([out[1].to(root) for out in outs], 1), k)
    dist = torch.where(ids >= 0, dist, float("inf"))
    return sum(out[2] for out in outs) / n, dist, ids


def _numbers(b, q, ref_d, dist, ids, membership) -> dict:
    """``compare.answer_numbers``' numbers of answers (``dist``, ``ids``, each
    (nq, k) numpy) given the reference's top-k distances ``ref_d``, and
    ``membership_diff``: the rows of the returned ids come from the host."""
    dev = q.device
    n = b.xb.shape[0]
    ids_t = torch.as_tensor(ids, device=dev)
    valid = (ids_t >= 0) & (ids_t < n)
    safe = np.where((ids >= 0) & (ids < n), ids, -1)
    uniq = np.unique(safe[safe >= 0])
    sub = torch.as_tensor(b.xb[uniq], device=dev)
    local = torch.as_tensor(np.where(safe >= 0, np.searchsorted(uniq, safe), -1), device=dev)
    got = reference.exact(q, sub, local, "l2")
    sc = reference.scale(q, sub, ref_d, "l2")[:, None]
    d_t = torch.as_tensor(dist, dtype=torch.float64, device=dev)
    err = torch.where(valid & torch.isfinite(d_t), (d_t - got).abs() / sc, 0.0)
    first = torch.where(valid[:, 0], got[:, 0], float("inf"))
    gap = ((first - ref_d[:, 0]) / sc[:, 0]).clamp_min(0.0)
    return dict(answers_bad=compare.answers_bad(dist, ids, n), dist_err=float(err.max()),
                nn_gap=float(gap.max()),
                top10_miss=compare.topk_miss(got[:, :10], ref_d[:, :10], sc[:, 0]),
                kth_gap=compare.kth_gap(got, ref_d, sc[:, 0]), membership_diff=membership)


def _sampled(b, win):
    starts = [s for s, _, _ in win["sample"]]
    batch = win["sample"][0][1].shape[0]
    return b.queries(np.concatenate([np.arange(s, s + batch) for s in starts]))


def check(b, win) -> dict:
    t = b.traffic
    t0 = time.perf_counter()
    with every_core():
        q = _sampled(b, win)
        centroids = torch.as_tensor(b.state["centroids"], device=b.device)
        membership, ref_d, _ = _pass(b, q, centroids, t["n_probe"], t["k"], "program")
        b.state["ref_d"] = ref_d
        out = _numbers(b, q, ref_d, np.concatenate([d for _, d, _ in win["sample"]]),
                       np.concatenate([i for _, _, i in win["sample"]]), membership)
    print(f"sharded check: {time.perf_counter() - t0:.3f} s", file=sys.stderr, flush=True)
    return out


def control(b, win) -> dict:
    """Each control's numbers (``compare.CONTROLS``) over the port's centroid
    table and the same sampled queries, after ``check`` (whose float64 lists
    and top-k it reuses): the readings behind each limit; runs never call
    it."""
    t = b.traffic
    q = _sampled(b, win)
    centroids = torch.as_tensor(b.state["centroids"], device=b.device)
    ref_d = b.state["ref_d"]
    out = {}
    for kind in compare.CONTROLS:
        membership, dist, ids = _pass(b, q, centroids, t["n_probe"], t["k"], kind)
        out[kind] = _numbers(b, q, ref_d, dist.float().cpu().numpy(), ids.cpu().numpy(),
                             membership)
    return out
