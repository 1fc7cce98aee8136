"""One run of one cell: the flow every cell shares, driven by data.

``run_cell`` reads the cell's configuration (``configs/<config>.json``),
traffic mix (``traffic/<mix>.json``) and limits (``cells/<cell>.json``),
draws the inputs from the seed, hands them to the traffic's driver
(``drivers/<driver>.py``: ``setup``, ``window``, ``release``, ``check``),
reads the cell's per-layer metrics (``metrics/<metric>.py``: ``read(ctx)``)
in a traced run, and returns the result line. Adding a configuration, a mix,
a driver or a metric adds a file; nothing here names one.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from . import compare, datagen, reference

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "vector_indexer_tpu")
TRACE_START = 0.3  # share of the window before the trace starts


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def cell_of(man: dict, workload: str) -> dict:
    for cell in man["workloads"]:
        if cell["name"] == workload:
            return cell
    raise SystemExit(f"unknown workload {workload!r}: BENCHMARK.json names "
                     f"{[c['name'] for c in man['workloads']]}")


def config_of(man: dict, name: str) -> dict:
    for cfg in man["configs"]:
        if cfg["name"] == name:
            return load_json(ROOT / cfg["file"])
    raise SystemExit(f"unknown config {name!r}")


def load_module(kind: str, name: str):
    """``portbench/<kind>/<name>.py`` as a module (names may hold dots)."""
    path = HERE / kind / f"{name}.py"
    if not path.is_file():
        raise SystemExit(f"no {kind[:-1]} file {path}")
    spec = importlib.util.spec_from_file_location(f"portbench_{kind}_{name.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metrics_of(man: dict, section: str, workload: str) -> list:
    """The manifest's ``section`` metrics that ``workload`` reports: those
    listing it, and those without a list whose end-to-end metric it reports."""
    e2e = {m["name"] for m in man["end_to_end"]
           if "workloads" not in m or workload in m["workloads"]}
    out = []
    for m in man[section]:
        if "workloads" in m:
            if workload in m["workloads"]:
                out.append(m)
        elif section == "end_to_end" or m["moves"] in e2e:
            out.append(m)
    return out


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name (before the first dot) is JAX's,
    jaxlib's, flax's or the JAX package's, compared whole."""
    modules = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in modules} & set(FORBIDDEN))


def cell_devices(device: torch.device, chips: int) -> list:
    """The cell's ``chips`` devices: cards ``cuda:0`` on, where ``device`` is a
    card; otherwise ``device`` once a chip (the CPU tests' slots)."""
    if device.type == "cuda":
        return [torch.device("cuda", i) for i in range(chips)]
    return [device] * chips


class Bench:
    """What a driver works with: the cell's data, its inputs and the window.
    ``device`` is the first of ``devices``, the cell's cards."""

    def __init__(self, workload: str, config: dict, traffic: dict, seed: int, seconds: float,
                 trace: bool, devices: list):
        self.workload, self.config, self.traffic = workload, config, traffic
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.devices, self.device = devices, devices[0]
        self.rng = np.random.default_rng(seed % (2**63))
        self.xb = None  # host corpus (n, d) float32: what the port builds from
        self.pool = None  # host query pool (nq, d) float32
        self.gt = None  # (nq, 10) int64 exact top-10 of the pool, when the mix needs it
        self.index = None  # the port's IvfIndex, while it lives
        self.state = {}  # the traffic driver's own

    def draw(self) -> None:
        """The corpus and the query pool from the seed, drawn on the device;
        the exact top-10 of every pool query when the mix asks for it. A
        configuration with ``"corpus": "host"`` has its corpus drawn into host
        memory a chunk at a time and its top-10 streamed over ``devices``, so
        that no card holds the whole corpus."""
        c = self.config
        host = c.get("corpus") == "host"
        params = {k: v for k, v in c["generator"].items() if k != "kind"}
        if host:
            params["host"] = True
        xb, xq = getattr(datagen, c["generator"]["kind"])(
            c["n"], c["d"], c["query_pool"], self.seed, device=self.device, **params)
        if self.traffic.get("ground_truth"):
            if host:
                gt = reference.ground_truth_streamed(xb, xq, c["metric"], 10, self.devices)
            else:
                gt = reference.ground_truth(xb, xq, c["metric"], 10)
            self.gt = gt.cpu().numpy()
        self.xb = xb.cpu().numpy()
        self.pool = xq.cpu().numpy()
        del xb, xq
        free(*self.devices)

    def build(self):
        """The port's ``IvfIndex.fit`` of the host corpus, as the public API
        builds (seed 42, the configuration's metric and nlist); no save."""
        from vector_indexer_tpu_torch.index.ivf import IvfIndex
        from vector_indexer_tpu_torch.storage.vector_store import VectorStore

        store = VectorStore(external_ids=np.arange(self.xb.shape[0], dtype=np.uint64),
                            vectors=self.xb)
        return IvfIndex.fit(store, seed=42, nlist=self.config["nlist"],
                            metric=self.config["metric"], device=self.device)

    def serving(self, index):
        """The public numpy-in, numpy-out handle over an index the harness
        built (``VectorIndex.search_sync``)."""
        from vector_indexer_tpu_torch.api import VectorIndexer, VectorIndexerConfig
        from vector_indexer_tpu_torch.bindings import VectorIndex

        cfg = VectorIndexerConfig(self.config["d"], metric=self.config["metric"],
                                  device=str(self.device))
        return VectorIndex(VectorIndexer(cfg, _index=index))

    def trace_window(self, length_s: float, min_steps: int, **hooks):
        from .devtrace import TraceWindow

        return TraceWindow(self.trace, TRACE_START * self.seconds, length_s, min_steps,
                           n_devices=len(self.devices), **hooks)

    def corpus(self) -> torch.Tensor:
        """The host corpus on the device again, for the reference."""
        return torch.as_tensor(self.xb, device=self.device)

    def corpus_rows(self, s: int, e: int, device=None) -> torch.Tensor:
        """Corpus rows s:e on ``device`` (default the first card): a check of
        a corpus that no card holds works in such blocks."""
        return torch.as_tensor(self.xb[s:e], device=self.device if device is None else device)

    def queries(self, idx) -> torch.Tensor:
        return torch.as_tensor(self.pool[np.asarray(idx)], device=self.device)


def free(*devices: torch.device) -> None:
    gc.collect()
    cards = [d for d in devices if d.type == "cuda"]
    for d in cards:
        torch.cuda.synchronize(d)
    if cards:
        torch.cuda.empty_cache()


def port_labels(lay, n: int) -> np.ndarray:
    """(n,) the list (index into the centroid table) that holds each corpus
    row in the port's posting layout ``lay`` (its host ``offsets``,
    ``lengths`` and ``perm``); -1 for a row in no list."""
    lengths = np.asarray(lay.lengths, np.int64)
    starts = np.asarray(lay.offsets[:-1], np.int64)
    lists = np.repeat(np.arange(len(lengths)), lengths)
    rows = np.repeat(starts, lengths) + (np.arange(lengths.sum())
                                         - np.repeat(np.cumsum(lengths) - lengths, lengths))
    out = np.full(n, -1, np.int64)
    out[np.asarray(lay.perm)[rows]] = lists
    return out


def device_info(devices: list) -> dict:
    """The result line's ``device``: the platform, the first card's name, the
    cell's card count and the peak of the fullest card since the last reset;
    with more than one card also each card's peak, in card order."""
    cuda = devices[0].type == "cuda"
    peaks = [int(torch.cuda.max_memory_allocated(d)) if cuda else 0 for d in devices]
    info = {"platform": "gpu" if cuda else "cpu",
            "kind": torch.cuda.get_device_name(devices[0]) if cuda else "cpu",
            "count": len(devices), "memory_peak_bytes": max(peaks)}
    if len(devices) > 1:
        info["memory_peak_bytes_by_device"] = peaks
    return info


def trace_info(summary: dict, n_devices: int) -> dict:
    """``busy_s`` and ``window_s`` for the result line's ``device``: on more
    than one card ``busy_s`` is the mean of each card's busy seconds, which
    follow as ``busy_s_by_device``; on one card it is the trace's own."""
    if n_devices == 1:
        return dict(busy_s=summary["busy_s"], window_s=summary["window_s"])
    by = summary["busy_s_by_device"]
    return dict(busy_s=sum(by) / n_devices, window_s=summary["window_s"], busy_s_by_device=by)


def run_cell(man: dict, workload: str, seed: int, seconds: float, trace: bool,
             device: torch.device, t_start: float, config=None, traffic=None,
             control: bool = False) -> dict:
    """One run of ``workload``: set-up, window, per-layer metrics (traced run),
    the comparison, and the result line as a dict. ``device`` is the cell's
    first (``cell_devices``). ``config`` and ``traffic`` replace the cell's
    files (the tests' small sizes); ``control`` adds the controls' numbers
    under ``control`` (calibration only)."""
    cell = cell_of(man, workload)
    config = config or config_of(man, cell["config"])
    traffic = traffic or load_json(HERE / "traffic" / f"{cell['traffic']}.json")
    limits = load_json(HERE / "cells" / f"{workload}.json")["limits"]
    driver = load_module("drivers", traffic["driver"])
    devices = cell_devices(device, cell["chips"])
    b = Bench(workload, config, traffic, seed, seconds, trace, devices)

    b.draw()
    for d in devices:
        if d.type == "cuda":
            torch.cuda.reset_peak_memory_stats(d)
    driver.setup(b)
    setup_s = time.perf_counter() - t_start
    win = driver.window(b)
    dev_info = device_info(devices)

    metrics = {}
    breakdown = None
    if trace:
        summary = win.get("trace") or {}
        ctx = dict(bench=b, window=win, trace=summary)
        for m in metrics_of(man, "per_layer", workload):
            value = load_module("metrics", m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        if summary:
            dev_info.update(trace_info(summary, len(devices)))
            breakdown = {"device_ops": summary["device_ops"], "idle_gaps": summary["idle_gaps"]}
    else:
        for m in metrics_of(man, "end_to_end", workload):
            value = setup_s if m["name"] == "setup_s" else win["e2e"].get(m["name"])
            if value is None:
                raise RuntimeError(f"driver {traffic['driver']} gave no {m['name']}")
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    driver.release(b)
    free(*devices)
    numbers = driver.check(b, win)
    correct, rows = compare.judge(numbers, limits)
    result = {"correct": correct, "attempted": win["attempted"], "failed": win["failed"],
              "metrics": metrics, "device": dev_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    if "requests" in win:  # the sample count of the latency percentile
        result["requests"] = win["requests"]
    if control:
        result["control"] = driver.control(b, win)
    result["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in rows}
    return result
