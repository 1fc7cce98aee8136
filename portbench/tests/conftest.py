"""Shared small sizes for the benchmark's CPU tests: the cells' own shapes
(d, metric, k, n_probe) on a corpus a test run holds."""

import sys
import time
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import harness  # noqa: E402

SEED = 2**31 + 12345  # past 32 signed bits, as the checker's seeds are


@pytest.fixture(scope="session")
def man():
    return harness.manifest()


def tiny(man, workload, n=20000):
    """(config, traffic) of ``workload`` at a CPU size: the configuration's
    width and metric, ``n`` vectors, nlist 64, 20 centres; batches of 100."""
    cell = harness.cell_of(man, workload)
    cfg = dict(harness.config_of(man, cell["config"]))
    cfg.update(n=n, nlist=64, query_pool=400,
               generator={"kind": "clustered", "ncent": 20, "spread": 4.0})
    tr = dict(harness.load_json(harness.HERE / "traffic" / f"{cell['traffic']}.json"))
    if "batch" in tr:
        tr["batch"] = min(tr["batch"], 100)
        tr["check_queries"] = 200
    if "first_batch" in tr:
        tr["first_batch"] = 100
    return cfg, tr


def run_tiny(man, workload, seconds=0.5, trace=False, n=20000, nlist=64, ncent=20, **kw):
    """One CPU run of ``workload`` at ``tiny``'s size; ``nlist`` and ``ncent``
    (the generator's centres) replace its 64 and 20."""
    cfg, tr = tiny(man, workload, n=n)
    cfg.update(nlist=nlist, generator=dict(cfg["generator"], ncent=ncent))
    return harness.run_cell(man, workload, SEED, seconds, trace, torch.device("cpu"),
                            time.perf_counter(), config=cfg, traffic=tr, **kw)
