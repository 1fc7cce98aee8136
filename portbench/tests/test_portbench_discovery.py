"""A configuration, a traffic mix and a per-layer metric added as files to a
copy of the benchmark are found by name, without editing any code."""

import json
import shutil
import subprocess
import sys

from .conftest import ROOT

NEW_METRIC = '''"""traced_steps: how many steps the trace held (a test's metric)."""


def read(ctx):
    tr = ctx["trace"]
    return float(tr["steps"]) if tr else None
'''


def test_new_files_are_found(tmp_path):
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    man = json.loads((ROOT / "BENCHMARK.json").read_text())
    pb = tmp_path / "portbench"
    cfg = json.loads((pb / "configs" / "sift1m-l2.json").read_text())
    cfg.update(name="toy-l2", n=4000, d=16, nlist=16, query_pool=200,
               generator={"kind": "clustered", "ncent": 8, "spread": 4.0})
    (pb / "configs" / "toy-l2.json").write_text(json.dumps(cfg))
    (pb / "traffic" / "toy-mix.json").write_text(json.dumps(
        {"driver": "search_closed_loop", "batch": 50, "k": 5, "n_probe": 4,
         "method": "auto", "ground_truth": True, "check_queries": 100}))
    (pb / "metrics" / "traced_steps.py").write_text(NEW_METRIC)
    (pb / "cells" / "toy.mix.json").write_text(json.dumps(
        {"limits": {"answers_bad": 0, "dist_err": 1e-2, "nn_gap": 1e-2,
                    "membership_diff": 1e-2,
                    "top10_miss": 0.05, "kth_gap": 0.05}}))
    man["configs"].append({"name": "toy-l2", "source": "https://example.org/toy",
                           "file": "portbench/configs/toy-l2.json", "reduced": [],
                           "why": "a test's configuration"})
    man["workloads"].append({"name": "toy.mix", "config": "toy-l2", "traffic": "toy-mix",
                             "chips": 1, "why": "a test's cell"})
    man["per_layer"].append({"name": "traced_steps", "unit": "steps", "better": "higher",
                             "source": "host_clock", "layer": "test", "moves": "qps",
                             "workloads": ["toy.mix"]})
    for m in man["end_to_end"]:
        if m["name"] in ("qps", "recall_at_10"):
            m["workloads"].append("toy.mix")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(man))
    code = (
        "import sys, time, torch; sys.path[:0] = [%r, %r]\n"
        "from portbench import harness\n"
        "assert harness.HERE == harness.ROOT / 'portbench' and str(harness.ROOT) == %r\n"
        "man = harness.manifest()\n"
        "for trace in (0, 1):\n"
        "    r = harness.run_cell(man, 'toy.mix', 7, 1.5, bool(trace), torch.device('cpu'),\n"
        "                         time.perf_counter())\n"
        "    print(sorted(r['metrics']), r['correct'])\n"
    ) % (str(tmp_path), str(ROOT), str(tmp_path))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    assert lines[-2] == "['qps', 'recall_at_10', 'setup_s'] True"
    assert lines[-1] == "['traced_steps'] True"
