"""BENCHMARK.json against the rules of its schema, and the files it names."""

import re

import pytest

from portbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


def test_keys_and_sizes(man):
    assert set(man) == TOP
    assert man["paths"] == ["portbench"]
    assert 1 <= man["run_seconds"] <= 51 and isinstance(man["run_seconds"], int)
    assert len((harness.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert not any(w.startswith("/") or ".." in w for w in man["command"])


@pytest.mark.parametrize("section,keys", [
    ("configs", {"name", "source", "file", "reduced", "why"}),
    ("workloads", {"name", "config", "traffic", "chips", "why"}),
    ("end_to_end", {"name", "unit", "better", "bound", "source", "workloads"}),
    ("per_layer", {"name", "unit", "better", "source", "layer", "moves", "workloads"}),
])
def test_entries(man, section, keys):
    names = [e["name"] for e in man[section]]
    assert len(names) == len(set(names))
    for e in man[section]:
        assert set(e) <= keys and set(e) >= keys - {"workloads"}, e["name"]
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
        for text in ("why", "layer", "source"):
            if text in e:
                assert 1 <= len(e[text]) <= 200 and "\n" not in e[text] and "\t" not in e[text]


def test_metrics_sources_and_bounds(man):
    names = {m["name"] for m in man["end_to_end"]}
    assert "setup_s" in names
    for m in man["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in man["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in names
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


def test_every_cell_reports_enough(man):
    for cell in man["workloads"]:
        e2e = {m["name"] for m in harness.metrics_of(man, "end_to_end", cell["name"])}
        per = harness.metrics_of(man, "per_layer", cell["name"])
        assert "setup_s" in e2e and len(e2e) >= 2 and per, cell["name"]
        for m in per:  # a per-layer metric's end-to-end metric is reported where it is
            assert m["moves"] in e2e, (cell["name"], m["name"])
        assert cell["chips"] in (1, 4)


def test_files_found_by_name(man):
    used = {c["config"] for c in man["workloads"]}
    assert used == {c["name"] for c in man["configs"]}
    for c in man["configs"]:
        cfg = harness.load_json(harness.ROOT / c["file"])
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert len(c["reduced"]) <= 16
    for cell in man["workloads"]:
        tr = harness.load_json(harness.HERE / "traffic" / f"{cell['traffic']}.json")
        assert (harness.HERE / "drivers" / f"{tr['driver']}.py").is_file()
        limits = harness.load_json(harness.HERE / "cells" / f"{cell['name']}.json")["limits"]
        assert limits["answers_bad"] == 0
    for m in man["per_layer"]:
        assert callable(harness.load_module("metrics", m["name"]).read)
    pairs = [(c["config"], c["traffic"]) for c in man["workloads"]]
    assert len(pairs) == len(set(pairs))
