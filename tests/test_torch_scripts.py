"""The port's package, its GPU scripts (chip_smoke.py, tools/torch_*.py)
and its demo (examples/demo_torch.py) import no JAX, and each refuses to
run without a CUDA device (the demo unless it is given --cpu)."""

import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
SCRIPTS = ["chip_smoke.py", "tools/torch_profile.py", "tools/torch_shape_check.py",
           "tools/torch_k2_sweep.py"]
DEMO = "examples/demo_torch.py"

_IMPORT_ALL = """
import importlib, pkgutil, runpy, sys
sys.path.insert(0, ".")
import vector_indexer_tpu_torch as pkg
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(m.name)
for script in %r:
    runpy.run_path(script, run_name="not_main")
bad = sorted(n for n in sys.modules
             if n.split(".")[0] in ("jax", "jaxlib", "vector_indexer_tpu"))
print(bad)
"""


def test_port_and_scripts_import_no_jax():
    res = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL % (SCRIPTS + [DEMO],)],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
    )
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().splitlines()[-1] == "[]"


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the no-card refusal")
@pytest.mark.parametrize("script", SCRIPTS)
def test_script_refuses_without_a_card(script):
    res = subprocess.run(
        [sys.executable, script], cwd=ROOT, capture_output=True, text=True, timeout=120,
    )
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
    assert "no CUDA device" in res.stderr


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the no-card refusal")
def test_smoke_kernels_only_refuses_without_a_card():
    res = subprocess.run(
        [sys.executable, "chip_smoke.py", "--kernels-only"], cwd=ROOT, capture_output=True,
        text=True, timeout=120,
    )
    assert res.returncode != 0
    assert "{" not in res.stdout
    assert "no CUDA device" in res.stderr


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the no-card refusal")
def test_demo_refuses_without_a_card(tmp_path):
    res = subprocess.run(
        [sys.executable, str(ROOT / DEMO), "--work-dir", str(tmp_path / "w")],
        cwd=tmp_path, capture_output=True, text=True, timeout=120,
    )
    assert res.returncode != 0
    assert "CUDA is not available" in res.stderr
    assert "external_id" not in res.stdout
    assert not (tmp_path / "w").exists()  # refused before writing anything
