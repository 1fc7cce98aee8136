"""What a run may load and where it may run: no JAX, no JAX package, a
reference free of the port, no CPU fallback."""

import ast
import json
import subprocess
import sys

import pytest

from portbench import harness

from .conftest import ROOT


@pytest.mark.parametrize("mods,found", [
    (["vector_indexer_tpu_torch", "vector_indexer_tpu_torch.ops.topk", "numpy"], []),
    (["vector_indexer_tpu.ops", "torch"], ["vector_indexer_tpu"]),
    (["jaxlib.xla_client", "jax_utils", "flax.linen"], ["flax", "jaxlib"]),
    (["jax"], ["jax"]),
])
def test_forbidden_names_compare_the_whole_top_level(mods, found):
    assert harness.forbidden_modules(dict.fromkeys(mods)) == found


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_sources_import_no_jax():
    for path in harness.HERE.rglob("*.py"):
        assert not set(_imports(path)) & set(harness.FORBIDDEN), path


def test_reference_loads_nothing_of_the_port():
    code = ("import sys; sys.path.insert(0, %r); import portbench.reference, portbench.compare;"
            "print(sorted({m.split('.')[0] for m in sys.modules}))" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True).stdout
    loaded = set(json.loads(out.replace("'", '"')))
    assert not loaded & {"vector_indexer_tpu_torch", *harness.FORBIDDEN}


def test_run_fails_without_a_card_and_prints_no_result():
    p = subprocess.run([sys.executable, str(harness.HERE / "run.py"), "--workload",
                        "sift1m.online-np32", "--seed", str(2**31 + 1), "--seconds", "1",
                        "--trace", "0"], capture_output=True, text=True, cwd=ROOT,
                       env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "CUDA card" in p.stderr


def test_a_cpu_run_of_the_port_loads_no_jax():
    code = ("import sys; sys.path.insert(0, %r); from portbench.tests.conftest import run_tiny;"
            "from portbench import harness; r = run_tiny(harness.manifest(), 'sift1m.online-np32',"
            " seconds=0.2); assert 'vector_indexer_tpu_torch' in sys.modules;"
            "print(harness.forbidden_modules())" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, cwd=ROOT).stdout
    assert out.strip().splitlines()[-1] == "[]"
