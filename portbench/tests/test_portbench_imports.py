"""What the benchmark imports: nothing of JAX, the JAX package or its
benchmark, judged by whole top-level names; the references nothing of the
port either."""

from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import harness

FORBIDDEN = {"jax", "jaxlib", "flax", "spark_rapids_jni_tpu", "benchmarks"}
PORT = "spark_rapids_jni_tpu_torch"


def _imports(path: Path, top_level_only: bool = False) -> set:
    """Top-level names of the absolute imports in ``path``."""
    tree = ast.parse(path.read_text())
    nodes = tree.body if top_level_only else ast.walk(tree)
    names = set()
    for node in nodes:
        if isinstance(node, ast.Import):
            names |= {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and not node.level:
            names.add(node.module.split(".", 1)[0])
    return names


def _sources(sub: str = ""):
    return [p for p in (harness.HERE / sub).rglob("*.py")
            if "tests" not in p.relative_to(harness.HERE).parts]


def test_no_module_imports_jax_or_the_jax_package():
    for path in _sources():
        assert not _imports(path) & FORBIDDEN, path


def test_the_references_import_nothing_of_the_port():
    for path in _sources("reference") + [harness.HERE / "yardstick.py"]:
        assert PORT not in _imports(path), path
    # the generators load the port only inside prepare(), to scan
    for path in _sources("data"):
        assert PORT not in _imports(path, top_level_only=True), path


def test_a_run_loads_no_forbidden_module():
    code = (
        "import sys; sys.path.insert(0, 'portbench');"
        "from tests.conftest import tiny_cell;"
        "from portbench import harness, run;"
        "out = harness.run_cell('rows_store_sales_sf10', 3, 0.5, False,"
        " device='cpu', cell=tiny_cell('rows_store_sales_sf10'));"
        "assert out['correct'];"
        "print(sorted(run.forbidden_modules()),"
        " 'numpy' in sys.modules and 'spark_rapids_jni_tpu_torch' in"
        " sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[] True"


def test_the_references_load_without_the_port():
    code = ("import sys; import portbench.reference.jcudf,"
            " portbench.reference.tpcds_oracle, portbench.yardstick,"
            " portbench.data.tpch_lineitem, portbench.data.tpcds_star;"
            f"print(sorted(m for m in sys.modules"
            f" if m.split('.')[0] in {sorted(FORBIDDEN | {PORT})!r}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


@pytest.mark.gpu
def test_a_cell_runs_on_the_card(cuda):
    """``python3 -m portbench.run`` on the card: one short run of the
    fixed-width rows cell comes out correct."""
    import json
    out = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload",
         "rows_store_sales_sf10", "--seed", "2147483659", "--seconds", "2",
         "--trace", "0"], cwd=harness.ROOT, capture_output=True, text=True,
        timeout=900)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"]
