"""The port's static analysis (``spark_rapids_jni_tpu_torch/analysis/``
and ``tools/torch_lint.py``) against the JAX package's, on the CPU.

* Every fixture tree of ``tests/test_analysis.py`` (read from that file,
  so the two stay one set) is written under each package's name and
  linted by each package's concurrency and knob passes: the findings are
  the same (rule, line, message; the path in each package).
* The host-sync pass, retargeted to torch, on torch fixtures:
  ``.item()``, ``.tolist()``, ``.cpu()``, ``int(torch...)``,
  ``syncs.scalar`` sanctioned, a branch on ``torch.``, set iteration in a
  fingerprint function, the scope, and inline suppression.
* Every registered knob of the port is in the README's port knob block.
* ``tools/torch_lint.py`` exits 0 over the real tree with its empty
  baseline, imports neither torch nor jax, and its ``--knob-table`` leaves
  the README as it is.
"""

import torch_one_thread  # noqa: F401  (first: one intra-op thread)

import ast
import json
import os
import subprocess
import sys
import textwrap

import pytest

from spark_rapids_jni_tpu.analysis import concurrency as JCONC
from spark_rapids_jni_tpu.analysis import core as JCORE
from spark_rapids_jni_tpu.analysis import knobpass as JKNOB

from spark_rapids_jni_tpu_torch.analysis import (concurrency, core,
                                                 knobpass, tracepass)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JPKG, PKG = "spark_rapids_jni_tpu", "spark_rapids_jni_tpu_torch"
LINT = os.path.join(REPO, "tools", "torch_lint.py")


def _fixtures() -> dict:
    """{test name: [(path under the package, source)]}: every
    ``_write(tmp_path, f"{PKG}/...", \"\"\"...\"\"\")`` of
    ``tests/test_analysis.py``."""
    with open(os.path.join(REPO, "tests", "test_analysis.py")) as f:
        tree = ast.parse(f.read())
    out = {}
    for fn in tree.body:
        if not isinstance(fn, ast.FunctionDef):
            continue
        for node in ast.walk(fn):
            if (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
                    and node.func.id == "_write"
                    and isinstance(node.args[1], ast.JoinedStr)):
                tail = node.args[1].values[-1].value      # "/exec/fix.py"
                out.setdefault(fn.name, []).append(
                    (tail.lstrip("/"), textwrap.dedent(node.args[2].value)))
    return out


FIXTURES = _fixtures()


def _tree(tmp_path, pkg, files):
    for rel, body in files:
        p = tmp_path / pkg / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(body)


def _keys(findings, pkg):
    return sorted((f.rule, f.path.replace(pkg + "/", "<pkg>/", 1), f.line,
                   f.message) for f in findings)


def test_fixtures_found():
    assert len(FIXTURES) >= 12
    assert "test_lock_order_inversion_detected" in FIXTURES


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_fixture_findings_equal_jax(tmp_path, name):
    _tree(tmp_path / "j", JPKG, FIXTURES[name])
    _tree(tmp_path / "p", PKG, FIXTURES[name])
    jsrc = JCORE.collect_sources(str(tmp_path / "j"), subdirs=(JPKG,))
    psrc = core.collect_sources(str(tmp_path / "p"), subdirs=(PKG,))
    jreg = set(JKNOB.load_registry(REPO))
    preg = set(knobpass.load_registry(REPO))
    jf = JCONC.run(jsrc) + JKNOB.run(jsrc, jreg)
    pf = concurrency.run(psrc) + knobpass.run(psrc, preg)
    assert _keys(pf, PKG) == _keys(jf, JPKG)
    expected_rule = {"lock_order": "conc-lock-order",
                     "mixed_guard": "conc-mixed-guard",
                     "augassign": "conc-global-augassign",
                     "environ": "knob-env", "unregistered":
                     "knob-unregistered"}
    for key, rule in expected_rule.items():
        if key in name and "clean" not in name:
            assert any(f.rule == rule for f in pf), (name, pf)


def test_undocumented_knob_detected():
    findings = knobpass.run([], registered={"SRJT_GHOST_KNOB"},
                            readme_text="no table here")
    assert [(f.rule, f.path) for f in findings] == [("knob-undoc",
                                                     "README.md")]


# --- the host-sync pass on torch fixtures -------------------------------------

def _lint(tmp_path, files):
    _tree(tmp_path, PKG, files)
    sources = core.collect_sources(str(tmp_path), subdirs=(PKG,))
    return sources, tracepass.run(sources)


def _hits(findings, rule):
    return sorted((f.path.split("/", 1)[1], f.line) for f in findings
                  if f.rule == rule)


SYNCS = """\
    import torch
    from ..utils import syncs

    def a(col):
        return col.item()

    def b(col):
        return col.offsets[[0, 3]].tolist()

    def c(col):
        return col.data.cpu().numpy()

    def d(col):
        return int(torch.max(col))

    def good(col):
        return syncs.scalar(torch.max(col))

    def host_ok(offs_np):
        return int(offs_np.max(initial=0))

    def bool_of_reduction(col):
        return bool((col == torch.zeros_like(col)).all())
"""


def test_host_syncs_detected_and_scalar_sanctioned(tmp_path):
    _, findings = _lint(tmp_path, [("rowconv/fix.py", textwrap.dedent(SYNCS))])
    assert _hits(findings, "trace-host-sync") == [
        ("rowconv/fix.py", 5), ("rowconv/fix.py", 8), ("rowconv/fix.py", 11),
        ("rowconv/fix.py", 14), ("rowconv/fix.py", 23)]
    msgs = sorted(f.message for f in findings)
    assert any(m.startswith(".tolist() forces") for m in msgs)
    assert any(m.startswith(".cpu() forces") for m in msgs)
    assert any(m.startswith(".item() forces") for m in msgs)
    assert any(m.startswith("int() over a device expression") for m in msgs)


@pytest.mark.parametrize("rel,hit", [
    ("ops/fix.py", True), ("rowconv/fix.py", True), ("plan/lower.py", True),
    ("models/compiled.py", True), ("plan/rules.py", False),
    ("exec/fix.py", False), ("rowconv/host.py", False),
    ("rowconv/native.py", False), ("rowconv/reference.py", False)])
def test_scope(tmp_path, rel, hit):
    _, findings = _lint(tmp_path, [(rel, "def f(x):\n    return x.item()\n")])
    assert bool(_hits(findings, "trace-host-sync")) == hit


def test_branch_on_torch_detected(tmp_path):
    _, findings = _lint(tmp_path, [("ops/fix.py", textwrap.dedent("""\
        import torch

        def clamp(col):
            if torch.any(col < 0):
                return torch.abs(col)
            while bool(torch.sum(col)):
                col = col - 1
            if col.shape[0] > 3:          # a host value: fine
                return col
            return col
    """))])
    assert _hits(findings, "trace-branch") == [("ops/fix.py", 4),
                                               ("ops/fix.py", 6)]
    assert _hits(findings, "trace-host-sync") == [("ops/fix.py", 6)]


def test_set_iteration_in_fingerprint_detected(tmp_path):
    _, findings = _lint(tmp_path, [("plan/fix.py", textwrap.dedent("""\
        def plan_fingerprint(cols):
            parts = []
            for name in {c.name for c in cols}:
                parts.append(name)
            return tuple(parts)

        def not_a_key_fn(cols):
            for name in {c.name for c in cols}:
                pass
    """))])
    assert _hits(findings, "trace-iter") == [("plan/fix.py", 3)]


def test_inline_suppression_silences_finding(tmp_path):
    sources, findings = _lint(tmp_path, [("ops/fix.py", textwrap.dedent("""\
        def pull(x):
            # a host boundary: the caller wants the value
            return x.item()  # srjt-lint: disable=trace-host-sync

        def pull_too(x):
            # srjt-lint: disable=trace-host-sync
            return x.tolist()

        def kept(x):
            return x.cpu()
    """))])
    by_rel = {s.rel: s for s in sources}
    kept = core.filter_findings(findings, by_rel, baseline=None)
    assert _hits(kept, "trace-host-sync") == [("ops/fix.py", 10)]


# --- the knob registry and the README ------------------------------------------

def test_every_registered_knob_in_the_port_knob_block():
    sys.path.insert(0, os.path.join(REPO, "tools"))
    import torch_lint
    from spark_rapids_jni_tpu_torch.utils import knobs
    with open(os.path.join(REPO, "README.md"), encoding="utf-8") as f:
        readme = f.read()
    block = readme.split(torch_lint.KNOB_TABLE_BEGIN, 1)[1].split(
        torch_lint.KNOB_TABLE_END, 1)[0]
    missing = [k for k in knobs.REGISTRY if f"`{k}`" not in block]
    assert not missing
    assert block.strip() == knobs.markdown_table().strip()


# --- the CLI ----------------------------------------------------------------

def test_torch_lint_real_tree_is_clean():
    with open(os.path.join(REPO, "tools", "torch_lint_baseline.json")) as f:
        assert json.load(f) == []
    probe = ("import runpy, sys\n"
             f"sys.argv = [{LINT!r}]\n"
             "try:\n"
             f"    runpy.run_path({LINT!r}, run_name='__main__')\n"
             "except SystemExit as e:\n"
             "    code = e.code\n"
             "print('imports', 'torch' in sys.modules, 'jax' in sys.modules)\n"
             "sys.exit(code)\n")
    proc = subprocess.run([sys.executable, "-c", probe], capture_output=True,
                          text=True, timeout=120, cwd=REPO)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "0 finding(s)" in proc.stdout
    assert "imports False False" in proc.stdout


def test_torch_lint_reports_a_finding_in_a_copy(tmp_path):
    """A tree with one unsuppressed sync fails the gate; --no-baseline
    and --write-baseline behave as the JAX tool's."""
    pkg = tmp_path / PKG
    (pkg / "ops").mkdir(parents=True)
    (pkg / "ops" / "bad.py").write_text("def f(x):\n    return x.item()\n")
    (pkg / "analysis").symlink_to(os.path.join(REPO, PKG, "analysis"))
    (pkg / "utils").mkdir()
    (pkg / "utils" / "knobs.py").symlink_to(
        os.path.join(REPO, PKG, "utils", "knobs.py"))
    (tmp_path / "tools").mkdir()

    def run(*args):
        return subprocess.run([sys.executable, LINT, "--root", str(tmp_path),
                               *args], capture_output=True, text=True,
                              timeout=120)
    out = run("--no-baseline")
    assert out.returncode == 1 and "ops/bad.py:2: [trace-host-sync]" in \
        out.stdout
    assert run("--write-baseline").returncode == 0
    assert run().returncode == 0
