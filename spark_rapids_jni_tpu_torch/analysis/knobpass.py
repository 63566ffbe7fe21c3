"""Knob pass: every ``SRJT_*`` environment read goes through the registry.

The port's copy of the JAX package's ``analysis/knobpass.py``, against
the port's registry.  ``utils/knobs.py`` is the single source of truth
for knob names, defaults, parse semantics, and docs — the port's block
of the README's knob tables is generated from it.  This pass keeps that
true mechanically:

``knob-env``
    A direct ``os.environ.get("SRJT_...")`` / ``os.environ["SRJT_..."]``
    / ``os.getenv("SRJT_...")`` READ anywhere outside ``utils/knobs.py``.
    Writes (``os.environ["SRJT_X"] = ...``) are fine — tests and the
    crash-resume benches set knobs; only reads must funnel through
    :func:`knobs.get` so defaults and parsing can't fork.

``knob-unregistered``
    ``knobs.get("SRJT_X")`` where ``SRJT_X`` is not registered — it
    would raise ``KeyError`` at runtime; catch it in CI instead.

``knob-undoc``
    A registered knob whose name does not appear in README.md.  Run
    ``python tools/torch_lint.py --knob-table`` to refresh the generated
    table in place.
"""

from __future__ import annotations

import ast
from typing import Optional

from .core import Finding, Source

__all__ = ["run", "load_registry"]

_KNOBS_REL = "spark_rapids_jni_tpu_torch/utils/knobs.py"


def load_registry(root: str) -> dict:
    """Load ``utils/knobs.py`` standalone (no package import, no torch) and
    return its ``REGISTRY``."""
    import importlib.util
    import os
    path = os.path.join(root, _KNOBS_REL)
    spec = importlib.util.spec_from_file_location("_srjt_knobs_lint", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.REGISTRY


def _knob_name(node: ast.expr) -> Optional[str]:
    """The SRJT_* name in a string-ish expression, else None."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value if node.value.startswith("SRJT_") else None
    if isinstance(node, ast.JoinedStr) and node.values:
        first = node.values[0]
        if isinstance(first, ast.Constant) and isinstance(first.value, str) \
                and first.value.startswith("SRJT_"):
            return first.value + "*"
    return None


def _is_environ(node: ast.expr) -> bool:
    """``os.environ`` or a bare ``environ`` name."""
    if isinstance(node, ast.Attribute) and node.attr == "environ" \
            and isinstance(node.value, ast.Name) and node.value.id == "os":
        return True
    return isinstance(node, ast.Name) and node.id == "environ"


def _env_read_findings(src: Source) -> list[Finding]:
    out = []
    for node in ast.walk(src.tree):
        name = None
        if isinstance(node, ast.Call):
            f = node.func
            # os.environ.get("SRJT_X"[, default]) / environ.get(...)
            if isinstance(f, ast.Attribute) and f.attr == "get" \
                    and _is_environ(f.value) and node.args:
                name = _knob_name(node.args[0])
            # os.getenv("SRJT_X")
            elif isinstance(f, ast.Attribute) and f.attr == "getenv" \
                    and isinstance(f.value, ast.Name) \
                    and f.value.id == "os" and node.args:
                name = _knob_name(node.args[0])
        elif isinstance(node, ast.Subscript) \
                and isinstance(node.ctx, ast.Load) \
                and _is_environ(node.value):
            name = _knob_name(node.slice)
        if name is not None:
            out.append(Finding(
                rule="knob-env", path=src.rel, line=node.lineno,
                message=f"direct environ read of {name}; use "
                        "utils.knobs.get so the default/parser/doc live "
                        "in one place"))
    return out


def _unregistered_findings(src: Source, registered: set[str]) \
        -> list[Finding]:
    out = []
    for node in ast.walk(src.tree):
        if not isinstance(node, ast.Call) or not node.args:
            continue
        f = node.func
        is_get = (isinstance(f, ast.Attribute) and f.attr == "get"
                  and isinstance(f.value, ast.Name)
                  and f.value.id == "knobs")
        if not is_get:
            continue
        arg = node.args[0]
        if isinstance(arg, ast.Constant) and isinstance(arg.value, str) \
                and arg.value.startswith("SRJT_") \
                and arg.value not in registered:
            out.append(Finding(
                rule="knob-unregistered", path=src.rel, line=node.lineno,
                message=f"knobs.get({arg.value!r}) but {arg.value} is not "
                        "registered in utils/knobs.py"))
    return out


def run(sources: list[Source], registered: set[str],
        readme_text: Optional[str] = None) -> list[Finding]:
    findings: list[Finding] = []
    for src in sources:
        if src.rel == _KNOBS_REL:
            continue
        findings += _env_read_findings(src)
        findings += _unregistered_findings(src, registered)
    if readme_text is not None:
        for name in sorted(registered):
            if name not in readme_text:
                findings.append(Finding(
                    rule="knob-undoc", path="README.md", line=1,
                    message=f"registered knob {name} is missing from the "
                            "README knob table (regenerate with "
                            "tools/srjt_lint.py --knob-table)"))
    return findings
