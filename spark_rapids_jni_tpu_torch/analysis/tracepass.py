"""Host-sync pass: syncing patterns in the code a CUDA graph captures.

The port's counterpart of the JAX package's ``analysis/tracepass.py``,
retargeted to torch.  The compiled queries (``models/compiled.py``) run
the op library's Python bodies under ``syncs.capture`` and then capture
them as one ``torch.cuda.CUDAGraph`` under ``syncs.replay``.  Inside a
capture no op may read the device: a ``.item()``, ``.tolist()`` or
``.cpu()``, or an ``int()``/``float()``/``bool()`` over a tensor, waits
for the card and fails the capture (or, eagerly, costs a silent sync a
call); a Python branch on a tensor's value is the same read; and
iterating an unordered ``set`` into a fingerprint makes "same plan" hash
differently run to run.

Rules (scope: ``ops/``, ``rowconv/``, ``plan/lower.py``,
``models/compiled.py``: the code the graphs capture; ``trace-iter``
additionally runs package-wide over fingerprint/cache-key functions).
``rowconv/host.py``, ``rowconv/native.py`` and ``rowconv/reference.py``
are out of the scope: they are the host engines and the numpy oracle,
which take host arrays, run on the CPU by design and are never reached
from a captured op.

``trace-host-sync``
    any ``.item()``, ``.tolist()`` or ``.cpu()`` call;
    ``int()``/``float()``/``bool()`` whose argument contains a device
    expression, a call rooted at ``torch.`` or a reduction method
    (``.sum()``, ``.max()``, ...) whose receiver involves one; and
    ``np.asarray``/``np.array`` over a device expression.  The one
    sanctioned funnel is ``utils.syncs.scalar``: it counts the sync and
    resolves from the tape under replay.

``trace-branch``
    ``if``/``while`` predicates containing a device expression:
    data-dependent Python control flow reads the device.

``trace-iter``
    Iteration over a ``set``/``frozenset`` inside a function whose name
    says it computes a fingerprint/cache key: unordered iteration feeds
    nondeterminism straight into plan identity.

A deliberate host boundary inside the scope carries an inline
``# srjt-lint: disable=trace-host-sync`` whose comment gives the reason.
"""

from __future__ import annotations

import ast
import re

from .core import Finding, Source

__all__ = ["run", "TRACE_SCOPE_DIRS", "TRACE_SCOPE_FILES",
           "TRACE_HOST_ONLY"]

_PKG = "spark_rapids_jni_tpu_torch/"
TRACE_SCOPE_DIRS = (_PKG + "ops/", _PKG + "rowconv/")
TRACE_SCOPE_FILES = (_PKG + "plan/lower.py", _PKG + "models/compiled.py")
# host engines and the numpy oracle: never reached from a captured op
TRACE_HOST_ONLY = (_PKG + "rowconv/host.py", _PKG + "rowconv/native.py",
                   _PKG + "rowconv/reference.py")

_DEVICE_ROOTS = ("torch",)
# methods that read a tensor back to the host, whatever the receiver
_SYNC_METHODS = ("item", "tolist", "cpu")
_REDUCTIONS = {"sum", "min", "max", "mean", "prod", "any", "all",
               "argmin", "argmax"}
_KEY_FN_RE = re.compile(
    r"fingerprint|cache_key|plan_key|size_key|_fp\b|\bfp_|hash_", re.I)


def in_trace_scope(rel: str) -> bool:
    return ((rel.startswith(TRACE_SCOPE_DIRS) or rel in TRACE_SCOPE_FILES)
            and rel not in TRACE_HOST_ONLY)


def _is_sanctioned_sync(node: ast.Call) -> bool:
    """``syncs.scalar(...)`` / ``scalar(...)``: the one approved funnel.
    It counts the sync eagerly and resolves from the tape under replay
    (returning a plain int), so its result is host-safe to branch on."""
    f = node.func
    if isinstance(f, ast.Attribute) and f.attr == "scalar" \
            and isinstance(f.value, ast.Name) and f.value.id == "syncs":
        return True
    return isinstance(f, ast.Name) and f.id == "scalar"


def _contains_device_expr(node: ast.expr) -> bool:
    """Heuristic: does the expression tree contain a call rooted at
    ``torch.`` or a reduction-style method call whose receiver involves
    one?  That is the stand-in for "a tensor": a static pass can't see
    dynamic types.  ``syncs.scalar(...)`` subtrees are pruned: their
    results are tape ints, not tensors."""
    stack = [node]
    while stack:
        n = stack.pop()
        if isinstance(n, ast.Call):
            if _is_sanctioned_sync(n):
                continue                      # prune: result is a host int
            f = n.func
            if isinstance(f, ast.Attribute):
                root = f.value
                while isinstance(root, ast.Attribute):
                    root = root.value
                if isinstance(root, ast.Name) and root.id in _DEVICE_ROOTS:
                    return True
                # x.sum()/x.max()/... counts only when the receiver itself
                # involves torch: numpy host arrays reduce with the same
                # method names and are not syncs
                if f.attr in _REDUCTIONS and any(
                        isinstance(d, ast.Name) and d.id in _DEVICE_ROOTS
                        for d in ast.walk(f.value)):
                    return True
        stack.extend(ast.iter_child_nodes(n))
    return False


def _host_sync_findings(src: Source) -> list[Finding]:
    out = []
    for node in ast.walk(src.tree):
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        if isinstance(f, ast.Attribute) and f.attr in _SYNC_METHODS \
                and not node.args and not node.keywords:
            out.append(Finding(
                rule="trace-host-sync", path=src.rel, line=node.lineno,
                message=f".{f.attr}() forces a device->host sync in traced "
                        "code; route sizes through syncs.scalar"))
            continue
        name = None
        if isinstance(f, ast.Name) and f.id in ("int", "float", "bool"):
            name = f.id
        elif (isinstance(f, ast.Attribute)
              and f.attr in ("asarray", "array")
              and isinstance(f.value, ast.Name) and f.value.id == "np"):
            name = f"np.{f.attr}"
        if name is None or not node.args:
            continue
        if _contains_device_expr(node.args[0]):
            out.append(Finding(
                rule="trace-host-sync", path=src.rel, line=node.lineno,
                message=f"{name}() over a device expression forces a "
                        "host sync in traced code; route through "
                        "syncs.scalar"))
    return out


def _branch_findings(src: Source) -> list[Finding]:
    out = []
    for node in ast.walk(src.tree):
        if isinstance(node, (ast.If, ast.While)) \
                and _contains_device_expr(node.test):
            kw = "if" if isinstance(node, ast.If) else "while"
            out.append(Finding(
                rule="trace-branch", path=src.rel, line=node.lineno,
                message=f"`{kw}` predicate evaluates a device expression "
                        "— data-dependent Python control flow does not "
                        "trace (use torch.where)"))
    return out


def _is_set_expr(node: ast.expr) -> bool:
    if isinstance(node, (ast.Set, ast.SetComp)):
        return True
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) \
            and node.func.id in ("set", "frozenset"):
        return True
    return False


def _iter_findings(src: Source) -> list[Finding]:
    out = []
    for fn in ast.walk(src.tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        if not _KEY_FN_RE.search(fn.name):
            continue
        for node in ast.walk(fn):
            it = None
            if isinstance(node, ast.For):
                it = node.iter
            elif isinstance(node, (ast.ListComp, ast.SetComp,
                                   ast.GeneratorExp)):
                it = node.generators[0].iter
            if it is not None and _is_set_expr(it):
                out.append(Finding(
                    rule="trace-iter", path=src.rel, line=node.lineno,
                    message=f"unordered set iteration inside key/"
                            f"fingerprint function `{fn.name}` — sort "
                            "before hashing"))
    return out


def run(sources: list[Source]) -> list[Finding]:
    findings: list[Finding] = []
    for src in sources:
        if in_trace_scope(src.rel):
            findings += _host_sync_findings(src)
            findings += _branch_findings(src)
        if src.rel.startswith(_PKG):
            findings += _iter_findings(src)
    return findings
