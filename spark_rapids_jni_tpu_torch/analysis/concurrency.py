"""Concurrency pass: lock graph, inversion cycles, unguarded mutation.

The port's copy of the JAX package's ``analysis/concurrency.py``, over
the port's package.  The port's locks are ``threading`` locks and
``analysis.sanitize.tracked_lock`` / ``tracked_rlock``, as in the JAX
package, across ``exec/``, ``memory/``, ``models/``, ``stream/`` and
``utils/``.  The pass applies, mechanically, the checks one makes by eye
when reading locking code:

``conc-lock-order``
    Build the global lock-acquisition graph: an edge L→M means some code
    path acquires M (directly, or via a resolvable call chain) while
    holding L.  A cycle across distinct locks is a potential deadlock —
    two threads entering the cycle from different locks can each block
    on the other's held lock.  Reentrant reacquisition (L→L) is not an
    edge; RLocks make it legal and the runtime watchdog ignores it too.

``conc-mixed-guard``
    A ``self._x`` attribute (or module global) written under a lock in
    one method and without it in another is almost always a race: the
    locked sites prove the author considered it shared.  ``__init__``
    writes are construction and exempt.

``conc-global-augassign``
    ``global x; x += 1`` with no lock held is a read-modify-write that
    loses updates under threads (the exact shape of the historical
    ``utils/syncs.py`` sync-counter race).

Resolution is deliberately conservative: bare calls resolve within the
module, ``self.m()`` within the class, ``alias.f()`` through package
imports — unresolvable calls contribute no edges (missed edges are
acceptable; invented ones are not).
"""

from __future__ import annotations

import ast
from typing import Optional

from .core import Finding, Source

__all__ = ["run", "LockCatalog"]

_PKG = "spark_rapids_jni_tpu_torch"

_LOCK_FACTORIES = {"Lock", "RLock", "Condition",
                   "tracked_lock", "tracked_rlock", "tracked_condition"}


def _module_name(rel: str) -> Optional[str]:
    """``spark_rapids_jni_tpu_torch/memory/budget.py`` → ``memory.budget``;
    None for files outside the package (tools, bench)."""
    if not rel.startswith(_PKG + "/"):
        return None
    parts = rel[len(_PKG) + 1:-3].split("/")      # strip pkg/ and .py
    if parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts) if parts else ""


def _is_lock_create(node: ast.expr) -> bool:
    """True when ``node`` constructs a lock/condition (``threading.Lock()``,
    ``sanitize.tracked_rlock(...)``, ``threading.Condition(...)``, ...)."""
    if not isinstance(node, ast.Call):
        return False
    f = node.func
    name = f.id if isinstance(f, ast.Name) else (
        f.attr if isinstance(f, ast.Attribute) else None)
    return name in _LOCK_FACTORIES


class _Module:
    def __init__(self, src: Source, mod: str):
        self.src = src
        self.mod = mod
        self.globals_locks: set[str] = set()      # module-level lock names
        self.functions: dict[str, ast.FunctionDef] = {}
        self.classes: dict[str, dict[str, ast.FunctionDef]] = {}
        self.class_locks: dict[str, set[str]] = {}  # class -> self attrs
        # alias -> module name ("budget" -> "memory.budget")
        self.mod_aliases: dict[str, str] = {}
        # name -> (module, name) for `from .x import _LOCK` style
        self.name_aliases: dict[str, tuple[str, str]] = {}


class LockCatalog:
    """Phase 1 over every package source: locks, functions, imports."""

    def __init__(self, sources: list[Source]):
        self.modules: dict[str, _Module] = {}
        for src in sources:
            mod = _module_name(src.rel)
            if mod is None:
                continue
            self.modules[mod] = self._scan(src, mod)

    def _scan(self, src: Source, mod: str) -> _Module:
        m = _Module(src, mod)
        pkg_parts = mod.split(".")[:-1] if mod else []
        for node in ast.walk(src.tree):
            if isinstance(node, ast.ImportFrom):
                if node.level:
                    base = pkg_parts[:len(pkg_parts) - (node.level - 1)] \
                        if node.level <= len(pkg_parts) + 1 else None
                    if base is None:
                        continue
                    prefix = ".".join(base + ([node.module]
                                              if node.module else []))
                    for alias in node.names:
                        name = alias.asname or alias.name
                        if node.module:
                            # from .x import y: y is attr of module x
                            tgt = prefix
                            m.name_aliases[name] = (tgt, alias.name)
                            m.mod_aliases[name] = (tgt + "." + alias.name)
                        else:
                            # from . import x: x is a module
                            m.mod_aliases[name] = \
                                (prefix + "." if prefix else "") + alias.name
        for node in src.tree.body:
            if isinstance(node, ast.Assign) and _is_lock_create(node.value):
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        m.globals_locks.add(t.id)
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                m.functions[node.name] = node
            elif isinstance(node, ast.ClassDef):
                methods: dict[str, ast.FunctionDef] = {}
                attrs: set[str] = set()
                for sub in node.body:
                    if isinstance(sub, (ast.FunctionDef,
                                        ast.AsyncFunctionDef)):
                        methods[sub.name] = sub
                        for n2 in ast.walk(sub):
                            if (isinstance(n2, ast.Assign)
                                    and _is_lock_create(n2.value)):
                                for t in n2.targets:
                                    if (isinstance(t, ast.Attribute)
                                            and isinstance(t.value, ast.Name)
                                            and t.value.id == "self"):
                                        attrs.add(t.attr)
                self.classes_register(m, node.name, methods, attrs)
        return m

    @staticmethod
    def classes_register(m: _Module, cls: str, methods, attrs) -> None:
        m.classes[cls] = methods
        m.class_locks[cls] = attrs

    # --- resolution ---------------------------------------------------------

    def lock_id(self, m: _Module, cls: Optional[str],
                expr: ast.expr) -> Optional[str]:
        """Resolve a lock expression to a stable global identity string,
        or None when it isn't a known lock."""
        if isinstance(expr, ast.Name):
            if expr.id in m.globals_locks:
                return f"{m.mod}.{expr.id}"
            al = m.name_aliases.get(expr.id)
            if al is not None:
                tgt = self.modules.get(al[0])
                if tgt is not None and al[1] in tgt.globals_locks:
                    return f"{al[0]}.{al[1]}"
            return None
        if isinstance(expr, ast.Attribute):
            base = expr.value
            if isinstance(base, ast.Name):
                if base.id == "self" and cls is not None:
                    if expr.attr in m.class_locks.get(cls, ()):
                        return f"{m.mod}.{cls}.{expr.attr}"
                    return None
                tgt_mod = m.mod_aliases.get(base.id)
                if tgt_mod is not None:
                    tgt = self.modules.get(tgt_mod)
                    if tgt is not None and expr.attr in tgt.globals_locks:
                        return f"{tgt_mod}.{expr.attr}"
        return None

    def resolve_call(self, m: _Module, cls: Optional[str],
                     call: ast.Call) -> Optional[tuple]:
        """→ (module, class_or_None, func_name) for calls we can pin to a
        package function/method; None otherwise."""
        f = call.func
        if isinstance(f, ast.Name):
            if f.id in m.functions:
                return (m.mod, None, f.id)
            al = m.name_aliases.get(f.id)
            if al is not None:
                tgt = self.modules.get(al[0])
                if tgt is not None and al[1] in tgt.functions:
                    return (al[0], None, al[1])
            return None
        if isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name):
            if f.value.id == "self" and cls is not None:
                if f.attr in m.classes.get(cls, {}):
                    return (m.mod, cls, f.attr)
                return None
            tgt_mod = m.mod_aliases.get(f.value.id)
            if tgt_mod is not None:
                tgt = self.modules.get(tgt_mod)
                if tgt is not None and f.attr in tgt.functions:
                    return (tgt_mod, None, f.attr)
        return None

    def all_functions(self):
        """Yield (fid, module, cls, node) for every function/method."""
        for m in self.modules.values():
            for name, node in m.functions.items():
                yield (m.mod, None, name), m, None, node
            for cls, methods in m.classes.items():
                for name, node in methods.items():
                    yield (m.mod, cls, name), m, cls, node


class _FuncWalker(ast.NodeVisitor):
    """Walk one function tracking the held-lock stack; record direct
    acquisitions, nested-acquisition edges, and calls made while
    holding."""

    def __init__(self, cat: LockCatalog, m: _Module, cls: Optional[str]):
        self.cat = cat
        self.m = m
        self.cls = cls
        self.held: list[str] = []
        self.acquired: set[str] = set()
        # (held_lock, acquired_lock, line)
        self.edges: list[tuple[str, str, int]] = []
        # (callee_fid, held_snapshot, line)
        self.calls: list[tuple[tuple, tuple, int]] = []
        # (lock_id_or_None, line, node) for every with-entered lock
        self.with_locks: list[tuple[Optional[str], int]] = []

    def visit_FunctionDef(self, node):     # don't descend into nested defs
        pass

    visit_AsyncFunctionDef = visit_FunctionDef
    visit_Lambda = visit_FunctionDef

    def _note_acquire(self, lock: Optional[str], line: int) -> None:
        if lock is None:
            return
        self.acquired.add(lock)
        for h in self.held:
            if h != lock:
                self.edges.append((h, lock, line))

    def visit_With(self, node: ast.With):
        entered = []
        for item in node.items:
            lock = self.cat.lock_id(self.m, self.cls, item.context_expr)
            self.with_locks.append((lock, node.lineno))
            self._note_acquire(lock, node.lineno)
            if lock is not None:
                entered.append(lock)
                self.held.append(lock)
            self.visit(item.context_expr)
        for stmt in node.body:
            self.visit(stmt)
        for _ in entered:
            self.held.pop()

    def visit_Call(self, node: ast.Call):
        f = node.func
        if isinstance(f, ast.Attribute) and f.attr == "acquire":
            lock = self.cat.lock_id(self.m, self.cls, f.value)
            self._note_acquire(lock, node.lineno)
        fid = self.cat.resolve_call(self.m, self.cls, node)
        if fid is not None and self.held:
            self.calls.append((fid, tuple(self.held), node.lineno))
        self.generic_visit(node)


def _walk_function(cat: LockCatalog, m: _Module, cls: Optional[str],
                   node: ast.FunctionDef) -> _FuncWalker:
    w = _FuncWalker(cat, m, cls)
    for stmt in node.body:
        w.visit(stmt)
    return w


def _lock_order_findings(cat: LockCatalog,
                         walks: dict[tuple, _FuncWalker]) -> list[Finding]:
    # may-acquire fixpoint
    may: dict[tuple, set[str]] = {fid: set(w.acquired)
                                  for fid, w in walks.items()}
    changed = True
    while changed:
        changed = False
        for fid, w in walks.items():
            for callee, _held, _ln in w.calls:
                callee_may = may.get(callee)
                if callee_may and not callee_may <= may[fid]:
                    may[fid] |= callee_may
                    changed = True

    # edges: direct (nested with/acquire) + via resolvable calls
    edges: dict[tuple[str, str], tuple[str, int]] = {}

    def add_edge(a: str, b: str, rel: str, line: int):
        if a != b and (a, b) not in edges:
            edges[(a, b)] = (rel, line)

    for fid, w in walks.items():
        rel = cat.modules[fid[0]].src.rel if fid[0] in cat.modules else "?"
        for a, b, ln in w.edges:
            add_edge(a, b, rel, ln)
        for callee, held, ln in w.calls:
            for b in may.get(callee, ()):
                for a in held:
                    add_edge(a, b, rel, ln)

    # cycles = SCCs with >1 node (self-loops already excluded)
    graph: dict[str, set[str]] = {}
    for (a, b) in edges:
        graph.setdefault(a, set()).add(b)
        graph.setdefault(b, set())
    sccs = _tarjan(graph)
    findings = []
    for scc in sccs:
        if len(scc) < 2:
            continue
        cyc = sorted(scc)
        # anchor at the lexically first edge inside the cycle
        anchor = min(((rel, ln) for (a, b), (rel, ln) in edges.items()
                      if a in scc and b in scc), default=("?", 0))
        findings.append(Finding(
            rule="conc-lock-order", path=anchor[0], line=anchor[1],
            message="lock-order cycle between " + " <-> ".join(cyc)))
    return findings


def _tarjan(graph: dict[str, set[str]]) -> list[set[str]]:
    index: dict[str, int] = {}
    low: dict[str, int] = {}
    on: set[str] = set()
    stack: list[str] = []
    out: list[set[str]] = []
    counter = [0]

    def strongconnect(v: str):
        # iterative Tarjan (package files can nest deep)
        work = [(v, iter(sorted(graph.get(v, ()))))]
        index[v] = low[v] = counter[0]
        counter[0] += 1
        stack.append(v)
        on.add(v)
        while work:
            node, it = work[-1]
            advanced = False
            for w in it:
                if w not in index:
                    index[w] = low[w] = counter[0]
                    counter[0] += 1
                    stack.append(w)
                    on.add(w)
                    work.append((w, iter(sorted(graph.get(w, ())))))
                    advanced = True
                    break
                elif w in on:
                    low[node] = min(low[node], index[w])
            if advanced:
                continue
            work.pop()
            if work:
                parent = work[-1][0]
                low[parent] = min(low[parent], low[node])
            if low[node] == index[node]:
                scc = set()
                while True:
                    w = stack.pop()
                    on.discard(w)
                    scc.add(w)
                    if w == node:
                        break
                out.append(scc)

    for v in sorted(graph):
        if v not in index:
            strongconnect(v)
    return out


def _mixed_guard_findings(cat: LockCatalog,
                          walks: dict[tuple, _FuncWalker]) -> list[Finding]:
    """Attrs/globals written both under a lock and unguarded."""
    findings = []
    # --- self attributes, per class ---
    for m in cat.modules.values():
        for cls, methods in m.classes.items():
            guarded: set[str] = set()
            unguarded: dict[str, tuple[int, str]] = {}

            for name, node in methods.items():
                writes = _attr_writes(cat, m, cls, node)
                for attr, line, under in writes:
                    if attr in m.class_locks.get(cls, ()):
                        continue
                    if under:
                        guarded.add(attr)
                    elif name != "__init__":
                        unguarded.setdefault(attr, (line, name))
            for attr in sorted(guarded & set(unguarded)):
                line, meth = unguarded[attr]
                findings.append(Finding(
                    rule="conc-mixed-guard", path=m.src.rel, line=line,
                    message=f"self.{attr} written without a lock in "
                            f"{cls}.{meth} but lock-guarded elsewhere in "
                            f"{cls}"))
    return findings


def _attr_writes(cat: LockCatalog, m: _Module, cls: str,
                 fn: ast.FunctionDef) -> list[tuple[str, int, bool]]:
    """(attr, line, under_lock) for every ``self.x`` assignment target."""
    out: list[tuple[str, int, bool]] = []

    class W(_FuncWalker):
        def _note_write(self, node):
            targets = []
            if isinstance(node, ast.Assign):
                targets = node.targets
            elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
                targets = [node.target]
            for t in targets:
                if (isinstance(t, ast.Attribute)
                        and isinstance(t.value, ast.Name)
                        and t.value.id == "self"):
                    out.append((t.attr, t.lineno, bool(self.held)))

        def visit_Assign(self, node):
            self._note_write(node)
            self.generic_visit(node)

        def visit_AugAssign(self, node):
            self._note_write(node)
            self.generic_visit(node)

        def visit_AnnAssign(self, node):
            self._note_write(node)
            self.generic_visit(node)

    w = W(cat, m, cls)
    for stmt in fn.body:
        w.visit(stmt)
    return out


def _global_augassign_findings(cat: LockCatalog) -> list[Finding]:
    findings = []
    for m in cat.modules.values():
        for fid, _m, cls, node in _functions_of(m):
            decl: set[str] = set()
            for n2 in ast.walk(node):
                if isinstance(n2, ast.Global):
                    decl.update(n2.names)
            if not decl:
                continue

            class W(_FuncWalker):
                def visit_AugAssign(self, w_node):
                    t = w_node.target
                    if (isinstance(t, ast.Name) and t.id in decl
                            and not self.held):
                        findings.append(Finding(
                            rule="conc-global-augassign", path=m.src.rel,
                            line=w_node.lineno,
                            message=f"global {t.id} mutated via augmented "
                                    "assignment with no lock held"))
                    self.generic_visit(w_node)

            w = W(cat, m, cls)
            for stmt in node.body:
                w.visit(stmt)
    return findings


def _functions_of(m: _Module):
    for name, node in m.functions.items():
        yield (m.mod, None, name), m, None, node
    for cls, methods in m.classes.items():
        for name, node in methods.items():
            yield (m.mod, cls, name), m, cls, node


def run(sources: list[Source]) -> list[Finding]:
    """All concurrency findings over the package sources."""
    cat = LockCatalog(sources)
    walks: dict[tuple, _FuncWalker] = {}
    for fid, m, cls, node in cat.all_functions():
        walks[fid] = _walk_function(cat, m, cls, node)
    findings = []
    findings += _lock_order_findings(cat, walks)
    findings += _mixed_guard_findings(cat, walks)
    findings += _global_augassign_findings(cat)
    return findings
