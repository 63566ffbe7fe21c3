"""Shared machinery of the port's static-analysis passes.

The port's copy of the JAX package's ``analysis/core.py``.

A *finding* is (rule id, path, line, message).  Findings are suppressible
two ways, mirroring how mature linters ratchet a legacy tree:

* inline — a ``# srjt-lint: disable=<rule>[,<rule>...]`` comment on the
  finding's line (or the preceding line, for findings on multi-line
  statements) silences those rules there, with the comment itself serving
  as the in-situ justification;
* baseline — ``tools/torch_lint_baseline.json`` holds accepted
  pre-existing findings.  Baseline entries match on (rule, path, message) and NOT on
  line number, so unrelated edits that shift lines don't resurrect them;
  the gate fails only on findings outside the baseline, so it starts
  green and ratchets as entries are fixed and removed.

This module is stdlib-only (ast/json/os/re/tokenize) — the lint tool must
run without importing the package, torch or jax.
"""

from __future__ import annotations

import ast
import io
import json
import os
import re
import tokenize
from dataclasses import dataclass
from typing import Iterable, Optional

__all__ = ["Finding", "Source", "load_source", "collect_sources",
           "Baseline", "filter_findings"]

_DISABLE_RE = re.compile(r"#\s*srjt-lint:\s*disable=([\w\-, ]+)")


@dataclass(frozen=True)
class Finding:
    """One lint finding with a stable rule id and a location."""
    rule: str       # e.g. "conc-lock-order"
    path: str       # repo-relative, forward slashes
    line: int       # 1-based
    message: str

    def key(self) -> tuple:
        """Baseline identity — deliberately line-free (see module doc)."""
        return (self.rule, self.path, self.message)

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"


class Source:
    """A parsed source file plus its inline-suppression map."""

    def __init__(self, path: str, rel: str, text: str):
        self.path = path
        self.rel = rel
        self.text = text
        self.tree = ast.parse(text, filename=rel)
        # line -> set of rule ids disabled on that line
        self.suppressions: dict[int, set[str]] = {}
        try:
            toks = tokenize.generate_tokens(io.StringIO(text).readline)
            for tok in toks:
                if tok.type != tokenize.COMMENT:
                    continue
                m = _DISABLE_RE.search(tok.string)
                if m:
                    rules = {r.strip() for r in m.group(1).split(",")
                             if r.strip()}
                    self.suppressions.setdefault(
                        tok.start[0], set()).update(rules)
        except tokenize.TokenError:
            pass

    def suppressed(self, rule: str, line: int) -> bool:
        """True when ``rule`` is disabled on ``line`` or the line above
        (the comment often sits on its own line before a long
        statement)."""
        for ln in (line, line - 1):
            rules = self.suppressions.get(ln)
            if rules and (rule in rules or "all" in rules):
                return True
        return False


def load_source(path: str, root: str) -> Optional[Source]:
    rel = os.path.relpath(path, root).replace(os.sep, "/")
    try:
        with open(path, encoding="utf-8") as f:
            text = f.read()
        return Source(path, rel, text)
    except (OSError, SyntaxError, ValueError):
        return None


def collect_sources(root: str, *, subdirs: Iterable[str],
                    extra_files: Iterable[str] = (),
                    exclude_dirs: Iterable[str] = ("tests", ".git",
                                                   "__pycache__")) \
        -> list[Source]:
    """Parse every ``.py`` under ``root/<subdir>`` (recursively) plus
    ``extra_files`` (root-relative), skipping ``exclude_dirs`` by
    basename.  Unparseable files are skipped, not fatal — the lint gate
    must not fall over on a scratch file."""
    out: list[Source] = []
    seen: set[str] = set()
    excl = set(exclude_dirs)
    for sub in subdirs:
        base = os.path.join(root, sub)
        for dirpath, dirnames, filenames in os.walk(base):
            dirnames[:] = sorted(d for d in dirnames if d not in excl)
            for fn in sorted(filenames):
                if not fn.endswith(".py"):
                    continue
                p = os.path.join(dirpath, fn)
                if p in seen:
                    continue
                seen.add(p)
                src = load_source(p, root)
                if src is not None:
                    out.append(src)
    for rel in extra_files:
        p = os.path.join(root, rel)
        if p in seen or not os.path.isfile(p):
            continue
        seen.add(p)
        src = load_source(p, root)
        if src is not None:
            out.append(src)
    return out


class Baseline:
    """The checked-in accepted-findings file (JSON list of objects)."""

    def __init__(self, entries: Iterable[Finding] = ()):
        self._keys = {f.key() for f in entries}

    @classmethod
    def load(cls, path: str) -> "Baseline":
        if not os.path.isfile(path):
            return cls()
        with open(path, encoding="utf-8") as f:
            raw = json.load(f)
        return cls(Finding(rule=e["rule"], path=e["path"],
                           line=int(e.get("line", 0)),
                           message=e["message"])
                   for e in raw)

    @staticmethod
    def write(path: str, findings: Iterable[Finding]) -> None:
        entries = [{"rule": f.rule, "path": f.path, "line": f.line,
                    "message": f.message}
                   for f in sorted(findings,
                                   key=lambda f: (f.path, f.line, f.rule))]
        with open(path, "w", encoding="utf-8") as f:
            json.dump(entries, f, indent=1)
            f.write("\n")

    def contains(self, finding: Finding) -> bool:
        return finding.key() in self._keys

    def __len__(self) -> int:
        return len(self._keys)


def filter_findings(findings: Iterable[Finding], sources: dict[str, "Source"],
                    baseline: Optional[Baseline] = None) -> list[Finding]:
    """Drop inline-suppressed and baselined findings; sort the rest."""
    out = []
    for f in findings:
        src = sources.get(f.path)
        if src is not None and src.suppressed(f.rule, f.line):
            continue
        if baseline is not None and baseline.contains(f):
            continue
        out.append(f)
    out.sort(key=lambda f: (f.path, f.line, f.rule))
    return out
