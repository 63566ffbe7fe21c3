#!/usr/bin/env python3
"""torch_lint — the static analysis of the PyTorch port.

Runs the three passes of ``spark_rapids_jni_tpu_torch/analysis/`` over
``spark_rapids_jni_tpu_torch/`` and ``chip_smoke.py``:

* concurrency — ``conc-lock-order``, ``conc-mixed-guard``,
  ``conc-global-augassign``
* host syncs  — ``trace-host-sync``, ``trace-branch``, ``trace-iter``
* knobs       — ``knob-env``, ``knob-unregistered``, ``knob-undoc``

Usage::

  python tools/torch_lint.py                  # lint vs the baseline
  python tools/torch_lint.py --no-baseline    # every finding, raw
  python tools/torch_lint.py --write-baseline # accept the current tree
  python tools/torch_lint.py --knob-table     # refresh the README block

Exit status: 0 when no finding is left outside the baseline
(``tools/torch_lint_baseline.json``), 1 otherwise.  The analysis modules
and ``utils/knobs.py`` are stdlib-only and load by file path, so the
tool imports neither torch nor jax and runs in a few seconds.

Suppression: ``# srjt-lint: disable=<rule>[,<rule>]`` on (or directly
above) the finding line, or an entry in the baseline file, which matches
on (rule, path, message), not on the line.
"""

from __future__ import annotations

import argparse
import collections
import importlib
import importlib.util
import os
import sys
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = "spark_rapids_jni_tpu_torch"
SCAN_SUBDIRS = (PKG,)
SCAN_EXTRA = ("chip_smoke.py",)
BASELINE_DEFAULT = os.path.join("tools", "torch_lint_baseline.json")
KNOB_TABLE_BEGIN = ("<!-- torch-knob-table:begin (generated by "
                    "tools/torch_lint.py --knob-table; do not hand-edit) -->")
KNOB_TABLE_END = "<!-- torch-knob-table:end -->"
# the name the analysis package loads under: not the port's own, so that
# its __init__ (which imports torch) never runs
_ALIAS = "_torch_lint_analysis"


def _analysis(root: str):
    """The port's ``analysis`` package, loaded by file path as
    ``_torch_lint_analysis``: (core, concurrency, knobpass, tracepass)."""
    if _ALIAS not in sys.modules:
        where = os.path.join(root, PKG, "analysis")
        spec = importlib.util.spec_from_file_location(
            _ALIAS, os.path.join(where, "__init__.py"),
            submodule_search_locations=[where])
        pkg = importlib.util.module_from_spec(spec)
        sys.modules[_ALIAS] = pkg
        spec.loader.exec_module(pkg)
    return tuple(importlib.import_module(f"{_ALIAS}.{m}")
                 for m in ("core", "concurrency", "knobpass", "tracepass"))


def _knobs_module(root: str):
    path = os.path.join(root, PKG, "utils", "knobs.py")
    spec = importlib.util.spec_from_file_location("_torch_lint_knobs", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def collect(root: str) -> list:
    core = _analysis(root)[0]
    return core.collect_sources(root, subdirs=SCAN_SUBDIRS,
                                extra_files=SCAN_EXTRA)


def run_all(root: str, sources: list) -> list:
    _, concurrency, knobpass, tracepass = _analysis(root)
    registry = knobpass.load_registry(root)
    readme_text = None
    readme_path = os.path.join(root, "README.md")
    if os.path.isfile(readme_path):
        with open(readme_path, encoding="utf-8") as f:
            readme_text = f.read()
    return (concurrency.run(sources) + tracepass.run(sources)
            + knobpass.run(sources, set(registry), readme_text))


def refresh_knob_table(root: str) -> int:
    """Regenerate the port's README knob block between its markers."""
    mod = _knobs_module(root)
    table = mod.markdown_table()
    readme = os.path.join(root, "README.md")
    with open(readme, encoding="utf-8") as f:
        text = f.read()
    try:
        head, rest = text.split(KNOB_TABLE_BEGIN, 1)
        _old, tail = rest.split(KNOB_TABLE_END, 1)
    except ValueError:
        print("README.md is missing the port's knob-table markers:\n  "
              f"{KNOB_TABLE_BEGIN}\n  {KNOB_TABLE_END}", file=sys.stderr)
        return 1
    new = head + KNOB_TABLE_BEGIN + "\n\n" + table + "\n" \
        + KNOB_TABLE_END + tail
    state = "already current"
    if new != text:
        with open(readme, "w", encoding="utf-8") as f:
            f.write(new)
        state = "refreshed"
    print(f"README.md port knob table {state} ({len(mod.REGISTRY)} knobs).")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=_ROOT)
    ap.add_argument("--baseline", default=None,
                    help=f"baseline file (default {BASELINE_DEFAULT})")
    ap.add_argument("--no-baseline", action="store_true",
                    help="report every finding, ignoring the baseline")
    ap.add_argument("--write-baseline", action="store_true",
                    help="accept the current tree's findings as baseline")
    ap.add_argument("--knob-table", action="store_true",
                    help="refresh the README's port knob table and exit")
    args = ap.parse_args(argv)

    root = os.path.abspath(args.root)
    if args.knob_table:
        return refresh_knob_table(root)

    core = _analysis(root)[0]
    t0 = time.monotonic()
    sources = collect(root)
    by_rel = {s.rel: s for s in sources}
    raw = run_all(root, sources)
    baseline_path = os.path.join(root, args.baseline or BASELINE_DEFAULT)
    inline_filtered = core.filter_findings(raw, by_rel, baseline=None)
    if args.write_baseline:
        core.Baseline.write(baseline_path, inline_filtered)
        print(f"wrote {len(inline_filtered)} findings to "
              f"{os.path.relpath(baseline_path, root)}")
        return 0

    baseline = (None if args.no_baseline
                else core.Baseline.load(baseline_path))
    findings = core.filter_findings(raw, by_rel, baseline=baseline)
    for f in findings:
        print(f)
    per_rule = collections.Counter(f.rule for f in findings)
    baselined = len(inline_filtered) - len(findings)
    print(f"--- torch_lint: {len(sources)} files, {len(findings)} finding(s)"
          + (f" ({baselined} baselined)" if baseline is not None else "")
          + f", {time.monotonic() - t0:.1f}s")
    for rule in sorted(per_rule):
        print(f"    {rule:24s} {per_rule[rule]}")
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
