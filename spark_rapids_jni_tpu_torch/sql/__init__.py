"""SQL front-end: text → ``plan/ir.py`` trees → the whole engine.

The port's copy of the JAX package's ``sql/``.  A first-party recursive-descent parser (``sql/parser.py`` documents the
grammar) binds against catalog schemas (``sql/binder.py``) and emits the
same IR the hand-built plan trees use, so a SQL-born query flows
unchanged through rule optimization, lowering and
``models/compiled.py`` — keyed on the same structural fingerprint as an
equivalently-shaped hand-built tree, in this package and in the JAX
package alike.

Entry points:

* :func:`parse` — text → AST (:class:`SqlError` with caret on failure).
* :func:`sql_to_plan` — text → **optimized** IR tree, memoized per
  (text, params, schema) under ``SRJT_SQL_CACHE`` so a warm repeat
  submission skips parse+bind+optimize entirely.
* :func:`compile_sql` — text → ``qfn(tables) -> Table`` (the shape
  ``models/compiled.compile_query`` takes, fingerprint attached).
* :func:`to_sql` — AST → SQL text (round-trip stable).

:data:`COUNTS` holds the memo's lifetime ``cache.hit`` / ``cache.miss``
and ``parse_error`` counts, which also go to ``utils.metrics`` as
``sql.cache.*``; a failed parse or bind files a ``sql_parse_error``
flight incident.
"""

from __future__ import annotations

import collections
from collections import OrderedDict
from threading import Lock
from typing import Any, Dict, Optional, Sequence

from ..plan import ir, lower, rules
from ..utils import flight, knobs, metrics
from .binder import bind
from .parser import Query, parse, to_sql
from .tokenizer import SqlError

__all__ = ["SqlError", "Query", "parse", "to_sql", "bind", "sql_to_plan",
           "compile_sql", "cache_stats", "clear_cache"]


# --- parsed-plan memo -------------------------------------------------------

_memo: "OrderedDict[tuple, ir.Plan]" = OrderedDict()
_memo_lock = Lock()

#: the memo's hits and misses and the failed parses and binds, for the
#: process's lifetime: :func:`clear_cache` leaves them alone
COUNTS: collections.Counter = collections.Counter()


def _schema_sig(schemas: Dict[str, Sequence[str]]) -> tuple:
    return tuple(sorted((t, tuple(cols)) for t, cols in schemas.items()))


def _params_sig(params: Optional[Dict[str, Any]]) -> tuple:
    if not params:
        return ()
    return tuple(sorted(params.items()))


def clear_cache() -> None:
    with _memo_lock:
        _memo.clear()


def cache_stats() -> dict:
    """Lifetime hit/miss counters of the SQL plan memo (they survive
    ``clear_cache``) and its current size."""
    return {"hit": COUNTS["cache.hit"], "miss": COUNTS["cache.miss"],
            "size": len(_memo)}


def _record_parse_error(e: SqlError, surface: str) -> None:
    COUNTS["parse_error"] += 1
    flight.incident("sql_parse_error", surface=surface, line=e.line,
                    col=e.col, message=e.message[:200])


def _count(key: str) -> None:
    COUNTS[key] += 1
    metrics.count(f"sql.{key}")


def sql_to_plan(text: str, schemas: Dict[str, Sequence[str]],
                params: Optional[Dict[str, Any]] = None, *,
                stats=None, optimize: bool = True) -> ir.Plan:
    """Parse + bind + (by default) rule-optimize ``text``.

    The result is memoized on ``(text, params, schemas)`` when
    ``SRJT_SQL_CACHE`` is on — a warm hit returns the previously
    optimized tree with zero parse work, which is what makes
    ``submit_sql`` amortized-free against pre-built plan trees (the
    plan-cache fingerprint dedupes the compile).  Parse/bind failures
    raise :class:`SqlError`, count in ``COUNTS["parse_error"]`` and
    record a ``sql_parse_error`` incident."""
    if len(text) > knobs.get("SRJT_SQL_MAX_LEN"):
        e = SqlError(f"query text of {len(text)} chars exceeds "
                     f"SRJT_SQL_MAX_LEN", text[:80], 1, 1)
        _record_parse_error(e, "sql_to_plan")
        raise e
    use_memo = bool(knobs.get("SRJT_SQL_CACHE")) and stats is None
    key = None
    if use_memo:
        key = (text, _params_sig(params), _schema_sig(schemas), optimize)
        with _memo_lock:
            got = _memo.get(key)
            if got is not None:
                _memo.move_to_end(key)
                _count("cache.hit")
                return got
        _count("cache.miss")
    try:
        with metrics.span("sql.parse"):
            tree = bind(parse(text), schemas, params, text)
    except SqlError as e:
        _record_parse_error(e, "sql_to_plan")
        raise
    if optimize:
        tree = rules.optimize(tree, schemas, stats=stats).tree
    else:
        ir.schema_of(tree, schemas)      # validate even when not rewriting
    if use_memo:
        with _memo_lock:
            _memo[key] = tree
            _memo.move_to_end(key)
            cap = knobs.get("SRJT_SQL_CACHE_CAP")
            while len(_memo) > cap:
                _memo.popitem(last=False)
    return tree


def compile_sql(text: str, schemas: Dict[str, Sequence[str]],
                params: Optional[Dict[str, Any]] = None, *, stats=None):
    """SQL text → ``qfn(tables: dict[str, Table]) -> Table`` with
    ``.plan_tree`` / ``.plan_fingerprint`` / ``.plan_output_names``
    attached — drop-in wherever a compiled plan tree goes
    (``models/compiled.compile_query``).  The qfn runs where its tables
    are."""
    tree = sql_to_plan(text, schemas, params, stats=stats)
    return lower.compile_plan(tree, schemas)
