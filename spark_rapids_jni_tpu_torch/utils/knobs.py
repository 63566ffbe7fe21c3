"""Registry of the port's ``SRJT_*`` environment knobs.

The port's counterpart of the JAX package's ``utils/knobs.py``: one
:class:`Knob` per name with its raw default, its parser and a one-line
doc, and :func:`get`, which re-reads the environment on every call so
that a toggle takes effect at once.  The mechanics (parsers, ``register``,
``get``) are the JAX package's; the registry holds only the knobs the
port's modules read so far, each with the JAX package's default and
parser.  The others arrive with the modules that read them.

Stdlib only: no torch, so tools can load it on their own.
"""

from __future__ import annotations

import os
from typing import Any, Callable, Optional

__all__ = ["Knob", "REGISTRY", "register", "get", "is_registered",
           "parse_bytes"]


# --- parsers ----------------------------------------------------------------
# Each turns the raw environment string into the knob's value; ``raw`` is
# None only for a knob whose default is None (unset means unset).


def _int(raw: str) -> int:
    return int(raw)


def _float(raw: str) -> float:
    return float(raw)


def _str(raw: Optional[str]) -> Optional[str]:
    return raw


def _on_unless_off(raw: str) -> bool:
    """The standard gate: anything but 0/off/false/empty."""
    return raw.lower() not in ("0", "off", "false", "")


def _on_unless_0_off(raw: str) -> bool:
    """The scan's gate: 0/off disable."""
    return raw.lower() not in ("0", "off")


def _opt_in(raw: str) -> bool:
    """Opt-in gate: only 1/true/on enable."""
    return raw.lower() in ("1", "true", "on")


def _is_1(raw: str) -> bool:
    return raw == "1"


def _not_0(raw: str) -> bool:
    return raw != "0"


def _opt_float(raw: Optional[str]) -> Optional[float]:
    """None/empty/whitespace → None, else float."""
    if raw is None or not raw.strip():
        return None
    return float(raw)


def _opt_int(raw: Optional[str]) -> Optional[int]:
    """None/empty → None, else int."""
    if raw is None or not raw:
        return None
    return int(raw)


def _opt_str(raw: Optional[str]) -> Optional[str]:
    """None/empty → None, else the string (paths, rule lists)."""
    return raw or None


def parse_bytes(raw) -> Optional[int]:
    """``"512m"`` / ``"2g"`` / ``"65536"`` → bytes; None/empty/``none``/
    ``unlimited``/``off`` → None (no limit)."""
    if raw is None:
        return None
    if isinstance(raw, (int, float)):
        return int(raw)
    t = raw.strip().lower()
    if t in ("", "none", "unlimited", "off"):
        return None
    mult = 1
    if t[-1] in "kmgt":
        mult = 1 << (10 * ("kmgt".index(t[-1]) + 1))
        t = t[:-1]
    return int(float(t) * mult)


class Knob:
    """One registered environment knob: name, raw default, parser, doc."""

    __slots__ = ("name", "default", "parse", "doc", "section")

    def __init__(self, name: str, default: Optional[str],
                 parse: Callable[[Optional[str]], Any], doc: str,
                 section: str):
        self.name = name
        self.default = default       # raw string default; None = unset
        self.parse = parse
        self.doc = doc
        self.section = section

    def value(self) -> Any:
        """Parsed current value: environment override, else the default."""
        return self.parse(os.environ.get(self.name, self.default))


REGISTRY: dict[str, Knob] = {}


def register(name: str, default: Optional[str], parse, doc: str,
             section: str = "general") -> Knob:
    k = Knob(name, default, parse, doc, section)
    REGISTRY[name] = k
    return k


def get(name: str) -> Any:
    """The parsed value of registered knob ``name`` (re-reads the
    environment on every call).  Raises ``KeyError`` for unregistered
    names."""
    return REGISTRY[name].value()


def is_registered(name: str) -> bool:
    return name in REGISTRY


# --- the registry -----------------------------------------------------------

# plan optimizer (plan/)
register("SRJT_PLAN_OPT", "1", _not_0,
         "`0` disables all plan rewrites (lower the raw tree)", "plan")
register("SRJT_PLAN_RULES", None, _opt_str,
         "comma-separated allowlist of optimizer rule names", "plan")
register("SRJT_PLAN_MAX_PASSES", "10", _int,
         "optimizer fixpoint pass bound", "plan")
register("SRJT_PLAN_STATS_CAP", "4096", _int,
         "cardinality-stats LRU entry cap", "plan")
register("SRJT_PLAN_STATS_PATH", None, _opt_str,
         "JSON sidecar for cardinality stats: loaded at first use for "
         "warm priors, saved atomically at exit", "plan")

# SQL front end (sql/)
register("SRJT_SQL_CACHE", "1", _on_unless_0_off,
         "memoize SQL text → optimized plan tree per (text, params, "
         "schema) so repeat submissions skip parse+bind+optimize; "
         "`0`/`off` reparses every call", "sql")
register("SRJT_SQL_CACHE_CAP", "256", _int,
         "parsed-plan memo entry cap (LRU)", "sql")
register("SRJT_SQL_MAX_LEN", "262144", _int,
         "reject SQL text longer than this many characters before "
         "tokenizing", "sql")

# parquet scan (parquet/)
register("SRJT_FUSED_FILTER", "1", _on_unless_0_off,
         "fused scan→filter: planner row predicates prune rows on the "
         "walked host pages (dictionary entries evaluated once, codes "
         "masked) before anything is staged; `0`/`off` decodes all rows "
         "and filters after", "parquet")
