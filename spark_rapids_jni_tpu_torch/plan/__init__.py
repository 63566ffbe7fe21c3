"""Relational plan IR + rule-based optimizer + lowering, in the port.

Queries become immutable plan trees (``plan.ir``), a fixpoint rewrite
engine pushes projections/filters into the parquet scan, reorders joins
from observed cardinalities, and detects join→aggregate fusion
(``plan.rules``), and the lowering (``plan.lower``) emits the exact
hand-fused op sequence — bit-identical results, composing unchanged with
``models/compiled.py``.  The JAX package's exports: adaptive execution
(``plan.adaptive``, behind ``SRJT_AQE``) and per-node profiles
(``plan.profile``) included.
"""

from . import adaptive, ir, lower, profile, rules, stats
from .adaptive import (AdaptiveReport, compile_adaptive_plan,
                       execute_adaptive, explain_adaptive)
from .ir import (GROUPING_ID, Aggregate, And, Between, Cmp, Col, Distinct,
                 Filter, FusedJoinAggregate, IsIn, Join, Limit, Lit, Mul, Or,
                 Plan, PlanError, Project, ScalarAgg, Scan, Sort, Union,
                 Window, expr_columns, fingerprint, render, schema_of)
from .lower import (FileCatalog, TableCatalog, compile_plan, execute,
                    rowgroup_conditions)
from .profile import NodeProfile, QueryProfile, explain_analyze
from .rules import DEFAULT_RULES, OptimizeResult, explain, optimize
from .stats import GLOBAL as GLOBAL_STATS
from .stats import CardinalityStats

__all__ = [
    "ir", "lower", "rules", "stats", "adaptive", "profile",
    "AdaptiveReport", "compile_adaptive_plan", "execute_adaptive",
    "explain_adaptive",
    "Plan", "PlanError", "Scan", "Filter", "Project", "Join", "Aggregate",
    "FusedJoinAggregate", "Window", "Sort", "Limit", "Union", "Distinct",
    "GROUPING_ID",
    "Col", "Lit", "Cmp", "Between", "And", "Or", "IsIn", "ScalarAgg", "Mul",
    "schema_of", "fingerprint", "render", "expr_columns",
    "optimize", "explain", "DEFAULT_RULES", "OptimizeResult",
    "compile_plan", "execute", "TableCatalog", "FileCatalog",
    "rowgroup_conditions", "CardinalityStats", "GLOBAL_STATS",
    "NodeProfile", "QueryProfile", "explain_analyze",
]
