"""Logical plan IR: immutable relational plan trees (Catalyst analog).

The port's copy of the JAX package's ``plan/ir.py``: queries become small
trees of frozen dataclass nodes — ``Scan``, ``Filter``, ``Project``,
``Join``, ``Aggregate``, ``Window``, ``Sort``, ``Limit`` — over typed
expressions, instead of hand-written op-layer Python
(``models/tpcds.py``).  The rewrite engine (``plan/rules.py``) rewrites
these trees; ``plan/lower.py`` lowers them onto the port's ops.

Design constraints:

* **Immutability**: every node and expression is a frozen dataclass with
  tuple-valued children, so rewrites share subtrees structurally and a
  node can key caches.
* **Name-based references**: columns are referenced by NAME, not index —
  projection pushdown renumbers physical columns freely without touching
  the tree above.
* **Stable fingerprints**: :func:`fingerprint` hashes the canonical form
  of a tree (conjunct order normalized, literals type-normalized), so two
  semantically-identical trees produced by different construction orders
  share one key.  ``_canon_lit`` and ``_sexp`` are the JAX package's,
  character for character, so a tree has the same fingerprint in both
  packages.
* **Host literals**: a ``Lit`` holds a Python or numpy scalar, never a
  torch tensor, whose fingerprint would read the device.
"""

from __future__ import annotations

import functools
import hashlib
from dataclasses import dataclass, replace
from typing import Any, Optional, Tuple

import torch


class PlanError(ValueError):
    """Malformed plan tree: unknown column/table, ambiguous names, or an
    expression form the lowering does not implement."""


# --- expressions ------------------------------------------------------------


@dataclass(frozen=True)
class Expr:
    pass


@dataclass(frozen=True)
class Col(Expr):
    """Column reference by name."""
    name: str


@dataclass(frozen=True)
class Lit(Expr):
    """Scalar literal (int / float / str / bool)."""
    value: Any

    def __post_init__(self):
        if isinstance(self.value, torch.Tensor):
            raise PlanError("a plan literal is a host scalar, not a torch "
                            "tensor")


@dataclass(frozen=True)
class Cmp(Expr):
    """``left <op> right`` with op in ``== != < <= > >=``; null rows
    compare False (validity ANDed into the mask, SQL-style)."""
    op: str
    left: Expr
    right: Expr


@dataclass(frozen=True)
class Between(Expr):
    """``lo <= col <= hi`` (either bound optional; ``hi_strict`` makes
    the upper bound exclusive) — the ``tpcds._range_mask`` shape."""
    col: Expr
    lo: Any = None
    hi: Any = None
    hi_strict: bool = False


@dataclass(frozen=True)
class And(Expr):
    parts: Tuple[Expr, ...]

    def __post_init__(self):
        object.__setattr__(self, "parts", tuple(self.parts))


@dataclass(frozen=True)
class Or(Expr):
    parts: Tuple[Expr, ...]

    def __post_init__(self):
        object.__setattr__(self, "parts", tuple(self.parts))


@dataclass(frozen=True)
class IsIn(Expr):
    """Null-safe membership: OR of null-safe equalities."""
    col: Expr
    values: Tuple[Any, ...]

    def __post_init__(self):
        object.__setattr__(self, "values", tuple(self.values))


@dataclass(frozen=True)
class ScalarAgg(Expr):
    """Whole-column scalar aggregate (``mean`` / ``sum``) usable as a
    comparison operand — stays a device scalar through lowering (no host
    pull, composes with capture/replay)."""
    fn: str
    arg: Expr


@dataclass(frozen=True)
class Mul(Expr):
    left: Expr
    right: Expr


def and_(parts) -> Optional[Expr]:
    """Conjunction of ``parts`` (flattened); None for an empty list."""
    flat: list[Expr] = []
    for p in parts:
        flat.extend(conjuncts(p))
    if not flat:
        return None
    return flat[0] if len(flat) == 1 else And(tuple(flat))


def conjuncts(expr: Optional[Expr]) -> list[Expr]:
    """Flatten nested ``And`` into a conjunct list (order-preserving)."""
    if expr is None:
        return []
    if isinstance(expr, And):
        out: list[Expr] = []
        for p in expr.parts:
            out.extend(conjuncts(p))
        return out
    return [expr]


def expr_columns(expr: Optional[Expr]) -> frozenset[str]:
    """All column names an expression references."""
    if expr is None:
        return frozenset()
    if isinstance(expr, Col):
        return frozenset((expr.name,))
    if isinstance(expr, (And, Or)):
        return frozenset().union(*(expr_columns(p) for p in expr.parts))
    if isinstance(expr, Cmp):
        return expr_columns(expr.left) | expr_columns(expr.right)
    if isinstance(expr, (Between, IsIn)):
        return expr_columns(expr.col)
    if isinstance(expr, ScalarAgg):
        return expr_columns(expr.arg)
    if isinstance(expr, Mul):
        return expr_columns(expr.left) | expr_columns(expr.right)
    return frozenset()


# --- plan nodes -------------------------------------------------------------


@dataclass(frozen=True)
class Plan:
    pass


def _tup(v):
    return None if v is None else tuple(v)


@dataclass(frozen=True)
class Scan(Plan):
    """Read a base table.  ``columns=None`` means the full schema;
    ``predicate`` is applied at the scan (and, on the file path, drives
    row-group pruning from footer statistics before decode)."""
    table: str
    columns: Optional[Tuple[str, ...]] = None
    predicate: Optional[Expr] = None

    def __post_init__(self):
        object.__setattr__(self, "columns", _tup(self.columns))


@dataclass(frozen=True)
class Filter(Plan):
    child: Plan
    predicate: Expr


@dataclass(frozen=True)
class Project(Plan):
    child: Plan
    columns: Tuple[str, ...]

    def __post_init__(self):
        object.__setattr__(self, "columns", tuple(self.columns))


@dataclass(frozen=True)
class Join(Plan):
    """Equi-join; output schema = left schema ++ right schema.

    ``engine`` optionally pins the physical build-index engine
    (``"dense"`` / ``"sorted"``) for THIS join — the adaptive executor
    (``plan/adaptive.py``) bakes observed-statistics engine flips into
    the tree through it.  ``None`` (the default, and the only value the
    front-end emits) keeps the ``ops/join_plan.py`` heuristic; both
    engines produce bit-identical results, so a pin only trades
    footprint for speed."""
    left: Plan
    right: Plan
    left_on: Tuple[str, ...]
    right_on: Tuple[str, ...]
    how: str = "inner"
    engine: Optional[str] = None

    def __post_init__(self):
        object.__setattr__(self, "left_on", tuple(self.left_on))
        object.__setattr__(self, "right_on", tuple(self.right_on))


#: name of the synthetic column grouping aggregates append (bit k set when
#: key k was aggregated away; MSB = first key — matches ``ops.groupby``).
GROUPING_ID = "grouping_id"


@dataclass(frozen=True)
class Aggregate(Plan):
    """GROUP BY ``keys``; ``aggs`` are ``(value_column, fn, out_name)``
    with fn from the ops groupby set (sum/mean/count/min/max/... plus
    ``nunique`` = COUNT(DISTINCT), single-agg only).

    ``grouping`` widens plain GROUP BY to multi-level grouping:
    ``"rollup"`` / ``"cube"`` derive their grouping sets from ``keys``;
    ``"sets"`` takes explicit ``grouping_sets`` — tuples of positions
    into ``keys`` (the ``ops.groupby_grouping_sets`` convention).  Any
    grouping spec appends a ``grouping_id`` int64 column to the output
    schema."""
    child: Plan
    keys: Tuple[str, ...]
    aggs: Tuple[Tuple[str, str, str], ...]
    grouping: Optional[str] = None              # None|"rollup"|"cube"|"sets"
    grouping_sets: Optional[Tuple[Tuple[int, ...], ...]] = None

    def __post_init__(self):
        object.__setattr__(self, "keys", tuple(self.keys))
        object.__setattr__(self, "aggs",
                           tuple(tuple(a) for a in self.aggs))
        if self.grouping_sets is not None:
            object.__setattr__(self, "grouping_sets",
                               tuple(tuple(s) for s in self.grouping_sets))
        if self.grouping not in (None, "rollup", "cube", "sets"):
            raise PlanError(f"unknown grouping spec {self.grouping!r}")
        if (self.grouping == "sets") != (self.grouping_sets is not None):
            raise PlanError("grouping_sets requires grouping='sets' "
                            "(and vice versa)")


@dataclass(frozen=True)
class FusedJoinAggregate(Plan):
    """Rule-emitted fusion of ``Aggregate(Join(left, right))`` — lowers to
    ``ops.join_plan.join_aggregate`` (no pair materialization).  Not meant
    to be written by hand: the ``fuse_join_aggregate`` rule detects the
    shape."""
    left: Plan
    right: Plan
    left_on: Tuple[str, ...]
    right_on: Tuple[str, ...]
    keys: Tuple[str, ...]
    aggs: Tuple[Tuple[str, str, str], ...]
    how: str = "inner"
    engine: Optional[str] = None     # see Join.engine

    def __post_init__(self):
        object.__setattr__(self, "left_on", tuple(self.left_on))
        object.__setattr__(self, "right_on", tuple(self.right_on))
        object.__setattr__(self, "keys", tuple(self.keys))
        object.__setattr__(self, "aggs",
                           tuple(tuple(a) for a in self.aggs))


@dataclass(frozen=True)
class Window(Plan):
    """Append one window-function column named ``out``
    (``fn`` in row_number/rank/dense_rank/running_sum/lag over
    ``ops.window``).  ``ascending`` optionally orders each order key
    descending (parallel to ``order_by``); ``value`` names the input
    column for value-carrying fns (running_sum/lag).  Both default to
    None and stay out of the fingerprint when unset, so pre-existing
    rank/row_number trees keep their historical cache keys."""
    child: Plan
    fn: str
    partition_by: Tuple[str, ...]
    order_by: Tuple[str, ...]
    out: str
    ascending: Optional[Tuple[bool, ...]] = None
    value: Optional[str] = None

    def __post_init__(self):
        object.__setattr__(self, "partition_by", tuple(self.partition_by))
        object.__setattr__(self, "order_by", tuple(self.order_by))
        object.__setattr__(self, "ascending", _tup(self.ascending))


@dataclass(frozen=True)
class Union(Plan):
    """UNION ALL: positional concatenation of ``parts`` (each the same
    arity and per-position dtype); output columns are renamed to
    ``names`` (the first arm's aliases, SQL-style)."""
    parts: Tuple[Plan, ...]
    names: Tuple[str, ...]

    def __post_init__(self):
        object.__setattr__(self, "parts", tuple(self.parts))
        object.__setattr__(self, "names", tuple(self.names))
        if len(self.parts) < 2:
            raise PlanError("union needs at least two parts")


@dataclass(frozen=True)
class Distinct(Plan):
    """Row-level DISTINCT over the child's full schema (lowers to the
    grouped-by-all-columns path; output order is the key sort order)."""
    child: Plan


@dataclass(frozen=True)
class Sort(Plan):
    child: Plan
    keys: Tuple[str, ...]
    ascending: Optional[Tuple[bool, ...]] = None

    def __post_init__(self):
        object.__setattr__(self, "keys", tuple(self.keys))
        object.__setattr__(self, "ascending", _tup(self.ascending))


@dataclass(frozen=True)
class Limit(Plan):
    child: Plan
    n: int


# --- tree plumbing ----------------------------------------------------------


def children(node: Plan) -> tuple[Plan, ...]:
    if isinstance(node, (Join, FusedJoinAggregate)):
        return (node.left, node.right)
    if isinstance(node, Union):
        return node.parts
    if isinstance(node, (Filter, Project, Aggregate, Window, Sort, Limit,
                         Distinct)):
        return (node.child,)
    return ()


def with_children(node: Plan, kids: tuple[Plan, ...]) -> Plan:
    if isinstance(node, (Join, FusedJoinAggregate)):
        return replace(node, left=kids[0], right=kids[1])
    if isinstance(node, Union):
        return replace(node, parts=tuple(kids))
    if isinstance(node, (Filter, Project, Aggregate, Window, Sort, Limit,
                         Distinct)):
        return replace(node, child=kids[0])
    return node


def transform_up(node: Plan, fn) -> Plan:
    """Bottom-up rewrite: children first, then ``fn(node)`` (None = keep).
    Shares unchanged subtrees (identity-preserving when nothing fires)."""
    kids = children(node)
    new_kids = tuple(transform_up(k, fn) for k in kids)
    if any(nk is not k for nk, k in zip(new_kids, kids)):
        node = with_children(node, new_kids)
    out = fn(node)
    return node if out is None else out


def walk(node: Plan):
    """Pre-order node iterator."""
    yield node
    for k in children(node):
        yield from walk(k)


# --- schema propagation -----------------------------------------------------


def schema_of(node: Plan, schemas: dict) -> tuple[str, ...]:
    """Output column names of ``node``; ``schemas`` maps base-table name →
    column-name sequence.  Validates column references on the way up."""
    if isinstance(node, Scan):
        try:
            full = tuple(schemas[node.table])
        except (KeyError, TypeError):
            raise PlanError(f"unknown table {node.table!r} "
                            f"(catalog: {sorted(schemas or ())})")
        cols = full if node.columns is None else node.columns
        _need(cols, full, f"scan({node.table})")
        _need(expr_columns(node.predicate), cols,
              f"scan({node.table}) predicate")
        return cols
    if isinstance(node, Filter):
        sch = schema_of(node.child, schemas)
        _need(expr_columns(node.predicate), sch, "filter predicate")
        return sch
    if isinstance(node, Project):
        sch = schema_of(node.child, schemas)
        _need(node.columns, sch, "project")
        return node.columns
    if isinstance(node, Join):
        ls = schema_of(node.left, schemas)
        rs = schema_of(node.right, schemas)
        _need(node.left_on, ls, "join left keys")
        _need(node.right_on, rs, "join right keys")
        if node.how in ("semi", "anti"):
            return ls                       # right side filters, never lands
        dup = set(ls) & set(rs)
        if dup:
            raise PlanError(f"join sides share column names {sorted(dup)}")
        return ls + rs
    if isinstance(node, Aggregate):
        sch = schema_of(node.child, schemas)
        _need(node.keys, sch, "aggregate keys")
        _need([a[0] for a in node.aggs], sch, "aggregate values")
        out = node.keys + tuple(a[2] for a in node.aggs)
        return out + (GROUPING_ID,) if node.grouping else out
    if isinstance(node, FusedJoinAggregate):
        ls = schema_of(node.left, schemas)
        rs = schema_of(node.right, schemas)
        joined = ls + rs
        _need(node.keys, joined, "fused aggregate keys")
        _need([a[0] for a in node.aggs], joined, "fused aggregate values")
        return node.keys + tuple(a[2] for a in node.aggs)
    if isinstance(node, Window):
        sch = schema_of(node.child, schemas)
        _need(node.partition_by + node.order_by, sch, "window keys")
        if node.value is not None:
            _need((node.value,), sch, "window value")
        return sch + (node.out,)
    if isinstance(node, Union):
        arity = len(node.names)
        for i, p in enumerate(node.parts):
            psch = schema_of(p, schemas)
            if len(psch) != arity:
                raise PlanError(
                    f"union arm {i} has {len(psch)} columns, expected "
                    f"{arity} ({list(node.names)})")
        return node.names
    if isinstance(node, Distinct):
        return schema_of(node.child, schemas)
    if isinstance(node, (Sort, Limit)):
        sch = schema_of(node.child, schemas)
        if isinstance(node, Sort):
            _need(node.keys, sch, "sort keys")
        return sch
    raise PlanError(f"unknown plan node {type(node).__name__}")


def _need(names, available, what: str):
    missing = [n for n in names if n not in available]
    if missing:
        raise PlanError(f"{what}: unknown column(s) {missing} "
                        f"(have {list(available)})")


# --- stable structural fingerprint ------------------------------------------


def _canon_lit(v) -> str:
    if isinstance(v, bool):
        return f"b:{v}"
    if isinstance(v, str):
        return f"s:{v}"
    if hasattr(v, "item"):          # numpy scalar → python scalar
        v = v.item()
    if isinstance(v, int):
        return f"i:{v}"
    if isinstance(v, float):
        return f"f:{v!r}"
    return f"x:{v!r}"


def _sexp_expr(e: Optional[Expr]) -> str:
    if e is None:
        return "-"
    if isinstance(e, Col):
        return f"c({e.name})"
    if isinstance(e, Lit):
        return f"l({_canon_lit(e.value)})"
    if isinstance(e, Cmp):
        return f"cmp({e.op},{_sexp_expr(e.left)},{_sexp_expr(e.right)})"
    if isinstance(e, Between):
        return (f"between({_sexp_expr(e.col)},"
                f"{_canon_lit(e.lo) if e.lo is not None else '-'},"
                f"{_canon_lit(e.hi) if e.hi is not None else '-'},"
                f"{int(e.hi_strict)})")
    if isinstance(e, (And, Or)):
        tag = "and" if isinstance(e, And) else "or"
        # conjunct/disjunct order is semantically irrelevant: normalize
        return f"{tag}({','.join(sorted(_sexp_expr(p) for p in e.parts))})"
    if isinstance(e, IsIn):
        vals = ",".join(sorted(_canon_lit(v) for v in e.values))
        return f"isin({_sexp_expr(e.col)},[{vals}])"
    if isinstance(e, ScalarAgg):
        return f"sagg({e.fn},{_sexp_expr(e.arg)})"
    if isinstance(e, Mul):
        return f"mul({_sexp_expr(e.left)},{_sexp_expr(e.right)})"
    raise PlanError(f"unknown expression {type(e).__name__}")


def _sexp(node: Plan) -> str:
    if isinstance(node, Scan):
        cols = "*" if node.columns is None else ",".join(node.columns)
        return (f"scan({node.table},[{cols}],"
                f"{_sexp_expr(node.predicate)})")
    if isinstance(node, Filter):
        return f"filter({_sexp(node.child)},{_sexp_expr(node.predicate)})"
    if isinstance(node, Project):
        return f"project({_sexp(node.child)},[{','.join(node.columns)}])"
    if isinstance(node, Join):
        keys = ",".join(f"{l}={r}"
                        for l, r in zip(node.left_on, node.right_on))
        # engine pin participates only when SET: unpinned trees (every
        # tree the front-end builds) keep their historical fingerprints,
        # while adaptive-decided trees get distinct cache keys for free
        eng = "" if node.engine is None else f",e={node.engine}"
        return (f"join({node.how},{_sexp(node.left)},{_sexp(node.right)},"
                f"[{keys}]{eng})")
    if isinstance(node, Aggregate):
        aggs = ",".join(f"{fn}({c})>{o}" for c, fn, o in node.aggs)
        # grouping spec participates only when SET: plain GROUP BY trees
        # keep their historical fingerprints
        if node.grouping is None:
            grp = ""
        elif node.grouping == "sets":
            sets = ";".join(",".join(map(str, s))
                            for s in node.grouping_sets)
            grp = f",g=sets[{sets}]"
        else:
            grp = f",g={node.grouping}"
        return (f"agg({_sexp(node.child)},[{','.join(node.keys)}],"
                f"[{aggs}]{grp})")
    if isinstance(node, FusedJoinAggregate):
        keys = ",".join(f"{l}={r}"
                        for l, r in zip(node.left_on, node.right_on))
        aggs = ",".join(f"{fn}({c})>{o}" for c, fn, o in node.aggs)
        eng = "" if node.engine is None else f",e={node.engine}"
        return (f"joinagg({node.how},{_sexp(node.left)},"
                f"{_sexp(node.right)},[{keys}],[{','.join(node.keys)}],"
                f"[{aggs}]{eng})")
    if isinstance(node, Window):
        # ascending/value participate only when SET (fingerprint
        # back-compat, same discipline as Join.engine)
        asc = ("" if node.ascending is None
               else ",a=" + "".join("1" if a else "0"
                                    for a in node.ascending))
        val = "" if node.value is None else f",v={node.value}"
        return (f"window({_sexp(node.child)},{node.fn},"
                f"[{','.join(node.partition_by)}],"
                f"[{','.join(node.order_by)}],{node.out}{asc}{val})")
    if isinstance(node, Union):
        parts = ",".join(_sexp(p) for p in node.parts)
        return f"union([{parts}],[{','.join(node.names)}])"
    if isinstance(node, Distinct):
        return f"distinct({_sexp(node.child)})"
    if isinstance(node, Sort):
        asc = ("-" if node.ascending is None
               else "".join("1" if a else "0" for a in node.ascending))
        return f"sort({_sexp(node.child)},[{','.join(node.keys)}],{asc})"
    if isinstance(node, Limit):
        return f"limit({_sexp(node.child)},{node.n})"
    raise PlanError(f"unknown plan node {type(node).__name__}")


@functools.lru_cache(maxsize=4096)
def fingerprint(node: Plan) -> str:
    """Stable structural fingerprint of a plan tree — usable directly as
    an ``exec/plan_cache.py`` / ``exec/scheduler.py`` request name.
    Semantically-identical trees (reordered conjuncts, numpy vs python
    literals) share one fingerprint."""
    return "plan:" + hashlib.sha256(
        _sexp(node).encode()).hexdigest()[:32]


# --- rendering (EXPLAIN) ----------------------------------------------------


def expr_str(e: Optional[Expr]) -> str:
    if e is None:
        return "true"
    if isinstance(e, Col):
        return e.name
    if isinstance(e, Lit):
        return repr(e.value)
    if isinstance(e, Cmp):
        return f"({expr_str(e.left)} {e.op} {expr_str(e.right)})"
    if isinstance(e, Between):
        lo = "" if e.lo is None else f"{e.lo!r} <= "
        hi = "" if e.hi is None else f" {'<' if e.hi_strict else '<='} {e.hi!r}"
        return f"({lo}{expr_str(e.col)}{hi})"
    if isinstance(e, And):
        return " AND ".join(expr_str(p) for p in e.parts)
    if isinstance(e, Or):
        return "(" + " OR ".join(expr_str(p) for p in e.parts) + ")"
    if isinstance(e, IsIn):
        return f"{expr_str(e.col)} IN {list(e.values)!r}"
    if isinstance(e, ScalarAgg):
        return f"{e.fn}({expr_str(e.arg)})"
    if isinstance(e, Mul):
        return f"{expr_str(e.left)} * {expr_str(e.right)}"
    return repr(e)


def _node_line(node: Plan) -> str:
    if isinstance(node, Scan):
        cols = "*" if node.columns is None else f"[{', '.join(node.columns)}]"
        pred = ("" if node.predicate is None
                else f" predicate={expr_str(node.predicate)}")
        return f"Scan {node.table} columns={cols}{pred}"
    if isinstance(node, Filter):
        return f"Filter {expr_str(node.predicate)}"
    if isinstance(node, Project):
        return f"Project [{', '.join(node.columns)}]"
    if isinstance(node, Join):
        keys = ", ".join(f"{l} = {r}"
                         for l, r in zip(node.left_on, node.right_on))
        eng = "" if node.engine is None else f" engine={node.engine}"
        return f"Join {node.how} on ({keys}){eng}"
    if isinstance(node, Aggregate):
        aggs = ", ".join(f"{fn}({c}) AS {o}" for c, fn, o in node.aggs)
        grp = "" if node.grouping is None else f" grouping={node.grouping}"
        return (f"Aggregate keys=[{', '.join(node.keys)}] "
                f"aggs=[{aggs}]{grp}")
    if isinstance(node, FusedJoinAggregate):
        keys = ", ".join(f"{l} = {r}"
                         for l, r in zip(node.left_on, node.right_on))
        aggs = ", ".join(f"{fn}({c}) AS {o}" for c, fn, o in node.aggs)
        eng = "" if node.engine is None else f" engine={node.engine}"
        return (f"FusedJoinAggregate {node.how} on ({keys}) "
                f"keys=[{', '.join(node.keys)}] aggs=[{aggs}]{eng}")
    if isinstance(node, Window):
        val = "" if node.value is None else f" value={node.value}"
        return (f"Window {node.fn}{val}"
                f" partition=[{', '.join(node.partition_by)}]"
                f" order=[{', '.join(node.order_by)}] AS {node.out}")
    if isinstance(node, Union):
        return f"Union [{', '.join(node.names)}]"
    if isinstance(node, Distinct):
        return "Distinct"
    if isinstance(node, Sort):
        return f"Sort keys=[{', '.join(node.keys)}]"
    if isinstance(node, Limit):
        return f"Limit {node.n}"
    return type(node).__name__


def render(node: Plan, indent: int = 0) -> str:
    """Indented one-node-per-line tree rendering (EXPLAIN body)."""
    lines = ["  " * indent + _node_line(node)]
    for k in children(node):
        lines.append(render(k, indent + 1))
    return "\n".join(lines)
