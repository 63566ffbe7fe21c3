"""Lowering: optimized plan trees → the port's ops.

The port's counterpart of the JAX package's ``plan/lower.py``.  The
executor walks a plan tree bottom-up against a **catalog** and emits
exactly the op calls the hand-fused queries make — same join order, same
mask construction (validity AND placement mirrors the port's
``models/tpcds._eq_scalar_mask`` / ``_range_mask``, on native FLOAT64
values), same fused ``join_aggregate`` tail — so results are
bit-identical to the hand-fused queries, including float summation
order, and the resolved sizes (``utils/syncs.py``) come at the same
places: a SQL-born query's tape equals its hand-fused twin's.

Catalogs:

* :class:`TableCatalog` — tables already decoded to device ``Table``
  objects.  Scans select columns by reference (column object identity is
  preserved, so the join build-index cache keeps hitting).
* :class:`FileCatalog` — raw parquet bytes.  Scans call
  ``parquet.device_scan.scan_table`` with the pruned column list and a
  row-group predicate derived from the scan predicate, so pushdown prunes
  *before decode* (:data:`COUNTS` ``scan.columns_pruned`` and the scan's
  ``device_scan.COUNTS`` ``rowgroups_pruned`` prove it), and the same
  conditions prune rows on the walked pages (``parquet/rowfilter.py``).

``compile_plan`` wraps execution as a ``qfn(tables) -> Table`` closure —
the shape ``models/compiled.compile_query`` consumes;
``ir.fingerprint(tree)`` is the natural request name.

Per-node profiling (``plan/profile.py``) wraps every node in
:func:`_execute` and reads each node's output at the one funnel,
``_apply_node``, as the JAX package does.  With ``SRJT_AQE`` on,
:func:`execute` and :func:`compile_plan` route through the stage-wise
adaptive executor (``plan/adaptive.py``), which applies each node
through the same ``_apply_node``; off (the default), this lowering is
the static path, byte for byte.
"""

from __future__ import annotations

import collections
import contextlib
from typing import Optional

import torch

from .. import types as T
from ..column import Column, Table
from ..ops import (anti_join, apply_boolean_mask, concat_tables, distinct,
                   groupby_aggregate, groupby_cube, groupby_grouping_sets,
                   groupby_nunique, groupby_rollup, inner_join, join_plan,
                   join_aggregate, left_join, mean, semi_join, slice_table,
                   sort_table, sum_)
from ..ops import strings as S
from ..utils import knobs, metrics
from ..ops import window as W
from . import ir
from . import profile
from . import stats as plan_stats

#: ``scan.columns_pruned`` (columns a FileCatalog scan did not read) and
#: ``scan.filter_fused`` (scan masks the fused row filter made redundant),
#: since :func:`reset_counts`
COUNTS: collections.Counter = collections.Counter()


def reset_counts() -> None:
    COUNTS.clear()


def _count(key: str, n: int = 1) -> None:
    """Count ``n`` in :data:`COUNTS` and, as the JAX package's site does,
    in ``utils.metrics``."""
    COUNTS[key] += n
    metrics.count("plan." + key, n)


# --- catalogs ---------------------------------------------------------------


class TableCatalog:
    """Catalog over already-decoded device tables."""

    def __init__(self, tables: dict[str, Table],
                 schemas: dict[str, list[str]]):
        self.tables = tables
        self.schemas = {k: list(v) for k, v in schemas.items()}

    def scan(self, node: ir.Scan) -> tuple[Table, list[str]]:
        t = self.tables[node.table]
        names = self.schemas[node.table]
        if node.columns is None:
            return t, list(names)
        # select by reference: column identity preserved → build-index
        # caches keyed on buffer identity still hit
        cols = [t[names.index(c)] for c in node.columns]
        return Table(cols), list(node.columns)


class FileCatalog:
    """Catalog over raw parquet file bytes: scans decode on demand with
    column pruning and statistics-driven row-group pruning, onto the GPU
    unless ``device`` says otherwise."""

    def __init__(self, files: dict[str, bytes], device=None):
        self.files = files
        self.device = device
        self._schemas: dict[str, list[str]] = {}

    def schema(self, table: str) -> list[str]:
        got = self._schemas.get(table)
        if got is None:
            from ..parquet import decode as D
            from ..parquet.footer import extract_footer_bytes
            from ..parquet.thrift import parse_struct
            raw = memoryview(self.files[table]).cast("B")
            meta = parse_struct(bytes(extract_footer_bytes(raw)))
            got = [leaf.name for leaf in D.leaf_schema_elements(meta)]
            self._schemas[table] = got
        return got

    @property
    def schemas(self) -> dict[str, list[str]]:
        return {name: self.schema(name) for name in self.files}

    def scan(self, node: ir.Scan) -> tuple[Table, list[str]]:
        from ..parquet import device_scan
        full = self.schema(node.table)
        cols = list(node.columns) if node.columns is not None else list(full)
        conds = rowgroup_conditions(node.predicate)
        # the same conjunct list drives both pushdown tiers: row groups
        # prune on footer statistics, surviving rows prune on the walked
        # raw pages (parquet.rowfilter) before anything decodes
        t = device_scan.scan_table(
            self.files[node.table], columns=cols, device=self.device,
            rowgroup_predicate=conds, row_predicate=conds)
        if len(cols) < len(full):
            _count("scan.columns_pruned", len(full) - len(cols))
        return t, cols


def _rowgroup_literal(v):
    """A literal usable for footer min/max pruning, or None.  Ints prune
    INT32/INT64 (and int-backed decimal) chunks; strings pass as UTF-8
    bytes and prune BYTE_ARRAY chunks (parquet's UTF8 logical order IS
    unsigned byte order, so Python bytes comparison matches)."""
    if hasattr(v, "item"):
        # a planning-time numpy scalar (ir.Lit holds no torch tensor)
        v = v.item()  # srjt-lint: disable=trace-host-sync
    if isinstance(v, bool):
        return None
    if isinstance(v, int):
        return v
    if isinstance(v, str):
        return v.encode("utf-8")
    if isinstance(v, (bytes, bytearray)):
        return bytes(v)
    return None


def rowgroup_conditions(expr: Optional[ir.Expr]):
    """Extract ``(column, op, value)`` conditions the parquet scanner can
    test against footer min/max statistics.  Integer and string
    comparisons qualify (strings travel as UTF-8 bytes); anything else is
    simply not offered for pruning (the full predicate still runs as a
    mask after decode)."""
    conds = []
    for c in ir.conjuncts(expr):
        if (isinstance(c, ir.Cmp) and isinstance(c.left, ir.Col)
                and isinstance(c.right, ir.Lit)
                and c.op in ("==", "<", "<=", ">", ">=")):
            v = _rowgroup_literal(c.right.value)
            if v is not None:
                op = {"==": "eq", "<": "lt", "<=": "le", ">": "gt",
                      ">=": "ge"}[c.op]
                conds.append((c.left.name, op, v))
        elif isinstance(c, ir.Between) and isinstance(c.col, ir.Col):
            lo = _rowgroup_literal(c.lo)
            hi = _rowgroup_literal(c.hi)
            if lo is not None:
                conds.append((c.col.name, "ge", lo))
            if hi is not None:
                conds.append((c.col.name, "lt" if c.hi_strict else "le",
                              hi))
    return conds or None


def _full_pushdown(expr: Optional[ir.Expr]) -> bool:
    """True when ``rowgroup_conditions(expr)`` is EQUIVALENT to the whole
    predicate — every conjunct is a Cmp/Between whose literals made it
    into the condition list — not merely a necessary relaxation.  Only
    then may a scan-side row filter replace the planner's mask."""
    if expr is None:
        return False
    for c in ir.conjuncts(expr):
        if (isinstance(c, ir.Cmp) and isinstance(c.left, ir.Col)
                and isinstance(c.right, ir.Lit)
                and c.op in ("==", "<", "<=", ">", ">=")):
            if _rowgroup_literal(c.right.value) is None:
                return False
        elif isinstance(c, ir.Between) and isinstance(c.col, ir.Col):
            if c.lo is None and c.hi is None:
                return False
            if c.lo is not None and _rowgroup_literal(c.lo) is None:
                return False
            if c.hi is not None and _rowgroup_literal(c.hi) is None:
                return False
        else:
            return False
    return True


# --- expression evaluation --------------------------------------------------


def _column(table: Table, names: list[str], name: str) -> Column:
    try:
        return table[names.index(name)]
    except ValueError:
        raise ir.PlanError(f"column {name!r} not in {names}")


def _scalar(e: ir.Expr, table: Table, names: list[str]):
    """Evaluate a scalar-valued expression: a literal stays a host
    scalar; a ScalarAgg is a 0-dim device tensor, never read back, so
    that the query captures as one CUDA graph (the hand-fused q65's
    ``mean(rev[1]) * frac``)."""
    if isinstance(e, ir.Lit):
        return e.value
    if isinstance(e, ir.ScalarAgg):
        if not isinstance(e.arg, ir.Col):
            raise ir.PlanError("ScalarAgg argument must be a column")
        col = _column(table, names, e.arg.name)
        if e.fn == "mean":
            return mean(col)
        if e.fn == "sum":
            return sum_(col)
        raise ir.PlanError(f"unsupported scalar aggregate {e.fn!r}")
    if isinstance(e, ir.Mul):
        return _scalar(e.left, table, names) * _scalar(e.right, table, names)
    raise ir.PlanError(f"not a scalar expression: {type(e).__name__}")


def _eq_mask(col: Column, value) -> torch.Tensor:
    # mirrors the port's models/tpcds._eq_scalar_mask bit for bit
    if col.dtype.id == T.TypeId.STRING:
        b = S.equal_to_scalar(col, value)
        m = b.data.to(torch.bool)
        return m if b.validity is None else (m & b.validity)
    m = col.data == value
    return m if col.validity is None else (m & col.validity)


def eval_mask(expr: ir.Expr, table: Table, names: list[str]):
    """Boolean row mask for ``expr`` over ``table`` — null rows fail
    (validity ANDed in, matching the hand-written query helpers)."""
    if isinstance(expr, ir.And):
        m = None
        for p in expr.parts:
            pm = eval_mask(p, table, names)
            m = pm if m is None else (m & pm)
        return m
    if isinstance(expr, ir.Or):
        m = None
        for p in expr.parts:
            pm = eval_mask(p, table, names)
            m = pm if m is None else (m | pm)
        return m
    if isinstance(expr, ir.IsIn):
        if not isinstance(expr.col, ir.Col):
            raise ir.PlanError("IsIn operand must be a column")
        col = _column(table, names, expr.col.name)
        m = None
        for v in expr.values:
            vm = _eq_mask(col, v)
            m = vm if m is None else (m | vm)
        if m is None:
            raise ir.PlanError("IsIn with empty value list")
        return m
    if isinstance(expr, ir.Between):
        if not isinstance(expr.col, ir.Col):
            raise ir.PlanError("Between operand must be a column")
        col = _column(table, names, expr.col.name)
        # mirrors the port's models/tpcds._range_mask bit for bit
        m = None
        cvals = col.data
        if expr.lo is not None:
            m = cvals >= expr.lo
        if expr.hi is not None:
            hm = (cvals < expr.hi) if expr.hi_strict else (cvals <= expr.hi)
            m = hm if m is None else (m & hm)
        if col.validity is not None:
            m = col.validity if m is None else (m & col.validity)
        if m is None:
            raise ir.PlanError("Between with no bounds")
        return m
    if isinstance(expr, ir.Cmp):
        if not isinstance(expr.left, ir.Col):
            raise ir.PlanError("comparison left side must be a column")
        col = _column(table, names, expr.left.name)
        rhs = _scalar(expr.right, table, names)
        if expr.op == "==":
            return _eq_mask(col, rhs)
        cvals = col.data
        if expr.op == "<":
            m = cvals < rhs
        elif expr.op == "<=":
            m = cvals <= rhs
        elif expr.op == ">":
            m = cvals > rhs
        elif expr.op == ">=":
            m = cvals >= rhs
        elif expr.op == "!=":
            m = cvals != rhs
        else:
            raise ir.PlanError(f"unsupported comparison {expr.op!r}")
        return m if col.validity is None else (m & col.validity)
    raise ir.PlanError(f"not a predicate expression: {type(expr).__name__}")


# --- execution --------------------------------------------------------------


def _key_indices(names: list[str], keys) -> list[int]:
    return [names.index(k) for k in keys]


def _on_arg(idxs: list[int]):
    # hand-written queries pass single-key joins as a bare int — match
    # that exactly so the join entry point takes the identical path
    return idxs[0] if len(idxs) == 1 else idxs


@contextlib.contextmanager
def _engine_pin(node: ir.Plan):
    """Honor an engine pin (``Join.engine`` /
    ``FusedJoinAggregate.engine``) around one join's execution.  An
    ambient ``join_plan.force_engine`` always wins."""
    eng = getattr(node, "engine", None)
    if eng is None or join_plan.forced_engine() is not None:
        yield
        return
    with join_plan.force_engine(eng):
        yield


def _apply_node(node: ir.Plan, kids: list, catalog, record_stats: bool):
    """Apply ONE plan node to its already-computed child results.

    ``kids`` holds one ``(table, names)`` pair per ``ir.children(node)``
    entry.  This is the single place a node becomes op calls:
    :func:`_execute` (the static executor) and ``plan/adaptive.py`` (the
    stage-wise adaptive executor) both route through it, so an
    adaptively re-ordered plan runs the op sequence the static lowering
    of the same tree would."""
    t: Table
    names: list[str]
    if isinstance(node, ir.Scan):
        t, names = catalog.scan(node)
        if node.predicate is not None:
            if (getattr(t, "fused_filter_complete", False)
                    and _full_pushdown(node.predicate)):
                # the scan already evaluated every conjunct on the raw
                # pages and pruned the rows — the mask here would be
                # all-True, skip the redundant gather
                _count("scan.filter_fused")
            else:
                t = apply_boolean_mask(t, eval_mask(node.predicate, t,
                                                    names))
    elif isinstance(node, ir.Filter):
        t, names = kids[0]
        t = apply_boolean_mask(t, eval_mask(node.predicate, t, names))
    elif isinstance(node, ir.Project):
        ct, cnames = kids[0]
        t = Table([ct[cnames.index(c)] for c in node.columns])
        names = list(node.columns)
    elif isinstance(node, ir.Join):
        (lt, ln), (rt, rn) = kids
        fn = {"inner": inner_join, "left": left_join,
              "semi": semi_join, "anti": anti_join}.get(node.how)
        if fn is None:
            raise ir.PlanError(f"unsupported join type {node.how!r}")
        with _engine_pin(node):
            t = fn(lt, rt, _on_arg(_key_indices(ln, node.left_on)),
                   _on_arg(_key_indices(rn, node.right_on)))
        names = ln if node.how in ("semi", "anti") else ln + rn
    elif isinstance(node, ir.FusedJoinAggregate):
        (lt, ln), (rt, rn) = kids
        joined = ln + rn
        with _engine_pin(node):
            t = join_aggregate(
                lt, rt, _on_arg(_key_indices(ln, node.left_on)),
                _on_arg(_key_indices(rn, node.right_on)),
                _key_indices(joined, node.keys),
                [(joined.index(c), fn) for c, fn, _out in node.aggs],
                how=node.how)
        names = list(node.keys) + [a[2] for a in node.aggs]
    elif isinstance(node, ir.Aggregate):
        ct, cnames = kids[0]
        key_idx = _key_indices(cnames, node.keys)
        agg_arg = [(cnames.index(c), fn) for c, fn, _out in node.aggs]
        names = list(node.keys) + [a[2] for a in node.aggs]
        if node.grouping is not None:
            gfn = {"rollup": groupby_rollup, "cube": groupby_cube}.get(
                node.grouping)
            if gfn is not None:
                t = gfn(ct, key_idx, agg_arg)
            else:
                t = groupby_grouping_sets(ct, key_idx,
                                          node.grouping_sets, agg_arg)
            names = names + [ir.GROUPING_ID]
        elif any(fn == "nunique" for _c, fn, _o in node.aggs):
            if len(node.aggs) != 1:
                raise ir.PlanError(
                    "nunique aggregate must be the only aggregation")
            t = groupby_nunique(ct, key_idx,
                                cnames.index(node.aggs[0][0]))
        else:
            t = groupby_aggregate(ct, key_idx, agg_arg)
    elif isinstance(node, ir.Window):
        ct, cnames = kids[0]
        asc = None if node.ascending is None else list(node.ascending)
        spec = W.WindowSpec(ct, _key_indices(cnames, node.partition_by),
                            _key_indices(cnames, node.order_by),
                            ascending=asc)
        order_idx = _key_indices(cnames, node.order_by)
        if node.fn == "row_number":
            wcol = W.row_number(spec)
        elif node.fn == "rank":
            wcol = W.rank(spec, order_idx)
        elif node.fn == "dense_rank":
            wcol = W.dense_rank(spec, order_idx)
        elif node.fn in ("running_sum", "lag", "lead"):
            if node.value is None:
                raise ir.PlanError(f"window {node.fn} needs a value column")
            vidx = cnames.index(node.value)
            wfn = {"running_sum": W.running_sum, "lag": W.lag,
                   "lead": W.lead}[node.fn]
            wcol = wfn(spec, vidx)
        else:
            raise ir.PlanError(f"unsupported window function {node.fn!r}")
        t = Table(list(ct.columns) + [wcol])
        names = cnames + [node.out]
    elif isinstance(node, ir.Union):
        t = concat_tables([k[0] for k in kids])
        names = list(node.names)
    elif isinstance(node, ir.Distinct):
        ct, cnames = kids[0]
        t = distinct(ct)
        names = cnames
    elif isinstance(node, ir.Sort):
        ct, cnames = kids[0]
        asc = None if node.ascending is None else list(node.ascending)
        t = sort_table(ct, _key_indices(cnames, node.keys), ascending=asc)
        names = cnames
    elif isinstance(node, ir.Limit):
        ct, cnames = kids[0]
        t = slice_table(ct, 0, node.n)
        names = cnames
    else:
        raise ir.PlanError(f"unknown plan node {type(node).__name__}")

    if record_stats:
        # feed the reorder rule's exact-cardinality store for the next
        # optimize of this shape; num_rows is a host int (a lazy column's
        # count was resolved when it was made), so this reads no device
        plan_stats.GLOBAL.observe(ir.fingerprint(node), t.num_rows)
    # the validity-density sync (SRJT_PROFILE_VALIDITY) lives at this
    # single funnel so capture and replay resolve the identical tape
    profile.at_node_output(t)
    return t, names


def _execute(node: ir.Plan, catalog, record_stats: bool):
    ctx = profile.node_enter(node)
    if ctx is None:
        kids = [_execute(k, catalog, record_stats)
                for k in ir.children(node)]
        return _apply_node(node, kids, catalog, record_stats)
    t = kids = None
    try:
        kids = [_execute(k, catalog, record_stats)
                for k in ir.children(node)]
        t, names = _apply_node(node, kids, catalog, record_stats)
    finally:
        profile.node_exit(ctx, t, kids)
    return t, names


def execute(tree: ir.Plan, catalog, record_stats: bool = True) -> Table:
    """Run a (typically optimized) plan tree against a catalog.  With
    ``SRJT_AQE`` on, through the stage-wise adaptive executor
    (``plan/adaptive.py``); off (the default), the static path, byte for
    byte."""
    if knobs.get("SRJT_AQE"):
        from . import adaptive
        return adaptive.execute_adaptive(tree, catalog,
                                         record_stats=record_stats)
    t, _names = _execute(tree, catalog, record_stats)
    return t


def output_names(tree: ir.Plan, schemas: dict) -> list[str]:
    return list(ir.schema_of(tree, schemas))


def compile_plan(tree: ir.Plan, schemas: dict):
    """Wrap a plan tree as ``qfn(tables: dict[str, Table]) -> Table`` —
    the callable shape ``models/compiled.compile_query`` consumes.  Use
    ``ir.fingerprint(tree)`` as the request/cache name.  The qfn runs
    where its tables are.

    With ``SRJT_AQE`` on at build time, returns the adaptive twin
    (``plan/adaptive.compile_adaptive_plan``), tagged ``aqe_variant`` so
    that the plan cache keys it apart.  Either way the qfn is pinned to
    the mode it was built under: a compiled (and perhaps cached) query
    must not change strategy when the environment flips later."""
    if knobs.get("SRJT_AQE"):
        from . import adaptive
        return adaptive.compile_adaptive_plan(tree, schemas)
    ir.schema_of(tree, schemas)       # validate once at build time

    def qfn(tables: dict[str, Table]) -> Table:
        t, _names = _execute(tree, TableCatalog(tables, schemas), True)
        return t

    qfn.plan_tree = tree
    qfn.plan_fingerprint = ir.fingerprint(tree)
    # output column names, in order — consumers that bind columns by name
    # read these instead of re-deriving the schema
    qfn.plan_output_names = output_names(tree, schemas)
    return qfn
