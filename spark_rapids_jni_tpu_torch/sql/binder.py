"""Name resolution + plan construction: SQL AST → ``plan/ir.py`` trees
(the JAX package's ``sql/binder.py``, copied).

The binder resolves every column reference against the catalog schemas
(qualified ``alias.col`` refs through the FROM/JOIN alias frames,
unqualified refs by uniqueness — ambiguity is an error), substitutes
named parameters, and emits exactly the IR shapes the hand-built plan
trees use, so a SQL-born tree and its hand-built equivalent share one
structural fingerprint (in both packages).

Logical binding order inside one SELECT (the SQL standard's):
FROM/JOIN → WHERE → GROUP BY/aggregates → HAVING → window functions →
SELECT projection → DISTINCT → ORDER BY → LIMIT.

Deliberate dialect limits (kept loud — each raises :class:`SqlError`):

* plain columns may only be aliased in UNION ALL arms and derived
  tables feeding a UNION (the IR renames positionally at ``Union``);
* aggregates require GROUP BY (no whole-table scalar aggregates);
* ``COUNT(DISTINCT x)`` must be the only aggregate of its SELECT;
* scalar expressions in WHERE/HAVING compare a column against a
  literal/parameter, or (HAVING) an aggregate-of-output-column times an
  optional literal — the ``ir.ScalarAgg`` device-scalar shape.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

from ..plan import ir
from . import parser as ast
from .tokenizer import SqlError

_HOW = {"inner", "left", "semi", "anti"}


class _Frame:
    """One FROM/JOIN input: its alias (may be None) and output names."""

    def __init__(self, alias: Optional[str], names: Sequence[str]):
        self.alias = alias
        self.names = list(names)


class _Binder:
    def __init__(self, schemas: Dict[str, Sequence[str]],
                 params: Optional[Dict[str, Any]], text: str):
        self.schemas = schemas
        self.params = params or {}
        self.text = text

    def _err(self, message: str, pos: Tuple[int, int]):
        raise SqlError(message, self.text, pos[0], pos[1])

    # . reference resolution .................................................

    def resolve(self, c: ast.ColRef, frames: List[_Frame]) -> str:
        if c.qual is not None:
            for f in frames:
                if f.alias == c.qual:
                    if c.name not in f.names:
                        self._err(f"unknown column {c.name!r} in "
                                  f"{c.qual!r} (has {f.names})", c.pos)
                    return c.name
            self._err(f"unknown table alias {c.qual!r}", c.pos)
        hits = sum(f.names.count(c.name) for f in frames)
        if hits == 0:
            have = [n for f in frames for n in f.names]
            self._err(f"unknown column {c.name!r} (have {have})", c.pos)
        if hits > 1:
            self._err(f"ambiguous column {c.name!r}: qualify it with a "
                      f"table alias", c.pos)
        return c.name

    def param_value(self, v: ast.Value):
        if v.param is None:
            return v.value
        if v.param not in self.params:
            self._err(f"unbound parameter :{v.param}", v.pos)
        return self.params[v.param]

    # . predicate binding ....................................................

    def bind_scalar(self, e: ast.Node, frames: List[_Frame]) -> ir.Expr:
        if isinstance(e, ast.Value):
            return ir.Lit(self.param_value(e))
        if isinstance(e, ast.AggFunc):
            if e.fn not in ("mean", "sum"):
                self._err(f"only AVG/SUM usable as scalar aggregates "
                          f"(got {e.fn})", e.pos)
            return ir.ScalarAgg(e.fn,
                                ir.Col(self.resolve(e.arg, frames)))
        if isinstance(e, ast.MulOp):
            return ir.Mul(self.bind_scalar(e.left, frames),
                          self.bind_scalar(e.right, frames))
        raise SqlError(f"unsupported scalar {type(e).__name__}")

    def bind_pred(self, p: ast.Node, frames: List[_Frame]) -> ir.Expr:
        if isinstance(p, ast.AndPred):
            return ir.And(tuple(self.bind_pred(x, frames)
                                for x in p.parts))
        if isinstance(p, ast.OrPred):
            return ir.Or(tuple(self.bind_pred(x, frames)
                               for x in p.parts))
        if isinstance(p, ast.Cmp):
            return ir.Cmp(p.op, ir.Col(self.resolve(p.left, frames)),
                          self.bind_scalar(p.right, frames))
        if isinstance(p, ast.BetweenPred):
            return ir.Between(ir.Col(self.resolve(p.col, frames)),
                              lo=self.param_value(p.lo),
                              hi=self.param_value(p.hi))
        if isinstance(p, ast.InPred):
            return ir.IsIn(ir.Col(self.resolve(p.col, frames)),
                           tuple(self.param_value(v) for v in p.values))
        raise SqlError(f"unsupported predicate {type(p).__name__}")

    # . FROM / JOIN ..........................................................

    def bind_table(self, tr: ast.TableRef) -> Tuple[ir.Plan, List[str]]:
        if tr.subquery is not None:
            return self.bind_query(tr.subquery)
        if tr.name not in self.schemas:
            self._err(f"unknown table {tr.name!r} "
                      f"(catalog: {sorted(self.schemas)})", tr.pos)
        return ir.Scan(tr.name), list(self.schemas[tr.name])

    def _on_sides(self, a: ast.ColRef, b: ast.ColRef,
                  left: List[_Frame], right: _Frame) -> Tuple[str, str]:
        """Resolve one ``ON x = y`` pair to (left key, right key),
        accepting either written order."""
        def side_of(c: ast.ColRef) -> Optional[str]:
            if c.qual is not None:
                if right.alias == c.qual:
                    return "r"
                if any(f.alias == c.qual for f in left):
                    return "l"
                return None
            in_l = any(c.name in f.names for f in left)
            in_r = c.name in right.names
            if in_l and in_r:
                self._err(f"ambiguous join key {c.name!r}: qualify it",
                          c.pos)
            return "l" if in_l else ("r" if in_r else None)

        sa, sb = side_of(a), side_of(b)
        if sa == "l" and sb == "r":
            lref, rref = a, b
        elif sa == "r" and sb == "l":
            lref, rref = b, a
        else:
            bad = a if sa is None else b
            self._err(f"join key {bad.name!r} matches neither side",
                      bad.pos)
        lk = self.resolve(lref, left)
        rk = self.resolve(rref, [right])
        return lk, rk

    # . one SELECT ...........................................................

    def bind_select(self, sel: ast.Select,
                    union_arm: bool = False
                    ) -> Tuple[ir.Plan, List[str], List[str]]:
        """Returns ``(plan, names, aliases)`` — ``aliases`` is the output
        name per position as the SELECT list wrote it (used by UNION ALL
        to name the concatenated columns)."""
        plan, names = self.bind_table(sel.table)
        frames = [_Frame(sel.table.alias, names)]

        for j in sel.joins:
            rplan, rnames = self.bind_table(j.table)
            rframe = _Frame(j.table.alias, rnames)
            lks, rks = [], []
            for a, b in j.on:
                lk, rk = self._on_sides(a, b, frames, rframe)
                lks.append(lk)
                rks.append(rk)
            if j.how not in _HOW:
                self._err(f"unsupported join type {j.how!r}", j.pos)
            plan = ir.Join(plan, rplan, tuple(lks), tuple(rks), how=j.how)
            if j.how in ("semi", "anti"):
                continue             # right side filters; never lands
            dup = set(n for f in frames for n in f.names) & set(rnames)
            if dup:
                self._err(f"join sides share column names {sorted(dup)}",
                          j.pos)
            frames.append(rframe)

        if sel.where is not None:
            plan = ir.Filter(plan, self.bind_pred(sel.where, frames))

        # classify the select list
        plain: List[ast.SelectItem] = []
        aggs: List[ast.SelectItem] = []
        wins: List[ast.SelectItem] = []
        star = None
        for it in sel.items:
            if isinstance(it.expr, ast.Star):
                star = it
            elif isinstance(it.expr, ast.AggFunc):
                aggs.append(it)
            elif isinstance(it.expr, ast.WinFunc):
                wins.append(it)
            elif isinstance(it.expr, ast.ColRef):
                plain.append(it)
            else:
                self._err("unsupported select expression", it.pos)

        plain_resolved: Dict[int, str] = {}
        if sel.group is not None:
            plan, frames, plain_resolved = self._bind_group(
                sel, plain, aggs, frames, plan)
        elif aggs:
            self._err("aggregates require GROUP BY (whole-table scalar "
                      "aggregates are unsupported)", aggs[0].pos)

        if sel.having is not None:
            plan = ir.Filter(plan, self.bind_pred(sel.having, frames))

        for it in wins:
            plan, frames = self._bind_window(it, frames, plan)

        cur = [n for f in frames for n in f.names]

        # final projection, in select-list order
        if star is not None:
            if len(sel.items) != 1:
                self._err("'*' cannot mix with other select items",
                          star.pos)
            out_names, out_aliases = list(cur), list(cur)
        else:
            out_names, out_aliases = [], []
            for it in sel.items:
                if isinstance(it.expr, ast.ColRef):
                    name = (plain_resolved.get(id(it))
                            or self.resolve(it.expr, frames))
                    if (it.alias is not None and it.alias != name
                            and not union_arm):
                        self._err(
                            f"renaming column {name!r} is only supported "
                            f"in UNION ALL arms", it.pos)
                    out_names.append(name)
                    out_aliases.append(it.alias or name)
                else:
                    # agg/window outputs were named when they were bound
                    name = self._out_name(it)
                    out_names.append(name)
                    out_aliases.append(name)
            if out_names != cur:
                plan = ir.Project(plan, tuple(out_names))

        if sel.distinct:
            plan = ir.Distinct(plan)

        if sel.order:
            keys, asc = [], []
            for name, ascending, pos in sel.order:
                if name not in out_names:
                    self._err(f"ORDER BY column {name!r} is not in the "
                              f"select list ({out_names})", pos)
                keys.append(name)
                asc.append(ascending)
            plan = ir.Sort(plan, tuple(keys),
                           None if all(asc) else tuple(asc))

        if sel.limit is not None:
            plan = ir.Limit(plan, sel.limit)
        return plan, out_names, out_aliases

    @staticmethod
    def _out_name(it: ast.SelectItem) -> str:
        if it.alias:
            return it.alias
        e = it.expr
        if isinstance(e, ast.AggFunc):
            return f"{e.fn}_{e.arg.name}"
        return e.fn                      # window fn without alias

    def _bind_group(self, sel: ast.Select, plain, aggs, frames, plan):
        g = sel.group
        keys = tuple(self.resolve(c, frames) for c in g.cols)
        # every plain select item must be a grouping key
        keyset = set(keys) | ({ir.GROUPING_ID} if g.kind != "plain"
                              else set())
        # remember each plain item's pre-aggregate resolution: qualifiers
        # don't survive into the post-aggregate frame, but SELECT
        # i.k ... GROUP BY i.k must still project the key
        resolved: Dict[int, str] = {}
        for it in plain:
            if (g.kind != "plain" and it.expr.qual is None
                    and it.expr.name == ir.GROUPING_ID):
                resolved[id(it)] = ir.GROUPING_ID
                continue     # synthesized by the grouping spec itself
            name = self.resolve(it.expr, frames)
            if name not in keyset:
                self._err(f"column {name!r} must appear in GROUP BY "
                          f"or inside an aggregate", it.pos)
            resolved[id(it)] = name
        agg_specs = []
        for it in aggs:
            e = it.expr
            agg_specs.append((self.resolve(e.arg, frames), e.fn,
                              self._out_name(it)))
        nuniques = [a for a in agg_specs if a[1] == "nunique"]
        if nuniques and len(agg_specs) != 1:
            self._err("COUNT(DISTINCT x) must be the only aggregate",
                      aggs[0].pos)
        grouping = None
        grouping_sets = None
        if g.kind in ("rollup", "cube"):
            grouping = g.kind
        elif g.kind == "sets":
            grouping = "sets"
            index = {k: i for i, k in enumerate(keys)}
            grouping_sets = tuple(
                tuple(index[self.resolve(c, frames)] for c in s)
                for s in g.sets)
        plan = ir.Aggregate(plan, keys, tuple(agg_specs),
                            grouping=grouping, grouping_sets=grouping_sets)
        out = list(keys) + [a[2] for a in agg_specs]
        if grouping is not None:
            out.append(ir.GROUPING_ID)
        return plan, [_Frame(None, out)], resolved

    def _bind_window(self, it: ast.SelectItem, frames, plan):
        e: ast.WinFunc = it.expr
        part = tuple(self.resolve(c, frames) for c in e.partition)
        order = tuple(self.resolve(c, frames) for c, _a in e.order)
        asc = tuple(a for _c, a in e.order)
        value = (None if e.value is None
                 else self.resolve(e.value, frames))
        out = self._out_name(it)
        cur = [n for f in frames for n in f.names]
        if out in cur:
            self._err(f"window output name {out!r} collides with an "
                      f"input column; add AS <name>", it.pos)
        plan = ir.Window(plan, e.fn, part, order, out,
                         ascending=None if all(asc) else asc,
                         value=value)
        return plan, frames + [_Frame(None, [out])]

    # . query (UNION chain) ..................................................

    def bind_query(self, q: ast.Query) -> Tuple[ir.Plan, List[str]]:
        if len(q.selects) == 1:
            plan, names, aliases = self.bind_select(q.selects[0])
            # a lone select exposes alias-free physical names (aliases
            # only rename across a UNION)
            return plan, names
        arms = [self.bind_select(s, union_arm=True) for s in q.selects]
        names = arms[0][2]               # first arm's aliases name the union
        arity = len(names)
        for i, (_p, n, _a) in enumerate(arms):
            if len(n) != arity:
                raise SqlError(
                    f"UNION ALL arm {i} has {len(n)} columns, expected "
                    f"{arity}", self.text)
        return ir.Union(tuple(p for p, _n, _a in arms),
                        tuple(names)), list(names)


def bind(q: ast.Query, schemas: Dict[str, Sequence[str]],
         params: Optional[Dict[str, Any]] = None,
         text: str = "") -> ir.Plan:
    """Bind a parsed query against ``schemas`` (table → column names),
    substituting ``params`` for ``:name`` placeholders.  Returns the IR
    tree; every resolution failure is a :class:`SqlError` whose caret
    points at the offending token in ``text``."""
    plan, _names = _Binder(schemas, params, text).bind_query(q)
    return plan
