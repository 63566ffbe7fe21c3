"""Fixpoint rewrite engine over the plan IR.

The port's copy of the JAX package's ``plan/rules.py``.  Five rules,
applied in a loop until a full pass changes nothing:

* **projection_pushdown** — walk required-column sets down the tree and
  narrow every ``Scan`` to the columns actually consumed above it (plus
  its own predicate's columns).  On the file catalog this prunes parquet
  columns *before decode*.
* **filter_pushdown** — sink ``Filter`` predicates through projects and
  joins (splitting conjuncts by side) until they merge into ``Scan``
  predicates, where footer statistics can prune whole row groups before
  decode.
* **join_reorder** — for a left-deep pair of inner joins whose outer key
  lives on the base table, join the smaller dimension first.  Driven by
  :mod:`plan.stats` cardinalities (exact observations; the port has no
  metrics prior yet); rejects — a deliberate no-op — when stats are
  absent.
* **fuse_join_aggregate** — detect ``Aggregate(Join(...))`` with an
  inner/left join and emit the fused ``ops/join_plan.join_aggregate``
  path (``FusedJoinAggregate`` node) instead of a per-query rewire.
* **fuse_join_window** — push a ``Window`` below a left join whose
  build side is provably unique on its keys (an ``Aggregate`` or
  ``Distinct`` on exactly those columns), so the window runs on the
  narrow pre-join table instead of the widened join output.

Counts: :data:`COUNTS` holds ``rule.fired.<name>`` /
``rule.rejected.<name>``, counted in ``utils.metrics`` too under the JAX
package's ``plan.rule.*`` names, and each :class:`OptimizeResult` carries its own events and
rejections.

Env knobs:

* ``SRJT_PLAN_OPT=0`` — disable optimization (``optimize`` returns the
  tree untouched; lowering still works on raw trees).
* ``SRJT_PLAN_RULES=a,b`` — run only the named rules.
* ``SRJT_PLAN_MAX_PASSES`` — fixpoint pass cap (default 10).
"""

from __future__ import annotations

import collections
from dataclasses import dataclass, field, replace
from typing import Optional, Sequence

from ..utils import knobs, metrics
from . import ir

#: rules fired and rejected by name, since :func:`reset_counts`
COUNTS: collections.Counter = collections.Counter()


def reset_counts() -> None:
    COUNTS.clear()


def _count(key: str, n: int = 1) -> None:
    """Count ``n`` in :data:`COUNTS` and, as the JAX package's site does,
    in ``utils.metrics``."""
    COUNTS[key] += n
    metrics.count("plan." + key, n)


@dataclass(frozen=True)
class RuleEvent:
    rule: str
    detail: str


@dataclass
class Context:
    """Per-optimize scratch state handed to rules."""
    schemas: dict
    stats: object = None            # CardinalityStats or None
    events: list = field(default_factory=list)
    rejections: list = field(default_factory=list)

    def fire(self, rule: str, detail: str) -> None:
        self.events.append(RuleEvent(rule, detail))

    def reject(self, rule: str, detail: str) -> None:
        self.rejections.append(RuleEvent(rule, detail))

    def schema(self, node: ir.Plan) -> tuple:
        return ir.schema_of(node, self.schemas)


class Rule:
    name = "rule"

    def apply(self, tree: ir.Plan, ctx: Context) -> ir.Plan:
        raise NotImplementedError


# --- projection pushdown ----------------------------------------------------


class ProjectionPushdown(Rule):
    """Narrow every Scan to the columns consumed above it."""

    name = "projection_pushdown"

    def apply(self, tree, ctx):
        return self._push(tree, None, ctx)

    def _push(self, node, need, ctx):
        # need: frozenset of columns required by ancestors, None = all
        if isinstance(node, ir.Scan):
            full = tuple(ctx.schemas[node.table])
            cur = node.columns if node.columns is not None else full
            if need is None:
                return node
            want = set(need) | set(ir.expr_columns(node.predicate))
            new_cols = tuple(c for c in cur if c in want)
            if new_cols == cur:
                return node
            ctx.fire(self.name,
                     f"scan({node.table}): {len(cur)} → {len(new_cols)} "
                     f"columns [{', '.join(new_cols)}]")
            return replace(node, columns=new_cols)
        if isinstance(node, ir.Filter):
            cneed = (None if need is None
                     else need | ir.expr_columns(node.predicate))
            return self._rebuild(node, (self._push(node.child, cneed, ctx),))
        if isinstance(node, ir.Project):
            return self._rebuild(
                node, (self._push(node.child, frozenset(node.columns),
                                  ctx),))
        if isinstance(node, ir.Join):
            if need is None:
                lneed = rneed = None
            else:
                ls = set(ctx.schema(node.left))
                rs = set(ctx.schema(node.right))
                lneed = frozenset((need & ls) | set(node.left_on))
                rneed = frozenset((need & rs) | set(node.right_on))
            return self._rebuild(node,
                                 (self._push(node.left, lneed, ctx),
                                  self._push(node.right, rneed, ctx)))
        if isinstance(node, ir.Aggregate):
            # aggregates reset the requirement to a CONCRETE set no
            # matter what the ancestors ask for
            cneed = frozenset(node.keys) | {a[0] for a in node.aggs}
            return self._rebuild(node, (self._push(node.child, cneed, ctx),))
        if isinstance(node, ir.FusedJoinAggregate):
            used = frozenset(node.keys) | {a[0] for a in node.aggs}
            ls = set(ctx.schema(node.left))
            rs = set(ctx.schema(node.right))
            lneed = frozenset((used & ls) | set(node.left_on))
            rneed = frozenset((used & rs) | set(node.right_on))
            return self._rebuild(node,
                                 (self._push(node.left, lneed, ctx),
                                  self._push(node.right, rneed, ctx)))
        if isinstance(node, ir.Window):
            val = set() if node.value is None else {node.value}
            cneed = (None if need is None
                     else frozenset((need - {node.out})
                                    | set(node.partition_by)
                                    | set(node.order_by) | val))
            return self._rebuild(node, (self._push(node.child, cneed, ctx),))
        if isinstance(node, ir.Union):
            # arms are positional: ancestors' name-based needs don't
            # translate, but each arm's own Projects reset the
            # requirement so scan narrowing still happens below
            return self._rebuild(
                node, tuple(self._push(p, None, ctx) for p in node.parts))
        if isinstance(node, ir.Distinct):
            # distinct is over the child's FULL row — everything is needed
            return self._rebuild(node, (self._push(node.child, None, ctx),))
        if isinstance(node, ir.Sort):
            cneed = None if need is None else need | set(node.keys)
            return self._rebuild(node, (self._push(node.child, cneed, ctx),))
        if isinstance(node, ir.Limit):
            return self._rebuild(node, (self._push(node.child, need, ctx),))
        raise ir.PlanError(f"unknown plan node {type(node).__name__}")

    @staticmethod
    def _rebuild(node, new_kids):
        kids = ir.children(node)
        if all(nk is k for nk, k in zip(new_kids, kids)):
            return node
        return ir.with_children(node, tuple(new_kids))


# --- filter pushdown --------------------------------------------------------


class FilterPushdown(Rule):
    """Sink Filter predicates toward (and into) the scans."""

    name = "filter_pushdown"

    def apply(self, tree, ctx):
        return ir.transform_up(tree, lambda n: self._rewrite(n, ctx))

    def _rewrite(self, node, ctx):
        if not isinstance(node, ir.Filter):
            return None
        child = node.child
        cj = ir.conjuncts(node.predicate)

        if isinstance(child, ir.Filter):
            ctx.fire(self.name, "merged adjacent filters")
            return ir.Filter(child.child,
                             ir.and_(ir.conjuncts(child.predicate) + cj))

        if isinstance(child, ir.Scan):
            merged = ir.conjuncts(child.predicate) + cj
            ctx.fire(self.name,
                     f"{len(cj)} predicate(s) → scan({child.table})")
            return replace(child, predicate=ir.and_(merged))

        if isinstance(child, ir.Project):
            if ir.expr_columns(node.predicate) <= set(child.columns):
                ctx.fire(self.name, "filter below project")
                return ir.Project(ir.Filter(child.child, node.predicate),
                                  child.columns)
            return None

        if isinstance(child, ir.Join):
            ls = set(ctx.schema(child.left))
            rs = set(ctx.schema(child.right))
            lp, rp, keep = [], [], []
            for c in cj:
                cols = ir.expr_columns(c)
                if cols and cols <= ls:
                    lp.append(c)
                elif cols and cols <= rs and child.how == "inner":
                    # right-side predicates must NOT sink below a left
                    # outer join (they'd drop null-extended rows early)
                    rp.append(c)
                else:
                    keep.append(c)
            if not lp and not rp:
                if child.how != "inner" and any(
                        ir.expr_columns(c) and ir.expr_columns(c) <= rs
                        for c in keep):
                    ctx.reject(self.name,
                               f"right-side predicate kept above "
                               f"{child.how} join")
                return None
            nl = (ir.Filter(child.left, ir.and_(lp)) if lp else child.left)
            nr = (ir.Filter(child.right, ir.and_(rp)) if rp else child.right)
            ctx.fire(self.name,
                     f"{len(lp) + len(rp)} conjunct(s) through "
                     f"{child.how} join ({len(keep)} kept above)")
            out = replace(child, left=nl, right=nr)
            return ir.Filter(out, ir.and_(keep)) if keep else out

        if isinstance(child, ir.Union):
            # positional rename per arm, then push into every arm (same
            # rows survive; concat of filtered arms == filtered concat)
            new_parts = []
            for part in child.parts:
                psch = ctx.schema(part)
                mapping = dict(zip(child.names, psch))
                new_parts.append(ir.Filter(
                    part, _rename_expr(node.predicate, mapping)))
            ctx.fire(self.name,
                     f"filter through union ({len(new_parts)} arms)")
            return replace(child, parts=tuple(new_parts))

        if isinstance(child, ir.Distinct):
            # distinct(filter(x)) == filter(distinct(x)): same surviving
            # key set, same key-sorted output order
            ctx.fire(self.name, "filter below distinct")
            return ir.Distinct(ir.Filter(child.child, node.predicate))

        # Sort/Limit/Aggregate/Window: order- or group-sensitive —
        # predicates stay put (HAVING-style filters land here)
        return None


def _rename_expr(e, mapping: dict):
    """Rewrite every Col reference through ``mapping`` (missing = keep)."""
    if e is None:
        return None
    if isinstance(e, ir.Col):
        return ir.Col(mapping.get(e.name, e.name))
    if isinstance(e, ir.Cmp):
        return ir.Cmp(e.op, _rename_expr(e.left, mapping),
                      _rename_expr(e.right, mapping))
    if isinstance(e, ir.Between):
        return replace(e, col=_rename_expr(e.col, mapping))
    if isinstance(e, (ir.And, ir.Or)):
        return type(e)(tuple(_rename_expr(p, mapping) for p in e.parts))
    if isinstance(e, ir.IsIn):
        return replace(e, col=_rename_expr(e.col, mapping))
    if isinstance(e, ir.ScalarAgg):
        return ir.ScalarAgg(e.fn, _rename_expr(e.arg, mapping))
    if isinstance(e, ir.Mul):
        return ir.Mul(_rename_expr(e.left, mapping),
                      _rename_expr(e.right, mapping))
    return e                          # Lit and friends: no columns


# --- join reorder -----------------------------------------------------------


class JoinReorder(Rule):
    """Left-deep inner-join pair: join the smaller dimension first.

    ``Join(Join(base, d1), d2)`` → ``Project(Join(Join(base, d2), d1))``
    when the outer keys come from ``base`` and est(d2) < est(d1); the
    Project restores the original output column order so the rewrite is
    invisible above.  Without stats for BOTH dimensions the rule rejects.
    """

    name = "join_reorder"

    def apply(self, tree, ctx):
        return ir.transform_up(tree, lambda n: self._rewrite(n, ctx))

    def _rewrite(self, node, ctx):
        if not (isinstance(node, ir.Join) and node.how == "inner"
                and isinstance(node.left, ir.Join)
                and node.left.how == "inner"):
            return None
        inner, d2 = node.left, node.right
        base, d1 = inner.left, inner.right
        if not set(node.left_on) <= set(ctx.schema(base)):
            return None           # outer keys come via d1: not commutable
        if ctx.stats is None:
            ctx.reject(self.name, "no cardinality stats provided")
            return None
        e1 = ctx.stats.rows_for(d1)
        e2 = ctx.stats.rows_for(d2)
        if e1 is None or e2 is None:
            ctx.reject(self.name,
                       "missing cardinality estimate for join input")
            return None
        if e2 >= e1:
            return None           # already smallest-first; strict <
        names = ctx.schema(node)  # original left++d1++d2 order
        ctx.fire(self.name,
                 f"swap join inputs (est {e2:.0f} < {e1:.0f} rows)")
        swapped = ir.Join(
            ir.Join(base, d2, node.left_on, node.right_on),
            d1, inner.left_on, inner.right_on)
        return ir.Project(swapped, names)


# --- join→aggregate fusion --------------------------------------------------


class FuseJoinAggregate(Rule):
    """Aggregate directly over an inner/left join → the fused
    ``join_aggregate`` path (covers left-join→groupby too)."""

    name = "fuse_join_aggregate"

    def apply(self, tree, ctx):
        return ir.transform_up(tree, lambda n: self._rewrite(n, ctx))

    def _rewrite(self, node, ctx):
        if not isinstance(node, ir.Aggregate):
            return None
        c = node.child
        if not isinstance(c, ir.Join):
            return None
        if node.grouping is not None or any(a[1] == "nunique"
                                            for a in node.aggs):
            ctx.reject(self.name,
                       "grouping-spec/nunique aggregate is unfusable")
            return None
        if c.how not in ("inner", "left"):
            ctx.reject(self.name, f"unfusable join type {c.how!r}")
            return None
        ctx.fire(self.name,
                 f"aggregate over {c.how} join → ops.join_aggregate")
        return ir.FusedJoinAggregate(c.left, c.right, c.left_on,
                                     c.right_on, node.keys, node.aggs,
                                     c.how)


# --- join→window fusion -----------------------------------------------------


class FuseJoinWindow(Rule):
    """Push a Window below a left join with a provably-unique build side.

    ``Window(Join(left, right, how="left"))`` == ``Join(Window(left),
    right)`` when (a) every window input column lives on ``left`` and
    (b) ``right`` is unique on its join keys, so each left row lands in
    the output exactly once.  Uniqueness is only claimed when it is
    structural: the right child is an ``Aggregate`` grouped exactly on
    the join keys, or a ``Distinct`` whose schema is exactly the join
    keys.  The trailing Project restores the original column order, so
    the rewrite is invisible above — and the window now runs on the
    narrow pre-join table instead of the gather-widened join output."""

    name = "fuse_join_window"

    def apply(self, tree, ctx):
        return ir.transform_up(tree, lambda n: self._rewrite(n, ctx))

    def _rewrite(self, node, ctx):
        if not isinstance(node, ir.Window):
            return None
        c = node.child
        if not isinstance(c, ir.Join):
            return None
        if c.how != "left":
            ctx.reject(self.name,
                       f"{c.how} join can drop/repeat probe rows")
            return None
        ls = ctx.schema(c.left)
        rs = ctx.schema(c.right)
        wcols = set(node.partition_by) | set(node.order_by)
        if node.value is not None:
            wcols.add(node.value)
        if not wcols <= set(ls):
            ctx.reject(self.name, "window keys straddle the join")
            return None
        if not _unique_on(c.right, c.right_on, ctx):
            ctx.reject(self.name,
                       "build side not provably unique on join keys")
            return None
        ctx.fire(self.name, f"window({node.fn}) below {c.how} join")
        win = replace(node, child=c.left)
        return ir.Project(replace(c, left=win), ls + rs + (node.out,))


def _unique_on(node: ir.Plan, keys, ctx: Context) -> bool:
    """True when ``node``'s output is structurally unique on ``keys``."""
    if isinstance(node, ir.Aggregate) and node.grouping is None:
        return set(node.keys) == set(keys)
    if isinstance(node, ir.FusedJoinAggregate):
        return set(node.keys) == set(keys)
    if isinstance(node, ir.Distinct):
        return set(ctx.schema(node)) == set(keys)
    return False


DEFAULT_RULES: tuple[Rule, ...] = (
    ProjectionPushdown(), FilterPushdown(), JoinReorder(),
    FuseJoinAggregate(), FuseJoinWindow(),
)


@dataclass(frozen=True)
class OptimizeResult:
    tree: ir.Plan
    events: tuple
    rejections: tuple
    passes: int
    converged: bool


def optimize(tree: ir.Plan, schemas: dict, stats=None,
             rules: Optional[Sequence[Rule]] = None,
             max_passes: Optional[int] = None) -> OptimizeResult:
    """Rewrite ``tree`` to fixpoint (or ``max_passes``).

    ``schemas`` maps base-table name → column names; ``stats`` is an
    optional :class:`plan.stats.CardinalityStats` for join reordering.
    """
    if not knobs.get("SRJT_PLAN_OPT"):
        return OptimizeResult(tree, (), (), 0, True)
    if stats is not None:
        # warm priors: merge the SRJT_PLAN_STATS_PATH sidecar (once per
        # process) before any rule consults cardinalities
        from . import stats as plan_stats
        plan_stats.ensure_sidecar_loaded()
    active = list(DEFAULT_RULES if rules is None else rules)
    only = knobs.get("SRJT_PLAN_RULES")
    if only:
        wanted = {r.strip() for r in only.split(",") if r.strip()}
        active = [r for r in active if r.name in wanted]
    if max_passes is None:
        max_passes = knobs.get("SRJT_PLAN_MAX_PASSES")

    ir.schema_of(tree, schemas)      # validate before rewriting
    ctx = Context(schemas=schemas, stats=stats)
    converged = False
    passes = 0
    while passes < max_passes:
        passes += 1
        before = len(ctx.events)
        for rule in active:
            f0, r0 = len(ctx.events), len(ctx.rejections)
            tree = rule.apply(tree, ctx)
            fired = len(ctx.events) - f0
            rejected = len(ctx.rejections) - r0
            if fired:
                _count(f"rule.fired.{rule.name}", fired)
            if rejected:
                _count(f"rule.rejected.{rule.name}", rejected)
        if len(ctx.events) == before:
            converged = True
            break
    ir.schema_of(tree, schemas)      # rewrites must preserve validity
    return OptimizeResult(tree, tuple(ctx.events), tuple(ctx.rejections),
                          passes, converged)


def explain(tree: ir.Plan, schemas: dict, stats=None,
            rules: Optional[Sequence[Rule]] = None,
            adaptive_report=None) -> str:
    """Render the pre-/post-rewrite tree with per-rule annotations.

    ``adaptive_report`` (a ``plan.adaptive.AdaptiveReport``) appends the
    stage-wise decisions of an adaptive execution: the static EXPLAIN
    shows what the optimizer planned, the adaptive section what the
    runtime changed."""
    res = optimize(tree, schemas, stats=stats, rules=rules)
    lines = ["== Logical plan ==", ir.render(tree), "",
             f"== Optimized plan ({res.passes} pass(es)"
             f"{'' if res.converged else ', pass cap hit'}) ==",
             ir.render(res.tree), "", "== Rules =="]
    if not res.events and not res.rejections:
        lines.append("(no rules fired)")
    for ev in res.events:
        lines.append(f"fired    {ev.rule}: {ev.detail}")
    for ev in res.rejections:
        lines.append(f"rejected {ev.rule}: {ev.detail}")
    if adaptive_report is not None:
        lines += ["", adaptive_report.render()]
    return "\n".join(lines)
