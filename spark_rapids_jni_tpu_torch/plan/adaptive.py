"""Adaptive query execution: stage-wise runtime re-optimization.

The port's counterpart of the JAX package's ``plan/adaptive.py``.  The
static optimizer (``plan/rules.py``) fires once, before execution, on the
priors ``plan/stats.py`` holds.  This module closes Spark-AQE's loop: the
lowered tree executes stage by stage (a stage boundary at every join and
aggregate, where intermediate tables materialize), and between stages
the observed facts feed back into the remainder:

* **replan**: a left-deep inner-join chain ending in a
  ``FusedJoinAggregate`` re-orders its dimension joins by the
  dimensions' actual post-filter row counts instead of the priors, only
  where the result is provably the same bytes: the aggregate is sorted
  by group key and every aggregate is exact (:func:`_aggs_order_insensitive`:
  no float or decimal128 input, no first/last), so any join order gives
  the same result.
* **engine_flip**: each join probes the materialized build side (valid
  count, key window) and the probe side's row count, and flips the
  dense/sorted engine where the observed statistics disagree with the
  lowering's rule, through ``ops/join_plan.force_engine``: every variant
  gives the same bytes, and an ambient pin (the scheduler's degradation,
  ``SRJT_JOIN_ENGINE``) always wins over an adaptive one.
* **skew**: where the dense window is chosen, the same pass computes the
  build index's hottest run.  Here the signal is advisory
  (``plan.aqe.skew_split.advisory``, a report line); the repartition
  join (``parallel/repartition_join.py``) acts on it, salting a hot key
  into sub-joins when its measured need passes ``SRJT_AQE_SKEW_FACTOR``
  times the mean.

Capture and replay: every decision derives ONLY from intermediate
tables' ``num_rows`` (host ints, which a replay reproduces because the
sizes come from the tape) and ``utils.syncs.scalar`` reads (recorded on
capture, handed back on replay).  No probe reads the device otherwise
(no ``.item()``, ``.tolist()`` or ``bool(tensor)``), so a capture run and
its replays take the same host branches and the tape stays aligned: the
decisions execute inline on every run, and a compiled adaptive query is
one CUDA graph like a static one.  Every probe read is unconditional on
its path (never gated on the metrics state).

Plan-cache composition: :func:`compile_adaptive_plan` tags its qfn with
``aqe_variant``, which ``exec/plan_cache.get_or_compile`` folds into the
cache key: adaptive and static compiles of one tree never share an entry.

Everything is behind ``SRJT_AQE`` (default off): ``lower.execute`` and
``lower.compile_plan`` route here only when it is on, so the off path is
the static executor, byte for byte.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple, Optional

import torch

from .. import types as T
from ..ops import join_plan
from ..utils import flight, knobs, metrics, syncs
from . import ir, lower, profile
from . import stats as plan_stats

#: observed rows > this factor × the prior, on a stage where a decision
#: fired → flight-recorder ``aqe_regression`` incident
REGRESSION_FACTOR = 2.0

#: exact (order-insensitive) aggregates over non-float inputs; first and
#: last depend on input order and float sums reassociate, so neither may
#: be reordered across
_REORDERABLE_AGGS = ("sum", "count", "min", "max", "mean")


def enabled() -> bool:
    return bool(knobs.get("SRJT_AQE"))


# --- decision and stage records (the EXPLAIN payload) ------------------------


@dataclass(frozen=True)
class Decision:
    kind: str            # "replan" | "engine_flip" | "skew_advisory"
    detail: str


@dataclass
class StageRecord:
    """One barrier-node stage: what the priors predicted, what came out,
    and which runtime rules fired in between."""
    index: int
    node: str                          # EXPLAIN line of the barrier node
    est_rows: Optional[float] = None   # prior estimate (None: unknown)
    rows: Optional[int] = None         # observed output rows
    decisions: list = field(default_factory=list)


@dataclass
class AdaptiveReport:
    stages: list = field(default_factory=list)

    def decisions(self) -> list:
        return [d for s in self.stages for d in s.decisions]

    def render(self) -> str:
        lines = ["== Adaptive execution =="]
        if not self.stages:
            lines.append("(no barrier stages)")
        for s in self.stages:
            est = "?" if s.est_rows is None else f"{s.est_rows:.0f}"
            lines.append(f"stage {s.index}: {s.node}")
            lines.append(f"  est={est} rows → observed={s.rows} rows")
            for d in s.decisions:
                lines.append(f"  fired    {d.kind}: {d.detail}")
        n = len(self.decisions())
        lines.append(f"({n} adaptive decision(s))")
        return "\n".join(lines)


# --- engine and skew probe ---------------------------------------------------


class _Probe(NamedTuple):
    engine: Optional[str]   # pin to apply ("dense"/"sorted"), None: agree
    detail: str
    skew: Optional[dict]    # skew_stats-shaped dict where dense and skewed


def _probe_engine(node, kids) -> Optional[_Probe]:
    """The observed-statistics engine choice for one Join or
    FusedJoinAggregate, or None where the key never qualifies for the
    dense engine.

    Reads the build lane's valid count and key window (three
    ``syncs.scalar`` reads, the values ``_build_index`` reads too) before
    the join runs, so that the index is built in the decided kind.  The
    adaptive rule widens the static span limit by the probe side's row
    count: a dense table pays off wherever the probe side amortizes it
    (``span ≤ max(2·n_valid, FLOOR, probe_rows)``, still capped)."""
    (lt, ln), (rt, rn) = kids
    try:
        lon = [ln.index(c) for c in node.left_on]
        ron = [rn.index(c) for c in node.right_on]
    except ValueError:
        return None
    plan = join_plan.plan_keys([lt[i] for i in lon], [rt[i] for i in ron])
    if plan.mode not in ("single", "composite") or not plan.dense_ok:
        return None
    n = int(plan.rdata.shape[0])
    if n == 0:
        return None
    # unconditional reads: the tape must not depend on what follows
    if plan.rvalid is None:
        n_valid = n
        kmin = syncs.scalar(plan.rdata.min())
        kmax = syncs.scalar(plan.rdata.max())
    else:
        info = torch.iinfo(plan.rdata.dtype)
        n_valid = syncs.size(plan.rvalid.sum(), n)
        kmin = syncs.scalar(torch.where(plan.rvalid, plan.rdata,
                                        info.max).min())
        kmax = syncs.scalar(torch.where(plan.rvalid, plan.rdata,
                                        info.min).max())
    if n_valid == 0:
        return None
    span = kmax - kmin + 1
    probe_rows = int(plan.ldata.shape[0])
    floor = max(join_plan.DENSE_SPAN_FACTOR * n_valid,
                join_plan.DENSE_SPAN_FLOOR)
    static_dense = span <= min(floor, join_plan.DENSE_SPAN_CAP)
    adaptive_dense = span <= min(max(floor, probe_rows),
                                 join_plan.DENSE_SPAN_CAP)

    skew = None
    if adaptive_dense:
        # the dense window is decided: its run histogram is one
        # index_add_ away, and its hottest run is the skew signal
        slot = (plan.rdata.to(torch.int64) - kmin).clamp(0, span - 1)
        ok = (torch.ones(n, dtype=torch.int32, device=slot.device)
              if plan.rvalid is None else plan.rvalid.to(torch.int32))
        cnt = torch.zeros(span, dtype=torch.int32, device=slot.device)
        cnt.index_add_(0, slot, ok)
        max_run = syncs.scalar(cnt.max())
        mean_run = max(n_valid / max(span, 1), 1.0)
        ratio = max_run / mean_run
        if ratio >= knobs.get("SRJT_AQE_SKEW_FACTOR"):
            skew = {"max_run": max_run, "n_valid": n_valid,
                    "span": span, "skew": ratio}

    if adaptive_dense == static_dense:
        return _Probe(None, "", skew)
    eng = "dense" if adaptive_dense else "sorted"
    detail = (f"{'sorted' if adaptive_dense else 'dense'}→{eng} "
              f"(span={span}, n_valid={n_valid}, probe_rows={probe_rows})")
    return _Probe(eng, detail, skew)


# --- reorderable chains ------------------------------------------------------


class _ChainDim(NamedTuple):
    plan: ir.Plan
    left_on: tuple
    right_on: tuple


def _collect_chain(fja: ir.FusedJoinAggregate):
    """``(base, dims)`` for a left-deep inner-join spine under an inner
    FusedJoinAggregate, or None.  ``dims[i]`` carries the key pair that
    binds dimension ``i``; the FJA's own join is the last."""
    if fja.how != "inner":
        return None
    spine = []
    node = fja.left
    while isinstance(node, ir.Join) and node.how == "inner":
        spine.append(node)
        node = node.left
    if not spine:
        return None
    base = node
    dims = [_ChainDim(j.right, j.left_on, j.right_on)
            for j in reversed(spine)]
    dims.append(_ChainDim(fja.right, fja.left_on, fja.right_on))
    return base, dims


def _aggs_order_insensitive(fja, results) -> bool:
    """True where every aggregate of ``fja`` gives the same bytes under
    any join order: an exact function over a non-float input.
    ``results`` holds the executed (table, names) of the base and dims."""
    for c, fn, _out in fja.aggs:
        if fn not in _REORDERABLE_AGGS:
            return False
        col = None
        for t, names in results:
            if c in names:
                col = t[names.index(c)]
                break
        if col is None:
            return False
        dt = col.dtype
        if dt.is_variable_width or dt.is_nested:
            return False
        if dt.id in (T.TypeId.FLOAT32, T.TypeId.FLOAT64,
                     T.TypeId.DECIMAL128):
            return False
    return True


# --- the stage-wise executor -------------------------------------------------


_BARRIERS = (ir.Join, ir.FusedJoinAggregate, ir.Aggregate)


class _Exec:
    def __init__(self, catalog, record_stats: bool,
                 report: AdaptiveReport):
        self.catalog = catalog
        self.record_stats = record_stats
        self.report = report

    def run(self, node: ir.Plan):
        if isinstance(node, ir.FusedJoinAggregate):
            chain = _collect_chain(node)
            if chain is not None and len(chain[1]) >= 2:
                ctx = profile.node_enter(node)
                if ctx is None:
                    return self._run_chain(node, *chain)
                res = None
                try:
                    res = self._run_chain(node, *chain)
                finally:
                    # the chain's record is the replan region: its
                    # children are the executed subtrees and the spine in
                    # its chosen order
                    profile.node_exit(ctx, None if res is None else res[0])
                return res
        ctx = profile.node_enter(node)
        if ctx is None:
            kids = [self.run(k) for k in ir.children(node)]
            return self._apply(node, kids)
        t = kids = None
        try:
            kids = [self.run(k) for k in ir.children(node)]
            t, names = self._apply(node, kids)
        finally:
            profile.node_exit(ctx, t, kids)
        return t, names

    def _apply(self, node: ir.Plan, kids,
               extra_decisions: Optional[list] = None):
        if not isinstance(node, _BARRIERS):
            return lower._apply_node(node, kids, self.catalog,
                                     self.record_stats)
        stage = StageRecord(index=len(self.report.stages),
                            node=ir._node_line(node),
                            est_rows=plan_stats.GLOBAL.rows_for(node))
        if extra_decisions:
            stage.decisions.extend(extra_decisions)
        self.report.stages.append(stage)

        force = None
        if (isinstance(node, (ir.Join, ir.FusedJoinAggregate))
                and node.engine is None
                and join_plan.forced_engine() is None):
            probe = _probe_engine(node, kids)
            if probe is not None:
                if probe.engine is not None:
                    force = probe.engine
                    stage.decisions.append(
                        Decision("engine_flip", probe.detail))
                    if metrics.recording():
                        metrics.count("plan.aqe.engine_flip.fired")
                        metrics.count(
                            f"plan.aqe.engine_flip.{probe.engine}")
                if probe.skew is not None:
                    s = probe.skew
                    stage.decisions.append(Decision(
                        "skew_advisory",
                        f"hot key ×{s['skew']:.1f} mean "
                        f"(max_run={s['max_run']}, "
                        f"n_valid={s['n_valid']})"))
                    if metrics.recording():
                        metrics.count("plan.aqe.skew_split.advisory")
                        metrics.gauge_max("plan.aqe.skew_split.max_run",
                                          s["max_run"])

        if force is None:
            t, names = lower._apply_node(node, kids, self.catalog,
                                         self.record_stats)
        else:
            # the seam the scheduler's degradation uses; the stats still
            # observe the unpinned fingerprint, so the static optimizer's
            # priors and the adaptive observations share one keyspace
            with join_plan.force_engine(force):
                t, names = lower._apply_node(node, kids, self.catalog,
                                             self.record_stats)
        stage.rows = t.num_rows
        if force is not None:
            profile.annotate_node(engine=force)
        for d in stage.decisions:
            profile.annotate_node(decision=f"{d.kind}: {d.detail}")
        self._check_regression(stage)
        return t, names

    def _check_regression(self, stage: StageRecord) -> None:
        if (not stage.decisions or stage.est_rows is None
                or stage.rows is None or stage.est_rows <= 0):
            return
        if stage.rows <= REGRESSION_FACTOR * stage.est_rows:
            return
        if metrics.recording():
            metrics.count("plan.aqe.regression")
        if syncs.mode() == "normal":
            # a replay would report the capture's incident again
            flight.incident(
                "aqe_regression", stage=stage.index, node=stage.node,
                est_rows=stage.est_rows, observed_rows=stage.rows,
                decisions=[f"{d.kind}: {d.detail}"
                           for d in stage.decisions])

    def _run_chain(self, fja: ir.FusedJoinAggregate, base_node, dims):
        base = self.run(base_node)
        dim_res = [self.run(d.plan) for d in dims]

        order = list(range(len(dims)))
        decisions: list = []
        base_names = set(base[1])
        commutable = all(set(d.left_on) <= base_names for d in dims)
        exact = commutable and _aggs_order_insensitive(
            fja, [base] + dim_res)
        rows = [r[0].num_rows for r in dim_res]
        min_rows = knobs.get("SRJT_AQE_REPLAN_MIN_ROWS")
        if exact and max(rows) >= min_rows:
            picked = sorted(order, key=lambda i: (rows[i], i))
            if picked != order:
                before = [rows[i] for i in order]
                after = [rows[i] for i in picked]
                decisions.append(Decision(
                    "replan",
                    f"join order {order} → {picked} "
                    f"(observed dim rows {before} → {after})"))
                if metrics.recording():
                    metrics.count("plan.aqe.replan.fired")
                order = picked
        elif metrics.recording():
            metrics.count("plan.aqe.replan.rejected")

        # the spine again in the chosen order; with the order unchanged
        # the nodes equal the originals, so fingerprints, stats and the
        # op sequence are the static executor's
        cur_plan, cur_res = base_node, base
        for j in order[:-1]:
            d = dims[j]
            jn = ir.Join(cur_plan, d.plan, d.left_on, d.right_on, "inner")
            cur_res = self._apply_staged(jn, [cur_res, dim_res[j]],
                                         extra_decisions=decisions)
            decisions = []          # the replan goes on the first stage
            cur_plan = jn
        last = dims[order[-1]]
        fnode = ir.FusedJoinAggregate(
            cur_plan, last.plan, last.left_on, last.right_on,
            fja.keys, fja.aggs, fja.how)
        return self._apply_staged(fnode, [cur_res, dim_res[order[-1]]],
                                  extra_decisions=decisions)

    def _apply_staged(self, node: ir.Plan, kids,
                      extra_decisions: Optional[list] = None):
        """One rebuilt spine node, profiled like a ``run()`` node, so that
        the executed join order shows in the profile."""
        ctx = profile.node_enter(node)
        if ctx is None:
            return self._apply(node, kids, extra_decisions)
        res = None
        try:
            res = self._apply(node, kids, extra_decisions)
        finally:
            profile.node_exit(ctx, None if res is None else res[0], kids)
        return res


# --- entry points ------------------------------------------------------------


def execute_adaptive(tree: ir.Plan, catalog, record_stats: bool = True,
                     report: Optional[AdaptiveReport] = None):
    """Run a plan tree with stage-wise adaptive re-optimization; returns
    the result table.  Pass ``report`` to collect the decisions."""
    plan_stats.ensure_sidecar_loaded()
    if report is None:
        report = AdaptiveReport()
    with metrics.span("plan.adaptive"):
        t, _names = _Exec(catalog, record_stats, report).run(tree)
    if metrics.recording():
        metrics.annotate(aqe_decisions=len(report.decisions()))
    return t


def compile_adaptive_plan(tree: ir.Plan, schemas: dict):
    """The adaptive twin of ``lower.compile_plan``: the same qfn shape,
    with an ``aqe_variant`` tag the plan cache folds into its key and a
    ``last_report`` attribute holding the latest run's decisions."""
    ir.schema_of(tree, schemas)

    def qfn(tables):
        report = AdaptiveReport()
        t = execute_adaptive(tree, lower.TableCatalog(tables, schemas),
                             report=report)
        qfn.last_report = report
        return t

    qfn.plan_tree = tree
    qfn.plan_fingerprint = ir.fingerprint(tree)
    qfn.plan_output_names = lower.output_names(tree, schemas)
    qfn.aqe_variant = "aqe"
    qfn.last_report = None
    return qfn


def explain_adaptive(tree: ir.Plan, schemas: dict, tables: dict,
                     stats=None) -> str:
    """EXPLAIN with the adaptive appendix: optimizes ``tree``, executes
    the optimized tree adaptively on ``tables``, and renders the static
    report and the decisions that fired."""
    from . import rules
    res = rules.optimize(tree, schemas, stats=stats)
    report = AdaptiveReport()
    execute_adaptive(res.tree, lower.TableCatalog(tables, schemas),
                     record_stats=False, report=report)
    return rules.explain(tree, schemas, stats=stats,
                         adaptive_report=report)
