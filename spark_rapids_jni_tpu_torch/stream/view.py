"""Materialized-view registry: incremental maintenance over append-only facts.

The port's counterpart of the JAX package's ``stream/view.py``.  Views
are keyed on the optimized plan's structural fingerprint
(``plan/ir.fingerprint``).  At registration the optimized tree is
classified:

* **incremental** — a (Sort/Limit/Filter)* tail over ONE keyed
  Aggregate/FusedJoinAggregate whose pre-aggregate tree is *linear in the
  fact table*: built from Scan/Filter/Project/Join only, references the
  fact exactly once, every other scanned table is a registered
  epoch-stable static (dimension), and joins are inner (fact on either
  side) or left with the fact on the left.  Linearity means the
  pre-aggregate relation of (base + delta) is the base relation plus the
  pre-aggregate relation of the delta alone — so a refresh executes the
  pre-tree over ONLY the appended row groups and merges partial aggregate
  states (``ops.groupby.merge_aggregate_states``).  By default every
  aggregate must also be merge-*exact* (``ops.groupby.merge_exact``) so
  refreshed results stay bit-identical to a full recompute;
  ``SRJT_STREAM_ALLOW_APPROX=1`` admits float sums/means and M2-merged
  var/std (numerically stable, not bit-exact).

* **full** — anything else (window shapes, rollup/cube/grouping-set
  aggregates, grand totals,
  non-mergeable or non-exact aggregates, outer joins the delta algebra
  cannot split).  Refresh recomputes from scratch; the classifier reason
  lands on the ``stream.view.fallback`` counter and flight-recorder
  stream so ops can see *why* a view is not O(delta).

Running states live as ordinary device tables registered with the
memory budget's spill layer (``memory/spill.register_table``): under
budget pressure a cold view's state moves to pinned host memory and
comes back bit-exactly on its next refresh.
"""

from __future__ import annotations

from typing import Optional

from ..analysis import sanitize
from ..column import Table
from ..memory import spill as mspill
from ..ops import apply_boolean_mask, slice_table, sort_table
from ..ops import groupby as G
from ..plan import ir, lower, rules
from ..plan import stats as plan_stats
from ..utils import flight, knobs, metrics
from .delta import DeltaTable, Watermark

_PRE_NODES = (ir.Scan, ir.Filter, ir.Project, ir.Join)
_POST_NODES = (ir.Sort, ir.Limit, ir.Filter)


def _allow_approx_default() -> bool:
    return knobs.get("SRJT_STREAM_ALLOW_APPROX")


class MaterializedView:
    """One registered view: optimized tree + (for incremental views) the
    running aggregate state and its fact watermark."""

    __slots__ = ("name", "tree", "fingerprint", "kind", "reason", "post",
                 "pre", "keys", "aggs", "names", "key_idx", "agg_pairs",
                 "spec", "state", "watermark", "epoch", "lock",
                 "refreshes", "exact")

    def __init__(self, name: str, tree: ir.Plan, fingerprint: str):
        self.name = name
        self.tree = tree
        self.fingerprint = fingerprint
        self.kind = "full"
        self.reason: Optional[str] = None
        self.post: tuple = ()
        self.pre: Optional[ir.Plan] = None
        self.keys: tuple = ()
        self.aggs: tuple = ()
        self.names: list[str] = []
        self.key_idx: list[int] = []
        self.agg_pairs: list[tuple[int, str]] = []
        self.spec = None
        self.state: Optional[Table] = None
        self.watermark: Optional[Watermark] = None
        self.epoch = 0
        self.lock = sanitize.tracked_lock("stream.view")
        self.refreshes = 0
        self.exact = False


class ViewRegistry:
    """Registry of materialized views over ONE append-only fact table plus
    epoch-stable static (dimension) tables."""

    def __init__(self, delta: DeltaTable, statics: dict[str, Table],
                 schemas: dict[str, list[str]],
                 allow_approx: Optional[bool] = None):
        self.delta = delta
        self.statics = dict(statics)
        self.schemas = {k: list(v) for k, v in schemas.items()
                        if k in self.statics}
        self.schemas[delta.name] = delta.schema()
        self.allow_approx = (_allow_approx_default() if allow_approx is None
                             else bool(allow_approx))
        self._mu = sanitize.tracked_lock("stream.view_registry")
        self._by_fp: dict[str, MaterializedView] = {}
        self._by_name: dict[str, MaterializedView] = {}
        self._listeners: list = []
        self._fallbacks = 0
        self._probe = f"stream.views:{delta.name}"
        flight.register_probe(self._probe, self.stats)

    def close(self) -> None:
        flight.unregister_probe(self._probe)

    def stats(self) -> dict:
        with self._mu:
            views = list(self._by_fp.values())
            fallbacks = self._fallbacks
        return {
            "views": len(views),
            "incremental": sum(1 for v in views if v.kind == "incremental"),
            "full": sum(1 for v in views if v.kind == "full"),
            "fallbacks": fallbacks,
            "refreshes": sum(v.refreshes for v in views),
            "epoch": self.delta.epoch,
        }

    # -- registration -------------------------------------------------------

    def register_view(self, plan: ir.Plan,
                      name: Optional[str] = None) -> MaterializedView:
        res = rules.optimize(plan, self.schemas, stats=plan_stats.GLOBAL)
        tree = res.tree
        fp = ir.fingerprint(tree)
        with self._mu:
            got = self._by_fp.get(fp)
        if got is not None:
            return got
        v = MaterializedView(name or f"view:{fp[:12]}", tree, fp)
        self._classify(v)
        if v.kind == "incremental":
            self._rebuild_state(v)
        else:
            self._fallback(v, at="register")
        if metrics.recording():
            metrics.count("stream.view.registered")
        with self._mu:
            # registration raced: first one in wins, state and all
            prior = self._by_fp.get(fp)
            if prior is not None:
                return prior
            self._by_fp[fp] = v
            self._by_name[v.name] = v
        return v

    def resolve(self, view) -> MaterializedView:
        if isinstance(view, MaterializedView):
            return view
        with self._mu:
            got = self._by_name.get(view) or self._by_fp.get(view)
        if got is None:
            raise KeyError(f"unknown view {view!r}")
        return got

    def views(self) -> list[MaterializedView]:
        with self._mu:
            return list(self._by_fp.values())

    def delta_bytes(self, view) -> int:
        """Admission estimate for a refresh: compressed bytes of the
        not-yet-consumed row groups (incremental) or the whole fact table
        (full recompute)."""
        v = self.resolve(view)
        since = v.watermark if v.kind == "incremental" else None
        return max(int(self.delta.delta_bytes(since)), 1)

    # -- classification -----------------------------------------------------

    def _classify(self, v: MaterializedView) -> None:
        node, post = v.tree, []
        while isinstance(node, _POST_NODES) and not isinstance(node, ir.Scan):
            post.append(node)
            node = node.child
        if isinstance(node, ir.Aggregate):
            if node.grouping is not None:
                # rollup/cube/sets: several grouping levels and a
                # grouping_id, which one keyed state cannot stand for
                # (the JAX package's classifier misses this and refreshes
                # such a view as its finest level alone)
                v.reason = f"grouping:{node.grouping}"
                return
            pre = node.child
        elif isinstance(node, ir.FusedJoinAggregate):
            pre = ir.Join(node.left, node.right, node.left_on,
                          node.right_on, how=node.how)
        else:
            v.reason = f"shape:{type(node).__name__}"
            return
        if not node.keys:
            v.reason = "grand_total"     # empty-input null semantics differ
            return
        fact = self.delta.name
        fact_scans = 0
        for sub in ir.walk(pre):
            if not isinstance(sub, _PRE_NODES):
                v.reason = f"pre_node:{type(sub).__name__}"
                return
            if isinstance(sub, ir.Scan):
                if sub.table == fact:
                    fact_scans += 1
                elif sub.table not in self.statics:
                    v.reason = f"non_static:{sub.table}"
                    return
            elif isinstance(sub, ir.Join):
                if sub.how == "inner":
                    continue
                if sub.how == "left":
                    # delta algebra needs the fact (the only growing
                    # input) on the preserved side
                    if any(isinstance(s, ir.Scan) and s.table == fact
                           for s in ir.walk(sub.right)):
                        v.reason = "left_join_fact_on_right"
                        return
                else:
                    v.reason = f"join:{sub.how}"
                    return
        if fact_scans != 1:
            v.reason = f"fact_scans:{fact_scans}"
            return
        names = list(ir.schema_of(pre, self.schemas))
        dtypes = {}
        try:
            for col, fn, _out in node.aggs:
                if fn not in G.MERGEABLE_AGGS:
                    v.reason = f"agg:{fn}"
                    return
                vi = names.index(col)
                dtypes[vi] = self._dtype_of(col)
                if not self.allow_approx and not G.merge_exact(fn,
                                                               dtypes[vi]):
                    v.reason = f"approx:{fn}({col})"
                    return
            spec = G.plan_aggregate_states(
                [(names.index(c), fn) for c, fn, _ in node.aggs],
                dtypes, len(node.keys))
        except (NotImplementedError, ValueError, KeyError) as e:
            v.reason = f"state_plan:{e}"
            return
        v.kind = "incremental"
        v.post = tuple(post)
        v.pre = pre
        v.keys = tuple(node.keys)
        v.aggs = tuple(node.aggs)
        v.names = names
        v.key_idx = [names.index(k) for k in node.keys]
        v.agg_pairs = [(names.index(c), fn) for c, fn, _ in node.aggs]
        v.spec = spec
        v.exact = spec.exact

    def _dtype_of(self, col: str):
        for tname, cols in self.schemas.items():
            if col in cols:
                if tname == self.delta.name:
                    return self.delta.column_dtype(col)
                return self.statics[tname][cols.index(col)].dtype
        raise KeyError(col)

    # -- refresh ------------------------------------------------------------

    def add_refresh_listener(self, fn) -> None:
        """Register ``fn(view, table)`` to run after every successful
        refresh, OUTSIDE the view's refresh lock (the online-feature-store
        hook — ``ml/serve.FeatureView`` re-packs here).  Listener errors
        are recorded to the flight buffer, never propagated into refresh."""
        with self._mu:
            self._listeners.append(fn)

    def remove_refresh_listener(self, fn) -> None:
        with self._mu:
            if fn in self._listeners:
                self._listeners.remove(fn)

    def _notify_refresh(self, v: MaterializedView, table: Table) -> None:
        with self._mu:
            listeners = list(self._listeners)
        for fn in listeners:
            try:
                fn(v, table)
            except Exception as e:                     # noqa: BLE001
                flight.record("stream.refresh.listener_error",
                              view=v.name, error=repr(e))

    def refresh(self, view) -> Table:
        """Bring the view up to the fact table's current epoch and return
        its result (post-aggregate Sort/Filter/Limit applied)."""
        v = self.resolve(view)
        out = self._refresh_locked(v)
        self._notify_refresh(v, out)
        return out

    def _refresh_locked(self, v: MaterializedView) -> Table:
        with v.lock:
            with metrics.span("stream.refresh", view=v.name, kind=v.kind):
                v.refreshes += 1
                if v.kind != "incremental":
                    if metrics.recording():
                        metrics.count("stream.refresh.full")
                    return self._execute_full(v)
                cur = self.delta.watermark()
                wm = v.watermark
                if wm is None or len(cur) < len(wm) \
                        or any(c < w for c, w in zip(cur, wm)):
                    # watermark no longer a prefix of the file layout —
                    # should be impossible through the DeltaTable API;
                    # recover by rebuilding rather than serving wrong rows
                    flight.incident("stream_watermark_regression",
                                    view=v.name, watermark=list(wm or ()),
                                    current=list(cur))
                    self._fallback(v, at="refresh")
                    self._rebuild_state(v)
                elif cur != wm:
                    delta_rel = lower.execute(
                        v.pre, _StreamCatalog(self, since=wm, until=cur),
                        record_stats=False)
                    dstate = G.partial_aggregate_states(
                        delta_rel, v.key_idx, v.agg_pairs, spec=v.spec)
                    v.state = G.merge_aggregate_states(v.spec, v.state,
                                                       dstate)
                    mspill.register_table(v.state, "stream.view_state")
                    v.watermark = cur
                    v.epoch = self.delta.epoch
                    if metrics.recording():
                        metrics.count("stream.refresh.incremental")
                        metrics.annotate(delta_rows=delta_rel.num_rows,
                                         state_rows=v.state.num_rows)
                else:
                    if metrics.recording():
                        metrics.count("stream.refresh.noop")
                out = G.finalize_aggregate_states(v.spec, v.state)
                return self._apply_post(v, out)

    def _rebuild_state(self, v: MaterializedView) -> None:
        cur = self.delta.watermark()
        rel = lower.execute(v.pre, _StreamCatalog(self, since=None,
                                                  until=cur),
                            record_stats=False)
        v.state = G.partial_aggregate_states(rel, v.key_idx, v.agg_pairs,
                                             spec=v.spec)
        mspill.register_table(v.state, "stream.view_state")
        v.watermark = cur
        v.epoch = self.delta.epoch

    def _execute_full(self, v: MaterializedView) -> Table:
        return lower.execute(v.tree, _StreamCatalog(self, since=None,
                                                    until=None),
                             record_stats=False)

    def _apply_post(self, v: MaterializedView, t: Table) -> Table:
        # mirrors lower._execute's Sort/Filter/Limit lowering exactly so
        # the refreshed result is bit-identical to executing the tree
        names = list(v.keys) + [a[2] for a in v.aggs]
        for node in reversed(v.post):
            if isinstance(node, ir.Filter):
                t = apply_boolean_mask(
                    t, lower.eval_mask(node.predicate, t, names))
            elif isinstance(node, ir.Sort):
                asc = None if node.ascending is None else list(node.ascending)
                t = sort_table(t, [names.index(k) for k in node.keys],
                               ascending=asc)
            elif isinstance(node, ir.Limit):
                t = slice_table(t, 0, node.n)
        return t

    def _fallback(self, v: MaterializedView, at: str) -> None:
        with self._mu:
            self._fallbacks += 1
        if metrics.recording():
            metrics.count("stream.view.fallback")
        flight.record("stream.view.fallback", view=v.name, at=at,
                      reason=v.reason)


class _StreamCatalog:
    """Catalog routing fact scans through the DeltaTable's row-group
    window and static scans through identity-preserving column selection
    (so dimension build-index caches keep hitting across refreshes)."""

    def __init__(self, registry: ViewRegistry, since: Optional[Watermark],
                 until: Optional[Watermark]):
        self._r = registry
        self._since = since
        self._until = until

    @property
    def schemas(self) -> dict[str, list[str]]:
        return self._r.schemas

    def scan(self, node: ir.Scan) -> tuple[Table, list[str]]:
        r = self._r
        if node.table == r.delta.name:
            full = r.schemas[node.table]
            cols = list(node.columns) if node.columns is not None \
                else list(full)
            t = r.delta.scan(
                columns=cols,
                rowgroup_predicate=lower.rowgroup_conditions(node.predicate),
                since=self._since, until=self._until)
            if metrics.recording() and len(cols) < len(full):
                metrics.count("plan.scan.columns_pruned",
                              len(full) - len(cols))
            return t, cols
        t = r.statics[node.table]
        names = r.schemas[node.table]
        if node.columns is None:
            return t, list(names)
        return (Table([t[names.index(c)] for c in node.columns]),
                list(node.columns))
