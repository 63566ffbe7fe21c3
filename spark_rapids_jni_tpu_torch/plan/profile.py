"""Per-plan-node runtime profiles: the EXPLAIN ANALYZE subsystem.

The port's counterpart of the JAX package's ``plan/profile.py``.  While a
:class:`QueryProfile` is active, the executor (``plan/lower.py``) wraps
every node execution in :func:`node_enter` / :func:`node_exit`,
producing a tree of :class:`NodeProfile` records that mirrors what
actually ran — input/output rows, output bytes, validity density, the
engine decision taken, and wall/device time.  :func:`explain_analyze`
renders the annotated tree (estimated vs observed rows, >2×
mispredictions flagged); artifacts export as JSON under
``SRJT_PROFILE_DIR``; the flight recorder embeds in-flight partial
profiles in incident snapshots.  The adaptive executor
(``plan/adaptive.py``) wraps its stages the same way and records its
engine pins and decisions on them (:func:`annotate_node`).

Discipline (the same three rules as ``utils/metrics.py``):

* **One bool check when disabled.**  Every public entry is gated on ONE
  module-level bool (``SRJT_PROFILE``, default off); the compiled steady
  loop (``CompiledQuery.run_unchecked``) is untouched entirely.
* **Capture/replay-safe.**  Profiles derive only from host-visible
  values — ``Table.num_rows`` (host ints), tensor byte sizes,
  ``perf_counter`` — and recording is skipped under a ``syncs.replay``
  run (the CUDA-graph capture of a compiled query).  The one knob that
  syncs, ``SRJT_PROFILE_VALIDITY``, does so UNCONDITIONALLY at the single
  lowering funnel (``lower._apply_node`` → :func:`at_node_output`),
  through ``syncs.scalar``, so capture and replay tapes stay aligned;
  keep it stable across a compiled plan's lifetime.
* **Device time never forces and never waits per node.**  With
  ``SRJT_PROFILE_DEVICE_TIME`` on (default) and a card present, a node
  records one CUDA event on the current stream at enter and one at exit
  (nothing while a stream is capturing); the profile reads all of them
  once, when it closes, after one wait on the last event.  A node's
  ``fence_ms`` is that device time, its children's included (the JAX
  package's field name, where it is the wait for the node's buffers).
  An unrealized ``LazyColumn`` is never forced: forcing it would resolve
  its sizes outside their recorded order.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Optional

import torch

from ..analysis import sanitize
from ..utils import flight, knobs, metrics, syncs
from . import ir
from . import stats as plan_stats

#: observed rows beyond this factor × the prior estimate flags the node
#: as a misprediction in ``explain_analyze``
MISPREDICT_FACTOR = 2.0

_enabled: bool = bool(knobs.get("SRJT_PROFILE"))
_device_time: bool = bool(knobs.get("SRJT_PROFILE_DEVICE_TIME"))
_validity: bool = bool(knobs.get("SRJT_PROFILE_VALIDITY"))

_lock = sanitize.tracked_lock("plan.profile")
_tls = threading.local()                    # .prof = active QueryProfile
_inflight: dict[int, "QueryProfile"] = {}   # tid → active (flight probe)
_completed: "deque[QueryProfile]" = deque(maxlen=32)
_artifact_seq = 0

#: per-node cap on op-level events (a pathological loop must not grow a
#: profile without bound)
_MAX_OPS_PER_NODE = 64


def enabled() -> bool:
    return _enabled


def set_enabled(on: Optional[bool] = None) -> None:
    """Toggle profiling at runtime; ``None`` re-reads the env knobs.
    Also refreshes the device-time / validity sub-knob gates."""
    global _enabled, _device_time, _validity
    _enabled = bool(knobs.get("SRJT_PROFILE")) if on is None else bool(on)
    _device_time = bool(knobs.get("SRJT_PROFILE_DEVICE_TIME"))
    _validity = bool(knobs.get("SRJT_PROFILE_VALIDITY"))


def active() -> Optional["QueryProfile"]:
    """The calling thread's active profile (None outside :func:`query`)."""
    return getattr(_tls, "prof", None)


# --- records -----------------------------------------------------------------


@dataclass
class NodeProfile:
    """One executed plan node's runtime facts (a tree: ``children`` hold
    the node's executed inputs, mirroring the actual run)."""

    op: str                             # plan node class name
    line: str                           # ir._node_line rendering
    node_id: str                        # ir.fingerprint (structural)
    est_rows: Optional[float] = None    # plan/stats prior at entry
    in_rows: Optional[int] = None       # sum of child output rows
    out_rows: Optional[int] = None
    out_bytes: int = 0                  # realized device buffer bytes
    lazy_cols: int = 0                  # unrealized columns (not forced)
    valid_frac: Optional[float] = None  # SRJT_PROFILE_VALIDITY only
    wall_ms: float = 0.0                # inclusive (children included)
    fence_ms: Optional[float] = None    # device ms, enter → exit events
    engine: Optional[str] = None        # join engine pinned/used
    decisions: list = field(default_factory=list)   # AQE decision strings
    ops: list = field(default_factory=list)         # op-level events
    error: bool = False                 # node raised (partial record)
    children: list = field(default_factory=list)

    def self_ms(self) -> float:
        """Wall time exclusive of profiled children."""
        return max(self.wall_ms - sum(c.wall_ms for c in self.children),
                   0.0)

    def mispredicted(self) -> bool:
        """True when observed rows disagree with the prior by more than
        ``MISPREDICT_FACTOR`` in either direction."""
        if self.est_rows is None or not self.est_rows or \
                self.out_rows is None:
            return False
        ratio = self.out_rows / self.est_rows
        return (ratio > MISPREDICT_FACTOR
                or (self.out_rows and 1 / ratio > MISPREDICT_FACTOR))

    def walk(self):
        yield self
        for c in self.children:
            yield from c.walk()

    def as_dict(self) -> dict:
        d: dict[str, Any] = {"op": self.op, "line": self.line,
                             "node_id": self.node_id,
                             "out_rows": self.out_rows,
                             "out_bytes": self.out_bytes,
                             "wall_ms": round(self.wall_ms, 3),
                             "self_ms": round(self.self_ms(), 3)}
        if self.est_rows is not None:
            d["est_rows"] = self.est_rows
        if self.in_rows is not None:
            d["in_rows"] = self.in_rows
        if self.lazy_cols:
            d["lazy_cols"] = self.lazy_cols
        if self.valid_frac is not None:
            d["valid_frac"] = round(self.valid_frac, 4)
        if self.fence_ms is not None:
            d["fence_ms"] = round(self.fence_ms, 3)
        if self.engine is not None:
            d["engine"] = self.engine
        if self.decisions:
            d["decisions"] = list(self.decisions)
        if self.ops:
            d["ops"] = [dict(o) for o in self.ops]
        if self.mispredicted():
            d["mispredict"] = True
        if self.error:
            d["error"] = True
        if self.children:
            d["children"] = [c.as_dict() for c in self.children]
        return d


class QueryProfile:
    """One query execution's node-profile tree plus identity/timing."""

    def __init__(self, name: str, fingerprint: Optional[str] = None):
        self.name = name
        self.fingerprint = fingerprint
        self.ts = time.time()
        self.wall_ms = 0.0
        self.finished = False
        self.roots: list[NodeProfile] = []
        self._stack: list[NodeProfile] = []
        self._spans: dict[int, Any] = {}
        self._events: list = []         # (record, start, end) CUDA events
        self._t0 = time.perf_counter()

    def nodes(self):
        for r in self.roots:
            yield from r.walk()

    def mispredictions(self) -> list[NodeProfile]:
        return [n for n in self.nodes() if n.mispredicted()]

    def _read_events(self) -> None:
        """Each timed node's device ms from its two events: one wait on
        the last event recorded, then the elapsed times, which need no
        further wait."""
        evs = [e for e in self._events if e[2] is not None]
        self._events = []
        if not evs:
            return
        evs[-1][2].synchronize()
        for rec, start, end in evs:
            try:
                rec.fence_ms = start.elapsed_time(end)
            except RuntimeError:        # an event never recorded
                rec.fence_ms = None

    def as_dict(self, partial: bool = False) -> dict:
        d: dict[str, Any] = {
            "name": self.name, "fingerprint": self.fingerprint,
            "ts": round(self.ts, 6), "finished": self.finished,
            "wall_ms": round(self.wall_ms, 3),
            "nodes": [r.as_dict() for r in self.roots]}
        if partial and self._stack:
            # the in-flight path: innermost-open-last — an incident
            # snapshot shows exactly where the request is stuck
            d["open"] = [rec.line for rec in self._stack]
        return d

    def render(self) -> str:
        """Annotated plan-tree rendering (the EXPLAIN ANALYZE body)."""
        lines: list[str] = []

        def emit(rec: NodeProfile, depth: int) -> None:
            est = ("?" if rec.est_rows is None
                   else f"{rec.est_rows:.0f}")
            obs = "?" if rec.out_rows is None else str(rec.out_rows)
            parts = [f"rows est={est} obs={obs}"]
            if rec.out_bytes:
                parts.append(f"bytes={rec.out_bytes}")
            t = f"time={rec.wall_ms:.2f}ms self={rec.self_ms():.2f}ms"
            if rec.fence_ms is not None:
                t += f" fence={rec.fence_ms:.2f}ms"
            parts.append(t)
            if rec.valid_frac is not None:
                parts.append(f"valid={rec.valid_frac:.3f}")
            if rec.engine is not None:
                parts.append(f"engine={rec.engine}")
            if rec.mispredicted():
                parts.append("!!misprediction")
            if rec.error:
                parts.append("!!error")
            lines.append("  " * depth + rec.line
                         + "   | " + " ".join(parts))
            for d in rec.decisions:
                lines.append("  " * depth + f"  fired {d}")
            for c in rec.children:
                emit(c, depth + 1)

        for r in self.roots:
            emit(r, 0)
        return "\n".join(lines) if lines else "(no profiled nodes)"


# --- activation --------------------------------------------------------------


@contextlib.contextmanager
def query(name: str, fingerprint: Optional[str] = None):
    """Activate a :class:`QueryProfile` for the calling thread.  Yields
    None (and records nothing) when profiling is disabled or inside a
    replay; on exit the profile's device times are read, and it is
    finalized, retained (bounded), and exported to ``SRJT_PROFILE_DIR``
    when set."""
    if not _enabled or syncs.mode() == "replay":
        yield None
        return
    prof = QueryProfile(name, fingerprint)
    prev = getattr(_tls, "prof", None)
    _tls.prof = prof
    tid = threading.get_ident()
    with _lock:
        _inflight[tid] = prof
    try:
        yield prof
    finally:
        prof._read_events()
        prof.wall_ms = (time.perf_counter() - prof._t0) * 1e3
        prof.finished = not prof._stack
        _tls.prof = prev
        with _lock:
            if prev is None:
                _inflight.pop(tid, None)
            else:
                _inflight[tid] = prev
            _completed.append(prof)
        if metrics.recording():
            metrics.count("plan.profile.queries")
            n = len(prof.mispredictions())
            if n:
                metrics.count("plan.profile.mispredict", n)
        _export_artifact(prof)


def completed(last: Optional[int] = None) -> list[QueryProfile]:
    """Finished profiles, oldest → newest (bounded retention)."""
    with _lock:
        profs = list(_completed)
    return profs[-int(last):] if last is not None else profs


def reset() -> None:
    """Drop retained profiles (tests)."""
    with _lock:
        _completed.clear()


# --- executor instrumentation ------------------------------------------------


def _event():
    """A timing CUDA event recorded on the current stream, or None (no
    card, device time off, or a stream capturing a graph)."""
    if not (_device_time and torch.cuda.is_available()):
        return None
    if torch.cuda.is_current_stream_capturing():
        return None
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


def node_enter(node: ir.Plan) -> Optional[NodeProfile]:
    """Open a node record under the thread's active profile.  Returns
    None — ONE bool check then out — when profiling is off; also None
    without an active profile or under a replay."""
    if not _enabled:
        return None
    prof = getattr(_tls, "prof", None)
    if prof is None or syncs.mode() == "replay":
        return None
    rec = NodeProfile(op=type(node).__name__, line=ir._node_line(node),
                      node_id=ir.fingerprint(node),
                      est_rows=plan_stats.GLOBAL.rows_for(node),
                      engine=getattr(node, "engine", None))
    prof._stack.append(rec)
    sp = metrics.span(f"plan.node:{rec.op}", node_id=rec.node_id,
                      line=rec.line)
    sp.__enter__()                      # nullcontext when metrics off
    prof._spans[id(rec)] = sp
    rec._ev = _event()
    rec._t0 = time.perf_counter()
    return rec


def node_exit(rec: NodeProfile, t, kids=None) -> None:
    """Close ``rec`` with the node's output ``t`` (None on error) and the
    child ``(table, names)`` pairs when the caller has them."""
    prof = getattr(_tls, "prof", None)
    if t is None:
        rec.error = True
    else:
        rec.out_rows = t.num_rows
        rec.out_bytes, rec.lazy_cols = _table_bytes(t)
        if kids:
            rec.in_rows = sum(k[0].num_rows for k in kids)
    start = getattr(rec, "_ev", None)
    if start is not None and prof is not None:
        prof._events.append((rec, start, _event()))
    rec.wall_ms = (time.perf_counter() - rec._t0) * 1e3
    sp = None if prof is None else prof._spans.pop(id(rec), None)
    if isinstance(sp, metrics.Span):
        sp.annotate(rows=rec.out_rows, out_bytes=rec.out_bytes,
                    est_rows=rec.est_rows)
        if rec.engine is not None:
            sp.annotate(engine=rec.engine)
    if sp is not None:
        sp.__exit__(None, None, None)
    if prof is None or not prof._stack or prof._stack[-1] is not rec:
        return                          # unbalanced exit: drop, never raise
    prof._stack.pop()
    if prof._stack:
        prof._stack[-1].children.append(rec)
    else:
        prof.roots.append(rec)


def annotate_node(engine: Optional[str] = None,
                  decision: Optional[str] = None, **fields) -> None:
    """Attach an engine choice / AQE decision / extra fields to the
    innermost open node record (``plan/adaptive.py`` calls this at its
    decision sites)."""
    if not _enabled:
        return
    prof = getattr(_tls, "prof", None)
    if prof is None or not prof._stack or syncs.mode() == "replay":
        return
    rec = prof._stack[-1]
    if engine is not None:
        rec.engine = engine
    if decision is not None:
        rec.decisions.append(decision)
    for k, v in fields.items():
        setattr(rec, k, v) if hasattr(rec, k) else rec.ops.append(
            {"op": "annotate", k: v})


@contextlib.contextmanager
def stage(name: str, **fields):
    """Open a synthetic node record for a non-plan stage (ml/ feature
    pack, train, predict): the stage gets its own row in EXPLAIN ANALYZE
    / profile_report with wall/self time, and :func:`op_event`s fired
    inside attach to it.  Installed as ``metrics._profile_stage_hook`` —
    ml/ reaches it without importing plan/."""
    if not _enabled:
        yield None
        return
    prof = getattr(_tls, "prof", None)
    if prof is None or syncs.mode() == "replay":
        yield None
        return
    line = name if not fields else name + "(" + ", ".join(
        f"{k}={v}" for k, v in fields.items()) + ")"
    rec = NodeProfile(op=name, line=line, node_id=name)
    prof._stack.append(rec)
    rec._t0 = time.perf_counter()
    try:
        yield rec
    except BaseException:
        rec.error = True
        raise
    finally:
        rec.wall_ms = (time.perf_counter() - rec._t0) * 1e3
        if prof._stack and prof._stack[-1] is rec:
            prof._stack.pop()
            if prof._stack:
                prof._stack[-1].children.append(rec)
            else:
                prof.roots.append(rec)


def op_event(name: str, **fields) -> None:
    """One op-level event (join match counts, filter selectivity, scan
    pruning, rowconv volumes) into the innermost open node record.
    Installed as ``metrics.profile_op``'s hook so ops/ modules report
    without importing plan/.  Fields must already be host values."""
    if not _enabled:
        return
    prof = getattr(_tls, "prof", None)
    if prof is None or not prof._stack or syncs.mode() == "replay":
        return
    rec = prof._stack[-1]
    eng = fields.pop("engine", None)
    if eng is not None and rec.engine is None:
        rec.engine = eng
    if fields and len(rec.ops) < _MAX_OPS_PER_NODE:
        rec.ops.append({"op": name, **fields})


def at_node_output(t) -> None:
    """Hook at the single lowering funnel (``lower._apply_node``), called
    for EVERY applied node: when ``SRJT_PROFILE_VALIDITY`` is on, read
    the output's validity density — UNCONDITIONALLY on the module gates,
    never on profile/metrics state, so a capture run and its replay
    resolve the identical sync sequence — and stash it into the open
    node record when one is recording."""
    if not (_enabled and _validity):
        return
    frac = _validity_fraction(t)
    prof = getattr(_tls, "prof", None)
    if (frac is not None and prof is not None and prof._stack
            and syncs.mode() != "replay"):
        prof._stack[-1].valid_frac = frac


# --- table accounting helpers ------------------------------------------------


def _realized(col):
    """The concrete Column behind ``col``, or None when it is an
    unrealized LazyColumn (which must never be forced here)."""
    from ..column import LazyColumn
    if isinstance(col, LazyColumn):
        return col._col if col.forced else None
    return col


def _buffers(col):
    """``col``'s existing device tensors — NO materialization: a
    DictColumn contributes codes + dictionary tensors (its ``data`` would
    build the flat string bytes), a plain Column its data/offsets/
    validity."""
    from ..column import DictColumn
    if isinstance(col, DictColumn):
        out = [col.codes, col.validity]
        d = _realized(col.dictionary)
        if d is not None:
            out.extend(_buffers(d))
        return out
    return [col.data, col.offsets, col.validity]


def _table_bytes(t) -> tuple[int, int]:
    """(realized device bytes, unrealized column count) for ``t`` —
    tensor byte sizes only, no device sync, no forcing."""
    total = 0
    lazy = 0
    for c in t.columns:
        col = _realized(c)
        if col is None:
            lazy += 1
            continue
        for a in _buffers(col):
            if a is not None:
                total += a.numel() * a.element_size()
    return total, lazy


def _validity_fraction(t) -> Optional[float]:
    """Valid-row density across nullable realized columns (one scalar
    sync per nullable column — each through ``syncs.scalar`` so the
    capture/replay tape carries it)."""
    rows = t.num_rows
    if rows == 0:
        return None
    total = 0
    valid = 0
    for c in t.columns:
        col = _realized(c)
        if col is None or col.validity is None:
            continue
        total += rows
        valid += syncs.scalar(col.validity.sum())
    if total == 0:
        return None
    return valid / total


# --- EXPLAIN ANALYZE ---------------------------------------------------------


def explain_analyze(tree: ir.Plan, schemas: Optional[dict] = None,
                    tables: Optional[dict] = None, *, catalog=None,
                    stats=None) -> str:
    """Optimize ``tree``, execute it under an active profile, and render
    the annotated plan tree: estimated vs observed rows per node (>2×
    mispredictions flagged), output bytes, wall/device time, and the
    engine or AQE decision taken at each join.  Executes with
    ``record_stats=True``, so every observed cardinality feeds
    ``plan/stats.py`` — the misprediction IS corrected for the next
    optimize of the same shape.

    Pass ``tables`` + ``schemas`` (a ``TableCatalog`` is built) or an
    explicit ``catalog``.  Routes through the adaptive executor when
    ``SRJT_AQE`` is on (``mode: adaptive``), as ``lower.execute`` does.
    Profiling is force-enabled for the duration (this call IS the
    opt-in).  :func:`analyze` returns the executed result and the
    profile beside the text."""
    return analyze(tree, schemas, tables, catalog=catalog, stats=stats)[0]


def analyze(tree: ir.Plan, schemas: Optional[dict] = None,
            tables: Optional[dict] = None, *, catalog=None,
            stats=None) -> tuple:
    """:func:`explain_analyze`'s text, the executed result table and the
    :class:`QueryProfile`, in that order."""
    from . import lower, rules
    if catalog is None:
        if tables is None or schemas is None:
            raise ir.PlanError(
                "explain_analyze needs tables+schemas or a catalog")
        catalog = lower.TableCatalog(tables, schemas)
    opt = tree
    opt_lines: list[str] = []
    if knobs.get("SRJT_PLAN_OPT"):
        res = rules.optimize(tree, schemas if schemas is not None
                             else catalog.schemas, stats=stats)
        opt = res.tree
        opt_lines = [f"applied {e.rule}: {e.detail}" for e in res.events]
    fp = ir.fingerprint(opt)
    prev = _enabled
    set_enabled(True)
    try:
        with metrics.query_span(f"explain_analyze:{fp[5:17]}"):
            with query(f"explain_analyze:{fp[5:17]}", fp) as prof:
                out = lower.execute(opt, catalog, record_stats=True)
    finally:
        set_enabled(prev)
    mode = "adaptive" if knobs.get("SRJT_AQE") else "static"
    lines = ["== EXPLAIN ANALYZE ==", f"plan: {fp}", f"mode: {mode}"]
    lines += opt_lines
    lines.append(prof.render())
    mis = prof.mispredictions()
    lines.append(f"{sum(1 for _ in prof.nodes())} node(s), "
                 f"wall {prof.wall_ms:.2f} ms, "
                 f"{len(mis)} misprediction(s) >{MISPREDICT_FACTOR:g}x")
    return "\n".join(lines), out, prof


# --- artifact pipeline -------------------------------------------------------


def _export_artifact(prof: QueryProfile) -> Optional[str]:
    """Write ``prof`` (plus the plan's compile-cost ledger entry) as one
    JSON file under ``SRJT_PROFILE_DIR``.  Atomic (tmp + replace), never
    raises — export failure is a counter, not a second failure."""
    global _artifact_seq
    try:
        out_dir = knobs.get("SRJT_PROFILE_DIR")
        if not out_dir:
            return None
        with _lock:
            _artifact_seq += 1
            seq = _artifact_seq
        doc = prof.as_dict()
        ledger = metrics.ledger_snapshot()
        if prof.fingerprint and prof.fingerprint in ledger:
            doc["compile_ledger"] = ledger[prof.fingerprint]
        safe = "".join(ch if ch.isalnum() or ch in "-_." else "_"
                       for ch in prof.name)[:64]
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(
            out_dir, f"profile-{safe}-{os.getpid()}-{seq}.json")
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f, indent=1, default=repr)
        os.replace(tmp, path)
        return path
    except Exception:
        try:
            if metrics.enabled():
                metrics.count("plan.profile.export_failed")
        except Exception:
            pass
        return None


# --- flight-recorder probe ---------------------------------------------------


def _flight_probe():
    """Partial node profiles of every in-flight profiled query — a
    deadline/SLO incident snapshot shows WHERE each stuck request was."""
    with _lock:
        profs = list(_inflight.items())
    if not profs:
        return None
    return {str(tid): p.as_dict(partial=True) for tid, p in profs}


flight.register_probe("plan.active_profile", _flight_probe)

# ops-layer sites (ops/join.py, ops/filter.py, ops/groupby.py,
# parquet/device_scan.py, rowconv/convert.py) report through
# ``metrics.profile_op`` — installing the hook here keeps plan/ out of
# their import graphs entirely
metrics._profile_op_hook = op_event
metrics._profile_stage_hook = stage
