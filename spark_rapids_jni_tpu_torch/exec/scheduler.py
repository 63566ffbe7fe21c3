"""Bounded-concurrency query scheduler: the serving runtime's front door.

The port's copy of the JAX package's ``exec/scheduler.py``.  Shape follows the Spark side of the reference stack: a bounded task queue
feeding a fixed worker pool over N data-parallel device replicas, with
admission control deciding what may touch device memory when (SURVEY §1's
many-tasks-one-GPU discipline, rebuilt at query granularity).  One
request's life:

    submit ──queue (priority heap, bounded depth)── dequeue (a replica's
      worker) → deadline check → prefetched tables (``exec/prefetch.py``)
      → per-device admission gate (``exec/admission.py``; defer/degrade)
      → placement (``exec/placement.py``: inputs replicated onto the
        replica's device, identity-cached)
      → plan cache (``exec/plan_cache.py``, device-keyed variant) under
        ``memory.budget.query_budget`` + the replica's
        ``faultinj.ResilientExecutor``
      → the current CUDA stream synchronized inside the executor, so
        that an asynchronous device fault raises there, never resolving
        a ticket with garbage
      → ticket resolves (result or typed error)

Everything device-touching happens on the WORKER thread that dequeued
the request: capture runs, graph captures and budget scopes are all
thread-local-safe (``utils.syncs`` tape state and the query-budget stack
are thread-local by construction), so workers never share partial state.
Graph captures exclude all other device work of the process
(``models.compiled.DEVICE``): every eager run, copy and synchronisation
here enters ``compiled.device_work`` first.  All threads stay on the
default CUDA stream.

``QueryScheduler(device="cpu")`` serves on CPU replicas (the tests);
without it the replicas are cards, and without a card it raises.

**Multi-device placement** (``devices=N`` / ``SRJT_EXEC_DEVICES``,
default 1): each of the first N local devices gets a
:class:`~.placement.Replica` — its own ``ResilientExecutor`` (fault
lifecycle is per device), its own ``AdmissionController``
(``SRJT_EXEC_INFLIGHT_BYTES`` caps each device's in-flight bytes), and
worker affinity (worker *i* serves replica *i* mod N).  Placement is
least-loaded by construction: free workers pull from the shared priority
heap, so work flows to whichever device has capacity; a non-serving
replica's workers PARK and pull nothing.  Request inputs are replicated
to the target device through an identity-keyed placement cache (small
read-only dimension tables copy once, then every repeat request reuses
the same device-resident buffers — which also keeps plan-cache identity
fingerprints stable), and compiled plans key on a per-device variant
(``d<k>``), so replicas never share traced buffers.

Backpressure is typed, never silent: a full queue raises
:class:`~.errors.ExecQueueFull` at submit, a missed deadline resolves
the ticket with :class:`~.errors.ExecDeadlineExceeded`, shutdown drains
to :class:`~.errors.ExecShutdown`.

**Fault lifecycle — quarantine → probation → recovery → (ejection)**:
transient OOMs retry in place with jittered exponential backoff; a fatal
device fault quarantines THAT replica only.  The admission ladder
generalizes defer → degrade → **relocate**: the quarantined replica's
in-flight-failed and queued requests re-enqueue onto healthy replicas
(bounded by ``SRJT_EXEC_RELOCATE_MAX`` hops, re-admitted on the target
device's ledger, bit-identical results), counted by
``exec.failover.relocated`` with a ``failover`` incident snapshot.  A
background probe (``SRJT_EXEC_RECOVERY``, default on) retries the dead
replica with jittered exponential backoff (``SRJT_EXEC_PROBE_BASE_S`` /
``SRJT_EXEC_PROBE_MAX_S``): each probe moves the executor to probation
and runs a host-validated canary through the real dispatch path —
success re-admits the replica (``exec.failover.recovered`` + a
``recovery`` incident), ``SRJT_EXEC_EJECT_AFTER`` consecutive failures
permanently eject it (``exec.failover.ejected`` + an ``ejected``
incident).  Only when NO replica can ever serve again does submit fail
fast with ``DeviceQuarantined`` — the plugin's "replace the executor"
contract, replacement included.

**Cross-request coalescing** (``SRJT_EXEC_COALESCE_MS``, default 4 ms;
0 disables): workers don't just interleave same-plan requests, they
COALESCE them into one program launch — the paper's few-large-programs
discipline applied across requests instead of across rows.  A dequeued
compiled request first sweeps the queue for requests with the same
coalesce key (query name + qfn + size fingerprint of the tables), then
holds a short window — bounded by every gathered request's deadline —
for more arrivals, and the whole batch executes through
``PlanCache.run_batched``: identical buffers share one dispatch and its
result, distinct same-shape buffers stack onto the plan's vmapped
program (which returns None in the port: distinct buffers replay the one
graph in turn).  Admission charges the batch ONCE (shared buffers dedup in the
estimate); a batch whose combined footprint would blow the in-flight cap
splits greedily into cap-sized sub-batches (``exec.batch.split``).
Results are bit-identical to serial execution by construction — the
batched paths are parity-checked, and every fallback is the ordinary
per-request dispatch.

**Request lifecycle tracing**: every request carries a request id
(``<name>#<seq>``, on the ticket as ``rid``) threaded through queue →
admission → coalesce window → batch membership → dispatch →
the stream synchronisation → resolve.  Each stage records (a) a flight-recorder
event (``utils/flight.py`` — always on, so the black box has the full
lifecycle when an incident snapshot fires) and (b) an exact per-stage
latency attribution histogram: ``exec.stage.queue_ms`` (submit →
dequeue/gather), ``exec.stage.coalesce_ms`` (gather → batch launch),
``exec.stage.admission_ms``, ``exec.stage.dispatch_ms`` (launch → outputs
dispatched), ``exec.stage.ready_ms`` (dispatch → buffers materialized) —
summing to ``exec.e2e_ms`` up to scheduling gaps.  A coalesced launch
records one ``exec.batch.launch`` event linking every member rid, so the
shared program's cost is attributable to the requests that rode it.
With metrics on, the worker's time is in ``utils.metrics`` spans, which
are ``torch.profiler`` ranges too: ``exec.wait`` (blocked on the queue
with no work), ``exec.coalesce`` (the hold), ``exec.admission``,
``exec.dispatch`` (the plan cache's ``plan_cache.lookup`` and the
plan's ``compiled.lock`` and ``compiled.replay`` inside it),
``exec.ready`` (the stream synchronisation) and ``exec.resolve``; each
carries its rid (or the batch's rids) as an attribute, never in its
name.
Deadline breaches, quarantines, and request failures dump incident
snapshots; resolved outcomes feed the SLO watchdog (``exec/slo.py``).

Knobs: ``SRJT_EXEC_WORKERS`` (default 4; floored at the device count),
``SRJT_EXEC_QUEUE_DEPTH`` (default 32), ``SRJT_EXEC_COALESCE_MS``
(default 4), ``SRJT_EXEC_COALESCE_MAX`` (default 16),
``SRJT_EXEC_DEADLINE`` (default end-to-end timeout in seconds for
requests submitted without one), ``SRJT_EXEC_DEVICES`` (default 1),
``SRJT_EXEC_RECOVERY`` (default 1), ``SRJT_EXEC_PROBE_BASE_S`` /
``SRJT_EXEC_PROBE_MAX_S`` (default 0.05 / 2.0),
``SRJT_EXEC_EJECT_AFTER`` (default 3), ``SRJT_EXEC_RELOCATE_MAX``
(default: device count), ``SRJT_AOT_WARMUP`` (default 8; with
``SRJT_AOT_DIR`` set, a background thread pre-hydrates that many
top-cost artifacts from the AOT store at startup — ``exec/artifacts.py``),
plus the admission/prefetch/plan-cache knobs of the composed parts.
``submit_refresh`` serves a ``stream/`` view refresh and
``submit_predict`` an ``ml/`` servable through the same pipeline.
Histograms: ``exec.e2e_ms``, ``exec.batch.size``, and the
``exec.stage.*`` attribution family above.
"""

from __future__ import annotations

import contextlib
import heapq
import itertools
import random
import threading
import time
from collections import OrderedDict
from typing import Any, Callable, Optional

from ..analysis import sanitize
from ..faultinj import injector as finj
from ..faultinj.resilience import DeviceQuarantined
from ..memory import budget as mbudget
from ..models import compiled as C
from ..utils import flight, knobs, metrics, structured_log
from . import artifacts
from .admission import request_bytes
from .errors import (ExecDeadlineExceeded, ExecError, ExecQueueFull,
                     ExecShutdown)
from .placement import Replica, build_replicas
from .plan_cache import PlanCache
from .prefetch import Prefetcher
from .slo import SloWatchdog


class QueryTicket:
    """One submitted request's future: resolves to the query result or a
    typed error.  ``result()`` blocks; ``timings`` carries the request's
    per-stage attribution (queue/coalesce/admission/dispatch/ready
    seconds) once resolved; ``rid`` is the request id every flight-
    recorder event and log line for this request carries."""

    __slots__ = ("name", "rid", "_done", "_result", "_exc", "timings",
                 "degraded", "batch_rids", "device", "relocations")

    def __init__(self, name: str, rid: str = ""):
        self.name = name
        self.rid = rid
        self._done = threading.Event()
        self._result: Any = None
        self._exc: Optional[BaseException] = None
        self.timings: dict[str, float] = {}
        self.degraded = False
        self.batch_rids: Optional[list[str]] = None   # coalesced peers
        self.device: Optional[str] = None             # replica that served
        self.relocations = 0                          # failover hops

    def done(self) -> bool:
        return self._done.is_set()

    def exception(self) -> Optional[BaseException]:
        self._done.wait()
        return self._exc

    def result(self, timeout: Optional[float] = None) -> Any:
        if not self._done.wait(timeout):
            raise TimeoutError(f"request {self.name!r} still pending")
        if self._exc is not None:
            raise self._exc
        return self._result

    def _resolve(self, result=None, exc: Optional[BaseException] = None):
        self._result = result
        self._exc = exc
        self._done.set()


class _Request:
    __slots__ = ("name", "qfn", "tables", "loader", "priority", "deadline",
                 "nbytes", "compiled", "ticket", "t_submit", "seq", "ckey",
                 "rid", "t_gather", "relocations", "relocatable")

    def __init__(self, **kw):
        self.t_gather = None        # set when pulled into a batch
        self.relocations = 0        # failover hops so far
        self.relocatable = True
        for k, v in kw.items():
            setattr(self, k, v)


class QueryScheduler:
    """Bounded worker pool pulling from a priority request queue.

    Lower ``priority`` values run first (0 = default; ties FIFO by
    submission order).  Context-manager use shuts the pool down on exit.
    ``device="cpu"`` serves on CPU replicas; left out, on the cards.
    """

    def __init__(self, workers: Optional[int] = None,
                 queue_depth: Optional[int] = None,
                 inflight_bytes=None,
                 plan_cache: Optional[PlanCache] = None,
                 prefetch: bool = True,
                 max_retries: int = 2,
                 coalesce_ms: Optional[float] = None,
                 max_batch: Optional[int] = None,
                 devices: Optional[int] = None,
                 recovery: Optional[bool] = None,
                 probe_base_s: Optional[float] = None,
                 probe_max_s: Optional[float] = None,
                 eject_after: Optional[int] = None,
                 relocate_max: Optional[int] = None,
                 device=None):
        if workers is None:
            workers = knobs.get("SRJT_EXEC_WORKERS")
        if queue_depth is None:
            queue_depth = knobs.get("SRJT_EXEC_QUEUE_DEPTH")
        if coalesce_ms is None:
            coalesce_ms = knobs.get("SRJT_EXEC_COALESCE_MS")
        if max_batch is None:
            max_batch = knobs.get("SRJT_EXEC_COALESCE_MAX")
        if devices is None:
            devices = knobs.get("SRJT_EXEC_DEVICES")
        if recovery is None:
            recovery = knobs.get("SRJT_EXEC_RECOVERY")
        if probe_base_s is None:
            probe_base_s = knobs.get("SRJT_EXEC_PROBE_BASE_S")
        if probe_max_s is None:
            probe_max_s = knobs.get("SRJT_EXEC_PROBE_MAX_S")
        if eject_after is None:
            eject_after = knobs.get("SRJT_EXEC_EJECT_AFTER")
        self.n_devices = max(int(devices), 1)
        if relocate_max is None:
            relocate_max = knobs.get("SRJT_EXEC_RELOCATE_MAX")
            if relocate_max is None:
                relocate_max = self.n_devices
        # every device needs at least one affine worker to serve at all
        self.workers = max(int(workers), 1, self.n_devices)
        self.queue_depth = max(int(queue_depth), 1)
        self.coalesce_ms = max(float(coalesce_ms), 0.0)
        self.max_batch = max(int(max_batch), 1)
        self.recovery = bool(recovery)
        self.probe_base_s = max(float(probe_base_s), 1e-3)
        self.probe_max_s = max(float(probe_max_s), self.probe_base_s)
        self.eject_after = max(int(eject_after), 1)
        self.relocate_max = max(int(relocate_max), 1)
        self.default_timeout_s: Optional[float] = \
            knobs.get("SRJT_EXEC_DEADLINE")
        self.replicas: list[Replica] = build_replicas(
            self.n_devices, device=device, inflight_bytes=inflight_bytes,
            max_retries=max_retries)
        # back-compat aliases: single-device callers (and the ops surface)
        # see replica 0's gate and executor under the historical names
        self.admission = self.replicas[0].admission
        self.resilient = self.replicas[0].resilient
        self.plans = plan_cache if plan_cache is not None else PlanCache()
        # SQL qfn memo: plan fingerprint + schema → one stable callable,
        # so repeat submit_sql calls coalesce (ckey uses id(qfn)) and hit
        # the same plan-cache entry as an equivalent hand-built tree
        self._sql_qfns: "OrderedDict[tuple, Callable]" = OrderedDict()
        self._sql_lock = threading.Lock()
        self.prefetcher = Prefetcher() if prefetch else None
        self.slo = SloWatchdog()
        self._heap: list[tuple[int, int, _Request]] = []
        self._cv = threading.Condition(
            sanitize.tracked_lock("exec.scheduler.cv"))
        self._seq = itertools.count()
        self._closed = False
        self._probe_rng = random.Random(0x5e1f)
        self._probe_stop = threading.Event()
        # black-box probes: an incident snapshot from ANY subsystem
        # carries the live serving state (last scheduler wins the names)
        flight.register_probe("scheduler.queue_depth", self.pending)
        flight.register_probe("scheduler.inflight_bytes",
                              self.admission.inflight_bytes)
        flight.register_probe("scheduler.plan_cache", self.plans.stats)
        flight.register_probe("scheduler.slo", self.slo.status)
        flight.register_probe(
            "scheduler.replicas",
            lambda: [rep.snapshot() for rep in self.replicas])
        metrics.start_http_server()    # no-op without SRJT_METRICS_PORT
        self._threads = [
            threading.Thread(target=self._worker, name=f"srjt-exec-{i}",
                             args=(self.replicas[i % self.n_devices],),
                             daemon=True)
            for i in range(self.workers)]
        for t in self._threads:
            t.start()
        self._probe_thread: Optional[threading.Thread] = None
        if self.recovery:
            self._probe_thread = threading.Thread(
                target=self._recovery_loop, name="srjt-exec-probe",
                daemon=True)
            self._probe_thread.start()
        # AOT warm-up (exec/artifacts.py): pre-hydrate the costliest
        # persisted plan artifacts on a low-priority background thread so
        # the first requests' plan-cache lookups are memory hits.  Pure
        # disk reads — never touches the device, never blocks serving.
        self._warmup_thread: Optional[threading.Thread] = None
        warm_n = knobs.get("SRJT_AOT_WARMUP")
        if artifacts.enabled() and warm_n > 0:
            self._warmup_thread = threading.Thread(
                target=self._aot_warmup, args=(int(warm_n),),
                name="srjt-exec-warmup", daemon=True)
            self._warmup_thread.start()

    def pending(self) -> int:
        """Queued-but-undequeued request count (ops probe)."""
        with self._cv:
            return len(self._heap)

    def ops_state(self) -> dict:
        """One dict of live serving state for ``tools/ops_report.py``:
        queue depth, in-flight bytes, plan-cache stats, SLO status."""
        return {"queue_depth": self.pending(),
                "workers": self.workers,
                "devices": self.n_devices,
                "inflight_bytes": self.admission.inflight_bytes(),
                "inflight_cap": self.admission.cap,
                "quarantined": self.resilient.quarantined,
                "replicas": [rep.snapshot() for rep in self.replicas],
                "plan_cache": self.plans.stats(),
                "slo": self.slo.status()}

    # -- submission ----------------------------------------------------------

    def submit(self, name: str, qfn: Callable, tables=None, *,
               loader: Optional[Callable[[], Any]] = None,
               priority: int = 0,
               timeout_s: Optional[float] = None,
               nbytes: Optional[int] = None,
               compiled: bool = True,
               relocatable: bool = True) -> QueryTicket:
        """Enqueue ``qfn`` over ``tables`` (or over ``loader()``'s result,
        staged ahead of execution by the prefetcher).  Raises
        :class:`ExecQueueFull` at depth — the backpressure signal —
        and :class:`DeviceQuarantined` once the pool is quarantined.

        ``timeout_s`` bounds the request END TO END (queue + admission;
        a dispatched execution is never aborted mid-flight).  ``nbytes``
        overrides the admission estimate; ``compiled=False`` bypasses
        the plan cache (eager execution)."""
        if tables is None and loader is None:
            raise ValueError("submit needs tables or a loader")
        # fail fast only when no replica can EVER serve this request:
        # with recovery on, a quarantined (non-ejected) replica still
        # counts — the probe may re-admit it before the deadline
        if not any(r.recoverable() if self.recovery else r.serving()
                   for r in self.replicas):
            raise DeviceQuarantined("every replica is quarantined")
        if timeout_s is None:
            timeout_s = self.default_timeout_s
        seq = next(self._seq)
        rid = f"{name}#{seq}"
        ticket = QueryTicket(name, rid)
        now = time.monotonic()
        ckey = None
        if compiled and tables is not None and self.coalesce_ms > 0:
            # coalesce key: same query + same plan shape ⇒ same compiled
            # program ⇒ batchable into one launch.  Size (not identity)
            # fingerprint, so refreshed same-shape data coalesces too.
            try:
                sfp, _ = C.plan_key(tables, by_size=True)
                ckey = (name, id(qfn), sfp)
            except Exception:
                ckey = None
        req = _Request(
            name=name, qfn=qfn, tables=tables, loader=loader,
            priority=int(priority),
            deadline=(now + timeout_s) if timeout_s is not None else None,
            nbytes=nbytes, compiled=compiled, ticket=ticket,
            t_submit=now, seq=seq, ckey=ckey, rid=rid,
            relocatable=relocatable)
        with self._cv:
            if self._closed:
                raise ExecShutdown("scheduler is shut down")
            if len(self._heap) >= self.queue_depth:
                if metrics.recording():
                    metrics.count("exec.queue.rejected")
                flight.record("exec.reject", rid=rid,
                              depth=self.queue_depth)
                raise ExecQueueFull(self.queue_depth)
            heapq.heappush(self._heap, (req.priority, req.seq, req))
            qdepth = len(self._heap)
            # notify_all: idle workers AND workers holding a coalesce
            # window open both need the arrival signal
            self._cv.notify_all()
        flight.record("exec.submit", rid=rid, priority=int(priority),
                      qdepth=qdepth,
                      timeout_s=timeout_s if timeout_s is not None else 0)
        if metrics.recording():
            metrics.count("exec.submitted")
        if loader is not None and tables is None \
                and self.prefetcher is not None:
            # overlap the next request's scan with current executions.
            # (tables-AND-loader submits must not stage: the serve path
            # uses the tables directly and would orphan the slot)
            self.prefetcher.stage((req.name, req.seq), loader,
                                  deadline=req.deadline)
        return ticket

    def run(self, name: str, qfn: Callable, tables=None, **kw) -> Any:
        """Synchronous convenience: submit + block on the result."""
        return self.submit(name, qfn, tables, **kw).result()

    def submit_refresh(self, registry, view, *, priority: int = 0,
                       timeout_s: Optional[float] = None) -> QueryTicket:
        """Route a materialized-view refresh (``stream.ViewRegistry``)
        through the serving pipeline: same queue, priorities, deadlines,
        and quarantine as queries — but admission charges only the
        NOT-YET-CONSUMED delta bytes (the refresh's actual decode work),
        not the full table, so refreshes of a trickle of appends don't
        stall behind table-sized admission holds.  Runs eager
        (``compiled=False``): the refresh closure consults and mutates
        registry state, so it is never plan-cached or coalesced."""
        v = registry.resolve(view)
        est = registry.delta_bytes(v)

        def _refresh(_tables, _registry=registry, _view=v):
            return _registry.refresh(_view)

        if metrics.recording():
            metrics.count("stream.refresh.submitted")
        flight.record("stream.refresh.submit", view=v.name,
                      view_kind=v.kind, est_bytes=est)
        # relocatable=False: the refresh closure mutates registry state,
        # so a fault mid-refresh must surface, never silently re-run
        return self.submit(f"refresh:{v.name}", _refresh, tables={},
                           priority=priority, timeout_s=timeout_s,
                           nbytes=est, compiled=False, relocatable=False)

    def submit_predict(self, model, tables=None, *,
                       loader: Optional[Callable[[], Any]] = None,
                       priority: int = 0,
                       timeout_s: Optional[float] = None,
                       nbytes: Optional[int] = None) -> QueryTicket:
        """Serve an ML servable (``ml/serve.ServableModel`` or its
        registered name) through the ordinary pipeline: the predict query
        function runs ``plan → features → predict`` as ONE compiled
        request (one CUDA graph on the card), so admission, coalescing,
        capture/replay and device failover apply exactly as they do to
        queries.  The result is a one-column FLOAT32 prediction Table,
        bit-identical to ``ServableModel.predict_table``."""
        from ..ml import serve as mlserve
        sv = mlserve.resolve(model)
        if metrics.recording():
            metrics.count("ml.predict.submitted")
        flight.record("ml.predict.submit", model=sv.name)
        return self.submit(f"predict:{sv.name}", sv.qfn, tables,
                           loader=loader, priority=priority,
                           timeout_s=timeout_s, nbytes=nbytes)

    def submit_sql(self, text: str, tables=None, *, schemas,
                   params: Optional[dict] = None,
                   loader: Optional[Callable[[], Any]] = None,
                   priority: int = 0,
                   timeout_s: Optional[float] = None,
                   nbytes: Optional[int] = None) -> QueryTicket:
        """Serve a SQL query (``sql/``) through the ordinary pipeline.

        The text is parsed, bound against ``schemas`` (table → column
        names), rule-optimized, and lowered to the same ``qfn`` shape a
        hand-built plan tree compiles to — then submitted under the
        plan's STRUCTURAL FINGERPRINT as the request name, so a SQL-born
        query and an equivalently-shaped hand-built tree share one
        plan-cache entry and coalesce into one launch.  Warm repeats
        are amortized-free: the SQL memo (``SRJT_SQL_CACHE``) skips
        parse+bind+optimize, the per-scheduler qfn memo returns the same
        callable, and the plan cache returns the compiled program.
        Malformed SQL raises :class:`~..sql.SqlError` (with a source
        caret) at submit time and records a ``sql_parse_error``
        incident — nothing is enqueued."""
        from .. import sql as sql_fe
        from ..plan import ir as plan_ir
        tree = sql_fe.sql_to_plan(text, schemas, params)  # SqlError here
        fp = plan_ir.fingerprint(tree)
        key = (fp, tuple(sorted((t, tuple(c)) for t, c in schemas.items())))
        with self._sql_lock:
            qfn = self._sql_qfns.get(key)
            if qfn is not None:
                self._sql_qfns.move_to_end(key)
        if qfn is None:
            from ..plan import lower as plan_lower
            qfn = plan_lower.compile_plan(tree, schemas)
            with self._sql_lock:
                qfn = self._sql_qfns.setdefault(key, qfn)
                while len(self._sql_qfns) > 256:
                    self._sql_qfns.popitem(last=False)
        if metrics.recording():
            metrics.count("sql.submitted")
        flight.record("sql.submit", fingerprint=fp, chars=len(text))
        return self.submit(fp, qfn, tables, loader=loader,
                           priority=priority, timeout_s=timeout_s,
                           nbytes=nbytes)

    # -- lifecycle -----------------------------------------------------------

    def shutdown(self, wait: bool = True) -> None:
        """Stop accepting work; queued-but-unstarted requests resolve
        with :class:`ExecShutdown`.  ``wait`` joins the workers (each
        finishes its in-flight request first)."""
        with self._cv:
            if self._closed:
                return
            self._closed = True
            pending = [r for _, _, r in self._heap]
            self._heap.clear()
            self._cv.notify_all()
        for req in pending:
            flight.record("exec.resolve", rid=req.rid, outcome="shutdown")
            req.ticket._resolve(exc=ExecShutdown(
                f"scheduler shut down before {req.name!r} started"))
        self._probe_stop.set()
        for rep in self.replicas:
            rep.admission.close()
        if self.prefetcher is not None:
            self.prefetcher.close()
        if wait:
            for t in self._threads:
                t.join(timeout=30)
            if self._probe_thread is not None:
                self._probe_thread.join(timeout=5)
            if self._warmup_thread is not None:
                self._warmup_thread.join(timeout=5)
            # the batch graphs the workers left to capture in background
            C.wait_batch_captures()
        for probe in ("scheduler.queue_depth", "scheduler.inflight_bytes",
                      "scheduler.plan_cache", "scheduler.slo",
                      "scheduler.replicas"):
            flight.unregister_probe(probe)

    def __enter__(self) -> "QueryScheduler":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown()

    # -- worker loop ---------------------------------------------------------

    def _worker(self, rep: Replica) -> None:
        while True:
            req = None
            batch = None
            with self._cv:
                if not self._heap and not self._closed:
                    with metrics.span("exec.wait"):
                        while not self._heap and not self._closed:
                            self._cv.wait()
                if not self._heap:
                    return              # closed and drained
                if not rep.serving():
                    # parked: a quarantined/probation/ejected replica's
                    # workers pull nothing — work flows to the healthy
                    # replicas' workers instead.  Timed wait so recovery
                    # (and close) edges are observed even without a
                    # notify.
                    with metrics.span("exec.wait"):
                        self._cv.wait(timeout=0.05)
                else:
                    _, _, req = heapq.heappop(self._heap)
                    req.t_gather = time.monotonic()
                    batch = [req]
                    if req.ckey is not None:
                        self._gather_locked(req.ckey, batch)
            if req is None:
                continue
            flight.record("exec.dequeue", rid=req.rid, device=rep.name)
            if req.ckey is not None:
                self._coalesce_wait(req.ckey, batch)
            if len(batch) == 1:
                self._serve(req, rep)
            else:
                self._serve_batch(batch, rep)

    def _aot_warmup(self, top_n: int) -> None:
        """Background pre-hydration of the ``top_n`` costliest artifacts
        in the store's warm-up manifest (``SRJT_AOT_WARMUP``).  Advisory:
        any failure is swallowed — warm-up must never take serving down."""
        try:
            store = artifacts.get_store()
            if store is None:
                return
            n = store.preload(top_n)
            flight.record("exec.aot.warmup", loaded=n, top_n=top_n)
            if n and metrics.recording():
                metrics.count("exec.aot.warmed", n)
        except Exception:
            pass

    # -- fault lifecycle: relocation + recovery probe ------------------------

    def _variant(self, rep: Replica, degrade: bool) -> str:
        """Plan-cache variant key: ambient modes (degraded sort engine)
        composed with the serving device — replicas must never share a
        traced program's captured buffers."""
        parts = []
        if degrade:
            parts.append("sorted")
        if self.n_devices > 1:
            parts.append(f"d{rep.index}")
        return "@".join(parts)

    def _relocate(self, req: "_Request", tables, rep: Replica) -> bool:
        """Fail a dying replica's request OVER instead of failing it:
        re-enqueue (original submission order, so relocated requests stay
        ahead of newer arrivals) for a healthy — or recoverable — replica
        to pick up.  Re-admission naturally charges the target device's
        ledger.  Returns False when the request must fail instead."""
        if not req.relocatable or req.relocations >= self.relocate_max:
            return False
        if req.deadline is not None and time.monotonic() > req.deadline:
            return False
        targets = [r for r in self.replicas if r is not rep
                   and (r.serving() or (self.recovery and r.recoverable()))]
        if not targets and not (self.recovery and rep.recoverable()):
            return False
        req.relocations += 1
        req.ticket.relocations = req.relocations
        if tables is not None:
            # carry the already-loaded working set: the target replica
            # re-places it from the SOURCE buffers (identity cache), so
            # nothing reloads and results stay bit-identical
            req.tables = tables
            req.loader = None
        with self._cv:
            if self._closed:
                return False
            heapq.heappush(self._heap, (req.priority, req.seq, req))
            self._cv.notify_all()
        if metrics.recording():
            metrics.count("exec.failover.relocated")
        flight.incident("failover", request_id=req.rid, query=req.name,
                        device=rep.name, relocations=req.relocations,
                        targets=[r.name for r in targets])
        return True

    def _on_quarantine(self, rep: Replica) -> None:
        """A fatal fault just quarantined ``rep`` (or a submit hit the
        already-quarantined executor): arm its recovery probe, or — when
        nothing can ever recover — drain the queue so no request hangs
        behind a permanently dead pool."""
        if self.recovery and rep.recoverable():
            with self._cv:
                if rep.resilient.quarantined and not rep.probe_armed:
                    rep.probe_armed = True
                    rep.schedule_probe(self.probe_base_s, self.probe_max_s,
                                       self._probe_rng)
        self._drain_if_dead()

    def _drain_if_dead(self) -> None:
        """When NO replica can ever serve again, resolve every queued
        request with ``DeviceQuarantined`` — queued work must fail fast,
        not hang until its deadline behind permanently parked workers."""
        if any(r.recoverable() if self.recovery else r.serving()
               for r in self.replicas):
            return
        with self._cv:
            dead = [r for _, _, r in self._heap]
            self._heap.clear()
            self._cv.notify_all()
        for req in dead:
            if self.prefetcher is not None and req.loader is not None:
                self.prefetcher.discard((req.name, req.seq))
            self._resolve_fail(
                req, DeviceQuarantined("every replica is quarantined"),
                "queue", incident_kind="quarantine")

    def _recovery_loop(self) -> None:
        while not self._probe_stop.wait(0.02):
            now = time.monotonic()
            for rep in self.replicas:
                with self._cv:
                    due = (rep.probe_armed and not rep.ejected
                           and rep.resilient.quarantined
                           and now >= rep.next_probe_at)
                if due:
                    self._probe(rep)

    def _probe(self, rep: Replica) -> None:
        """One recovery attempt: probation + canary.  Success re-admits
        the replica; ``eject_after`` consecutive failures eject it."""
        rep.resilient.recover()
        flight.record("exec.failover.probe", device=rep.name,
                      streak=rep.fail_streak)
        try:
            rep.canary()
        except BaseException as e:
            # still faulting (or the canary miscompared — treat a wrong
            # answer exactly like a fault: the device cannot be trusted)
            rep.resilient.fail_probation()
            streak = rep.note_probe_failed()
            if metrics.recording():
                metrics.count("exec.failover.probe_failed")
            flight.record("exec.failover.probe_failed", device=rep.name,
                          streak=streak, error=type(e).__name__)
            if streak >= self.eject_after:
                rep.eject()
                with self._cv:
                    rep.probe_armed = False
                    self._cv.notify_all()
                self._drain_if_dead()
            else:
                with self._cv:
                    rep.schedule_probe(self.probe_base_s, self.probe_max_s,
                                       self._probe_rng)
            return
        rep.note_probe_ok()
        with self._cv:
            rep.probe_armed = False
            self._cv.notify_all()       # unpark this replica's workers
        if metrics.recording():
            metrics.count("exec.failover.recovered")
        flight.incident("recovery", device=rep.name, canary="ok",
                        recovery_count=rep.resilient.recovery_count)

    # -- coalescing ----------------------------------------------------------

    def _gather_locked(self, ckey, batch: list) -> None:
        """Pull every queued request with coalesce key ``ckey`` out of the
        heap into ``batch`` (up to ``max_batch``).  Caller holds the CV
        lock."""
        room = self.max_batch - len(batch)
        if room <= 0 or not self._heap:
            return
        keep, take = [], []
        for item in self._heap:
            if room > 0 and item[2].ckey == ckey:
                take.append(item[2])
                room -= 1
            else:
                keep.append(item)
        if take:
            self._heap[:] = keep
            heapq.heapify(self._heap)
            take.sort(key=lambda r: (r.priority, r.seq))
            now = time.monotonic()
            for r in take:
                r.t_gather = now
            batch.extend(take)

    def _coalesce_wait(self, ckey, batch: list) -> None:
        """Hold a short window for more same-plan arrivals.  The window is
        bounded by ``coalesce_ms`` AND by every gathered request's
        deadline — coalescing must never be the thing that kills a
        servable request."""
        t0 = time.monotonic()
        t_end = t0 + self.coalesce_ms / 1e3

        def _bound(reqs):
            nonlocal t_end
            for r in reqs:
                if r.deadline is not None:
                    t_end = min(t_end, r.deadline)
        _bound(batch)
        with metrics.span("exec.coalesce", rid=batch[0].rid):
            while len(batch) < self.max_batch and not self._closed:
                now = time.monotonic()
                if now >= t_end:
                    break
                with self._cv:
                    self._cv.wait(timeout=t_end - now)
                    n0 = len(batch)
                    self._gather_locked(ckey, batch)
                _bound(batch[n0:])
            metrics.annotate(size=len(batch))
        if len(batch) > 1:
            flight.record("exec.coalesce", rid=batch[0].rid,
                          batch=[r.rid for r in batch],
                          wait_ms=round((time.monotonic() - t0) * 1e3, 3))

    # -- resolution (tracing + SLO fan-in) -----------------------------------

    def _stage_obs(self, tk: "QueryTicket", stage: str,
                   seconds: float) -> None:
        """Record one stage's attribution: ticket timing + histogram."""
        tk.timings[f"{stage}_s"] = seconds
        if metrics.recording():
            metrics.observe(f"exec.stage.{stage}_ms", seconds * 1e3)

    def _resolve_ok(self, req: "_Request", result, *,
                    degraded: bool = False, deferred: bool = False,
                    relocated: bool = False) -> None:
        with metrics.span("exec.resolve", rid=req.rid):
            e2e = req.ticket.timings.get(
                "e2e_s", time.monotonic() - req.t_submit)
            flight.record("exec.resolve", rid=req.rid, outcome="ok",
                          e2e_ms=round(e2e * 1e3, 3), degraded=degraded,
                          device=req.ticket.device,
                          relocations=req.relocations)
            self.slo.observe(req.name, e2e * 1e3, outcome="ok",
                             degraded=degraded, deferred=deferred,
                             relocated=relocated, request_id=req.rid)
            req.ticket._resolve(result=result)

    def _resolve_fail(self, req: "_Request", exc: BaseException,
                      stage: str, *, outcome: str = "error",
                      incident_kind: Optional[str] = None,
                      batch: Optional[list] = None) -> None:
        """Resolve a request with a typed error, recording the outcome in
        the flight ring and (for incident-class failures) dumping the
        black-box snapshot that carries this rid's whole lifecycle."""
        with metrics.span("exec.resolve", rid=req.rid):
            e2e = time.monotonic() - req.t_submit
            req.ticket.timings.setdefault("e2e_s", e2e)
            flight.record("exec.resolve", rid=req.rid, outcome=outcome,
                          stage=stage, error=type(exc).__name__,
                          e2e_ms=round(e2e * 1e3, 3))
            if incident_kind is not None:
                flight.incident(incident_kind, request_id=req.rid,
                                batch=batch, stage=stage, error=repr(exc),
                                query=req.name, e2e_ms=round(e2e * 1e3, 3))
            self.slo.observe(req.name, e2e * 1e3, outcome=outcome,
                             request_id=req.rid)
            req.ticket._resolve(exc=exc)

    def _split_by_cap(self, reqs: list) -> list:
        """Greedily pack ``reqs`` into sub-batches whose combined unique
        input bytes fit the in-flight cap.  Shared buffers count once per
        sub-batch (the estimate is the batch's true working set, not
        N× it); a request that alone exceeds the cap stays a singleton
        and takes the ordinary degraded-admission path."""
        cap = self.admission.cap
        if cap is None:
            return [(reqs, 0)]
        subs: list = []
        cur, seen, total = [], set(), 0
        for r in reqs:
            est = r.nbytes if r.nbytes is not None \
                else request_bytes(r.tables, seen=seen)
            if cur and total + est > cap:
                subs.append((cur, total))
                cur, seen, total = [], set(), 0
                est = r.nbytes if r.nbytes is not None \
                    else request_bytes(r.tables, seen=seen)
            cur.append(r)
            total += est
        subs.append((cur, total))
        if len(subs) > 1 and metrics.recording():
            metrics.count("exec.batch.split", len(subs) - 1)
        return subs

    def _serve_batch(self, batch: list, rep: Replica) -> None:
        """Serve a coalesced same-plan batch: per-request deadline sweep,
        one admission charge per cap-fitting sub-batch, one program
        launch through ``PlanCache.run_batched``."""
        now = time.monotonic()
        rids = [r.rid for r in batch]
        live = []
        for r in batch:
            qw = now - r.t_submit
            r.ticket.timings["queue_wait_s"] = qw
            t_gather = r.t_gather if r.t_gather is not None else now
            self._stage_obs(r.ticket, "queue", t_gather - r.t_submit)
            self._stage_obs(r.ticket, "coalesce", now - t_gather)
            if r.deadline is not None and now > r.deadline:
                if metrics.recording():
                    metrics.count("exec.deadline.queue")
                if self.prefetcher is not None and r.loader is not None:
                    self.prefetcher.discard((r.name, r.seq))
                self._resolve_fail(
                    r, ExecDeadlineExceeded(r.name, "queue", qw),
                    "queue", outcome="deadline", incident_kind="deadline",
                    batch=rids)
            else:
                live.append(r)
        for sub, est in self._split_by_cap(live):
            if len(sub) == 1:
                self._serve(sub[0], rep)
            elif sub:
                self._execute_batch(sub, est, rep)

    def _execute_batch(self, batch: list, est: int, rep: Replica) -> None:
        name = batch[0].name
        rids = [r.rid for r in batch]
        for r in batch:
            r.ticket.batch_rids = rids
        deadlines = [r.deadline for r in batch if r.deadline is not None]
        members = ",".join(rids)
        try:
            t_adm = time.monotonic()
            with metrics.span("exec.admission", rids=members):
                grant = rep.admission.admit(
                    est, name=f"{name}[x{len(batch)}]",
                    deadline=min(deadlines) if deadlines else None)
            adm_wait = time.monotonic() - t_adm
            for r in batch:
                r.ticket.timings["admission_wait_s"] = adm_wait
                self._stage_obs(r.ticket, "admission", adm_wait)
        except ExecDeadlineExceeded:
            # only the earliest deadline is binding: resolve the expired
            # members, serve the survivors individually (each re-admits
            # under its own deadline)
            now = time.monotonic()
            for r in batch:
                if r.deadline is not None and now > r.deadline:
                    if metrics.recording():
                        metrics.count("exec.admission.deadline")
                    self._resolve_fail(
                        r, ExecDeadlineExceeded(
                            r.name, "admission", now - r.t_submit),
                        "admission", outcome="deadline",
                        incident_kind="deadline", batch=rids)
                else:
                    self._serve(r, rep)
            return
        except ExecError as e:
            for r in batch:
                self._resolve_fail(r, e, "admission")
            return
        except BaseException as e:
            if metrics.recording():
                metrics.count("exec.failed")
            for r in batch:
                self._resolve_fail(r, e, "admission",
                                   incident_kind="request_failed",
                                   batch=rids)
            return
        if grant.degrade:
            # a multi-request sub-batch always fits the cap by
            # construction; defensive fallback only
            grant.release()
            for r in batch:
                self._serve(r, rep)
            return
        flight.record("exec.batch.launch", rid=batch[0].rid, batch=rids,
                      size=len(batch), est_bytes=est, device=rep.name)
        t0 = time.monotonic()
        retries0 = rep.resilient.retry_count
        variant = self._variant(rep, False)
        rep.note_active(len(batch))
        try:
            with grant, structured_log.bound(batch_rids=members):
                scope = mbudget.query_budget(
                    name, batched=len(batch),
                    device=rep.name if self.n_devices > 1 else None) \
                    if mbudget.enabled() \
                    else metrics.span(f"query:{name}", batched=len(batch))
                with scope, metrics.span("batch", size=len(batch),
                                         members=members), \
                        rep.scope(pin_device=self.n_devices > 1):
                    if self.n_devices > 1:
                        with C.device_work():
                            member_tables = [rep.place(r.tables)
                                             for r in batch]
                    else:
                        member_tables = [r.tables for r in batch]
                    marks = {}

                    def _run():
                        with metrics.span("exec.dispatch", rids=members):
                            finj.get_injector().check("exec.dispatch")
                            outs = self.plans.run_batched(
                                name, batch[0].qfn, member_tables,
                                variant=variant)
                        marks["dispatched"] = time.monotonic()
                        # a device fault raises here, into the executor
                        with metrics.span("exec.ready", rids=members):
                            rep.synchronize()
                        return outs
                    outs = rep.resilient.submit(_run)
                    t_disp = marks["dispatched"]
            t_done = time.monotonic()
            dt = t_done - t0
            flight.record("exec.batch.ready", rid=batch[0].rid,
                          batch=rids, exec_ms=round(dt * 1e3, 3))
            if metrics.recording():
                metrics.observe("exec.batch.size", len(batch))
                retried = rep.resilient.retry_count - retries0
                if retried:
                    metrics.count("exec.retries", retried)
            rep.note_completed(len(batch))
            for r, out in zip(batch, outs):
                r.ticket.timings["exec_s"] = dt
                r.ticket.timings["e2e_s"] = t_done - r.t_submit
                r.ticket.device = rep.name
                self._stage_obs(r.ticket, "dispatch", t_disp - t0)
                self._stage_obs(r.ticket, "ready", t_done - t_disp)
                if metrics.recording():
                    metrics.observe("exec.e2e_ms",
                                    (t_done - r.t_submit) * 1e3)
                    metrics.count("exec.completed")
                    metrics.count("exec.device."
                                  + rep.name.replace(":", "")
                                  + ".completed")
                self._resolve_ok(r, out, deferred=grant.deferred,
                                 relocated=r.relocations > 0)
        except DeviceQuarantined as e:
            self._on_quarantine(rep)
            for r in batch:
                if self._relocate(r, r.tables, rep):
                    continue
                if metrics.recording():
                    metrics.count("exec.quarantined")
                self._resolve_fail(r, e, "execute",
                                   incident_kind="quarantine", batch=rids)
        except BaseException as e:
            if metrics.recording():
                metrics.count("exec.failed")
            for r in batch:
                self._resolve_fail(r, e, "execute",
                                   incident_kind="request_failed",
                                   batch=rids)
        finally:
            rep.note_active(-len(batch))

    def _serve(self, req: _Request, rep: Replica) -> None:
        tk = req.ticket
        t_dq = time.monotonic()
        queue_wait = t_dq - req.t_submit
        # a batch's sweep records these first
        tk.timings.setdefault("queue_wait_s", queue_wait)
        if "queue_s" not in tk.timings:
            t_gather = req.t_gather if req.t_gather is not None else t_dq
            self._stage_obs(tk, "queue", t_gather - req.t_submit)
            if t_dq > t_gather:     # held through a coalesce window
                self._stage_obs(tk, "coalesce", t_dq - t_gather)
        if req.deadline is not None and t_dq > req.deadline:
            if metrics.recording():
                metrics.count("exec.deadline.queue")
            if self.prefetcher is not None and req.loader is not None:
                # a dead request's staged tables must not occupy a slot
                self.prefetcher.discard((req.name, req.seq))
            self._resolve_fail(
                req, ExecDeadlineExceeded(req.name, "queue", queue_wait),
                "queue", outcome="deadline", incident_kind="deadline",
                batch=tk.batch_rids)
            return
        try:
            tables = req.tables
            if tables is None:
                if self.prefetcher is not None:
                    tables = self.prefetcher.take((req.name, req.seq),
                                                  req.loader)
                else:
                    with C.device_work():
                        tables = req.loader()
            est = req.nbytes if req.nbytes is not None \
                else request_bytes(tables)
            t_adm = time.monotonic()
            with metrics.span("exec.admission", rid=req.rid):
                grant = rep.admission.admit(est, name=req.rid or req.name,
                                            deadline=req.deadline)
            adm_wait = time.monotonic() - t_adm
            tk.timings["admission_wait_s"] = adm_wait
            self._stage_obs(tk, "admission", adm_wait)
        except ExecDeadlineExceeded as e:
            self._resolve_fail(req, e, "admission", outcome="deadline",
                               incident_kind="deadline",
                               batch=tk.batch_rids)
            return
        except ExecError as e:
            self._resolve_fail(req, e, "admission")
            return
        except BaseException as e:
            if metrics.recording():
                metrics.count("exec.failed")
            self._resolve_fail(req, e, "admission",
                               incident_kind="request_failed")
            return
        tk.degraded = grant.degrade
        t0 = time.monotonic()
        retries0 = rep.resilient.retry_count
        variant = self._variant(rep, grant.degrade)
        rep.note_active()
        try:
            with grant, structured_log.bound(request_id=req.rid):
                # degraded admission: the dense engine's O(key-range)
                # lookup table is exactly the allocation that does not
                # fit — route this request's joins to sort-probe (bit-
                # identical results, O(n) memory)
                if grant.degrade:
                    from ..ops import join_plan
                    ctx = join_plan.force_engine("sorted")
                else:
                    ctx = contextlib.nullcontext()
                # the full query_budget scope opens a query_span with
                # live-array HBM censuses — worth it only when the arena
                # is actually accounting; otherwise a plain span keeps
                # per-request overhead off the serving hot path
                scope = mbudget.query_budget(
                    req.name, queue_wait_ms=round(queue_wait * 1e3, 3),
                    degraded=grant.degrade,
                    device=rep.name if self.n_devices > 1 else None) \
                    if mbudget.enabled() \
                    else metrics.span(f"query:{req.name}",
                                      degraded=grant.degrade)
                with ctx, scope, \
                        rep.scope(pin_device=self.n_devices > 1):
                    # replicate the working set onto the serving device
                    # (identity-cached; single-device serves in place)
                    if self.n_devices > 1:
                        with C.device_work():
                            run_tables = rep.place(tables)
                    else:
                        run_tables = tables
                    marks = {}

                    def _run():
                        with metrics.span("exec.dispatch", rid=req.rid):
                            finj.get_injector().check("exec.dispatch")
                            if req.compiled:
                                # degraded/per-device plans cache under
                                # their own variant: a dense-captured tape
                                # misaligns under the forced sorted
                                # engine, and replicas never share
                                # captured buffers
                                out = self.plans.run(
                                    req.name, req.qfn, run_tables,
                                    variant=variant)
                            else:
                                # lazy columns are forced here, inside
                                # the budget scope
                                with C.device_work():
                                    out = C._materialized(
                                        req.qfn(run_tables))
                        marks["dispatched"] = time.monotonic()
                        # a response is delivered, not launched: the
                        # stream is synchronized inside the executor, so
                        # that an asynchronous device fault raises into
                        # it instead of resolving the ticket
                        with metrics.span("exec.ready", rid=req.rid):
                            rep.synchronize()
                        return out
                    result = rep.resilient.submit(_run)
                    t_disp = marks["dispatched"]
            t_done = time.monotonic()
            tk.timings["exec_s"] = t_done - t0
            tk.timings["e2e_s"] = t_done - req.t_submit
            tk.device = rep.name
            self._stage_obs(tk, "dispatch", t_disp - t0)
            self._stage_obs(tk, "ready", t_done - t_disp)
            if metrics.recording():
                metrics.observe("exec.e2e_ms", tk.timings["e2e_s"] * 1e3)
                metrics.count("exec.completed")
                metrics.count("exec.device." + rep.name.replace(":", "")
                              + ".completed")
                retried = rep.resilient.retry_count - retries0
                if retried:
                    metrics.count("exec.retries", retried)
            rep.note_completed()
            self._resolve_ok(req, result, degraded=grant.degrade,
                             deferred=grant.deferred,
                             relocated=req.relocations > 0)
        except DeviceQuarantined as e:
            self._on_quarantine(rep)
            if not self._relocate(req, tables, rep):
                if metrics.recording():
                    metrics.count("exec.quarantined")
                self._resolve_fail(req, e, "execute",
                                   incident_kind="quarantine",
                                   batch=tk.batch_rids)
        except BaseException as e:
            if metrics.recording():
                metrics.count("exec.failed")
            self._resolve_fail(req, e, "execute",
                               incident_kind="request_failed",
                               batch=tk.batch_rids)
        finally:
            rep.note_active(-1)
