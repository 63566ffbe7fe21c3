"""Per-request device-memory admission for the serving runtime.

The port's copy of the JAX package's ``exec/admission.py``.

``memory.budget`` answers "can THIS allocation proceed right now" at each
allocation site; a concurrent server needs the question answered once per
REQUEST, before any of its allocations exist — otherwise four admitted
queries can each pass their first small charge and then collectively blow
the arena mid-flight, where nothing can be unwound (an admitted query
must complete; ``budget`` docstring).  This controller is that front
gate: a global in-flight byte ledger (``SRJT_EXEC_INFLIGHT_BYTES``)
composed with the per-query ``budget.query_budget`` scope the worker
enters after admission.

Degradation ladder (pressure NEVER fails a request that can be served):

1. **fits** — estimate ≤ free in-flight room: admit on the requested
   path (dense join engine, full working set).
2. **defer** — estimate > free room but ≤ the cap: wait for in-flight
   requests to drain, then admit (``exec.admission.deferred``).  Queue
   wait is the currency overload is paid in — same as Spark's task
   queue — not errors.
3. **degrade** — estimate > the whole cap, so no amount of draining
   admits it as-is: admit EXCLUSIVELY (wait until in-flight is zero,
   hold the full cap) and tell the worker to route joins to the
   sort-probe engine via ``ops.join_plan.force_engine("sorted")``
   (``exec.admission.degraded``).  The sorted engine allocates O(n)
   lanes instead of a dense O(key-range) lookup table and returns
   bit-identical rows — the engines are differentially tested — so the
   degraded request is slower, never wrong.

Deadlines bound stage 2/3 waits: a request whose deadline passes while
deferred raises :class:`~.errors.ExecDeadlineExceeded` instead of
occupying the gate forever.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

from ..analysis import sanitize
from ..memory import budget as mbudget
from ..utils import flight, knobs, metrics
from .errors import ExecDeadlineExceeded, ExecShutdown


def request_bytes(tables, seen: Optional[set] = None) -> int:
    """Byte estimate for one request's input working set: every payload
    tensor across the request's tables.  Inputs dominate the footprint's
    lower bound; op transients ride the per-site budget charges after
    admission.  A :class:`~..column.DictColumn` counts its codes, validity
    and dictionary (not the chars it would materialize); a
    :class:`~..column.LazyColumn` not yet forced counts nothing and is
    not forced.

    ``seen`` (a set of tensor ids) carries dedup state ACROSS calls: a
    coalesced batch charges each shared buffer once — N requests over the
    same resident tables cost the ledger one working set, not N — while
    distinct buffers accumulate, which is what the scheduler's greedy
    cap-split walks."""
    from ..column import Column, DictColumn, LazyColumn, Table
    total = 0
    if seen is None:
        seen = set()

    def add(a):
        nonlocal total
        if a is not None and id(a) not in seen:
            seen.add(id(a))
            total += int(a.nbytes)

    def col(c):
        if isinstance(c, LazyColumn):
            if not c.forced:
                return
            c = c._col
        if isinstance(c, DictColumn):
            add(c.codes)
            add(c.validity)
            col(c.dictionary)
            return
        add(c.data)
        add(c.offsets)
        add(c.validity)

    def walk(obj):
        if isinstance(obj, dict):
            for v in obj.values():
                walk(v)
        elif isinstance(obj, Table):
            for c in obj.columns:
                col(c)
        elif isinstance(obj, Column):
            col(obj)
        elif isinstance(obj, (list, tuple)):
            for v in obj:
                walk(v)

    walk(tables)
    return total


class AdmissionGrant:
    """One admitted request's hold on the in-flight ledger (context
    manager; exiting releases the bytes and wakes deferred waiters).
    ``degrade`` tells the worker to run under ``force_engine("sorted")``;
    ``deferred`` reports whether the request waited behind the ladder's
    stage-2 gate (per-request attribution for the SLO watchdog)."""

    __slots__ = ("nbytes", "degrade", "deferred", "_ctl", "_released")

    def __init__(self, ctl: "AdmissionController", nbytes: int,
                 degrade: bool, deferred: bool = False):
        self._ctl = ctl
        self.nbytes = nbytes
        self.degrade = degrade
        self.deferred = deferred
        self._released = False

    def __enter__(self) -> "AdmissionGrant":
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def release(self) -> None:
        if not self._released:
            self._released = True
            self._ctl._release(self.nbytes)


class AdmissionController:
    """The serving gate: bounded in-flight bytes with defer/degrade.

    ``device`` labels this gate's ledger with the replica device it
    fronts (multi-device scheduler: one controller per device, so
    ``SRJT_EXEC_INFLIGHT_BYTES`` is a per-device cap and failover
    re-admission charges the target device's ledger)."""

    def __init__(self, cap_bytes=None, device: Optional[str] = None):
        if cap_bytes is None:
            cap_bytes = knobs.get("SRJT_EXEC_INFLIGHT_BYTES")
        self.cap: Optional[int] = mbudget.parse_bytes(cap_bytes)
        self.device = device
        self._cv = threading.Condition(
            sanitize.tracked_lock("exec.admission.cv"))
        self._inflight = 0
        self._closed = False

    def inflight_bytes(self) -> int:
        with self._cv:
            return self._inflight

    def close(self) -> None:
        """Wake every deferred waiter with :class:`ExecShutdown`."""
        with self._cv:
            self._closed = True
            self._cv.notify_all()

    def admit(self, nbytes: int, *, name: str = "request",
              deadline: Optional[float] = None) -> AdmissionGrant:
        """Block until ``nbytes`` fits the in-flight cap (the ladder in
        the module docstring), then return the grant.  ``deadline`` is an
        absolute ``time.monotonic()`` instant bounding the wait."""
        n = max(int(nbytes), 0)
        cap = self.cap
        if cap is None:
            return AdmissionGrant(self, 0, False)
        degrade = n > cap
        hold = cap if degrade else n
        # degraded requests admit exclusively: they hold the entire cap,
        # so their true (over-cap) footprint never overlaps another
        # request's admitted bytes
        t0 = time.monotonic()
        deferred = False
        with self._cv:
            while self._inflight + hold > cap:
                if self._closed:
                    raise ExecShutdown("admission gate closed")
                if not deferred:
                    deferred = True
                    if metrics.recording():
                        metrics.count("exec.admission.deferred")
                    flight.record("exec.admission.defer", rid=name,
                                  nbytes=n, inflight=self._inflight,
                                  cap=cap, device=self.device)
                timeout = None
                if deadline is not None:
                    timeout = deadline - time.monotonic()
                    if timeout <= 0:
                        if metrics.recording():
                            metrics.count("exec.admission.deadline")
                        raise ExecDeadlineExceeded(
                            name, "admission", time.monotonic() - t0)
                self._cv.wait(timeout)
            self._inflight += hold
            if metrics.recording():
                metrics.gauge("exec.inflight_bytes", self._inflight)
                if self.device is not None:
                    metrics.gauge(
                        "exec.inflight_bytes."
                        + self.device.replace(":", ""), self._inflight)
        if degrade:
            if metrics.recording():
                metrics.count("exec.admission.degraded")
            flight.record("exec.admission.degrade", rid=name, nbytes=n,
                          cap=cap, device=self.device)
        return AdmissionGrant(self, hold, degrade, deferred)

    def _release(self, nbytes: int) -> None:
        with self._cv:
            self._inflight = max(self._inflight - int(nbytes), 0)
            if metrics.recording():
                metrics.gauge("exec.inflight_bytes", self._inflight)
                if self.device is not None:
                    metrics.gauge(
                        "exec.inflight_bytes."
                        + self.device.replace(":", ""), self._inflight)
            self._cv.notify_all()
