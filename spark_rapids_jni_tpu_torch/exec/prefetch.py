"""Double-buffered staging of queued requests' tables.

The port's copy of the JAX package's ``exec/prefetch.py``: while the
workers execute the current requests, one staging thread runs the NEXT
requests' loaders (the Parquet scan and its upload — the dominant cost of
a cold request), so by the time a worker dequeues a request its tables
are already on the card.

Every thread stays on the default CUDA stream, so a table scanned on the
staging thread is safe to read on a worker without a ``wait_stream``.
The loader runs under ``models.compiled.device_work`` (never during a
CUDA-graph capture).

``depth`` (``SRJT_EXEC_PREFETCH_DEPTH``, default 2) bounds how many
staged working sets exist at once — double buffering, not an unbounded
table heap.  Staged tables are registered with ``memory.spill`` under
the ``exec.prefetch`` tag, so under memory pressure the budget evicts the
*waiting* request's tables before anything a running request holds; on
``take`` the registration is dropped, and a spilled table is moved back
to the card first.

Slots are deadline-aware: ``stage`` records the request's deadline, and
a staged table whose request already exceeded it frees its slot instead
of occupying double-buffer capacity — swept when a new ``stage`` finds
the buffer full, and skipped by the staging loop before loading
(``exec.prefetch.deadline_evicted``).

Counters: ``exec.prefetch.{hit,miss,rejected,deadline_evicted,discarded}``;
each load's deltas of the staging counters (``parquet.stage.slab_bytes``,
``transfers``, ``overlap_ms``) annotate its span and an
``exec.prefetch.ingest`` flight event.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict, deque
from typing import Callable, Optional

from ..analysis import sanitize
from ..models import compiled as C
from ..utils import flight, knobs, metrics

# the staging tier's counters credited to each prefetch load (their
# deltas across the loader call, ``_loop``)
_INGEST_COUNTERS = ("parquet.stage.slab_bytes", "parquet.stage.transfers",
                    "parquet.stage.overlap_ms")

def _walk_tables(obj, fn) -> None:
    """``fn(table)`` for every Table in a loader result (a Table, or a
    dict/sequence of them)."""
    from ..column import Table
    if isinstance(obj, Table):
        fn(obj)
    elif isinstance(obj, dict):
        for v in obj.values():
            _walk_tables(v, fn)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            _walk_tables(v, fn)


def _register_staged(obj) -> None:
    """Spill-register every Table in a staged loader result
    (``register_table`` is idempotent per table object)."""
    from ..memory import spill as mspill
    _walk_tables(obj, lambda t: mspill.register_table(t, "exec.prefetch"))


def _unregister_staged(obj, restore: bool = False) -> None:
    """Drop the registrations; ``restore`` moves spilled tables back to
    the card (a take), else they are dropped as they are (a discard)."""
    from ..memory import spill as mspill
    _walk_tables(obj, lambda t: mspill.unregister_table(
        t, "exec.prefetch", restore=restore))


class Prefetcher:
    """One staging thread + a bounded slot map of loaded working sets."""

    def __init__(self, depth: Optional[int] = None):
        if depth is None:
            depth = knobs.get("SRJT_EXEC_PREFETCH_DEPTH")
        self.depth = max(int(depth), 1)
        self._cv = threading.Condition(
            sanitize.tracked_lock("exec.prefetch.cv"))
        self._slots: "OrderedDict[object, dict]" = OrderedDict()
        self._todo: deque = deque()
        self._closed = False
        self._thread = threading.Thread(
            target=self._loop, name="srjt-exec-prefetch", daemon=True)
        self._thread.start()

    def stage(self, key, loader: Callable[[], object],
              deadline: Optional[float] = None) -> bool:
        """Queue ``loader`` to run on the staging thread.  False (with
        ``exec.prefetch.rejected``) when the buffer is full or the key is
        already staged — the caller's ``take`` then loads inline, which
        is the correct degraded behavior, not an error.

        ``deadline`` is the request's absolute ``time.monotonic()``
        deadline: once it passes, the slot is reclaimable — a full buffer
        evicts expired slots before rejecting the newcomer."""
        with self._cv:
            if self._closed or key in self._slots:
                return False
            if len(self._slots) >= self.depth:
                self._evict_expired_locked()
            if len(self._slots) >= self.depth:
                if metrics.recording():
                    metrics.count("exec.prefetch.rejected")
                return False
            self._slots[key] = {"state": "queued", "done": threading.Event(),
                                "result": None, "exc": None, "loader": loader,
                                "deadline": deadline}
            self._todo.append(key)
            self._cv.notify_all()
        return True

    def _evict_expired_locked(self) -> None:
        """Free every slot whose request's deadline has passed (called
        with the lock held).  Loading slots stay — the staging thread
        owns them mid-flight; they are swept once done."""
        now = time.monotonic()
        for k, slot in list(self._slots.items()):
            dl = slot.get("deadline")
            if dl is None or now <= dl or slot["state"] == "loading":
                continue
            self._slots.pop(k)
            if slot["done"].is_set() and slot["exc"] is None:
                _unregister_staged(slot["result"])
            if metrics.recording():
                metrics.count("exec.prefetch.deadline_evicted")

    def take(self, key, loader: Optional[Callable[[], object]] = None):
        """The staged working set for ``key`` (blocks until staged), or
        ``loader()`` run inline on a miss.  Either way the result leaves
        the prefetch spill registrations behind — it is about to become a
        running plan's working set."""
        with self._cv:
            slot = self._slots.pop(key, None)
            # a still-"queued" slot hasn't been picked up by the staging
            # thread; popping it here makes the staging loop skip it, and
            # THIS thread loads inline — waiting on it would deadlock if
            # the loop saw the pop first and never ran the loader
            queued = slot is not None and slot["state"] == "queued"
        if slot is None or queued:
            if metrics.recording():
                metrics.count("exec.prefetch.miss")
            if loader is None and queued:
                loader = slot["loader"]
            if loader is None:
                raise KeyError(f"prefetch: {key!r} not staged, no loader")
            with C.device_work():
                return loader()
        slot["done"].wait()
        with self._cv:
            self._cv.notify_all()      # a slot freed; staging may resume
        if slot["exc"] is not None:
            raise slot["exc"]
        if metrics.recording():
            metrics.count("exec.prefetch.hit")
        result = slot["result"]
        with C.device_work():
            _unregister_staged(result, restore=True)
        return result

    def discard(self, key) -> None:
        """Drop a staged slot without delivering it (cancelled, expired,
        or failed-over request).  Every scheduler path that resolves a
        loader-backed request WITHOUT taking its tables must call this —
        an orphaned slot holds double-buffer capacity (and its spill
        registration) until deadline eviction, which a slot staged
        without a deadline never reaches."""
        with self._cv:
            slot = self._slots.pop(key, None)
            if slot is not None:
                self._cv.notify_all()   # a slot freed; staging may resume
        if slot is None:
            return
        if metrics.recording():
            metrics.count("exec.prefetch.discarded")
        if slot["done"].is_set() and slot["exc"] is None:
            _unregister_staged(slot["result"])

    def close(self) -> None:
        from .errors import ExecShutdown
        with self._cv:
            self._closed = True
            for slot in self._slots.values():
                if not slot["done"].is_set():
                    slot["exc"] = ExecShutdown("prefetcher closed")
                    slot["done"].set()
            self._slots.clear()
            self._todo.clear()
            self._cv.notify_all()
        self._thread.join(timeout=5)

    def _loop(self) -> None:
        while True:
            with self._cv:
                while not self._todo and not self._closed:
                    self._cv.wait()
                if self._closed:
                    return
                key = self._todo.popleft()
                slot = self._slots.get(key)
                if slot is not None and slot.get("deadline") is not None \
                        and time.monotonic() > slot["deadline"]:
                    # the request is already dead: don't spend the
                    # staging thread (or a slot) loading for it
                    self._slots.pop(key, None)
                    if metrics.recording():
                        metrics.count("exec.prefetch.deadline_evicted")
                    slot = None
                if slot is not None:
                    slot["state"] = "loading"
            if slot is None:           # taken inline or discarded
                continue
            try:
                with metrics.span("exec.prefetch.load", key=str(key)), \
                        C.device_work():
                    rec = metrics.recording()
                    # ingest attribution: the staging counters are
                    # process-wide, so their deltas across the load
                    # credit this prefetch (the JAX package's
                    # ``exec.prefetch.ingest``)
                    base = {k: metrics.counter_value(k)
                            for k in _INGEST_COUNTERS} if rec else {}
                    slot["result"] = slot["loader"]()
                    if rec:
                        delta = {k.rsplit(".", 1)[-1]:
                                 metrics.counter_value(k) - base[k]
                                 for k in _INGEST_COUNTERS}
                        if any(delta.values()):
                            metrics.annotate(**delta)
                            flight.record("exec.prefetch.ingest",
                                          key=str(key), **delta)
                _register_staged(slot["result"])
            except Exception as e:     # delivered to the taker
                slot["exc"] = e
                # black-box breadcrumb: the taker re-raises this on its
                # own thread, where the staging context is already gone
                flight.record("exec.prefetch.fail", key=str(key),
                              error=type(e).__name__)
            finally:
                slot["loader"] = None
                slot["done"].set()
