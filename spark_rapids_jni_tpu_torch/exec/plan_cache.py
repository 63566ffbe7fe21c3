"""Capacity-bound LRU of compiled query plans for the serving runtime.

The port's copy of the JAX package's ``exec/plan_cache.py``.
``models/compiled.py`` makes a query ONE CUDA-graph replay per execution,
after a capture run and a graph capture that cost far more than the
replay.  A server amortizes that only if compiled plans are REUSED across
requests: this cache keys plans on (query name, variant, input-table
fingerprint) so the steady serving loop is a cache hit straight into a
replay.

Key discipline (``models.compiled.plan_key``): the fingerprint covers
every payload tensor's identity (id + ``_version`` + dtype + shape),
with weakrefs guarding ids against recycling, so a hit presents the very
tensors the plan was captured from, in the same state.  The checked first
run (one read of the size vector validating the tape) backstops the
remaining edge, and a :class:`~..models.compiled.StaleTapeError` there
evicts and recompiles instead of surfacing to the client.

**Cross-request plan sharing** (``SRJT_EXEC_PLAN_SIZE_FP``, default on):
an identity miss consults a second index keyed on the SIZE fingerprint
(dtype + shape, no ids).  A hit there reuses the warm
:class:`~..models.compiled.CompiledQuery` — no capture run — for the new
tensors, provided the first replay runs the CHECKED path: the tape's
resolved sizes (join cardinalities, group counts) are data-determined, so
refreshed same-shape data must revalidate them
(``exec.plan_cache.revalidate``); a mismatch raises StaleTapeError and
recompiles, never returns wrong rows.

**Cross-request batching** (:meth:`PlanCache.run_batched`): K requests
that resolved to the same plan — requests over identical tensors share a
single replay and its result; requests over distinct same-shape tensors
stack through :meth:`~..models.compiled.CompiledQuery.run_vmapped`:
on the card one replay of a graph of K members rounded up to a power of
two (at most ``compiled.BATCH_MAX``; a width with no graph yet is
captured on a thread of its own while the requests replay in turn), on
the CPU K runs under the tape.

**Cold start from a persisted tape** (``SRJT_AOT_DIR``,
``exec/artifacts.py``): an identity + size miss consults the persistent
artifact store before capturing.  A hit rehydrates the plan from the
persisted capture tape — no eager capture run — and the entry starts
unverified, so the first run is CHECKED (it captures the graph, which
cannot be persisted) and a stale artifact degrades to a live recapture
whose write-back overwrites it.  Fresh captures write back with their
measured compile cost, which ranks the warm-up manifest.

Entries single-flight: two workers missing on the same key compile once
(the second waits on the first's build event — a duplicate capture would
waste the most expensive step the cache exists to amortize).

Knobs: ``SRJT_EXEC_PLAN_CACHE_CAP`` (entries, default 32),
``SRJT_EXEC_PLAN_SIZE_FP`` (size-fingerprint sharing, default on),
``SRJT_AOT_DIR`` (persistent artifact store; unset disables).
Counters: ``exec.plan_cache.{hit,miss,size_hit,aot_hit,revalidate,
evictions,stale,expired}``.  With metrics on, the fingerprints and the
lookup are a ``plan_cache.lookup`` span (``utils.metrics``, a profiler
range too); a miss's compile runs after it.
"""

from __future__ import annotations

import threading
import time
import weakref
from collections import OrderedDict
from typing import Callable, Optional

from ..analysis import sanitize
from ..models import compiled as C
from ..utils import knobs, metrics
from . import artifacts


class PlanCache:
    """LRU of :class:`~..models.compiled.CompiledQuery` keyed on
    (query name, table fingerprint), with a size-fingerprint side index
    for cross-request plan sharing."""

    def __init__(self, cap: Optional[int] = None,
                 share_by_size: Optional[bool] = None):
        if cap is None:
            cap = knobs.get("SRJT_EXEC_PLAN_CACHE_CAP")
        if share_by_size is None:
            share_by_size = knobs.get("SRJT_EXEC_PLAN_SIZE_FP")
        self.cap = max(int(cap), 1)
        self.share_by_size = bool(share_by_size)
        # RLock: weakref death callbacks can fire at GC points on a
        # thread already inside the cache
        self._mu = sanitize.tracked_rlock("exec.plan_cache")
        self._d: "OrderedDict[tuple, dict]" = OrderedDict()
        # size key → CompiledQuery, STRONG refs by design: the sharing
        # scenario is precisely "old buffers are gone, new same-shape
        # data arrived" — a weakref would die with the old entry and the
        # warm plan with it.  Bounded by the same cap, LRU.
        self._by_size: "OrderedDict[tuple, object]" = OrderedDict()
        self._building: dict[tuple, threading.Event] = {}

    def __len__(self) -> int:
        with self._mu:
            return len(self._d)

    def clear(self) -> None:
        with self._mu:
            self._d.clear()
            self._by_size.clear()

    def stats(self) -> dict:
        """Live occupancy + lifetime hit/miss counters (flight-recorder
        probe and ops-report surface)."""
        with self._mu:
            plans = {id(e["plan"]): e["plan"] for e in self._d.values()}
            plans.update((id(p), p) for p in self._by_size.values())
            occ = {"entries": len(self._d),
                   "size_index": len(self._by_size),
                   # the graphs' private inputs and pools, batch graphs
                   # included (``CompiledQuery.device_bytes``)
                   "device_bytes": sum(p.device_bytes()
                                       for p in plans.values()),
                   "cap": self.cap,
                   "share_by_size": self.share_by_size,
                   "building": len(self._building)}
        for c in ("hit", "miss", "size_hit", "aot_hit", "revalidate",
                  "evictions", "stale", "expired"):
            occ[c] = metrics.counter_value(f"exec.plan_cache.{c}")
        return occ

    def _evict(self, key, counter: Optional[str]) -> None:
        with self._mu:
            entry = self._d.pop(key, None)
        # weakref death callbacks fire at GC points — including during
        # interpreter shutdown, after the metrics module's globals are
        # torn down.  The eviction itself already happened above; only
        # the counter is best-effort.
        try:
            if entry is not None and counter and metrics.recording():
                metrics.count(counter)
        except TypeError:
            pass

    def _lookup(self, key) -> Optional[dict]:
        """The live entry for ``key`` (LRU-touched), or None.  A dead
        weakref means a keyed buffer was collected and its id may be
        recycled — the entry is unusable and drops here."""
        with self._mu:
            entry = self._d.get(key)
            if entry is None:
                return None
            if any(r() is None for r in entry["refs"]):
                self._d.pop(key, None)
                if metrics.recording():
                    metrics.count("exec.plan_cache.expired")
                return None
            self._d.move_to_end(key)
            return entry

    def get_or_compile(self, name: str, qfn: Callable, tables,
                       variant: str = "", *,
                       _skip_aot: bool = False) -> dict:
        """The cache entry for (``name``, ``variant``, fingerprint of
        ``tables``), compiling on miss (single-flight per key).

        An identity miss first tries the size-fingerprint index: a warm
        plan for the same (name, variant, shape signature) is adopted
        without recapturing (``exec.plan_cache.size_hit``); the adopted
        entry starts unverified, so its first run takes the checked path
        and revalidates the tape against the new buffers.

        ``variant`` keys any ambient mode that changes the captured
        plan — e.g. the scheduler passes ``"sorted"`` for degraded-
        admission requests running under ``force_engine``: a tape
        recorded on the dense join path would misalign when replayed
        with the engine forced, so the two variants must never share an
        entry.  An adaptive qfn (``plan/adaptive.compile_adaptive_plan``)
        carries its mode in ``qfn.aqe_variant``, folded into the variant
        here: static and adaptive compiles of one tree never share (or
        thrash) an entry."""
        aqe = getattr(qfn, "aqe_variant", "")
        if aqe:
            variant = f"{variant}+{aqe}" if variant else aqe
        with metrics.span("plan_cache.lookup", query=name):
            fp, arrays = C.plan_key(tables)
            key = (name, variant, fp)
            skey = None
            if self.share_by_size:
                sfp, _ = C.plan_key(tables, by_size=True)
                skey = (name, variant, sfp)
            while True:
                with self._mu:
                    entry = self._lookup(key)
                    if entry is not None:
                        if metrics.recording():
                            metrics.count("exec.plan_cache.hit")
                            metrics.ledger_add(
                                getattr(qfn, "plan_fingerprint", None)
                                or name, cache_hits=1)
                        return entry
                    ev = self._building.get(key)
                    if ev is None:
                        ev = self._building[key] = threading.Event()
                        break
                ev.wait()
        try:
            shared = None
            if skey is not None:
                with self._mu:
                    shared = self._by_size.get(skey)
                    if shared is not None:
                        self._by_size.move_to_end(skey)
            if shared is not None:
                if metrics.recording():
                    metrics.count("exec.plan_cache.size_hit")
                    metrics.ledger_add(
                        getattr(qfn, "plan_fingerprint", None) or name,
                        cache_size_hits=1)
                plan, expected = shared, None
            else:
                lkey = getattr(qfn, "plan_fingerprint", None) or name
                if metrics.recording():
                    metrics.count("exec.plan_cache.miss")
                    metrics.ledger_add(lkey, cache_misses=1)
                store = artifacts.get_store()
                geom = artifacts.geometry_key(tables) \
                    if store is not None else None
                plan = expected = None
                if store is not None and geom is not None \
                        and not _skip_aot:
                    tape = store.lookup(lkey, variant, geom)
                    if tape is not None:
                        # cold start without the eager capture run: the
                        # entry stays unverified so the first run is
                        # CHECKED and a stale artifact degrades to a
                        # recapture
                        plan = C.rehydrate_query(qfn, tape)
                        if metrics.recording():
                            metrics.count("exec.plan_cache.aot_hit")
                if plan is None:
                    t0 = time.perf_counter()
                    plan = C.compile_query(qfn, tables)
                    cost_ms = (time.perf_counter() - t0) * 1e3
                    # the capture run's result IS this request's answer:
                    # hand it out once instead of re-executing, and drop
                    # the plan's own copy — cached entries must not pin
                    # result-sized memory
                    expected = plan.expected
                    plan.expected = None
                    if store is not None and geom is not None:
                        store.put(lkey, variant, geom, plan.tape,
                                  name=name, cost_ms=cost_ms)
            try:
                refs = tuple(
                    weakref.ref(a, lambda _, k=key: self._evict(
                        k, "exec.plan_cache.expired"))
                    for a in arrays)
            except TypeError:
                refs = ()
            entry = {"plan": plan, "refs": refs, "verified": False,
                     "expected": expected, "key": key, "skey": skey,
                     "shared": shared is not None}
            with self._mu:
                self._d[key] = entry
                self._d.move_to_end(key)
                while len(self._d) > self.cap:
                    old = next(iter(self._d))
                    if old == key:
                        break
                    self._d.pop(old)
                    if metrics.recording():
                        metrics.count("exec.plan_cache.evictions")
                if skey is not None:
                    self._by_size[skey] = plan
                    self._by_size.move_to_end(skey)
                    while len(self._by_size) > self.cap:
                        self._by_size.popitem(last=False)
            return entry
        finally:
            with self._mu:
                self._building.pop(key, None)
            ev.set()

    def invalidate(self, entry: dict) -> None:
        """Drop ``entry``; a stale plan also loses its size-index slot so
        the next same-shape request recompiles instead of re-adopting it."""
        self._evict(entry["key"], None)
        skey = entry.get("skey")
        if skey is not None:
            with self._mu:
                if self._by_size.get(skey) is entry["plan"]:
                    del self._by_size[skey]

    def _run_entry(self, entry: dict, name: str, qfn: Callable, tables,
                   variant: str):
        """Execute ``tables`` through an already-looked-up ``entry`` —
        the tail of :meth:`run` after the cache lookup, shared with
        :meth:`run_batched` so batch members don't double-count hits."""
        expected = entry.pop("expected", None)
        if expected is not None:
            return expected
        plan = entry["plan"]
        if entry["verified"]:
            return plan.run_unchecked(tables)
        try:
            if entry.get("shared") and metrics.recording():
                # first replay of a size-fingerprint-adopted plan over
                # fresh buffers: the checked run below IS the tape
                # revalidation
                metrics.count("exec.plan_cache.revalidate")
            out = plan.run(tables)
            entry["verified"] = True
            return out
        except C.StaleTapeError:
            if metrics.recording():
                metrics.count("exec.plan_cache.stale")
            self.invalidate(entry)
            # the retry must NOT re-adopt a persisted artifact: the tape
            # that just failed validation is exactly what the store holds
            # for this key, so a lookup here would loop stale→rehydrate→
            # stale forever.  Force a live capture — its write-back
            # overwrites the stale artifact for the next process.
            fresh = self.get_or_compile(name, qfn, tables, variant,
                                        _skip_aot=True)
            return self._run_entry(fresh, name, qfn, tables, variant)

    def run(self, name: str, qfn: Callable, tables, variant: str = ""):
        """Execute ``qfn(tables)`` through the cache.

        Miss → compile; the capture run's own (eager) result is
        returned, so a cold request executes the query once, not twice.
        Size-fingerprint hit → adopt the warm plan, checked first run
        revalidates the tape.  First identity hit → checked run (one
        read of the size vector validates the tape).  Later hits → one
        replay with no check (``run_unchecked``).  A stale tape evicts + recompiles —
        clients never see :class:`StaleTapeError`."""
        entry = self.get_or_compile(name, qfn, tables, variant)
        return self._run_entry(entry, name, qfn, tables, variant)

    def run_batched(self, name: str, qfn: Callable, tables_list,
                    variant: str = "") -> list:
        """Execute K coalesced same-plan requests as few device programs
        as possible; returns the K results in request order.

        Requests over IDENTICAL buffers (one identity fingerprint) share
        a single execution and its result — the common serving case,
        where every request reads the same resident tables.  Requests
        over distinct same-shape buffers are offered to the plan's
        ``run_vmapped`` with ``background=True`` (one launch of a batch
        graph; where it returns None, because its graph is still being
        captured on a thread of its own or the plan does not batch, each
        replays the one graph), provided their entries are warm and
        verified; cold or unverified members run individually (their
        first run is the capture / tape revalidation).

        The contract: integers, keys and validity are what serial
        execution gives, byte for byte; floats may differ from it within
        a relative ``compiled.PARITY_RTOL`` (float sums add by atomics on
        the card).  Parity is checked once a plan, on member 0 of its
        first batch, against a serial replay."""
        K = len(tables_list)
        results: list = [None] * K
        groups: "OrderedDict[tuple, list[int]]" = OrderedDict()
        with metrics.span("plan_cache.lookup", query=name):
            for i, t in enumerate(tables_list):
                fp, _ = C.plan_key(t)
                groups.setdefault(fp, []).append(i)

        def _fan(idxs, res):
            for i in idxs:
                results[i] = res
            # duplicate-identity members logically hit the cache too:
            # keep hit+miss+size_hit == requests served
            if len(idxs) > 1 and metrics.recording():
                metrics.count("exec.plan_cache.hit", len(idxs) - 1)

        reps = list(groups.items())
        if len(reps) == 1:
            _fan(reps[0][1], self.run(name, qfn,
                                      tables_list[reps[0][1][0]], variant))
            return results
        batchable: "OrderedDict[int, list]" = OrderedDict()
        for fp, idxs in reps:
            t = tables_list[idxs[0]]
            entry = self.get_or_compile(name, qfn, t, variant)
            if entry.get("expected") is not None or not entry["verified"]:
                # cold capture or first-replay revalidation: serial path
                _fan(idxs, self._run_entry(entry, name, qfn, t, variant))
                continue
            batchable.setdefault(id(entry["plan"]), []).append((entry, idxs))
        for _, items in batchable.items():
            plan = items[0][0]["plan"]
            outs = None
            if len(items) >= 2:
                outs = plan.run_vmapped(
                    [tables_list[idxs[0]] for _, idxs in items],
                    background=True)
            if outs is not None:
                for (entry, idxs), res in zip(items, outs):
                    _fan(idxs, res)
            else:
                for entry, idxs in items:
                    _fan(idxs, plan.run_unchecked(tables_list[idxs[0]]))
        return results
