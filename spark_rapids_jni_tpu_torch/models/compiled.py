"""Whole-query compilation: one CUDA graph per (query, data) plan.

The port's counterpart of the JAX package's ``models/compiled.py``.  An
eager query pays a host synchronisation at every size it resolves (a
filter's count, a join's pairs, a group count) and a launch per op, so a
short query on the card is mostly waiting.  Every such size goes through
``utils.syncs.scalar``, so a query is shape-deterministic given its
sizes:

1. **capture**: run the query eagerly once under ``syncs.capture``,
   recording each resolved size in order: the tape, and the result,
   :attr:`CompiledQuery.expected`;
2. **replay**: run it again under ``syncs.replay``, which hands out the
   tape's sizes instead of reading the device, inside
   ``torch.cuda.graph``: the whole query becomes one CUDA graph over
   private static copies of its input tensors, with no host
   synchronisation in it.  The values that arrived at each size are
   stacked into one size vector at the end of the graph.

:meth:`CompiledQuery.run` copies the caller's tensors into the static
inputs (skipping tensors copied already and unchanged since), replays the
graph, reads the size vector back (its one synchronisation) and raises
:class:`StaleTapeError` where it differs from the tape: the data's true
sizes changed, so the graph's buffers were sized wrongly.  Every op keeps
what it sizes or indexes by a tape value in bounds whatever that value is
(``utils.syncs``), so a stale replay computes harmless wrong values, never
a device fault.  The results are clones: a later replay never overwrites
a result the caller holds.  :meth:`CompiledQuery.run_unchecked` skips the
check.  The join planner's choices (dense or sorted engine, key packing)
are sizes on the tape too, so a change of engine is a stale tape.

On the CPU there is no graph: ``run`` and ``run_unchecked`` run the query
eagerly under the tape, and ``run`` holds the sizes it saw against the
tape afterwards.  There is no fallback on the card: a capture that fails
raises.

**Threads.**  A CUDA graph is captured in ``global`` mode, where any
other thread's launch, allocation or synchronisation breaks the capture.
:data:`DEVICE` is a readers-writer lock over the process's device work:
a graph capture holds it exclusively (and reads ``graph_pool_bytes``
inside it, so no other thread's allocations skew the reading), replays
and eager runs share it.  Every caller that touches the card beside
compiled queries (the serving runtime's workers, prefetcher and canary)
enters :func:`device_work` first.  A compiled query that dies leaves its
graph to be destroyed at the next such point, never inside a capture.

:meth:`CompiledQuery.run_vmapped` runs K same-shape table sets as one
launch: one graph that holds the plan W times over W private input sets,
W the power of two at or above K (at most :data:`BATCH_MAX`; the spare
members repeat the last set, and more sets go in chunks), so a plan
holds at most three batch graphs (on the CPU, K runs under the tape);
the serving runtime's batches take it (``exec/plan_cache.run_batched``),
and capture a missing width on a thread of its own while they replay
each set.  A batch graph's private inputs and pool count in
``CompiledQuery.batch_bytes`` and, with the budget on, are a
``memory.spill`` resident that budget pressure drops.  :meth:`CompiledQuery.lower_text`
lists what a compiled query runs: its tape, its kernels and graph nodes.
Counts go to :data:`COUNTS` and, under ``compiled.*`` names, to
``utils.metrics``; a stale tape files a ``stale_tape`` flight incident,
and each capture of a plan's graph after its first trips
``analysis.sanitize``'s recapture wire.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import itertools
import threading
import time
import weakref
from typing import Any, Callable, Optional

import torch

from ..analysis import sanitize
from ..column import Column, DictColumn, LazyColumn, Table, force_column
from ..memory import spill as mspill
from ..utils import flight, metrics, syncs

#: captures, rehydrations, graph captures, runs, stale tapes and batches
#: refused, since :func:`reset_counts`
COUNTS: collections.Counter = collections.Counter()

_plan_serial = itertools.count()


def reset_counts() -> None:
    COUNTS.clear()


def _count(key: str, n: int = 1) -> None:
    COUNTS[key] += n
    if metrics.recording():
        metrics.count(f"compiled.{key}", n)


class DeviceLock:
    """A readers-writer lock over the process's device work.

    :meth:`exclusive` (a graph capture) waits for every holder to leave
    and keeps new ones out; :meth:`shared` (a replay, an eager run, a
    copy) runs beside other shared holders.  A waiting capture is served
    before new shared holders, so captures do not starve.  Both are
    reentrant on a thread; a thread that holds :meth:`shared` may not ask
    for :meth:`exclusive`, which would wait for itself."""

    def __init__(self, name: str):
        self._cv = threading.Condition(sanitize.tracked_lock(name))
        self._readers = 0
        self._writer: Optional[int] = None
        self._waiting = 0
        self._tls = threading.local()

    @contextlib.contextmanager
    def shared(self):
        depth = getattr(self._tls, "depth", 0)
        if depth or self._writer == threading.get_ident():
            self._tls.depth = depth + 1
            try:
                yield
            finally:
                self._tls.depth = depth
            return
        with self._cv:
            while self._writer is not None or self._waiting:
                self._cv.wait()
            self._readers += 1
        self._tls.depth = 1
        try:
            yield
        finally:
            self._tls.depth = 0
            with self._cv:
                self._readers -= 1
                if not self._readers:
                    self._cv.notify_all()

    @contextlib.contextmanager
    def exclusive(self):
        me = threading.get_ident()
        if self._writer == me:
            yield
            return
        if getattr(self._tls, "depth", 0):
            raise RuntimeError("a graph capture asked for while this thread "
                               "holds shared device work would wait for "
                               "itself")
        with self._cv:
            self._waiting += 1
            try:
                while self._writer is not None or self._readers:
                    self._cv.wait()
            finally:
                self._waiting -= 1
            self._writer = me
        try:
            yield
        finally:
            with self._cv:
                self._writer = None
                self._cv.notify_all()


#: the process's device work: graph captures exclusive, the rest shared
DEVICE = DeviceLock("models.compiled.device")

# the graphs (with the tensors they own) of compiled queries that died,
# kept until a point where no capture runs: a query can die at any time,
# when a cache drops it or the garbage collector finds it in a cycle, even
# on the thread that is capturing, and destroying a graph there breaks
# that capture
_GRAVE: list = []
# the spill-registry keys of dead queries' batch graphs, unregistered at
# the same points (a finalizer may not take the budget's lock)
_DEAD_RESIDENTS: list = []


def _bury() -> None:
    """Destroy the dead queries' graphs.  Called with :data:`DEVICE` held
    and no capture running."""
    while _GRAVE:
        _GRAVE.pop()
    while _DEAD_RESIDENTS:
        mspill.unregister(_DEAD_RESIDENTS.pop())


#: the most members a batch graph holds; a batch of more sets runs in
#: chunks of this many
BATCH_MAX = 8

# the background batch captures in flight (``run_vmapped(background=True)``)
_CAPTURES: set = set()
_CAPTURES_MU = threading.Lock()


def batch_chunks(k: int) -> list[tuple[int, int, int]]:
    """How ``k`` sets run: (start, stop, width) per launch, in chunks of
    :data:`BATCH_MAX`, each chunk's width the power of two at or above
    its size (a chunk of one set is a plain replay, width 1)."""
    out = []
    for lo in range(0, k, BATCH_MAX):
        hi = min(lo + BATCH_MAX, k)
        w = 1
        while w < hi - lo:
            w *= 2
        out.append((lo, hi, w))
    return out


def wait_batch_captures(timeout: Optional[float] = None) -> int:
    """Wait for the background batch captures in flight; returns how many
    there were.  The serving runtime's shutdown calls it."""
    with _CAPTURES_MU:
        threads = list(_CAPTURES)
    for t in threads:
        t.join(timeout)
    return len(threads)


@contextlib.contextmanager
def device_work():
    """Context manager for device work beside compiled queries: shared
    with other such work, never during a graph capture."""
    with DEVICE.shared():
        _bury()
        yield


class StaleTapeError(ValueError):
    """The compiled plan's recorded sizes no longer match the data."""


# -- the tensors of tables and results --------------------------------------

def _flatten(obj, tensors: list):
    """A hashable spec of ``obj`` (dicts, lists, tuples, tables, columns,
    tensors, plain values) with each tensor's dtype and shape, its tensors
    appended to ``tensors`` in order.  A lazy column is forced; a
    :class:`DictColumn` gives its codes, validity and dictionary, not its
    materialized chars."""
    def leaf(t):
        if t is None:
            return None
        tensors.append(t)
        return ("t", t.dtype, tuple(t.shape), t.device.type)

    if isinstance(obj, torch.Tensor):
        return leaf(obj)
    if isinstance(obj, LazyColumn):
        return _flatten(force_column(obj), tensors)
    if isinstance(obj, DictColumn):
        return ("dict", leaf(obj.codes), leaf(obj.validity),
                _flatten(obj.dictionary, tensors))
    if isinstance(obj, Column):
        return ("col", obj.dtype, leaf(obj.data), leaf(obj.offsets),
                leaf(obj.validity))
    if isinstance(obj, Table):
        return ("table", obj.host_decoded_cols,
                tuple(_flatten(c, tensors) for c in obj.columns))
    if isinstance(obj, dict):
        return ("map", tuple((k, _flatten(obj[k], tensors))
                             for k in sorted(obj, key=repr)))
    if isinstance(obj, (list, tuple)):
        return ("seq", type(obj), tuple(_flatten(v, tensors) for v in obj))
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        # a result record (``ml.features.FeatureBatch``): its fields
        return ("record", type(obj),
                tuple((f.name, _flatten(getattr(obj, f.name), tensors))
                      for f in dataclasses.fields(obj)))
    return ("val", obj)


def _unflatten(spec, tensors):
    """The structure ``spec`` describes over the tensors of the iterator
    ``tensors``."""
    if spec is None:
        return None
    kind = spec[0]
    if kind == "t":
        return next(tensors)
    if kind == "dict":
        codes = _unflatten(spec[1], tensors)
        validity = _unflatten(spec[2], tensors)
        return DictColumn(codes, _unflatten(spec[3], tensors), validity)
    if kind == "col":
        return Column(spec[1], *(_unflatten(s, tensors) for s in spec[2:]))
    if kind == "table":
        return Table([_unflatten(s, tensors) for s in spec[2]], spec[1])
    if kind == "map":
        return {k: _unflatten(s, tensors) for k, s in spec[1]}
    if kind == "seq":
        return spec[1](_unflatten(s, tensors) for s in spec[2])
    if kind == "record":
        return spec[1](**{k: _unflatten(s, tensors) for k, s in spec[2]})
    return spec[1]


def _materialized(result):
    """``result`` with every lazy column forced, rebuilt of plain columns.
    Called inside the capture or replay, so that the sizes a lazy column
    resolves land on the tape, as the JAX package's ``_materialized``
    does."""
    tensors: list = []
    spec = _flatten(result, tensors)
    return _unflatten(spec, iter(tensors))


def _size_vector(seen: list, device) -> torch.Tensor:
    """The values that arrived at the sizes, as one int64 vector."""
    if not seen:
        return torch.zeros(0, dtype=torch.int64, device=device)
    return torch.stack([
        x.reshape(()).to(torch.int64) if isinstance(x, torch.Tensor)
        else torch.full((), int(x), dtype=torch.int64, device=device)
        for x in seen])


def _kernel_launches() -> dict:
    from ..rowconv import bytepath, ragged, xpack
    counts = {}
    for mod in (xpack, ragged, bytepath):
        counts.update(mod.launch_counts())
    return counts


# -- the compiled query ------------------------------------------------------

def graph_replay(graph) -> None:
    """Replay a captured graph: every compiled query's one launch on the
    card, and the fault shim's ``torch.launch`` seam
    (``faultinj/torch_shim.py``)."""
    graph.replay()


class CompiledQuery:
    """A query function compiled to one CUDA graph over its tables (on the
    CPU: an eager run under the tape).

    ``tape`` is the recorded size vector (its length is the eager run's
    count of resolved sizes); ``expected`` the capture run's result (None
    for a rehydrated query).  On the card, ``graph_capture_ms``,
    ``graph_pool_bytes`` (``torch.cuda.memory_reserved`` across the
    capture, read while :data:`DEVICE` is held exclusively), ``static_bytes`` (the private input copies) and
    ``graph_launches`` (each kernel wrapper's launches inside the graph)
    describe the graph once it is captured."""

    def __init__(self, qfn: Callable, tables: Any, *,
                 tape: Optional[tuple] = None):
        self.name = getattr(qfn, "__name__", None) or getattr(
            getattr(qfn, "func", None), "__name__", "query")
        self._qfn = qfn
        self._lock = threading.Lock()
        self._graph = None
        self._spec = None
        self._static: list = []
        self._copied: list = []           # (weakref, _version) a static
        self.graph_capture_ms = None
        self.graph_pool_bytes = None
        self.graph_launches = None
        self.static_bytes = None
        self.rehydrated = tape is not None
        self._batches: dict = {}          # width → the batch graph
        self._batchable: Optional[bool] = None
        self._capturing: set = set()      # widths captured in background
        self._dropped: list = []          # (width, graph) the spiller marked
        self._ledger_key = getattr(qfn, "plan_fingerprint", None) \
            or self.name
        self._trace_key = f"{self.name}#{next(_plan_serial)}"
        if tape is None:
            rec: list = []
            _count("capture")
            t0 = time.perf_counter()
            with metrics.span(f"compiled.capture:{self.name}"), \
                    device_work(), syncs.capture(rec):
                self.expected = _materialized(qfn(tables))
            metrics.ledger_add(self._ledger_key, captures=1,
                               capture_ms=(time.perf_counter() - t0) * 1e3)
            self.tape = tuple(rec)
            spec, tensors, on_card = self._inputs(tables)
            if on_card:
                self._capture_graph(spec, tensors)
        else:
            # a persisted tape: unverified until the first checked run
            _count("rehydrate")
            metrics.ledger_add(self._ledger_key, rehydrates=1)
            self.expected = None
            self.tape = tuple(int(v) for v in tape)
        if metrics.recording():
            metrics.observe("compiled.tape_len", len(self.tape))

    @staticmethod
    def _inputs(tables):
        """(spec, tensors, whether they lie on the card) of ``tables``."""
        tensors: list = []
        spec = _flatten(tables, tensors)
        kinds = {t.device.type for t in tensors}
        if len(kinds) > 1:
            raise ValueError(f"tables span devices {sorted(kinds)}")
        return spec, tensors, kinds == {"cuda"}

    # -- the graph ------------------------------------------------------------
    def _capture_graph(self, spec, tensors: list) -> None:
        """Private static copies of the tables' ``tensors`` (``spec`` their
        structure), a warm-up replay on a side stream, then the graph of
        one replay, ending in the size vector.  Raises (no eager fallback)
        if the capture fails; a tape the plan does not consume exactly is
        a :class:`StaleTapeError`.  Holds :data:`DEVICE` exclusively."""
        with DEVICE.exclusive(), \
                metrics.span(f"compiled.graph_capture:{self.name}"):
            _bury()
            self._capture_graph_locked(spec, tensors)

    def _capture_graph_locked(self, spec, tensors: list) -> None:
        # an old graph, its outputs and inputs go first
        self._graph, self._out, self._static = None, [], []
        self._spec = spec
        self._static = [t.clone() for t in tensors]
        self._copied = [(weakref.ref(t), t._version) for t in tensors]

        def static_tables():
            # fresh column objects over the static tensors for each run: a
            # dictionary column the warm-up materialized would otherwise
            # keep its chars out of the graph
            return _unflatten(self._spec, iter(self._static))
        try:
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                with syncs.replay(self.tape):
                    _materialized(self._qfn(static_tables()))
            torch.cuda.current_stream().wait_stream(side)
            torch.cuda.synchronize()
            graph = torch.cuda.CUDAGraph()
            seen: list = []
            # the capture empties the allocator's cache first: so do we,
            # so that the difference is the graph's own pool
            torch.cuda.empty_cache()
            reserved = torch.cuda.memory_reserved()
            launches = _kernel_launches()
            t0 = time.perf_counter()
            with torch.cuda.graph(graph):
                with syncs.replay(self.tape, collect=seen):
                    out = _materialized(self._qfn(static_tables()))
                sizes = _size_vector(seen, self._static[0].device)
            torch.cuda.synchronize()
        except syncs.TapeDivergence as e:
            self._stale(error=str(e)[:200])
            raise StaleTapeError(f"compiled plan {self.name} is stale: "
                                 f"{e}") from e
        self.graph_capture_ms = (time.perf_counter() - t0) * 1e3
        self.graph_pool_bytes = torch.cuda.memory_reserved() - reserved
        self.static_bytes = sum(t.numel() * t.element_size()
                                for t in self._static)
        after = _kernel_launches()
        self.graph_launches = {k: after[k] - launches[k] for k in after}
        out_tensors: list = []
        self._out_spec = _flatten(out, out_tensors)
        self._out = out_tensors
        self._sizes = sizes
        self._graph = graph
        _count("graph_capture")
        metrics.ledger_add(self._ledger_key, graph_captures=1,
                           graph_capture_ms=self.graph_capture_ms)
        # the first capture of this plan is warm-up; another (tables of
        # other shapes, a stale plan captured again) is a recapture
        sanitize.note_trace(self._trace_key)

    def __del__(self):
        # _GRAVE is None once the interpreter tears the module down
        if _GRAVE is None:
            return
        if getattr(self, "_graph", None) is not None:
            _GRAVE.append((self._graph, self._static, self._out,
                           self._sizes))
        if getattr(self, "_batches", None):
            _GRAVE.append(self._batches)
            _DEAD_RESIDENTS.extend(b["resident"] for b in
                                   self._batches.values()
                                   if b.get("resident"))

    def _stale(self, **fields) -> None:
        _count("tape_mismatch")
        flight.incident("stale_tape", query=self.name,
                        tape_len=len(self.tape), rehydrated=self.rehydrated,
                        **fields)

    def _replay(self, spec, tensors: list):
        """The graph's outputs for the tables of ``spec`` and ``tensors``,
        cloned, and its size vector (not read).  The tensors are copied
        into the static inputs, but those that are the very tensors, at
        the same ``_version``, copied last.  Tables of other shapes get a
        graph of their own under the same tape first, as a jitted function
        traces again for new shapes: the check then says whether the tape
        fits them."""
        if self._graph is None or spec != self._spec:
            self._capture_graph(spec, tensors)
        with device_work():
            return self._replay_locked(tensors)

    def _replay_locked(self, tensors: list):
        for i, (t, s) in enumerate(zip(tensors, self._static)):
            ref, version = self._copied[i]
            if ref() is t and t._version == version:
                continue
            s.copy_(t)
            self._copied[i] = (weakref.ref(t), t._version)
        graph_replay(self._graph)
        out = _unflatten(self._out_spec, (t.clone() for t in self._out))
        return out, self._sizes

    # -- the entry points -----------------------------------------------------
    def run(self, tables):
        """Checked execution: the plan, then one read of the sizes the
        data resolved; raises :class:`StaleTapeError` where they differ
        from the capture run's."""
        _count("replay_run")
        metrics.ledger_add(self._ledger_key, runs=1)
        spec, tensors, on_card = self._inputs(tables)
        with metrics.span(f"compiled.run:{self.name}",
                          tape_len=len(self.tape)):
            if on_card:
                with self._lock:
                    if self._graph is None or spec != self._spec:
                        self._capture_graph(spec, tensors)
                    with device_work():
                        out, sizes = self._replay_locked(tensors)
                        syncs.note_sync()       # the size vector's one copy
                        # the checked run's one read, after the replay and
                        # outside any capture, counted just above
                        actual = sizes.tolist()  # srjt-lint: disable=trace-host-sync
            else:
                seen: list = []
                try:
                    with syncs.replay(self.tape, collect=seen):
                        out = _materialized(self._qfn(tables))
                except syncs.TapeDivergence as e:
                    self._stale(error=str(e)[:200])
                    raise StaleTapeError(f"compiled plan {self.name} is "
                                         f"stale: {e}") from e
                syncs.note_sync()
                # a CPU tensor: the CPU run's size vector, no device read
                actual = _size_vector(seen, "cpu").tolist()  # srjt-lint: disable=trace-host-sync
        if tuple(actual) != self.tape:
            diffs = [i for i, (a, b) in enumerate(zip(actual, self.tape))
                     if a != b]
            self._stale(positions=diffs[:8])
            raise StaleTapeError(
                f"compiled plan {self.name} is stale: resolved sizes differ "
                f"from the capture run at tape positions {diffs[:8]} (of "
                f"{len(self.tape)}); compile it again on the refreshed "
                "tables")
        return out

    def run_unchecked(self, tables):
        """Steady-loop execution: the plan with no check and no host
        synchronisation (inputs copied where they changed, one graph
        replay, the outputs cloned)."""
        _count("replay_run")
        metrics.ledger_add(self._ledger_key, runs=1)
        spec, tensors, on_card = self._inputs(tables)
        with metrics.span(f"compiled.run_unchecked:{self.name}"):
            if on_card:
                with self._lock:
                    return self._replay(spec, tensors)[0]
            with syncs.replay(self.tape):
                return _materialized(self._qfn(tables))

    @property
    def batch_bytes(self) -> int:
        """The device bytes of the batch graphs: their private inputs and
        their graph pools."""
        return sum(b["bytes"] for b in list(self._batches.values()))

    def device_bytes(self) -> int:
        """The device bytes the compiled query holds: its graph's private
        inputs and pool, and :attr:`batch_bytes`."""
        return ((self.static_bytes or 0) + (self.graph_pool_bytes or 0)
                + self.batch_bytes)

    def run_vmapped(self, tables_list, *,
                    background: bool = False) -> Optional[list]:
        """K same-shape table sets as one launch a chunk: on the card, a
        replay of a graph that holds the plan W times over W private input
        sets (:func:`batch_chunks`: W the power of two at or above K, at
        most :data:`BATCH_MAX`, the spare members repeating the last set;
        captured once for each W, under the same tape: every member's
        sizes are the tape's, as under ``jax.vmap`` in the JAX package);
        on the CPU, K runs under the tape.  The results are clones, in
        order.  No sizes are read back: the callers batch only plans
        verified on each member's tables (``exec/plan_cache``).

        ``background``: a width with no graph yet is captured on a thread
        of its own (:func:`wait_batch_captures`), and this call returns
        None, so that the caller replays each set meanwhile
        (``compiled.batch_deferred``).  Otherwise it is captured here.

        Returns None where the caller must dispatch each set itself: sets
        of differing structure or shape, a deferred capture, a failed
        background capture (``compiled.batch_capture_failed``, a flight
        incident; batching stays off for the plan), or a plan whose first
        batch differed from its serial run (element 0 is held against
        :meth:`run_unchecked` once: integers, keys and validity byte for
        byte, floats within a relative :data:`PARITY_RTOL`, since float
        sums add by atomics on the card and two runs of one graph may
        differ in their last bits; a difference rejects batching for the
        plan, ``compiled.batch_parity_reject``, and files a flight
        incident)."""
        if self._batchable is False:
            return None
        specs = [self._inputs(t) for t in tables_list]
        spec0, _, on_card = specs[0]
        if any(sp != spec0 or oc != on_card for sp, _, oc in specs[1:]):
            _count("batch_unsupported")
            return None
        members = [t for _, t, _ in specs]
        chunks = batch_chunks(len(members))
        with metrics.span(f"compiled.batch:{self.name}",
                          size=len(tables_list)):
            if on_card:
                with self._lock:
                    self._drop_marked()
                    missing = [(lo, hi, w) for lo, hi, w in chunks
                               if w > 1 and not self._has_batch(spec0, w)]
                    if missing and background:
                        for lo, hi, w in missing:
                            self._capture_later(spec0, members[lo:hi], w)
                        _count("batch_deferred")
                        return None
                    outs = []
                    for lo, hi, w in chunks:
                        if w == 1:
                            outs.append(self._replay(spec0, members[lo])[0])
                        else:
                            outs += self._batch_replay(spec0,
                                                       members[lo:hi], w)
            else:
                outs = []
                for t in tables_list:
                    with syncs.replay(self.tape):
                        outs.append(_materialized(self._qfn(t)))
        _count("batch_replay", sum(1 for _, _, w in chunks if w > 1)
               if on_card else 1)
        _count("batch_member", len(tables_list))
        if self._batchable is None:
            _count("batch_parity_check")
            ref: list = []
            got: list = []
            same = (_flatten(self.run_unchecked(tables_list[0]), ref)
                    == _flatten(outs[0], got))
            same = same and all(_parity(a, b) for a, b in zip(ref, got))
            if not same:
                _count("batch_parity_reject")
                flight.incident("vmap_parity_reject", query=self.name,
                                batch_size=len(tables_list))
                self._batchable = False
                return None
            self._batchable = True
        return outs

    def _has_batch(self, spec, w: int) -> bool:
        b = self._batches.get(w)
        return b is not None and b["spec"] == spec

    def _drop_marked(self) -> None:
        """Drop the batch graphs the spiller marked while the query was
        busy.  The caller holds ``_lock``."""
        while self._dropped:
            w, b = self._dropped.pop()
            if self._batches.get(w) is b:
                _GRAVE.append(self._batches.pop(w))

    def _capture_later(self, spec, members: list, w: int) -> None:
        """Capture the width-``w`` graph over ``members`` on a thread of
        its own, unless one is on its way.  The caller holds ``_lock``."""
        if w in self._capturing:
            return
        self._capturing.add(w)

        def job():
            try:
                with self._lock:
                    if not self._has_batch(spec, w):
                        self._install_batch(spec, members, w)
            except BaseException as e:
                _count("batch_capture_failed")
                flight.incident("batch_capture_failed", query=self.name,
                                width=w, error=repr(e)[:200])
                self._batchable = False
            finally:
                with self._lock:
                    self._capturing.discard(w)
                with _CAPTURES_MU:
                    _CAPTURES.discard(threading.current_thread())

        t = threading.Thread(target=job, name=f"batch-capture:{self.name}:{w}")
        with _CAPTURES_MU:
            _CAPTURES.add(t)
        t.start()

    def _batch_replay(self, spec, members: list, w: int) -> list:
        """The width-``w`` graph for ``members`` (captured first where
        there is none; the spare members repeat the last set), replayed
        once; the members' results."""
        if not self._has_batch(spec, w):
            self._install_batch(spec, members, w)
        b = self._batches[w]
        padded = members + [members[-1]] * (w - len(members))
        with device_work():
            for k, tensors in enumerate(padded):
                for i, (t, s) in enumerate(zip(tensors, b["static"][k])):
                    ref, version = b["copied"][k][i]
                    if ref() is t and t._version == version:
                        continue
                    s.copy_(t)
                    b["copied"][k][i] = (weakref.ref(t), t._version)
            graph_replay(b["graph"])
            return [_unflatten(b["out_spec"][k],
                               (t.clone() for t in b["out"][k]))
                    for k in range(len(members))]

    def _install_batch(self, spec, members: list, w: int) -> None:
        """Capture the width-``w`` graph (replacing one of another spec)
        and account its bytes.  The caller holds ``_lock``."""
        padded = members + [members[-1]] * (w - len(members))
        with DEVICE.exclusive(), \
                metrics.span(f"compiled.batch_capture:{self.name}", size=w), \
                torch.cuda.device(padded[0][0].device):
            _bury()
            old = self._batches.pop(w, None)
            if old is not None:
                _GRAVE.append(old)
                if old.get("resident"):
                    mspill.unregister(old["resident"])
            b = self._capture_batch(spec, padded)
        self._batches[w] = b
        self._register_batch(w, b)

    def _register_batch(self, w: int, b: dict) -> None:
        """With the budget on, the graph is a ``memory.spill`` resident:
        budget pressure drops it (at once, or at the query's next batch
        where a replay or capture holds it) and a later batch captures it
        again."""
        b["resident"] = None
        from ..memory import budget as mbudget
        if not mbudget.active():
            return
        me = weakref.ref(self)
        key = ("compiled.batch_graph", self._trace_key, w)

        def spiller():
            cq = me()
            if cq is None or cq._batches.get(w) is not b:
                return 0
            if cq._lock.acquire(blocking=False):
                try:
                    if cq._batches.get(w) is b:
                        del cq._batches[w]
                        _GRAVE.append(b)
                finally:
                    cq._lock.release()
            else:
                cq._dropped.append((w, b))
            return b["bytes"]
        b["resident"] = key
        mspill.register(key, b["bytes"], "compiled.batch_graph", spiller)

    def _capture_batch(self, spec, members: list) -> dict:
        statics = [[t.clone() for t in tensors] for tensors in members]

        def member(k):
            return _unflatten(spec, iter(statics[k]))
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for k in range(len(members)):
                with syncs.replay(self.tape):
                    _materialized(self._qfn(member(k)))
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        # as for the one-set graph: the pool is what the capture reserves
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved()
        launches = _kernel_launches()
        t0 = time.perf_counter()
        outs, out_specs = [], []
        with torch.cuda.graph(graph):
            for k in range(len(members)):
                with syncs.replay(self.tape):
                    out = _materialized(self._qfn(member(k)))
                tensors: list = []
                out_specs.append(_flatten(out, tensors))
                outs.append(tensors)
        torch.cuda.synchronize()
        pool = torch.cuda.memory_reserved() - reserved
        after = _kernel_launches()
        _count("batch_capture")
        metrics.ledger_add(self._ledger_key, batch_captures=1,
                           batch_capture_ms=(time.perf_counter() - t0) * 1e3)
        static_bytes = sum(t.numel() * t.element_size()
                           for tensors in statics for t in tensors)
        return {"spec": spec, "static": statics, "graph": graph,
                "out": outs, "out_spec": out_specs,
                "bytes": static_bytes + pool, "pool_bytes": pool,
                "launches": {k: after[k] - launches[k] for k in after},
                "copied": [[(weakref.ref(t), t._version) for t in tensors]
                           for tensors in members]}

    def lower_text(self, tables=None) -> str:
        """What the compiled query runs, as text (diagnostics; the JAX
        package dumps its StableHLO here): the tape, and on the card the
        graph's hand-written kernel launches and its CUDA graph nodes
        (``CUDAGraph.debug_dump``'s DOT text, where the graph was
        captured with debug mode on), else the graph's node count.
        ``tables`` captures the graph first where there is none."""
        if tables is not None and self._graph is None:
            spec, tensors, on_card = self._inputs(tables)
            if on_card:
                with self._lock:
                    self._capture_graph(spec, tensors)
        lines = [f"compiled query {self.name}",
                 f"tape ({len(self.tape)} sizes): {list(self.tape)}"]
        if self._graph is None:
            lines.append("graph: none (eager under the tape on the CPU)")
            return "\n".join(lines)
        launches = {k: v for k, v in (self.graph_launches or {}).items()
                    if v}
        lines.append(f"kernels launched in the graph: {launches}")
        lines.append(f"graph pool bytes: {self.graph_pool_bytes}, "
                     f"static input bytes: {self.static_bytes}, "
                     f"batch graphs {sorted(self._batches)}: "
                     f"{self.batch_bytes} bytes")
        dot = _graph_dot(self._graph)
        if dot is not None:
            nodes = [ln for ln in dot.splitlines() if "label=" in ln]
            lines.append(f"graph nodes ({len(nodes)}):")
            lines += ["  " + ln.strip() for ln in nodes]
        return "\n".join(lines)


#: the relative difference a batched float result may show against its
#: serial run in the first batch's parity check
PARITY_RTOL = 1e-12


def _parity(a: torch.Tensor, b: torch.Tensor) -> bool:
    """``a`` and ``b`` equal: bit for bit, or floats within
    :data:`PARITY_RTOL` (NaN where the other is NaN)."""
    # a check of two finished runs' outputs, never inside a capture
    if not a.is_floating_point():
        return torch.equal(a, b)
    if torch.equal(a, b):  # srjt-lint: disable=trace-branch
        return True
    return bool(torch.allclose(  # srjt-lint: disable=trace-host-sync
        a, b, rtol=PARITY_RTOL, atol=0.0, equal_nan=True))


def _graph_dot(graph) -> Optional[str]:
    """The DOT text of a captured graph (``debug_dump``), or None where
    the graph was not captured in debug mode."""
    import os
    import tempfile
    try:
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "graph.dot")
            graph.debug_dump(path)
            with open(path) as f:
                return f.read()
    except Exception:
        return None


def compile_query(qfn: Callable, tables) -> CompiledQuery:
    """Capture ``qfn(tables)`` and return its one-graph form."""
    return CompiledQuery(qfn, tables)


def rehydrate_query(qfn: Callable, tape) -> CompiledQuery:
    """A :class:`CompiledQuery` over a persisted tape, with no eager
    capture run.  Unverified until its first checked
    :meth:`CompiledQuery.run`, which captures its graph on the card and
    raises :class:`StaleTapeError` where the tape does not fit the
    data."""
    return CompiledQuery(qfn, None, tape=tuple(tape))


def plan_key(tables, *, by_size: bool = False) -> tuple[tuple, list]:
    """Fingerprint of a query's input tables, for plan caching: ``(key,
    objects)``, a hashable key and the keyed tensors (and objects), so
    that a cache can hold weak references guarding ids against reuse.

    **Identity mode** (default): a tensor keys on its ``id``, its
    ``_version`` (an in-place write is new data), dtype and shape: two
    lookups with one key present the same tensors in the same state.
    **Size mode** (``by_size=True``): dtype and shape only, the shape of
    the request, under which a compiled plan may be shared across
    refreshed data of the same shapes, provided its first run there is
    the checked :meth:`CompiledQuery.run`.  An object the walker cannot
    see inside keys by identity in both modes.

    A :class:`LazyColumn` not yet forced keys as itself (size mode: its
    dtype and length): fingerprinting never computes a column.  A
    :class:`DictColumn` keys on its codes, validity and dictionary."""
    key: list = []
    objects: list = []

    def leaf(t):
        if t is None:
            key.append(None)
            return
        shape = (str(t.dtype), tuple(t.shape))
        key.append(shape if by_size else (id(t), t._version) + shape)
        objects.append(t)

    def col(c):
        if isinstance(c, LazyColumn) and c.forced:
            c = c._col
        dt = (c.dtype.id.value, c.dtype.scale)
        if isinstance(c, LazyColumn):
            key.append(("lazy",) + dt + (len(c),) if by_size
                       else ("lazy", id(c)) + dt + (len(c),))
            objects.append(c)
        elif isinstance(c, DictColumn):
            key.append(("dict",) + dt)
            leaf(c.codes)
            leaf(c.validity)
            col(c.dictionary)
        else:
            key.append(("col",) + dt)
            leaf(c.data)
            leaf(c.offsets)
            leaf(c.validity)

    def walk(obj):
        if isinstance(obj, dict):
            for k in sorted(obj, key=repr):
                key.append(("key", k))
                walk(obj[k])
        elif isinstance(obj, Table):
            key.append(("table", len(obj.columns)))
            for c in obj.columns:
                col(c)
        elif isinstance(obj, Column):
            col(obj)
        elif isinstance(obj, torch.Tensor):
            leaf(obj)
        elif isinstance(obj, (list, tuple)):
            key.append(("seq", len(obj)))
            for v in obj:
                walk(v)
        elif isinstance(obj, (int, float, str, bool, bytes, type(None))):
            key.append(("val", obj))
        else:
            key.append(("obj", id(obj)))
            objects.append(obj)

    walk(tables)
    return tuple(key), objects
