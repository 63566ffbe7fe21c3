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

Not ported yet: ``run_vmapped`` (batched replay, whose caller is the
unported ``exec/plan_cache.run_batched``), ``lower_text``, and the
metrics spans, compile ledger and flight incidents.  Counts go to
:data:`COUNTS`.
"""

from __future__ import annotations

import collections
import threading
import time
import weakref
from typing import Any, Callable, Optional

import torch

from ..column import Column, DictColumn, LazyColumn, Table, force_column
from ..utils import syncs

#: captures, rehydrations, graph captures, runs and stale tapes, since
#: :func:`reset_counts`
COUNTS: collections.Counter = collections.Counter()


def reset_counts() -> None:
    COUNTS.clear()


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

class CompiledQuery:
    """A query function compiled to one CUDA graph over its tables (on the
    CPU: an eager run under the tape).

    ``tape`` is the recorded size vector (its length is the eager run's
    count of resolved sizes); ``expected`` the capture run's result (None
    for a rehydrated query).  On the card, ``graph_capture_ms``,
    ``graph_pool_bytes`` (``torch.cuda.memory_reserved`` across the
    capture), ``static_bytes`` (the private input copies) and
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
        if tape is None:
            rec: list = []
            COUNTS["capture"] += 1
            with syncs.capture(rec):
                self.expected = _materialized(qfn(tables))
            self.tape = tuple(rec)
            spec, tensors, on_card = self._inputs(tables)
            if on_card:
                self._capture_graph(spec, tensors)
        else:
            # a persisted tape: unverified until the first checked run
            COUNTS["rehydrate"] += 1
            self.expected = None
            self.tape = tuple(int(v) for v in tape)

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
        a :class:`StaleTapeError`."""
        # an old graph, its outputs and inputs go first
        self._graph, self._out, self._static = None, [], []
        self._spec = spec
        self._static = [t.clone() for t in tensors]
        self._copied = [(weakref.ref(t), t._version) for t in tensors]
        static_tables = _unflatten(self._spec, iter(self._static))
        try:
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                with syncs.replay(self.tape):
                    _materialized(self._qfn(static_tables))
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
                    out = _materialized(self._qfn(static_tables))
                sizes = _size_vector(seen, self._static[0].device)
            torch.cuda.synchronize()
        except syncs.TapeDivergence as e:
            COUNTS["tape_mismatch"] += 1
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
        COUNTS["graph_capture"] += 1

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
        for i, (t, s) in enumerate(zip(tensors, self._static)):
            ref, version = self._copied[i]
            if ref() is t and t._version == version:
                continue
            s.copy_(t)
            self._copied[i] = (weakref.ref(t), t._version)
        self._graph.replay()
        out = _unflatten(self._out_spec, (t.clone() for t in self._out))
        return out, self._sizes

    # -- the entry points -----------------------------------------------------
    def run(self, tables):
        """Checked execution: the plan, then one read of the sizes the
        data resolved; raises :class:`StaleTapeError` where they differ
        from the capture run's."""
        COUNTS["replay_run"] += 1
        spec, tensors, on_card = self._inputs(tables)
        if on_card:
            with self._lock:
                out, sizes = self._replay(spec, tensors)
                syncs.note_sync()           # the size vector's one copy
                actual = sizes.tolist()
        else:
            seen: list = []
            try:
                with syncs.replay(self.tape, collect=seen):
                    out = _materialized(self._qfn(tables))
            except syncs.TapeDivergence as e:
                COUNTS["tape_mismatch"] += 1
                raise StaleTapeError(f"compiled plan {self.name} is stale: "
                                     f"{e}") from e
            syncs.note_sync()
            actual = _size_vector(seen, "cpu").tolist()
        if tuple(actual) != self.tape:
            diffs = [i for i, (a, b) in enumerate(zip(actual, self.tape))
                     if a != b]
            COUNTS["tape_mismatch"] += 1
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
        COUNTS["replay_run"] += 1
        spec, tensors, on_card = self._inputs(tables)
        if on_card:
            with self._lock:
                return self._replay(spec, tensors)[0]
        with syncs.replay(self.tape):
            return _materialized(self._qfn(tables))


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
