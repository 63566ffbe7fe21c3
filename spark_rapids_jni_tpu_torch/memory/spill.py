"""LRU registry of evictable device residents with host spill/fault-back.

The port's copy of the JAX package's ``memory/spill.py`` (the
spark-rapids ``RapidsBufferCatalog`` analog): long-lived device residents
(cached build indexes, staged request tables) register here with their
byte footprint; when ``memory.budget`` sees pressure it walks this
registry in LRU order and asks residents to spill.

A spill copies a resident's card tensors into pinned host memory
(``.cpu()`` into a ``pin_memory`` buffer, where the JAX package uses
``np.asarray``) and drops the card references, so the caching allocator
can reuse the memory.  A fault-back is ``.to(device)``: the same bits,
since a copy moves bytes, whatever the dtype.

Residents must be *re-derivable or self-contained*: the registry never
spills buffers a running plan holds references to, only caches that can
fault back (or rebuild) on their next touch.  PyTorch ops do not move a
CPU tensor to the card on their own, so a spilled :class:`SpillableTable`
faults back explicitly (:meth:`SpillableTable.faultback`, which
:func:`unregister_table` calls) before its tables are handed to a query.
"""

from __future__ import annotations

import weakref
from collections import OrderedDict
from typing import Callable, Optional

import torch

from ..analysis import sanitize
from ..utils import flight, metrics
from . import budget

_reg: "OrderedDict[object, Resident]" = OrderedDict()
_tables: dict = {}                  # key → SpillableTable of a registered table


class Resident:
    """One evictable device-resident entry.

    ``spiller()`` must free the resident's device references and return
    the bytes it released; after it runs the entry leaves the registry
    (a fault-back re-registers it)."""

    __slots__ = ("key", "nbytes", "tag", "spiller")

    def __init__(self, key, nbytes: int, tag: str,
                 spiller: Callable[[], int]):
        self.key = key
        self.nbytes = int(nbytes)
        self.tag = tag
        self.spiller = spiller


def register(key, nbytes: int, tag: str,
             spiller: Callable[[], int]) -> None:
    """Track a device resident as evictable; charges the budget (soft —
    registering a cache entry must not fail the query; pressure instead
    spills older residents, possibly including this one later)."""
    if not budget.active():
        return
    budget.charge(nbytes, tag=tag, strict=False)
    with budget._LOCK:
        _reg[key] = Resident(key, nbytes, tag, spiller)
        _reg.move_to_end(key)


def unregister(key, *, release: bool = True) -> None:
    """Drop a resident (evicted, died with its arrays, or spilled)."""
    with budget._LOCK:
        r = _reg.pop(key, None)
    if r is not None and release:
        budget.release(r.nbytes)


def touch(key) -> None:
    """Mark a resident most-recently-used."""
    with budget._LOCK:
        if key in _reg:
            _reg.move_to_end(key)


def registered_bytes() -> int:
    with budget._LOCK:
        return sum(r.nbytes for r in _reg.values())


def resident_count() -> int:
    return len(_reg)


def reset() -> None:
    """Forget every resident without spilling (tests)."""
    with budget._LOCK:
        _reg.clear()
        _tables.clear()


def reclaim(nbytes_needed: int) -> int:
    """Spill LRU residents until ``nbytes_needed`` bytes were released
    (or the registry runs dry).  Returns bytes actually freed."""
    freed = 0
    while freed < nbytes_needed:
        with budget._LOCK:
            if not _reg:
                break
            key, r = next(iter(_reg.items()))
            _reg.pop(key, None)
        with metrics.span("arena.spill", tag=r.tag, bytes=r.nbytes):
            try:
                got = int(r.spiller())
            except Exception:
                got = 0
        budget.release(r.nbytes)
        freed += got or r.nbytes
        if metrics.recording():
            metrics.count("arena.spill.events")
            metrics.count("arena.spill.bytes", r.nbytes)
            metrics.count(f"arena.spill.{r.tag}")
    return freed


def _to_host(t: torch.Tensor) -> torch.Tensor:
    """A host copy of ``t``: into pinned memory from the card, a plain
    copy on the CPU."""
    if t.device.type == "cuda":
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        h.copy_(t)
        return h
    return t.clone()


def _host_copy(t: torch.Tensor) -> torch.Tensor:
    """:func:`_to_host`, but a tensor with a host mirror
    (``utils/hostcache.py``) of its shape spills with no device → host
    copy: the mirror IS the host copy.  An integer mirror of another width
    (the int64 mirrors of int32 offsets that ``Column.strings_from_arrays``
    and ``hostcache.host_i64`` seed) holds the same values, since it was
    made from them, and is cast on the host."""
    from ..utils import hostcache
    h = hostcache.peek(t)
    want = torch.empty(0, dtype=t.dtype).numpy().dtype
    if h is not None and h.shape == tuple(t.shape) and (
            h.dtype == want or (h.dtype.kind in "iu" and want.kind in "iu")):
        if metrics.recording():
            metrics.count("arena.spill.mirror_reuse")
        return torch.from_numpy(h if h.dtype == want else h.astype(want))
    return _to_host(t)


class SpillableArrays:
    """A named bundle of device tensors that can round-trip through host
    memory bit-exactly (the generic resident payload).

    ``get()`` returns the tensor dict, faulting back from the host copies
    when spilled (counted as ``arena.faultback.*``); ``spill()`` moves
    every tensor to the host and drops the device references."""

    __slots__ = ("tag", "_dev", "_host", "_where", "nbytes", "_mu")

    def __init__(self, tag: str, arrays: dict):
        self.tag = tag
        self._dev: Optional[dict] = {k: v for k, v in arrays.items()}
        self._host: Optional[dict] = None
        self._where = {k: (None if a is None else a.device)
                       for k, a in arrays.items()}
        self.nbytes = sum(a.numel() * a.element_size()
                          for a in arrays.values() if a is not None)
        self._mu = sanitize.tracked_rlock("memory.spill")

    @property
    def spilled(self) -> bool:
        return self._dev is None

    @property
    def names(self) -> tuple:
        """The bundle's tensor names."""
        return tuple(self._where)

    def spill(self) -> int:
        """Device → host; returns bytes released (0 when already host)."""
        with self._mu:
            if self._dev is None:
                return 0
            self._host = {k: (None if a is None else _to_host(a))
                          for k, a in self._dev.items()}
            self._dev = None
            return self.nbytes

    def get(self) -> dict:
        """The tensor dict on its devices, faulting back if spilled.  A
        fault-back that cannot re-upload (out of memory mid-restore) is an
        incident: the data survives on the host, but the query that
        touched it is about to fail under memory pressure."""
        with self._mu:
            if self._dev is None:
                try:
                    with metrics.span("arena.faultback", tag=self.tag,
                                      bytes=self.nbytes):
                        self._dev = {
                            k: (None if a is None
                                else a.to(self._where[k], copy=True))
                            for k, a in self._host.items()}
                except BaseException as e:
                    self._dev = None   # stay spilled; host copy is intact
                    flight.incident("spill_faultback", tag=self.tag,
                                    nbytes=self.nbytes, error=repr(e))
                    raise
                self._host = None
                if metrics.recording():
                    metrics.count("arena.faultback.events")
                    metrics.count("arena.faultback.bytes", self.nbytes)
            return self._dev


class SpillableTable:
    """In-place host spill for a whole :class:`~..column.Table` (staged
    request tables of the serving runtime's prefetcher).

    :class:`SpillableArrays` works for payloads whose OWNER re-fetches
    them through ``get()``; a staged table is held directly by its
    caller, so eviction works in place: :meth:`spill` replaces every
    column's card tensors with pinned host copies (or their host
    mirrors, ``utils/hostcache.py``, where those match), and
    :meth:`faultback` moves them back to the card they came from,
    bit-exact.  Holds only a weakref to the table: residency must not
    keep a dead request's working set alive."""

    __slots__ = ("tag", "_ref", "nbytes", "_where", "_mu")

    def __init__(self, table, tag: str, on_death=None):
        self.tag = tag
        self._ref = weakref.ref(table, on_death)
        self.nbytes = table_device_bytes(table)
        self._where: dict = {}        # (id(col), field) → device
        self._mu = sanitize.tracked_lock("memory.spill.table")

    def spill(self) -> int:
        t = self._ref()
        if t is None:
            return 0
        freed = 0
        with self._mu:
            for col in _concrete_columns(t):
                for field in _payload_fields(col):
                    a = getattr(col, field, None)
                    if a is None or a.device.type != "cuda":
                        continue
                    self._where[(id(col), field)] = a.device
                    setattr(col, field, _host_copy(a))
                    freed += a.numel() * a.element_size()
        if freed and metrics.recording():
            metrics.count("arena.spill.table_cols")
        return freed

    def faultback(self) -> int:
        """Every spilled tensor back on its card; returns the bytes moved
        (0 when nothing was spilled)."""
        t = self._ref()
        if t is None:
            return 0
        moved = 0
        with self._mu:
            if not self._where:
                return 0
            with metrics.span("arena.faultback", tag=self.tag):
                for col in _concrete_columns(t):
                    for field in _payload_fields(col):
                        dev = self._where.pop((id(col), field), None)
                        if dev is None:
                            continue
                        h = getattr(col, field)
                        setattr(col, field, h.to(dev))
                        moved += h.numel() * h.element_size()
        if moved and metrics.recording():
            metrics.count("arena.faultback.events")
            metrics.count("arena.faultback.bytes", moved)
        return moved


def _payload_fields(col) -> tuple:
    """The column's spillable payload attributes.  Dict columns spill their
    CODES (touching ``data``/``offsets`` would materialize the byte payload
    — allocating under pressure, the opposite of spilling); the shared
    dictionary spills through its own entry in ``_concrete_columns``."""
    from ..column import DictColumn
    if isinstance(col, DictColumn):
        return ("codes", "validity")
    return ("data", "offsets", "validity")


def _concrete_columns(table):
    """The table's materialized columns; lazy columns that were never
    forced hold no device payload and are left untouched (forcing them
    here would ADD allocations under pressure)."""
    from ..column import DictColumn, LazyColumn
    out = []
    stack = list(table.columns)
    while stack:
        c = stack.pop()
        if isinstance(c, LazyColumn):
            if not c.forced:
                continue
            c = c._col
        out.append(c)
        if isinstance(c, DictColumn):
            stack.append(c.dictionary)
            if c._mat is not None:     # already-materialized bytes spill too
                stack.append(c._mat)
    return out


def table_device_bytes(table) -> int:
    """Total bytes of the table's card-resident payload tensors."""
    total = 0
    for col in _concrete_columns(table):
        for field in _payload_fields(col):
            a = getattr(col, field, None)
            if a is not None and a.device.type == "cuda":
                total += a.numel() * a.element_size()
    return total


def register_table(table, tag: str) -> Optional[SpillableTable]:
    """Track a caller-held table's card payload as evictable (staged
    request tables).  The registration dies with the table.  Returns the
    handle, or None when the ledger is off / nothing is on the card."""
    if not budget.active():
        return None
    with budget._LOCK:
        # idempotent per table object: re-registering would double-charge
        for r in _reg.values():
            s = getattr(r.spiller, "__self__", None)
            if isinstance(s, SpillableTable) and s._ref() is table:
                return s
    key = (tag, id(table))
    try:
        st = SpillableTable(
            table, tag,
            on_death=lambda _: (_tables.pop(key, None), unregister(key)))
    except TypeError:
        return None
    if st.nbytes <= 0:
        return None
    register(key, st.nbytes, tag, st.spill)
    _tables[key] = st
    return st


def unregister_table(table, tag: str, *, restore: bool = True) -> None:
    """Drop ``table``'s registration under ``tag``; with ``restore``
    first move back to the card whatever a spill moved off it (from here
    on the table is a running query's working set)."""
    key = (tag, id(table))
    st = _tables.pop(key, None)
    unregister(key)
    if restore and st is not None and st._ref() is table:
        st.faultback()
