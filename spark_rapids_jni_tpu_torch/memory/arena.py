"""Size-class slab arena over device memory (the RMM pool analog).

The port's counterpart of the JAX package's ``memory/arena.py``.
PyTorch's caching allocator owns the card's memory and already pools
freed blocks, so this arena does what an allocation layer can add above
it, in three tiers, as the JAX package's does:

* **slabs**: ``alloc``/``free``/``trim``: uint8 device tensors rounded
  up to power-of-two size classes (at least 256 B), kept on a per-class
  free list when freed and handed back by identity on the next matching
  ``alloc``.  A pooled slab keeps its block, so a steady loop's scratch
  never returns to the caching allocator; ``trim()`` drops them all.
  The arena holds only blocks it was asked for: it never reserves memory
  of its own, so it cannot fight the caching allocator for the card.
* **zeros cache**: ``zeros(shape, dtype, device)``: the join's null
  fill allocates identical all-zero tensors over and over.  The JAX
  package hands one immutable array to every caller; a torch tensor is
  mutable, so the pooled tensor is shared on one rule: **no caller
  writes it in place**.  The ops that take these tensors (the join's
  null columns, groupby's null keys) build new tensors from them and
  never write them; a test holds the shared tensors' ``_version`` fixed
  across a join.  LRU-capped at ``SRJT_ARENA_ZEROS_CAP``.
* **reservations**: ``reserve(nbytes)``: accounting-only admission for
  the transient buffers an op makes (the join's pair expansion, the
  repartition join's buckets).  The bytes are charged to
  ``memory.budget`` for the context's lifetime; pressure spills LRU
  residents (``memory.spill``) before the buffers are made.

Per-device bytes in use and high water of the slabs flow into
``utils.metrics`` as ``arena.slab_bytes_in_use``, ``arena.pooled_bytes``
and ``arena.device{i}.*``; the budget's ``arena.bytes_in_use`` and
``arena.peak_bytes`` count the reservations.

``alloc`` is admission-controlled (raises
:class:`~.budget.HbmBudgetExceeded` over budget); ``reserve`` is soft by
default, as in the JAX package: an admitted query completes with the
pressure recorded rather than failing mid-plan.  Everything is behind
``SRJT_HBM_ARENA`` (or a set ``SRJT_HBM_BUDGET``); off, ``zeros`` is
``torch.zeros`` and ``reserve`` a shared no-op context.
"""

from __future__ import annotations

import contextlib
from collections import OrderedDict

import torch

from ..analysis import sanitize
from ..column import resolve_device
from ..utils import knobs, metrics
from . import budget

MIN_CLASS = 256

_lock = sanitize.tracked_rlock("memory.arena")
_free: dict[tuple, list] = {}            # (class, device) → [u8 tensors]
_zeros: "OrderedDict[tuple, torch.Tensor]" = OrderedDict()
_zeros_bytes = 0

_in_use = 0          # live slab bytes (class-rounded)
_pooled = 0          # freed slab bytes kept on free lists
_peak = 0
_dev_in_use: dict[str, int] = {}
_dev_peak: dict[str, int] = {}


def size_class(nbytes: int) -> int:
    """Next power of two ≥ ``nbytes``, at least :data:`MIN_CLASS` (every
    slab length is a multiple of 256, so any fixed-width dtype view tiles
    it exactly)."""
    n = max(int(nbytes), MIN_CLASS)
    return 1 << (n - 1).bit_length()


def _zeros_cap() -> int:
    return budget.parse_bytes(knobs.get("SRJT_ARENA_ZEROS_CAP")) or 0


def _dev_key(device: torch.device) -> str:
    if device.type == "cuda":
        return f"cuda{device.index if device.index is not None else 0}"
    return device.type


class Slab:
    """One arena buffer: a uint8 device tensor of ``nbytes`` (the size
    class) backing a request of ``requested`` bytes."""

    __slots__ = ("data", "nbytes", "requested", "tag", "_freed")

    def __init__(self, data, nbytes: int, requested: int, tag: str):
        self.data = data
        self.nbytes = nbytes
        self.requested = requested
        self.tag = tag
        self._freed = False


def _note_gauges() -> None:
    if not metrics.recording():
        return
    metrics.gauge("arena.slab_bytes_in_use", _in_use)
    metrics.gauge("arena.pooled_bytes", _pooled)
    for k, v in _dev_in_use.items():
        metrics.gauge(f"arena.device{k}.bytes_in_use", v)
        metrics.gauge_max(f"arena.device{k}.peak_bytes", _dev_peak[k])


def alloc(nbytes: int, tag: str = "scratch", device=None) -> Slab:
    """A device slab of ≥ ``nbytes`` zero bytes on ``device`` (None: the
    card).  Reuses a pooled slab of the same size class where there is
    one (the returned tensor IS the freed one, zeroed again); else
    admission-checks the budget (strict: raises
    :class:`~.budget.HbmBudgetExceeded`) and allocates."""
    global _in_use, _pooled, _peak
    dev = resolve_device(device)
    key = _dev_key(dev)
    cls = size_class(nbytes)
    with _lock:
        stack = _free.get((cls, key))
        if stack:
            data = stack.pop()
            _pooled -= cls
            _in_use += cls
            if metrics.recording():
                metrics.count("arena.reuse.hits")
                metrics.count("arena.reuse.bytes", cls)
            _note_gauges()
            data.zero_()
            return Slab(data, cls, int(nbytes), tag)
    # a new slab: admit first, so that a denied alloc leaves no buffer
    budget.charge(cls, tag=f"arena.{tag}", strict=True)
    data = torch.zeros(cls, dtype=torch.uint8, device=dev)
    with _lock:
        _in_use += cls
        _peak = max(_peak, _in_use + _pooled)
        _dev_in_use[key] = _dev_in_use.get(key, 0) + cls
        _dev_peak[key] = max(_dev_peak.get(key, 0), _dev_in_use[key])
        if metrics.recording():
            metrics.count("arena.alloc.calls")
            metrics.count("arena.alloc.bytes", cls)
        _note_gauges()
    return Slab(data, cls, int(nbytes), tag)


def free(slab: Slab) -> None:
    """Give a slab back to its size class's free list.  Its block stays
    held for the next ``alloc`` of that class; ``trim()`` returns it to
    the caching allocator and the budget.  A second free is a no-op."""
    global _in_use, _pooled
    if slab._freed:
        return
    slab._freed = True
    key = _dev_key(slab.data.device)
    with _lock:
        _free.setdefault((slab.nbytes, key), []).append(slab.data)
        _in_use -= slab.nbytes
        _pooled += slab.nbytes
        _note_gauges()
    slab.data = None


def trim() -> int:
    """Drop every pooled slab and cached zeros tensor; returns the slab
    bytes released."""
    global _pooled, _zeros_bytes
    with _lock:
        released = _pooled
        for (cls, key), stack in _free.items():
            _dev_in_use[key] = max(_dev_in_use.get(key, 0)
                                   - cls * len(stack), 0)
        _free.clear()
        _pooled = 0
        _zeros.clear()
        _zeros_bytes = 0
        _note_gauges()
    budget.release(released)
    return released


def zeros(shape, dtype: torch.dtype, device) -> torch.Tensor:
    """An all-zeros tensor, pooled per (shape, dtype, device) while the
    arena is on: one instance serves every caller, who must not write it
    in place (module docstring).  ``torch.zeros`` when the arena is off,
    under a ``syncs`` replay (a graph capture must own its buffers), or
    past the cap."""
    global _zeros_bytes
    dev = torch.device(device)
    if not budget.active():
        return torch.zeros(shape, dtype=dtype, device=dev)
    shp = tuple(shape) if isinstance(shape, (tuple, list)) else (shape,)
    key = (shp, dtype, _dev_key(dev))
    with _lock:
        hit = _zeros.get(key)
        if hit is not None:
            _zeros.move_to_end(key)
            if metrics.recording():
                metrics.count("arena.zeros.hits")
            return hit
    t = torch.zeros(shp, dtype=dtype, device=dev)
    n = t.numel() * t.element_size()
    cap = _zeros_cap()
    if cap <= 0 or n > cap:
        return t                         # pooling off, or too big to pool
    with _lock:
        _zeros[key] = t
        _zeros_bytes += n
        while _zeros_bytes > cap and len(_zeros) > 1:
            _, old = _zeros.popitem(last=False)
            _zeros_bytes -= old.numel() * old.element_size()
    return t


def pooled_zeros() -> list:
    """The zeros tensors the cache holds now (tests check their
    ``_version``)."""
    with _lock:
        return list(_zeros.values())


_NOOP = contextlib.nullcontext()


@contextlib.contextmanager
def _reserve_cm(nbytes: int, tag: str, strict: bool):
    budget.charge(nbytes, tag=tag, strict=strict)
    if metrics.recording():
        metrics.count("arena.reserve.calls")
        metrics.count(f"arena.reserve.{tag}")
    try:
        yield
    finally:
        budget.release(nbytes)


def reserve(nbytes: int, tag: str = "ephemeral", *, strict: bool = False):
    """Admission context for a transient device buffer of known size:
    charges the budget for the context's lifetime (spilling LRU
    residents under pressure) and releases it on exit.  A shared no-op
    context when the arena is off or a replay is active."""
    if not budget.active() or nbytes <= 0:
        return _NOOP
    return _reserve_cm(int(nbytes), tag, strict)


def stats() -> dict:
    """Arena snapshot: slab ledgers, pool occupancy, per-device bytes,
    the budget's reservations."""
    with _lock:
        return {
            "slab_bytes_in_use": _in_use,
            "pooled_bytes": _pooled,
            "peak_bytes": _peak,
            "zeros_bytes": _zeros_bytes,
            "free_slabs": {f"{cls}@{key}": len(v)
                           for (cls, key), v in _free.items() if v},
            "budget_in_use": budget.in_use(),
            "budget_peak": budget.peak(),
            "device_bytes_in_use": dict(_dev_in_use),
            "device_peak_bytes": dict(_dev_peak),
        }


def reset() -> None:
    """Drop pools and ledgers (tests)."""
    global _in_use, _pooled, _peak, _zeros_bytes
    with _lock:
        _free.clear()
        _zeros.clear()
        _in_use = _pooled = _peak = _zeros_bytes = 0
        _dev_in_use.clear()
        _dev_peak.clear()
