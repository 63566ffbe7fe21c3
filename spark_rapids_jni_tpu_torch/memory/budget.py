"""Per-query device-memory budgets with admission control.

The port's copy of the JAX package's ``memory/budget.py``.  PyTorch's
caching allocator owns the card's memory, so the budget works at the
level the engine *can* see: every large allocation site declares its
bytes here BEFORE launching, and the ledger answers admit /
spill-then-admit / reject.

Ledger model
------------
One process-wide ledger (``in_use`` / ``peak``) plus an optional
per-query :class:`QueryBudget` stack (thread-local).  The effective limit
at any charge is the innermost query budget's limit, else the process
limit: ``SRJT_HBM_BUDGET`` when set, else the card's memory
(``torch.cuda.mem_get_info``).  A query budget opened without a limit
takes :func:`default_limit`: the knob, else the recorded pair-expansion
histogram's rule, else the card's memory.  A charge that would exceed the limit
first asks ``memory.spill`` to reclaim LRU residents; if still over:

* ``strict=True``  — the charge rolls back and :class:`HbmBudgetExceeded`
  raises;
* ``strict=False`` — the charge stands and ``arena.budget.soft_over``
  counts (an admitted query must COMPLETE: the soft path records the
  pressure instead of failing the query).

``SRJT_HBM_BUDGET`` accepts ``512m`` / ``2g`` / plain bytes; empty /
``none`` / ``unlimited`` means no limit.  Setting it, or
``SRJT_HBM_ARENA``, switches the ledger on (``memory/arena.py``).
Nothing here syncs a device value: all byte counts arrive as host ints.
"""

from __future__ import annotations

import contextlib
import os
import threading
from typing import Optional

from ..analysis import sanitize
from ..utils import flight, knobs, metrics

_LOCK = sanitize.tracked_rlock("memory.budget")      # shared with memory.spill (lock order:
#                                budget → spill registry, never reversed)

#: pair-expansion working set per output pair in ``ops/join.py``: the
#: int64 lanes of the repeat, the positions and the build rows, and the
#: matched mask (the JAX package's figure)
PAIR_EXPANSION_BYTES = 40
#: :func:`default_limit`'s headroom over the largest recorded expansion,
#: and its floor (the JAX package's figures)
_HEADROOM = 4.0
_FLOOR_BYTES = 64 << 20


def _from_env() -> bool:
    return (knobs.get("SRJT_HBM_ARENA")
            or bool(knobs.get("SRJT_HBM_BUDGET")))


_enabled: bool = _from_env()


class HbmBudgetExceeded(RuntimeError):
    """A strict charge exceeded the active budget even after spilling."""

    def __init__(self, requested: int, in_use: int, limit: int,
                 query: Optional[str], tag: str):
        self.requested = int(requested)
        self.in_use = int(in_use)
        self.limit = int(limit)
        self.query = query
        self.tag = tag
        super().__init__(
            f"HBM budget exceeded: {tag} wants {requested} B with "
            f"{in_use} B in use, limit {limit} B"
            + (f" (query {query})" if query else "")
            + " — raise SRJT_HBM_BUDGET or free residents")


def enabled() -> bool:
    return _enabled


def set_enabled(on: Optional[bool] = None) -> None:
    """Toggle the ledger; ``None`` re-reads the env knobs."""
    global _enabled
    if on is None:
        _enabled = _from_env()
    else:
        _enabled = bool(on)


def active() -> bool:
    """True when charges should be taken NOW: the ledger on, and not
    inside a ``syncs.replay`` (the replay re-runs plan Python whose
    allocations were already admitted by the capture run)."""
    if not _enabled:
        return False
    from ..utils import syncs
    return syncs.mode() != "replay"


parse_bytes = knobs.parse_bytes


class QueryBudget:
    """One query's admission scope: a limit plus its own peak tracking."""

    __slots__ = ("name", "limit", "charged", "peak")

    def __init__(self, name: str, limit: Optional[int]):
        self.name = name
        self.limit = limit
        self.charged = 0           # bytes this query charged (net)
        self.peak = 0              # high-water of the PROCESS ledger


class _Ledger:
    __slots__ = ("in_use", "peak")

    def __init__(self):
        self.in_use = 0
        self.peak = 0


_process = _Ledger()
_tls = threading.local()


def _stack() -> list:
    st = getattr(_tls, "stack", None)
    if st is None:
        st = _tls.stack = []
    return st


def current() -> Optional[QueryBudget]:
    st = getattr(_tls, "stack", None)
    return st[-1] if st else None


_card_bytes: dict = {}


def card_bytes() -> Optional[int]:
    """The current card's memory in bytes (``torch.cuda.mem_get_info``'s
    total, read once per card), or None without a card."""
    import torch
    if not torch.cuda.is_available():
        return None
    i = torch.cuda.current_device()
    if i not in _card_bytes:
        _card_bytes[i] = int(torch.cuda.mem_get_info(i)[1])
    return _card_bytes[i]


def process_limit() -> Optional[int]:
    """``SRJT_HBM_BUDGET`` when set, else the card's memory."""
    env = parse_bytes(knobs.get("SRJT_HBM_BUDGET"))
    return env if env is not None else card_bytes()


def limit_now() -> Optional[int]:
    q = current()
    if q is not None and q.limit is not None:
        return q.limit
    return process_limit()


def default_limit() -> Optional[int]:
    """A query's limit when it names none: ``SRJT_HBM_BUDGET`` when set,
    else the largest recorded ``join.expand.pair_elements`` ×
    :data:`PAIR_EXPANSION_BYTES` × 4 headroom, floored at 64 MiB (the
    JAX package's ``default_limit``), else the card's memory.  Without
    the knob and the histogram the JAX package has no limit (None); here
    the card's bytes stand for it, and None only without a card."""
    env = parse_bytes(knobs.get("SRJT_HBM_BUDGET"))
    if env is not None:
        return env
    most = metrics.histogram_max("join.expand.pair_elements")
    if most is not None:
        return max(int(most * PAIR_EXPANSION_BYTES * _HEADROOM),
                   _FLOOR_BYTES)
    return card_bytes()


def in_use() -> int:
    return _process.in_use


def peak() -> int:
    return _process.peak


def reset() -> None:
    """Zero the ledgers (tests)."""
    with _LOCK:
        _process.in_use = 0
        _process.peak = 0
        _tls.stack = []


def _note_gauges() -> None:
    if metrics.recording():
        metrics.gauge("arena.bytes_in_use", _process.in_use)
        metrics.gauge_max("arena.peak_bytes", _process.peak)


def charge(nbytes: int, tag: str = "buf", *, strict: bool = False) -> bool:
    """Admit ``nbytes`` against the active budget.

    Over-limit charges first ask the spill registry to reclaim the
    deficit from LRU residents.  Returns True when the charge fits (or no
    limit applies); strict charges raise :class:`HbmBudgetExceeded`
    instead of standing over-limit."""
    if not active() or nbytes <= 0:
        return True
    n = int(nbytes)
    exc = None
    with _LOCK:
        _process.in_use += n
        limit = limit_now()
        if limit is not None and _process.in_use > limit:
            from . import spill
            spill.reclaim(_process.in_use - limit)
        fits = limit is None or _process.in_use <= limit
        if not fits and strict:
            _process.in_use -= n
            q = current()
            if metrics.recording():
                metrics.count("arena.budget.denied")
            exc = HbmBudgetExceeded(n, _process.in_use, limit,
                                    q.name if q else None, tag)
    if exc is not None:
        # incident fires OUTSIDE the ledger lock: the snapshot samples
        # live probes (scheduler queue depth etc.) that take their own
        # locks, and the black box must never order-invert against them
        flight.incident("hbm_budget", query=exc.query, tag=tag,
                        requested=n, in_use=exc.in_use, limit=exc.limit)
        raise exc
    with _LOCK:
        _process.peak = max(_process.peak, _process.in_use)
        q = current()
        if q is not None:
            q.charged += n
            q.peak = max(q.peak, _process.in_use)
        if not fits and metrics.recording():
            metrics.count("arena.budget.soft_over")
        _note_gauges()
        return fits


def release(nbytes: int) -> None:
    if not _enabled or nbytes <= 0:
        return
    with _LOCK:
        _process.in_use = max(_process.in_use - int(nbytes), 0)
        q = current()
        if q is not None:
            q.charged -= int(nbytes)
        _note_gauges()


@contextlib.contextmanager
def query_budget(name: str, limit_bytes=None, device=None, **attrs):
    """Per-query admission scope, composed with ``metrics.query_span``.

    ``limit_bytes`` accepts ints or ``"512m"`` strings; None sizes from
    ``SRJT_HBM_BUDGET`` / the pair-expansion histogram / the card
    (:func:`default_limit`).  ``device`` labels the scope
    with the replica device serving the query (e.g. ``"cuda:1"``): the
    span is annotated and
    a per-device peak gauge recorded, so a multi-replica scheduler's arena
    pressure decomposes by device.  On exit the query span is annotated
    with the arena peak and the query's net spill activity, so Chrome
    traces carry the budget story next to the stage tree."""
    limit = parse_bytes(limit_bytes) if limit_bytes is not None \
        else default_limit()
    q = QueryBudget(name, limit)
    snap0 = metrics.snapshot()["counters"] if metrics.recording() else {}
    if device is not None:
        attrs = dict(attrs, device=device)
    with metrics.query_span(name, budget_bytes=limit or 0, **attrs) as sp:
        _stack().append(q)
        try:
            yield q
        finally:
            st = _stack()
            if st and st[-1] is q:
                st.pop()
            if sp is not None:
                snap1 = metrics.snapshot()["counters"]
                sp.annotate(
                    arena_peak_bytes=q.peak,
                    arena_spills=int(
                        snap1.get("arena.spill.events", 0)
                        - snap0.get("arena.spill.events", 0)))
            if metrics.recording():
                metrics.gauge_max("arena.query.peak_bytes", q.peak)
                if device is not None:
                    metrics.gauge_max(
                        "arena.query.peak_bytes."
                        + str(device).replace(":", ""), q.peak)
