"""Runtime sanitizers: lock-order watchdog + recapture tripwire.

The port's copy of the JAX package's ``analysis/sanitize.py``.
``SRJT_SANITIZE=1`` arms both sanitizers in incident mode: violations
file a flight-recorder incident (kind ``lock_order`` or ``retrace``) with
the offending stacks and keep going.  ``SRJT_SANITIZE=strict`` raises
instead.

Lock-order watchdog
    Lock sites create their primitives through :func:`tracked_lock` /
    :func:`tracked_rlock` (and build conditions as
    ``threading.Condition(tracked_lock("name"))``).  Off (the default),
    these return plain ``threading`` primitives, chosen once at
    creation.  On, each wrapper keeps a per-thread held stack and a
    process-global acquisition DAG: acquiring M while holding L records
    edge L→M with the first-seen acquisition stack; if a path M→…→L
    already exists, two threads can deadlock by entering from opposite
    ends, and that is the violation.  Reentrant reacquisition (RLocks)
    records no edge.  The watchdog's own mutex is held only for graph
    bookkeeping, never while blocking on a user lock.

Recapture tripwire
    ``models/compiled.py`` calls :func:`note_trace(key)` on each CUDA-graph
    capture of a plan, where the JAX package calls it on each XLA trace.
    The first capture per key is warm-up; any further one outside
    :func:`allow_retrace` (a capture for tables of other shapes, a stale
    plan captured again) trips.

Stdlib and the stdlib-only ``utils/knobs.py`` at module level: the
metrics and flight modules import it.
"""

from __future__ import annotations

import contextlib
import threading
import traceback
from typing import Optional

from ..utils import knobs

__all__ = ["mode", "enabled", "strict", "tracked_lock", "tracked_rlock",
           "note_trace", "allow_retrace", "reset",
           "LockOrderError", "RetraceError"]


def mode() -> str:
    """``"off"`` | ``"on"`` | ``"strict"`` — read from the environment on
    every call (lock sites sample it once at creation)."""
    raw = (knobs.get("SRJT_SANITIZE") or "").strip().lower()
    if raw in ("", "0", "off", "false"):
        return "off"
    return "strict" if raw == "strict" else "on"


def enabled() -> bool:
    return mode() != "off"


def strict() -> bool:
    return mode() == "strict"


class LockOrderError(RuntimeError):
    """Strict-mode lock-order inversion."""


class RetraceError(RuntimeError):
    """Strict-mode unexpected recapture."""


# --- lock-order watchdog ----------------------------------------------------

_tls = threading.local()            # .held: list[str], .suppress: bool
_mu = threading.Lock()              # guards the three dicts below ONLY
_graph: dict[str, set[str]] = {}    # edge a -> b: acquired b while holding a
_edge_stacks: dict[tuple, str] = {}  # first-seen stack per edge
_violations: list[dict] = []        # recorded inversions (tests/ops)


def _held() -> list:
    h = getattr(_tls, "held", None)
    if h is None:
        h = _tls.held = []
    return h


def _path(graph: dict, a: str, b: str) -> Optional[list]:
    """A path a→…→b in ``graph`` (callers hold ``_mu``), else None."""
    stack = [(a, [a])]
    seen = {a}
    while stack:
        node, path = stack.pop()
        for nxt in graph.get(node, ()):
            if nxt == b:
                return path + [b]
            if nxt not in seen:
                seen.add(nxt)
                stack.append((nxt, path + [nxt]))
    return None


def _on_acquired(name: str) -> None:
    """Record edges held→name; detect inversions.  Called after the inner
    lock is held; takes only ``_mu`` and only briefly."""
    if getattr(_tls, "suppress", False):
        return
    held = _held()
    if name in held:                 # reentrant (RLock): no edge, no push
        held.append(name)
        return
    inversion = None
    if held:
        uniq = []
        for h in held:
            if h != name and h not in uniq:
                uniq.append(h)
        with _mu:
            for h in uniq:
                cyc = _path(_graph, name, h)
                if cyc is not None:
                    if inversion is None:
                        inversion = {
                            "acquiring": name,
                            "while_holding": h,
                            "established_path": cyc,
                            "prior_stack": _edge_stacks.get(
                                (cyc[0], cyc[1]), "<unknown>"),
                        }
                    # do NOT record the cycle-closing edge: the graph
                    # stays a DAG of established orders, so the correct
                    # order keeps working and every future inverted
                    # acquisition still trips
                    continue
                edge = (h, name)
                if name not in _graph.setdefault(h, set()):
                    _graph[h].add(name)
                    _edge_stacks[edge] = "".join(
                        traceback.format_stack(limit=12))
            if inversion is not None:
                _violations.append(inversion)
    held.append(name)
    if inversion is not None:
        _report_lock_order(inversion)


def _on_released(name: str) -> None:
    held = _held()
    for i in range(len(held) - 1, -1, -1):
        if held[i] == name:
            del held[i]
            return


def _report_lock_order(v: dict) -> None:
    _tls.suppress = True
    try:
        here = "".join(traceback.format_stack(limit=12))
        try:
            from ..utils import flight
            flight.incident(
                "lock_order",
                acquiring=v["acquiring"],
                while_holding=v["while_holding"],
                established_path=" -> ".join(v["established_path"]),
                stack=here,
                prior_stack=v["prior_stack"])
        except Exception:
            pass
        if strict():
            raise LockOrderError(
                f"lock-order inversion: acquiring {v['acquiring']!r} while "
                f"holding {v['while_holding']!r}, but the established "
                f"order is {' -> '.join(v['established_path'])}\n"
                f"--- first-seen acquisition stack ---\n{v['prior_stack']}")
    finally:
        _tls.suppress = False


class _TrackedLock:
    """A ``threading.Lock`` that feeds the watchdog.  Works as the inner
    lock of a ``threading.Condition`` (supports the ``acquire(0)``
    probe its ``_is_owned`` fallback uses)."""

    _reentrant = False

    def __init__(self, name: str):
        self._name = name
        self._inner = self._make()

    @staticmethod
    def _make():
        return threading.Lock()

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            try:
                _on_acquired(self._name)
            except BaseException:
                # strict-mode LockOrderError: back the acquisition out so
                # the caller's `with` (whose __exit__ never runs) does not
                # leave the lock held forever
                _on_released(self._name)
                self._inner.release()
                raise
        return ok

    def release(self) -> None:
        _on_released(self._name)
        self._inner.release()

    def locked(self) -> bool:
        return self._inner.locked()

    def __enter__(self):
        if not self.acquire():
            raise RuntimeError(f"failed to acquire {self._name}")
        return self

    def __exit__(self, *exc) -> bool:
        self.release()
        return False

    def __repr__(self) -> str:
        kind = "rlock" if self._reentrant else "lock"
        return f"<tracked {kind} {self._name!r}>"


class _TrackedRLock(_TrackedLock):
    _reentrant = True

    @staticmethod
    def _make():
        return threading.RLock()

    def locked(self) -> bool:            # RLock has no .locked() pre-3.12
        if self._inner.acquire(blocking=False):
            self._inner.release()
            return False
        return True


def tracked_lock(name: str):
    """A mutex named for the watchdog's graph; plain ``threading.Lock``
    when the sanitizer is off (decided here, at creation)."""
    if not enabled():
        return threading.Lock()
    return _TrackedLock(name)


def tracked_rlock(name: str):
    if not enabled():
        return threading.RLock()
    return _TrackedRLock(name)


# --- retrace tripwire -------------------------------------------------------

_trace_counts: dict[str, int] = {}
_retrace_events: list[dict] = []


def note_trace(key: str) -> None:
    """One call = one graph capture of plan ``key`` (the JAX package: one
    XLA trace).  First is warm-up; later ones outside
    :func:`allow_retrace` trip the wire."""
    if not enabled():
        return
    if getattr(_tls, "allow_retrace", 0) > 0:
        return
    with _mu:
        n = _trace_counts.get(key, 0) + 1
        _trace_counts[key] = n
    if n <= 1:
        return
    ev = {"key": key, "count": n,
          "stack": "".join(traceback.format_stack(limit=16))}
    with _mu:
        _retrace_events.append(ev)
    _tls.suppress = True
    try:
        try:
            from ..utils import flight
            flight.incident("retrace", plan_key=key, compiles=n,
                            stack=ev["stack"])
        except Exception:
            pass
        if strict():
            raise RetraceError(
                f"unexpected recapture: plan {key!r} captured {n} times "
                f"(the first is warm-up; wrap legitimate rebuilds in "
                f"sanitize.allow_retrace())\n{ev['stack']}")
    finally:
        _tls.suppress = False


@contextlib.contextmanager
def allow_retrace():
    """Legitimise recaptures in the dynamic extent."""
    prev = getattr(_tls, "allow_retrace", 0)
    _tls.allow_retrace = prev + 1
    try:
        yield
    finally:
        _tls.allow_retrace = prev


# --- introspection / tests --------------------------------------------------


def violations() -> list[dict]:
    with _mu:
        return list(_violations)


def retrace_events() -> list[dict]:
    with _mu:
        return list(_retrace_events)


def reset() -> None:
    """Drop the acquisition graph, recorded violations, and trace counts
    (tests).  Held stacks are per-thread and owned by their threads."""
    with _mu:
        _graph.clear()
        _edge_stacks.clear()
        _violations.clear()
        _trace_counts.clear()
        _retrace_events.clear()
