"""Host-sync accounting, the capture/replay size tape, and weak result
caches.

The port's counterpart of the JAX package's ``utils/syncs.py``.  Every
size an op reads back from the device (a filter's count, a join's pair
total, a group count, a string width, a chars total, the join planner's
key window) goes through :func:`scalar`, the one funnel for intentional
device → host reads.  It counts them (:func:`sync_count`), and it is what
makes a whole query capturable (``models/compiled.py``):

* **capture** (:func:`capture`): an eager run that records each resolved
  size, in order, on a tape;
* **replay** (:func:`replay`): a run that takes each size from the tape
  instead of reading the device, so that nothing in it waits for the
  device and every shape is fixed: the run can be captured as one CUDA
  graph.  ``collect`` receives the value that arrived at each call, a
  device tensor, so that the caller can hold the data's true sizes
  against the tape after the fact.

A tape can be stale: the data changed and its true sizes differ.  Each op
keeps every buffer it sizes or indexes by a tape value in bounds whatever
the value (:func:`size` clamps a count into the range its shapes allow),
so that a stale replay computes wrong but harmless values, which the
caller's check then rejects.

The mode and tape are thread-local, as in the JAX module: a capture on
one thread never flips the mode of a query running on another.  Both
modes disable the weak memos (:func:`memo_get` / :func:`memo_put`), so
that capture and replay visit the same sequence of sites.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Any, Optional

from .hostcache import WeakIdMemo

_count = 0
_count_mu = threading.Lock()

_tls = threading.local()    # .mode, .tape, .tape_pos, .seen


class TapeDivergence(RuntimeError):
    """A replay consumed more or fewer sizes than its tape holds: the
    plan took another path than the capture run."""


def mode() -> str:
    return getattr(_tls, "mode", "normal")


@contextlib.contextmanager
def capture(tape: list):
    """An eager run recording every resolved size into ``tape``, in
    order."""
    if mode() != "normal":
        raise RuntimeError(f"cannot capture while in {mode()} mode")
    _tls.mode, _tls.tape = "capture", tape
    try:
        yield tape
    finally:
        _tls.mode, _tls.tape = "normal", []


@contextlib.contextmanager
def replay(tape, collect: Optional[list] = None):
    """A run resolving sizes from ``tape`` instead of reading the device.

    ``collect``, when given, receives the value that arrived at each
    :func:`scalar` call, in tape order.  Raises :class:`TapeDivergence`
    when the run consumes more or fewer sizes than the tape holds."""
    if mode() != "normal":
        raise RuntimeError(f"cannot replay while in {mode()} mode")
    _tls.mode, _tls.tape, _tls.tape_pos, _tls.seen = \
        "replay", list(tape), 0, collect
    try:
        yield
        if _tls.tape_pos != len(_tls.tape):
            raise TapeDivergence(
                f"replay consumed {_tls.tape_pos} of {len(_tls.tape)} "
                "recorded sizes: the plan diverged from the capture run")
    finally:
        _tls.mode, _tls.tape, _tls.tape_pos, _tls.seen = \
            "normal", [], 0, None


def scalar(x) -> int:
    """``int(x)`` with sync accounting: use for every intentional device →
    host scalar.  Under replay it returns the tape's value and reads
    nothing; the value that arrived goes to ``collect`` (a tensor is
    copied, so that a later in-place write cannot change it)."""
    global _count
    if mode() == "replay":
        if _tls.tape_pos >= len(_tls.tape):
            raise TapeDivergence(
                "replay tape exhausted: the plan diverged from the capture "
                "run")
        if _tls.seen is not None:
            _tls.seen.append(x.detach().clone() if hasattr(x, "detach")
                             else x)
        v = _tls.tape[_tls.tape_pos]
        _tls.tape_pos += 1
        return v
    with _count_mu:
        _count += 1
    v = int(x)
    if mode() == "capture":
        _tls.tape.append(v)
    return v


def size(x, upper: Optional[int] = None) -> int:
    """:func:`scalar` of a count, clamped into ``[0, upper]`` (``upper``
    the most its shapes allow, where they bound it).  Eagerly the count
    lies there already; under a stale tape the clamp keeps what the caller
    sizes by it in bounds."""
    v = max(scalar(x), 0)
    return v if upper is None else min(v, upper)


def note_sync(k: int = 1) -> None:
    """Count ``k`` intentional device → host reads that do not flow through
    :func:`scalar` (a stacked size vector's one copy)."""
    global _count
    with _count_mu:
        _count += k


def sync_count() -> int:
    return _count


def reset_sync_count() -> int:
    global _count
    with _count_mu:
        old, _count = _count, 0
    return old


# -- weak memos keyed on tensor identity --------------------------------------
# (the mechanism is the host-mirror cache's, utils/hostcache.py, with no byte
# cap, as in the JAX package)

_MEMOS: dict[str, WeakIdMemo] = {}
_MEMOS_MU = threading.Lock()


def memo_get(tag: str, tensors) -> Any:
    """The cached value for (``tag``, ``tensors``), or None on a miss.
    Disabled under capture and replay."""
    if mode() != "normal":
        return None
    memo = _MEMOS.get(tag)
    return None if memo is None else memo.get(tensors)


def memo_put(tag: str, tensors, value) -> None:
    """Cache ``value`` for (``tag``, ``tensors``); stores nothing under
    capture and replay."""
    if mode() != "normal":
        return
    with _MEMOS_MU:
        memo = _MEMOS.setdefault(tag, WeakIdMemo())
    memo.put(tensors, value)
