"""Host mirrors of device metadata tensors (offsets), weakly cached.

The port's counterpart of the JAX package's ``utils/hostcache.py``.  The
variable-width paths want string offsets on the host (batch splits,
slices, ``to_pylist``), and those offsets are almost always *born* on
the host (``Column.strings_from_arrays``, the Parquet decode), so the
producers seed this cache and the consumers get their host copy back
without a device → host copy.

Entries key on the identity of the device tensor: a weak reference (the
entry drops when the tensor dies) and its ``_version`` (an in-place write
makes the mirror miss), as the port's other weak memos do.  The cache is
an optimisation only: a miss copies.  The host-mirror instance is
byte-capped (``SRJT_HOSTCACHE_CAP``, default 256 MiB): past the cap the
least recently used mirror goes and ``arena.hostcache.evictions`` counts
it.

:class:`WeakIdMemo` is also the mechanism behind ``utils.syncs``'s
memos, which set no cap.
"""

from __future__ import annotations

import threading
import weakref
from collections import OrderedDict
from typing import Any, Callable, Optional

import numpy as np
import torch


class WeakIdMemo:
    """A cache keyed on the identity of one or more tensors: an entry holds
    a weak reference to each, drops when one dies, and misses when one was
    written in place since (its ``_version``) or its id was recycled.

    ``cap_bytes`` (a value or a zero-argument callable, None: unbounded)
    makes it an LRU over the values' ``nbytes``; ``on_evict`` fires once
    per eviction past the cap (not for a tensor's death), after the lock
    is released, so that it may take other locks."""

    def __init__(self, cap_bytes=None,
                 on_evict: Optional[Callable[[], None]] = None) -> None:
        self._d: "OrderedDict[tuple, tuple]" = OrderedDict()
        self._bytes = 0
        self._cap = cap_bytes
        self._on_evict = on_evict
        # reentrant: a weak reference's callback can fire at a collection
        # point inside put, on the thread that holds the lock
        self._mu = threading.RLock()

    def _cap_now(self) -> Optional[int]:
        c = self._cap
        return c() if callable(c) else c

    def _drop(self, key) -> None:
        with self._mu:
            entry = self._d.pop(key, None)
            if entry is not None:
                self._bytes -= entry[3]

    def get(self, tensors) -> Any:
        key = tuple(id(t) for t in tensors)
        with self._mu:
            entry = self._d.get(key)
            if entry is None:
                return None
            refs, versions, value, _ = entry
            for r, v, t in zip(refs, versions, tensors):
                if r() is not t or t._version != v:
                    return None
            self._d.move_to_end(key)
            return value

    def put(self, tensors, value) -> None:
        key = tuple(id(t) for t in tensors)
        try:
            refs = tuple(weakref.ref(t, lambda _, k=key: self._drop(k))
                         for t in tensors)
        except TypeError:
            return                      # not weak-referenceable: no entry
        nbytes = int(getattr(value, "nbytes", 0) or 0)
        evictions = 0
        with self._mu:
            self._drop(key)
            self._d[key] = (refs, tuple(t._version for t in tensors),
                            value, nbytes)
            self._bytes += nbytes
            cap = self._cap_now()
            if cap is not None:
                while self._bytes > cap and len(self._d) > 1:
                    lru = next(iter(self._d))
                    if lru == key:
                        break
                    self._drop(lru)
                    evictions += 1
        if self._on_evict is not None:
            for _ in range(evictions):
                self._on_evict()

    def nbytes(self) -> int:
        return self._bytes

    def __len__(self) -> int:
        return len(self._d)


def _host_cap() -> Optional[int]:
    from . import knobs
    return knobs.parse_bytes(knobs.get("SRJT_HOSTCACHE_CAP"))


def _count_host_eviction() -> None:
    from . import metrics
    if metrics.recording():
        metrics.count("arena.hostcache.evictions")


_HOST = WeakIdMemo(cap_bytes=_host_cap, on_evict=_count_host_eviction)


def seed(device_t: torch.Tensor, host: np.ndarray) -> None:
    """Record ``host`` as the host mirror of ``device_t``."""
    _HOST.put((device_t,), host)


def peek(device_t: torch.Tensor) -> Optional[np.ndarray]:
    """The cached host mirror, or None; never copies.  Misses under a
    ``syncs`` capture or replay, as the JAX package's does, so that the
    two visit the same sites."""
    from . import syncs
    if syncs.mode() != "normal":
        return None
    return _HOST.get((device_t,))


def host_i64(device_t: torch.Tensor) -> np.ndarray:
    """Host int64 copy of a device int tensor, cached across calls."""
    h = peek(device_t)
    if h is not None:
        return h if h.dtype == np.int64 else h.astype(np.int64)
    out = device_t.cpu().numpy().astype(np.int64)
    seed(device_t, out)
    return out


def stats() -> dict:
    """Mirrors held and their bytes."""
    return {"entries": len(_HOST), "bytes": _HOST.nbytes()}
