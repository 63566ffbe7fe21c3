"""Always-on flight recorder: the serving runtime's black box.

The port's copy of the JAX package's ``utils/flight.py``.  ``utils.metrics``
answers "how fast" when someone turned it on BEFORE the run; incidents
happen when nobody did.  This module keeps a bounded, thread-safe ring
buffer of recent request/stage/event records that runs EVEN WHEN the
metrics knobs are off, and on any incident dumps a structured JSON
snapshot an operator can read cold.

Discipline
----------
* **Cheap enough to never turn off.**  One event is one small dict built
  by the caller and one ``deque.append`` under a lock; record sites are
  per-REQUEST (submit, dequeue, admit, launch, resolve), never per row.
* **Records are atomic.**  An event dict is fully built before it enters
  the ring and never mutated after; concurrent writers interleave whole
  records, never fields.
* **Incidents never raise.**  A failed snapshot write is a counter, not a
  second failure riding the first.

Knobs
-----
  SRJT_FLIGHT=0|1            master gate (default ON — this is the
                             black box; turning it off is the exception)
  SRJT_FLIGHT_N=<n>          ring capacity in events (default 512)
  SRJT_INCIDENT_DIR=<dir>    where incident snapshots land; unset means
                             incidents are counted + ring-recorded but
                             not written to disk
  SRJT_INCIDENT_PER_KIND=<n> per-kind snapshot cap per process (default
                             5 — a breach storm must not fill the disk)

Snapshot shape (one JSON object per file)::

  {"kind": ..., "ts": ..., "request_id": ..., "batch": [...],
   "fields": {...},          # incident-site details
   "events": [...],          # the ring, oldest → newest
   "metrics": {...},         # counters/gauges/histograms snapshot
   "probes": {...}}          # live registered probes (queue depth,
                             # plan-cache stats, arena gauges, ...)
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time
from typing import Any, Callable, Optional

from ..analysis import sanitize
from . import knobs, metrics, structured_log

_enabled: bool = knobs.get("SRJT_FLIGHT")

_lock = sanitize.tracked_lock("utils.flight")
_ring: "collections.deque[dict]" = collections.deque(
    maxlen=max(knobs.get("SRJT_FLIGHT_N"), 8))
_probes: dict[str, Callable[[], Any]] = {}
_incident_counts: dict[str, int] = {}
_incident_seq = 0


def enabled() -> bool:
    return _enabled


def set_enabled(on: Optional[bool] = None) -> None:
    """Toggle the recorder at runtime; ``None`` re-reads the env knob."""
    global _enabled
    if on is None:
        _enabled = knobs.get("SRJT_FLIGHT")
    else:
        _enabled = bool(on)


def set_capacity(n: int) -> None:
    """Resize the ring (tests); keeps the newest events."""
    global _ring
    with _lock:
        _ring = collections.deque(_ring, maxlen=max(int(n), 8))


def reset() -> None:
    """Drop every recorded event and incident budget (tests)."""
    with _lock:
        _ring.clear()
        _incident_counts.clear()


def record(kind: str, **fields) -> None:
    """Append one event to the ring.  The dict is complete before it
    enters the ring — concurrent appends interleave records, not keys."""
    if not _enabled:
        return
    ev = {"ts": round(time.time(), 6), "tid": threading.get_ident(),
          "kind": kind}
    ev.update(fields)
    with _lock:
        _ring.append(ev)


def events(last: Optional[int] = None, *,
           request_id: Optional[str] = None) -> list[dict]:
    """The ring's events oldest → newest (copies).  ``last`` keeps only
    the newest N; ``request_id`` filters to one request's lifecycle."""
    with _lock:
        evs = list(_ring)
    if request_id is not None:
        evs = [e for e in evs
               if e.get("rid") == request_id
               or request_id in (e.get("batch") or ())]
    if last is not None:
        evs = evs[-int(last):]
    return [dict(e) for e in evs]


# --- live-state probes ------------------------------------------------------


def register_probe(name: str, fn: Callable[[], Any]) -> None:
    """Register a zero-arg callable sampled into every incident snapshot
    (scheduler queue depth, plan-cache stats, admission in-flight bytes).
    Re-registering a name replaces the previous probe."""
    with _lock:
        _probes[name] = fn


def unregister_probe(name: str) -> None:
    with _lock:
        _probes.pop(name, None)


def sample_probes() -> dict:
    """Every registered probe's current value; a probe that raises
    reports its error string instead of killing the snapshot."""
    with _lock:
        items = list(_probes.items())
    out = {}
    for name, fn in items:
        try:
            out[name] = fn()
        except Exception as e:          # incident paths must not re-fail
            out[name] = f"<probe error: {e!r}>"
    return out


# --- incidents --------------------------------------------------------------


def incident_dir() -> Optional[str]:
    return knobs.get("SRJT_INCIDENT_DIR")


def incident(kind: str, *, request_id: Optional[str] = None,
             batch: Optional[list] = None, **fields) -> Optional[str]:
    """Record an incident: one ring event + ``flight.incidents`` counter
    + structured log line always; a JSON snapshot file when
    ``SRJT_INCIDENT_DIR`` is set and the per-kind cap allows.  Returns
    the snapshot path (None when not written).  Never raises."""
    global _incident_seq
    try:
        record(f"incident:{kind}", rid=request_id, batch=batch, **fields)
        if metrics.enabled():
            metrics.count("flight.incidents", in_trace=True)
            metrics.count(f"flight.incident.{kind}", in_trace=True)
        structured_log.event(f"incident.{kind}", request_id=request_id,
                             **{k: v for k, v in fields.items()
                                if isinstance(v, (str, int, float, bool))})
        out_dir = incident_dir()
        if not _enabled or out_dir is None:
            return None
        cap = max(knobs.get("SRJT_INCIDENT_PER_KIND"), 1)
        with _lock:
            n = _incident_counts.get(kind, 0)
            if n >= cap:
                return None
            _incident_counts[kind] = n + 1
            _incident_seq += 1
            seq = _incident_seq
        snap = {
            "kind": kind,
            "ts": round(time.time(), 6),
            "request_id": request_id,
            "batch": list(batch) if batch else [],
            "fields": fields,
            "events": events(),
            "metrics": metrics.snapshot(),
            "probes": sample_probes(),
        }
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(
            out_dir, f"incident-{kind}-{os.getpid()}-{seq}.json")
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(snap, f, indent=1, default=repr)
        os.replace(tmp, path)          # readers never see a torn file
        return path
    except Exception:
        try:
            if metrics.enabled():
                metrics.count("flight.incident.write_failed", in_trace=True)
        except Exception:
            pass
        return None
