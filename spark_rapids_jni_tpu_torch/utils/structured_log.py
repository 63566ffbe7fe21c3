"""Structured logging: one event per line, as text or JSON.

The port's copy of the JAX package's ``utils/structured_log.py``, with
the same knobs, fields and format:

  SPARK_RAPIDS_TPU_LOG=off|text|json     (default off)
  SPARK_RAPIDS_TPU_LOG_FILE=<path>       (default stderr)

``json`` writes one object per line: ``ts``, ``event``, ``duration_ms``
when given, then the fields bound on the thread (:func:`bound`, e.g. the
serving workers' ``request_id``) under the call's own.  Read at process
start; :func:`configure` overrides at runtime.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import threading
import time
from typing import Optional

from ..analysis import sanitize

_lock = sanitize.tracked_lock("utils.structured_log")
_mode: str = os.environ.get("SPARK_RAPIDS_TPU_LOG", "off").lower()
_path: Optional[str] = os.environ.get("SPARK_RAPIDS_TPU_LOG_FILE")
_stream = None
_tls = threading.local()               # per-thread bound context fields


def bind(**fields) -> None:
    """Bind fields onto every subsequent :func:`event` from THIS thread
    (until :func:`unbind`): the serving workers bind ``request_id`` so a
    request's whole log trail greps by one key."""
    ctx = getattr(_tls, "ctx", None)
    if ctx is None:
        ctx = _tls.ctx = {}
    ctx.update(fields)


def unbind(*names) -> None:
    """Drop bound fields by name; no names drops everything."""
    ctx = getattr(_tls, "ctx", None)
    if not ctx:
        return
    if not names:
        ctx.clear()
    for n in names:
        ctx.pop(n, None)


@contextlib.contextmanager
def bound(**fields):
    """Context-managed :func:`bind`: fields apply inside, restore after."""
    ctx = getattr(_tls, "ctx", None)
    saved = dict(ctx) if ctx else {}
    bind(**fields)
    try:
        yield
    finally:
        if getattr(_tls, "ctx", None) is not None:
            _tls.ctx.clear()
            _tls.ctx.update(saved)


def _close_stream_locked() -> None:
    """Close + reset the lazily-opened stream.  Caller holds ``_lock`` —
    every writer goes through :func:`event` (which holds the lock across
    the ``_out()`` lookup AND the write), so no thread can be mid-write on
    the stream being closed."""
    global _stream
    if _stream is not None:
        try:
            _stream.close()
        except ValueError:        # already closed externally
            pass
        _stream = None


def configure(mode: str | None = None, path: str | None = None) -> None:
    """Override the env configuration at runtime ('off'|'text'|'json').

    Lock-consistent with :func:`event`: a path change or a flip to
    ``off`` closes the open stream under the same lock writers hold, so
    concurrent ``event()`` calls either finish on the old stream or open
    the new one — never write to a closed file."""
    global _mode, _path
    with _lock:
        if mode is not None:
            _mode = mode.lower()
            if _mode == "off":
                _close_stream_locked()
        if path is not None:
            _path = path
            _close_stream_locked()


def enabled() -> bool:
    return _mode in ("text", "json")


def _out():
    """The output stream.  Caller must hold ``_lock``; reopens if a
    ``configure`` closed the stream since the last write."""
    global _stream
    if _path is None:
        return sys.stderr
    if _stream is None or _stream.closed:
        _stream = open(_path, "a", buffering=1)
    return _stream


def event(name: str, duration_s: float | None = None, **fields) -> None:
    """Emit one structured event (no-op when the knob is off).  Fields
    bound on this thread via :func:`bind` merge in under the call's own
    fields (explicit wins)."""
    if not enabled():
        return
    ctx = getattr(_tls, "ctx", None)
    if ctx:
        fields = {**ctx, **fields}
    with _lock:
        if not enabled():         # re-check: racing configure(mode='off')
            return
        out = _out()
        if _mode == "json":
            rec = {"ts": time.time(), "event": name}
            if duration_s is not None:
                rec["duration_ms"] = round(duration_s * 1e3, 3)
            rec.update(fields)
            out.write(json.dumps(rec) + "\n")
        else:
            extra = " ".join(f"{k}={v}" for k, v in fields.items())
            dur = (f" {duration_s * 1e3:.3f}ms"
                   if duration_s is not None else "")
            out.write(f"[srjt] {name}{dur}{' ' + extra if extra else ''}\n")
        out.flush()
