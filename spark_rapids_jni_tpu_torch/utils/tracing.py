"""Tracing hooks: named ranges around the public entries.

The port's counterpart of the JAX package's ``utils/tracing.py``.  The
reference instruments every public entry with NVTX ranges
(``CUDF_FUNC_RANGE()``); here a range is a ``torch.profiler`` range (a
row of ``torch.profiler``'s trace and of ``key_averages()``), opened
while a profiler records, and, when a card is present, an NVTX range of
the same name (``torch.cuda.nvtx.range_push``/``range_pop``) for external
timeline tools.  The JAX package's ``jax.named_scope`` and
``TraceAnnotation`` have no other counterpart.

The knob (``SPARK_RAPIDS_TPU_TRACE``, default on) is read at import and
re-checkable at runtime: :func:`set_enabled` flips it.

A recorded ``utils.metrics`` span opens its range here too
(:func:`range_push` / :func:`range_pop`), so the span tree and the
profiler's trace are one record on one clock.  ``@traced`` entries feed
two sinks besides when their knobs are on, as the JAX package's do:

* ``utils.structured_log`` — one event record with wall-time duration per
  call;
* ``utils.metrics`` — one span in the per-query span tree, which opens
  the entry's range.
"""

from __future__ import annotations

import contextlib
import functools
import os
import time
from typing import Optional

import torch
import torch.autograd.profiler as _autograd_profiler
# the profiler's range at a fraction of ``record_function``'s cost
from torch._C._profiler import _RecordFunctionFast


def _read_env() -> bool:
    return os.environ.get("SPARK_RAPIDS_TPU_TRACE", "1") not in ("0", "false")


_ENABLED = _read_env()


def enabled() -> bool:
    return _ENABLED


def set_enabled(on: Optional[bool] = None) -> None:
    """Toggle tracing at runtime; ``None`` re-reads the env knob."""
    global _ENABLED
    _ENABLED = _read_env() if on is None else bool(on)


def range_push(name: str):
    """Open range ``name``: a ``torch.profiler`` range while a profiler
    records (none otherwise: a range costs microseconds, and one opened
    before a profiler starts is not in its trace), and an NVTX range on a
    card.  Returns the handle :func:`range_pop` closes (None when tracing
    is off); both calls are made on one thread."""
    if not _ENABLED:
        return None
    rf = None
    if _autograd_profiler._is_profiler_enabled:
        rf = _RecordFunctionFast(name)
        rf.__enter__()
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    return rf, nvtx


def range_pop(handle) -> None:
    """Close a range :func:`range_push` opened."""
    if handle is None:
        return
    rf, nvtx = handle
    if nvtx:
        torch.cuda.nvtx.range_pop()
    if rf is not None:
        rf.__exit__(None, None, None)


@contextlib.contextmanager
def func_range(name: str):
    """The NVTX-range analog: :func:`range_push`'s ranges around the
    block.  Nothing when tracing is off."""
    handle = range_push(name)
    try:
        yield
    finally:
        range_pop(handle)


def traced(name: str | None = None):
    """Decorator form of :func:`func_range` (the CUDF_FUNC_RANGE analog).

    With metrics on (``SPARK_RAPIDS_TPU_METRICS``), each call records one
    span in the current span tree, which opens the range; with the
    structured log on (``SPARK_RAPIDS_TPU_LOG``), each call emits one
    event record with its wall-time duration."""

    def wrap(fn):
        scope = name or fn.__qualname__

        @functools.wraps(fn)
        def inner(*args, **kwargs):
            from . import metrics
            from . import structured_log as slog
            rec = metrics.recording()
            log = slog.enabled()
            if not (rec or log):
                with func_range(scope):
                    return fn(*args, **kwargs)
            t0 = time.perf_counter()
            with metrics.span(scope) if rec else func_range(scope):
                out = fn(*args, **kwargs)
            if log:
                slog.event(scope, duration_s=time.perf_counter() - t0)
            return out

        return inner

    return wrap
