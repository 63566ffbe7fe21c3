"""Tracing hooks: named ranges around the public entries.

The port's counterpart of the JAX package's ``utils/tracing.py``.  The
reference instruments every public entry with NVTX ranges
(``CUDF_FUNC_RANGE()``); here a range is a ``torch.profiler``
``record_function`` (a row of ``torch.profiler``'s trace and of
``key_averages()``) and, when a card is present, an NVTX range of the
same name (``torch.cuda.nvtx.range_push``/``range_pop``) for external
timeline tools.  The JAX package's ``jax.named_scope`` and
``TraceAnnotation`` have no other counterpart.

The knob (``SPARK_RAPIDS_TPU_TRACE``, default on) is read at import and
re-checkable at runtime: :func:`set_enabled` flips it.

``@traced`` entries additionally feed two sinks when their knobs are on,
as the JAX package's do:

* ``utils.structured_log`` — one event record with wall-time duration per
  call;
* ``utils.metrics`` — one span in the per-query span tree.
"""

from __future__ import annotations

import contextlib
import functools
import os
import time
from typing import Optional

import torch
from torch.profiler import record_function


def _read_env() -> bool:
    return os.environ.get("SPARK_RAPIDS_TPU_TRACE", "1") not in ("0", "false")


_ENABLED = _read_env()


def enabled() -> bool:
    return _ENABLED


def set_enabled(on: Optional[bool] = None) -> None:
    """Toggle tracing at runtime; ``None`` re-reads the env knob."""
    global _ENABLED
    _ENABLED = _read_env() if on is None else bool(on)


@contextlib.contextmanager
def func_range(name: str):
    """The NVTX-range analog: a ``record_function`` range, and an NVTX
    range on a card.  Nothing when tracing is off."""
    if not _ENABLED:
        yield
        return
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


def traced(name: str | None = None):
    """Decorator form of :func:`func_range` (the CUDF_FUNC_RANGE analog).

    With the structured log on (``SPARK_RAPIDS_TPU_LOG``), each call emits
    one event record with its wall-time duration; with metrics on
    (``SPARK_RAPIDS_TPU_METRICS``), each call records one span in the
    current span tree."""

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
            ctx = metrics.span(scope) if rec else contextlib.nullcontext()
            with ctx, func_range(scope):
                out = fn(*args, **kwargs)
            if log:
                slog.event(scope, duration_s=time.perf_counter() - t0)
            return out

        return inner

    return wrap
