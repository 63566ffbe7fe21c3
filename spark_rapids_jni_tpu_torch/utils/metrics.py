"""Process-wide metrics registry + hierarchical span recorder.

The port's copy of the JAX package's ``utils/metrics.py``: counters
(join-engine choices, build-index cache hits, tape lengths, plan-cache
hits), gauges (device-memory watermarks), histograms with their log2
buckets and a bounded sample tail (the serving runtime's latencies), and
a per-query SPAN TREE exportable as Chrome-trace JSON (``chrome://
tracing`` / Perfetto) with the registry under its ``srjtCounters``,
``srjtGauges``, ``srjtHistograms`` and ``srjtLedger`` keys, as a
structured summary dict, and in Prometheus text format
(:func:`start_http_server`, a no-op without ``SRJT_METRICS_PORT``).

Knobs
-----
  SPARK_RAPIDS_TPU_METRICS=0|1        (default off)
  SPARK_RAPIDS_TPU_METRICS_TRACE=<p>  default export path for
                                      :func:`export_chrome_trace`

Discipline
----------
* **Nothing recorded when disabled.**  Every public entry is gated on ONE
  module-level bool; :func:`span` returns a shared ``nullcontext``
  without allocating, counters return before touching any dict.
* **Record around launches, never inside a capture.**  Sites that run
  under ``utils.syncs`` replay (the CUDA-graph capture of a compiled
  query, and its eager replay on the CPU) are skipped: a replay would
  otherwise count the capture run's events twice.  The one deliberate
  exception is ``count(..., in_trace=True)``, which records a replay's
  own occurrence on purpose.
* No device syncs: values passed in must already be host ints/floats.
* **One tracer.**  A recorded span is also a ``torch.profiler`` range
  (and an NVTX range on a card) of the same name, opened through
  ``utils.tracing`` on the thread that runs it, and its start is taken
  on the profiler's clock (Unix-epoch nanoseconds, from
  ``perf_counter_ns`` anchored once at import): the exported Chrome
  trace lays over a ``torch.profiler`` export of the same run.  The
  tree keeps the newest :data:`ROOTS_MAX` completed roots.

The device-memory census (:func:`sample_hbm`) reads the caching
allocator's counters, ``torch.cuda.memory_allocated`` and
``max_memory_allocated``, where the JAX package sums
``jax.live_arrays()``.  On the CPU torch keeps no list of live tensors,
so there the census reads 0 and sets no per-device gauge.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import re
import threading
import time

from ..analysis import sanitize
from . import knobs, syncs, tracing
from typing import Optional

_enabled: bool = os.environ.get(
    "SPARK_RAPIDS_TPU_METRICS", "0").lower() not in ("0", "off", "false", "")

_lock = sanitize.tracked_lock("utils.metrics")
_counters: dict[str, float] = {}
_gauges: dict[str, float] = {}
_hists: dict[str, dict] = {}        # name -> {count,total,min,max,buckets}
# bounded (ts, value) sample tails per histogram, feeding the
# rolling-window percentile path (the SLO watchdog's quantiles); the
# log2 buckets above stay the process-lifetime story
_WINDOW_N = max(knobs.get("SRJT_METRICS_WINDOW_N"), 16)
_samples: dict[str, "collections.deque[tuple[float, float]]"] = {}

# the profiler's clock: Unix-epoch ns, read as perf_counter_ns plus this
_ANCHOR_NS = time.time_ns() - time.perf_counter_ns()

#: completed root spans kept (the newest; a serving process that records
#: for its whole life holds no more)
ROOTS_MAX = 8192

_tls = threading.local()            # per-thread open-span stack
_roots: "collections.deque[Span]" = collections.deque(maxlen=ROOTS_MAX)

# compile-cost ledger: plan fingerprint → summed cost fields (capture_ms,
# trace_ms, traces, first_dispatch_ms, runs, cache_hits, ...) — the
# per-plan attribution of where compilation wall time went
# (``models/compiled.py`` and ``exec/plan_cache.py`` feed it)
_ledger: dict[str, dict[str, float]] = {}

# installed by ``plan/profile.py`` when that module loads; ops-layer
# sites report into the active node profile through :func:`profile_op`
# without importing plan/ (no cycle, no cost when profiling never loads)
_profile_op_hook = None


def enabled() -> bool:
    return _enabled


def set_enabled(on: Optional[bool] = None) -> None:
    """Toggle metrics at runtime; ``None`` re-reads the env knob."""
    global _enabled
    if on is None:
        _enabled = os.environ.get(
            "SPARK_RAPIDS_TPU_METRICS",
            "0").lower() not in ("0", "off", "false", "")
    else:
        _enabled = bool(on)


def recording() -> bool:
    """True when events should be recorded NOW: metrics on, and not inside
    a ``syncs.replay`` (which re-runs the already-recorded plan's Python
    for a CUDA-graph capture or, on the CPU, as the compiled run)."""
    return _enabled and syncs.mode() != "replay"


def reset() -> None:
    """Drop all counters, gauges, histograms, completed spans, and the
    compile-cost ledger."""
    with _lock:
        _counters.clear()
        _gauges.clear()
        _hists.clear()
        _samples.clear()
        _roots.clear()
        _ledger.clear()


def profile_op(name: str, **fields) -> None:
    """Report one op-level event (host-visible fields only — already
    resolved ints/strings, never device values) into the active plan-node
    profile.  A no-op until ``plan/profile.py`` is loaded AND a profile is
    active; ops-layer sites call this instead of importing plan/."""
    hook = _profile_op_hook
    if hook is not None:
        hook(name, **fields)


_profile_stage_hook = None      # plan/profile.stage once that module loads


def profile_stage(name: str, **fields):
    """Context manager opening a synthetic stage record (ml/ feature pack,
    train, predict) under the active plan-node profile — the non-plan-node
    twin of :func:`profile_op`, same no-import-cycle indirection.  Yields
    the open record (or None when no profile is active) so the stage can
    set output facts like ``out_rows``."""
    hook = _profile_stage_hook
    if hook is None:
        return contextlib.nullcontext()
    return hook(name, **fields)


# --- compile-cost ledger -----------------------------------------------------


def ledger_add(plan: str, *, in_trace: bool = False, **fields) -> None:
    """Accumulate numeric cost ``fields`` (ms, counts) under ``plan`` —
    a plan fingerprint or query name.  Same gating discipline as
    :func:`count`: no-op when disabled; ``in_trace=True`` records even
    under a replay trace (trace time is MEASURED at trace time)."""
    if not _enabled:
        return
    if not in_trace and not recording():
        return
    with _lock:
        e = _ledger.setdefault(plan, {})
        for k, v in fields.items():
            e[k] = e.get(k, 0) + v


def ledger_snapshot() -> dict[str, dict[str, float]]:
    """The compile-cost ledger as plain dicts (deep-copied):
    plan → {capture_ms, trace_ms, traces, first_dispatch_ms, runs,
    cache_hits, ...}.  ``traces`` counts jit (re)traces of the plan body;
    ``traces - 1`` of them are recompiles."""
    with _lock:
        return {k: dict(v) for k, v in _ledger.items()}


# --- counters / gauges / histograms ----------------------------------------


def count(name: str, value: float = 1, *, in_trace: bool = False) -> None:
    """Add ``value`` to counter ``name`` (no-op when disabled or replaying;
    ``in_trace=True`` records even under a replay trace — for events whose
    occurrence IS the trace, e.g. recompiles)."""
    if not _enabled:
        return
    if not in_trace and not recording():
        return
    with _lock:
        _counters[name] = _counters.get(name, 0) + value


def counter_value(name: str, default: float = 0) -> float:
    """Read counter ``name`` (``default`` when never incremented)."""
    with _lock:
        return _counters.get(name, default)


def histogram_max(name: str) -> Optional[float]:
    """The largest observation of histogram ``name`` (None when it has
    none), without :func:`snapshot`'s copy of everything."""
    with _lock:
        h = _hists.get(name)
        return None if h is None else h["max"]


def gauge(name: str, value: float) -> None:
    """Set gauge ``name`` to ``value``."""
    if not recording():
        return
    with _lock:
        _gauges[name] = value


def gauge_max(name: str, value: float) -> None:
    """High-water gauge: keep the max of all samples (HBM watermarks)."""
    if not recording():
        return
    with _lock:
        if value > _gauges.get(name, float("-inf")):
            _gauges[name] = value


def observe(name: str, value: float) -> None:
    """Record one histogram observation (count/total/min/max + log2
    buckets — enough for skew questions without storing samples)."""
    if not recording():
        return
    with _lock:
        h = _hists.get(name)
        if h is None:
            h = _hists[name] = {"count": 0, "total": 0, "min": value,
                                "max": value, "buckets": {}}
        h["count"] += 1
        h["total"] += value
        h["min"] = min(h["min"], value)
        h["max"] = max(h["max"], value)
        b = f"<=2^{max(int(value), 0).bit_length()}"
        h["buckets"][b] = h["buckets"].get(b, 0) + 1
        s = _samples.get(name)
        if s is None:
            s = _samples[name] = collections.deque(maxlen=_WINDOW_N)
        s.append((time.monotonic(), value))


def percentile(name: str, q: float,
               window_s: Optional[float] = None) -> Optional[float]:
    """The ``q``-th percentile (0..100) of histogram ``name``.

    ``window_s=None`` (default) estimates over the PROCESS LIFETIME from
    the log2 buckets: the answer is the upper edge of the bucket holding
    the quantile, clamped to the observed min/max — coarse (≤2× off) but
    storage-free; serving latency tails need the magnitude, not the
    digit.

    ``window_s`` computes an EXACT quantile (nearest-rank) over the
    retained sample tail restricted to the last ``window_s`` seconds —
    the rolling view the SLO watchdog alarms on.  The tail is bounded
    (``SRJT_METRICS_WINDOW_N``, default 1024 newest observations), so a
    long window over a hot histogram sees the newest N, never unbounded
    storage.  Returns None when no observation falls in the window
    (including the empty-histogram case); a single in-window sample is
    its own percentile at every q."""
    q = min(max(q, 0.0), 100.0)
    if window_s is not None:
        cutoff = time.monotonic() - max(float(window_s), 0.0)
        with _lock:
            s = _samples.get(name)
            vals = [v for ts, v in s if ts >= cutoff] if s else []
        if not vals:
            return None
        vals.sort()
        rank = max(int(-(-len(vals) * q // 100)), 1)   # ceil, 1-based
        return float(vals[min(rank, len(vals)) - 1])
    with _lock:
        h = _hists.get(name)
        if h is None or not h["count"]:
            return None
        lo, hi, total = h["min"], h["max"], h["count"]
        edges = sorted((int(k.rsplit("^", 1)[1]), c)
                       for k, c in h["buckets"].items())
    target = total * q / 100.0
    cum = 0
    for exp, c in edges:
        cum += c
        if cum >= target:
            return float(min(max(float(1 << exp), lo), hi))
    return float(hi)


# --- span recorder ----------------------------------------------------------


def _clock_ns() -> int:
    """Now on the profiler's clock, in Unix-epoch nanoseconds."""
    return time.perf_counter_ns() + _ANCHOR_NS


class Span:
    """One timed range, and the profiler range of its name while open;
    completed children hang off ``children``."""

    __slots__ = ("name", "attrs", "t0", "dur", "tid", "children", "_range")

    def __init__(self, name: str, attrs: dict):
        self.name = name
        self.attrs = attrs
        self.t0 = 0             # _clock_ns() on __enter__
        self.dur = 0.0          # seconds
        self.tid = 0
        self.children: list[Span] = []
        self._range = None

    def annotate(self, **attrs) -> None:
        self.attrs.update(attrs)

    def __enter__(self) -> "Span":
        stack = getattr(_tls, "stack", None)
        if stack is None:
            stack = _tls.stack = []
        stack.append(self)
        self.tid = threading.get_ident()
        self._range = tracing.range_push(self.name)
        self.t0 = _clock_ns()
        return self

    def __exit__(self, *exc) -> None:
        self.dur = (_clock_ns() - self.t0) / 1e9
        tracing.range_pop(self._range)
        self._range = None
        stack = _tls.stack
        stack.pop()
        if stack:
            stack[-1].children.append(self)
        else:
            with _lock:
                _roots.append(self)

    def as_dict(self) -> dict:
        d = {"name": self.name, "start_ms": self.t0 / 1e6,
             "dur_ms": round(self.dur * 1e3, 3)}
        if self.attrs:
            d["attrs"] = dict(self.attrs)
        if self.children:
            d["children"] = [c.as_dict() for c in self.children]
        return d


_NOOP = contextlib.nullcontext()


def span(name: str, **attrs):
    """Context manager recording a span under the current thread's open
    span (or as a new root), and opening the profiler range of its name.
    Returns a shared no-op context when disabled or under a replay trace
    — zero allocation on the hot path, and no range."""
    if not recording():
        return _NOOP
    return Span(name, attrs)


def current_span() -> Optional[Span]:
    stack = getattr(_tls, "stack", None)
    return stack[-1] if stack else None


def annotate(**attrs) -> None:
    """Attach attributes to the innermost open span (no-op without one)."""
    if not recording():
        return
    sp = current_span()
    if sp is not None:
        sp.attrs.update(attrs)


@contextlib.contextmanager
def query_span(name: str, **attrs):
    """Root span for one query execution, with device-memory samples
    taken before and after (around the launches, never inside them)."""
    if not recording():
        yield None
        return
    pre = sample_hbm("pre")
    with span(f"query:{name}", **attrs) as sp:
        yield sp
    post = sample_hbm("post")
    if pre is not None and post is not None:
        sp.annotate(hbm_pre_bytes=pre, hbm_post_bytes=post)


# --- HBM accounting ---------------------------------------------------------


def sample_hbm(tag: str = "sample") -> Optional[int]:
    """Sample live device memory from the caching allocator: the bytes
    its tensors hold on each card (``torch.cuda.memory_allocated``) and
    the high-water mark (``max_memory_allocated``).  Updates
    ``hbm.live_bytes``, its ``hbm.live_bytes.peak`` high-water gauge and
    ``hbm.device<i>.{bytes_in_use,peak_bytes_in_use}``; returns the
    live-byte total (None when disabled).  Without a card it returns 0
    and sets no per-device gauge: torch keeps no list of live CPU
    tensors to sum."""
    if not recording():
        return None
    import torch
    live = 0
    if torch.cuda.is_available():
        for i in range(torch.cuda.device_count()):
            in_use = int(torch.cuda.memory_allocated(i))
            live += in_use
            gauge(f"hbm.device{i}.bytes_in_use", in_use)
            gauge_max(f"hbm.device{i}.peak_bytes_in_use",
                      int(torch.cuda.max_memory_allocated(i)))
    gauge("hbm.live_bytes", live)
    gauge_max("hbm.live_bytes.peak", live)
    return live


# --- export -----------------------------------------------------------------


def snapshot() -> dict:
    """Counters/gauges/histograms/ledger as plain dicts (deep-copied)."""
    with _lock:
        return {"counters": dict(_counters), "gauges": dict(_gauges),
                "histograms": {k: {**v, "buckets": dict(v["buckets"])}
                               for k, v in _hists.items()},
                "ledger": {k: dict(v) for k, v in _ledger.items()}}


def span_roots() -> list[dict]:
    """Completed root span trees (dict form), in completion order: the
    newest :data:`ROOTS_MAX`."""
    with _lock:
        return [s.as_dict() for s in _roots]


def _walk(spans, fn):
    for s in spans:
        fn(s)
        _walk(s.children, fn)


def stage_breakdown() -> dict[str, dict]:
    """Aggregate all completed spans by name: call count, total/max ms —
    the per-query stage table."""
    agg: dict[str, dict] = {}

    def add(s: Span):
        e = agg.setdefault(s.name, {"count": 0, "total_ms": 0.0,
                                    "max_ms": 0.0})
        e["count"] += 1
        e["total_ms"] += s.dur * 1e3
        e["max_ms"] = max(e["max_ms"], s.dur * 1e3)

    with _lock:
        _walk(list(_roots), add)
    for e in agg.values():
        e["total_ms"] = round(e["total_ms"], 3)
        e["max_ms"] = round(e["max_ms"], 3)
    return agg


def summary() -> dict:
    """One structured dict: counters, gauges, histograms, span aggregate."""
    return {**snapshot(), "spans": stage_breakdown()}


def chrome_trace() -> dict:
    """The recorded spans + counters in Chrome-trace (JSON object) format.

    Spans become complete ("ph": "X") events with microsecond ts/dur,
    ``ts`` on the profiler's clock (Unix-epoch microseconds);
    counters/gauges ride along both as trailing counter events and under
    the ``srjtCounters``/``srjtGauges``/``srjtHistograms`` keys (the
    object format ignores unknown top-level keys, so Perfetto and
    ``chrome://tracing`` both load it and a reader gets the registry
    without re-aggregating events)."""
    pid = os.getpid()
    events: list[dict] = []
    end_us = 0.0

    def emit(s: Span):
        nonlocal end_us
        ev = {"name": s.name, "cat": "srjt", "ph": "X", "pid": pid,
              "tid": s.tid, "ts": s.t0 / 1e3,
              "dur": round(s.dur * 1e6, 3)}
        if s.attrs:
            ev["args"] = {k: v for k, v in s.attrs.items()}
        events.append(ev)
        end_us = max(end_us, s.t0 / 1e3 + s.dur * 1e6)

    with _lock:
        _walk(list(_roots), emit)
        counters = dict(_counters)
        gauges = dict(_gauges)
        hists = {k: {**v, "buckets": dict(v["buckets"])}
                 for k, v in _hists.items()}
        ledger = {k: dict(v) for k, v in _ledger.items()}
    for k, v in sorted(counters.items()):
        events.append({"name": k, "cat": "srjt", "ph": "C", "pid": pid,
                       "ts": end_us, "args": {"value": v}})
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "srjtCounters": counters, "srjtGauges": gauges,
            "srjtHistograms": hists, "srjtLedger": ledger}


def export_chrome_trace(path: Optional[str] = None) -> str:
    """Write :func:`chrome_trace` as JSON; returns the path written.
    Default path: ``SPARK_RAPIDS_TPU_METRICS_TRACE`` or
    ``srjt_trace.json``."""
    path = path or os.environ.get("SPARK_RAPIDS_TPU_METRICS_TRACE",
                                  "srjt_trace.json")
    with open(path, "w") as f:
        json.dump(chrome_trace(), f)
    return path


# --- Prometheus export ------------------------------------------------------

_PROM_BAD = re.compile(r"[^a-zA-Z0-9_:]")


def _prom_name(name: str) -> str:
    """``exec.stage.queue_ms`` → ``srjt_exec_stage_queue_ms`` (the
    text-format metric-name grammar admits ``[a-zA-Z_:][a-zA-Z0-9_:]*``)."""
    n = "srjt_" + _PROM_BAD.sub("_", name)
    if not re.match(r"[a-zA-Z_:]", n[0]):
        n = "_" + n
    return n


def _prom_num(v: float) -> str:
    f = float(v)
    return repr(int(f)) if f == int(f) and abs(f) < 2 ** 53 else repr(f)


def _prom_label(v: str) -> str:
    """Escape a label VALUE for the text exposition grammar (the CI lint
    admits ``[^"]*`` between the quotes — strip anything that would
    close or continue the quoted string)."""
    return str(v).replace("\\", "_").replace('"', "_").replace("\n", "_")


def to_prometheus() -> str:
    """The registry in Prometheus text exposition format (version 0.0.4).

    Counters and gauges export directly; every histogram exports as a
    native Prometheus histogram — cumulative ``_bucket{le="..."}`` series
    built from the log2 buckets, plus ``_sum`` and ``_count`` — so a
    scrape of the serving runtime yields rate()-able latency and
    admission series without any sidecar."""
    with _lock:
        counters = dict(_counters)
        gauges = dict(_gauges)
        hists = {k: {**v, "buckets": dict(v["buckets"])}
                 for k, v in _hists.items()}
        ledger = {k: dict(v) for k, v in _ledger.items()}
    lines: list[str] = []
    for name, v in sorted(counters.items()):
        p = _prom_name(name)
        lines.append(f"# TYPE {p} counter")
        lines.append(f"{p} {_prom_num(v)}")
    for name, v in sorted(gauges.items()):
        p = _prom_name(name)
        lines.append(f"# TYPE {p} gauge")
        lines.append(f"{p} {_prom_num(v)}")
    for name, h in sorted(hists.items()):
        p = _prom_name(name)
        lines.append(f"# TYPE {p} histogram")
        edges = sorted((int(k.rsplit("^", 1)[1]), c)
                       for k, c in h["buckets"].items())
        cum = 0
        for exp, c in edges:
            cum += c
            lines.append(f'{p}_bucket{{le="{float(1 << exp)!r}"}} {cum}')
        lines.append(f'{p}_bucket{{le="+Inf"}} {h["count"]}')
        lines.append(f"{p}_sum {_prom_num(h['total'])}")
        lines.append(f"{p}_count {h['count']}")
    if ledger:
        # compile-cost attribution: one labeled series per (plan, field)
        # — `rate(srjt_compile_ledger{kind="trace_ms"}[5m])` answers "who
        # is recompiling" straight off a scrape
        p = "srjt_compile_ledger"
        lines.append(f"# TYPE {p} counter")
        for plan, e in sorted(ledger.items()):
            for k, v in sorted(e.items()):
                lines.append(f'{p}{{plan="{_prom_label(plan)}",'
                             f'kind="{_prom_label(k)}"}} {_prom_num(v)}')
    return "\n".join(lines) + ("\n" if lines else "")


_http_server = None
_http_lock = sanitize.tracked_lock("utils.metrics.http")


def start_http_server(port: Optional[int] = None):
    """Serve :func:`to_prometheus` on ``http://0.0.0.0:<port>/metrics``
    from a daemon thread (the ops scrape surface; ``SRJT_METRICS_PORT``).
    Idempotent — one server per process; returns it (``.server_port``
    carries the bound port, useful with ``port=0`` in tests), or None
    when no port is configured."""
    global _http_server
    if port is None:
        port = knobs.get("SRJT_METRICS_PORT")
        if not port:
            return None
    port = int(port)
    with _http_lock:
        if _http_server is not None:
            return _http_server
        import http.server

        class _Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):            # noqa: N802 (stdlib API name)
                if self.path.split("?")[0] not in ("/metrics", "/"):
                    self.send_response(404)
                    self.end_headers()
                    return
                body = to_prometheus().encode()
                self.send_response(200)
                self.send_header("Content-Type",
                                 "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):    # scrapes must not spam stderr
                pass

        _http_server = http.server.ThreadingHTTPServer(
            ("0.0.0.0", port), _Handler)
        threading.Thread(target=_http_server.serve_forever,
                         name="srjt-metrics-http", daemon=True).start()
        return _http_server


def stop_http_server() -> None:
    """Shut the scrape endpoint down (tests)."""
    global _http_server
    with _http_lock:
        if _http_server is not None:
            _http_server.shutdown()
            _http_server.server_close()
            _http_server = None
