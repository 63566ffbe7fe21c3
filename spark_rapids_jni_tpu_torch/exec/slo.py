"""SLO watchdog: rolling-window latency/error objectives per query class.

The port's copy of the JAX package's ``exec/slo.py``.

The serving runtime's histograms say what latency WAS over the process
lifetime; an operator needs to know when it stops being acceptable NOW.
This watchdog keeps a bounded rolling window of per-request outcomes per
query class (the request's query name) and evaluates configurable
objectives over it: p50/p95/p99 end-to-end latency and error / deadline /
defer / degrade rates.  A breach emits the full alarm chain —
``exec.slo.breach`` counter, a structured log line, and a flight-recorder
incident snapshot (``utils/flight.py``) — so the black box captures the
window in which the objective died, not a later steady state.

Thresholds come from env (unset objectives are simply not evaluated)::

  SRJT_SLO_P50_MS / SRJT_SLO_P95_MS / SRJT_SLO_P99_MS
      latency objectives in milliseconds
  SRJT_SLO_ERROR_RATE / SRJT_SLO_DEADLINE_RATE /
  SRJT_SLO_DEFER_RATE  / SRJT_SLO_DEGRADE_RATE /
  SRJT_SLO_RELOCATE_RATE
      rate objectives in [0, 1] (relocate = requests that failed over
      to another replica after a device fault — a rising relocate rate
      is the first operator signal of a flapping device)
  SRJT_SLO_WINDOW_S    rolling window (default 60 s)
  SRJT_SLO_MIN_N       minimum window population before any verdict
                       (default 8 — two requests must not page anyone)
  SRJT_SLO_COOLDOWN_S  per-(class, objective) re-alarm holdoff
                       (default 30 s — a sustained breach is one page,
                       not one per request)

The scheduler calls :meth:`SloWatchdog.observe` on every ticket
resolution; evaluation happens inline on the observing thread (a few
hundred floats sorted per breach check, bounded by the window cap) —
no extra thread to leak."""

from __future__ import annotations

import collections
import time
from typing import Optional

from ..analysis import sanitize
from ..utils import flight, knobs, metrics, structured_log

_WINDOW_CAP = 4096          # per-class sample bound, whatever the window

_RATE_OUTCOMES = ("error", "deadline", "defer", "degrade")


def thresholds_from_env() -> dict:
    """The configured objectives; empty dict when none are set."""
    th = {
        "p50_ms": knobs.get("SRJT_SLO_P50_MS"),
        "p95_ms": knobs.get("SRJT_SLO_P95_MS"),
        "p99_ms": knobs.get("SRJT_SLO_P99_MS"),
        "error_rate": knobs.get("SRJT_SLO_ERROR_RATE"),
        "deadline_rate": knobs.get("SRJT_SLO_DEADLINE_RATE"),
        "defer_rate": knobs.get("SRJT_SLO_DEFER_RATE"),
        "degrade_rate": knobs.get("SRJT_SLO_DEGRADE_RATE"),
        "relocate_rate": knobs.get("SRJT_SLO_RELOCATE_RATE"),
    }
    return {k: v for k, v in th.items() if v is not None}


class SloWatchdog:
    """Rolling-window SLO evaluation over per-request outcomes."""

    def __init__(self, thresholds: Optional[dict] = None,
                 window_s: Optional[float] = None,
                 min_n: Optional[int] = None,
                 cooldown_s: Optional[float] = None):
        if thresholds is None:
            thresholds = thresholds_from_env()
        if window_s is None:
            window_s = knobs.get("SRJT_SLO_WINDOW_S")
        if min_n is None:
            min_n = knobs.get("SRJT_SLO_MIN_N")
        if cooldown_s is None:
            cooldown_s = knobs.get("SRJT_SLO_COOLDOWN_S")
        self.thresholds = dict(thresholds)
        self.window_s = max(float(window_s), 1e-3)
        self.min_n = max(int(min_n), 1)
        self.cooldown_s = max(float(cooldown_s), 0.0)
        self._mu = sanitize.tracked_lock("exec.slo")
        # class -> deque of (ts, e2e_ms, outcome, degraded, deferred)
        self._obs: dict[str, collections.deque] = {}
        self._last_alarm: dict[tuple, float] = {}
        self.breach_count = 0

    def enabled(self) -> bool:
        """A watchdog with no objectives records nothing and never fires."""
        return bool(self.thresholds)

    # -- recording -----------------------------------------------------------

    def observe(self, qclass: str, e2e_ms: float, outcome: str = "ok", *,
                degraded: bool = False, deferred: bool = False,
                relocated: bool = False,
                request_id: Optional[str] = None) -> list[dict]:
        """Record one resolved request and evaluate its class.  Returns
        the breaches fired (empty in the steady state).  ``outcome`` is
        ``ok`` | ``error`` | ``deadline``; ``relocated`` marks a request
        that failed over to another replica before resolving."""
        if not self.enabled():
            return []
        now = time.monotonic()
        with self._mu:
            dq = self._obs.get(qclass)
            if dq is None:
                dq = self._obs[qclass] = collections.deque(
                    maxlen=_WINDOW_CAP)
            dq.append((now, float(e2e_ms), outcome, bool(degraded),
                       bool(deferred), bool(relocated)))
        return self._evaluate(qclass, now, request_id=request_id)

    # -- evaluation ----------------------------------------------------------

    def _window(self, qclass: str, now: float) -> list[tuple]:
        with self._mu:
            dq = self._obs.get(qclass)
            if not dq:
                return []
            cutoff = now - self.window_s
            return [o for o in dq if o[0] >= cutoff]

    def class_status(self, qclass: str,
                     now: Optional[float] = None) -> Optional[dict]:
        """The rolling-window stats + per-objective verdicts for one
        class, or None below the minimum population."""
        now = time.monotonic() if now is None else now
        win = self._window(qclass, now)
        if len(win) < self.min_n:
            return None
        lat = sorted(o[1] for o in win)
        n = len(lat)

        def pct(q):
            rank = max(int(-(-n * q // 100)), 1)
            return lat[min(rank, n) - 1]

        stats = {
            "n": n,
            "window_s": self.window_s,
            "p50_ms": round(pct(50), 3),
            "p95_ms": round(pct(95), 3),
            "p99_ms": round(pct(99), 3),
            "error_rate": sum(o[2] == "error" for o in win) / n,
            "deadline_rate": sum(o[2] == "deadline" for o in win) / n,
            "defer_rate": sum(o[4] for o in win) / n,
            "degrade_rate": sum(o[3] for o in win) / n,
            "relocate_rate": sum(o[5] for o in win) / n,
        }
        verdicts = {}
        for obj, limit in self.thresholds.items():
            observed = stats.get(obj)
            if observed is not None:
                verdicts[obj] = {"limit": limit,
                                 "observed": round(observed, 6),
                                 "breached": observed > limit}
        stats["objectives"] = verdicts
        stats["breached"] = any(v["breached"] for v in verdicts.values())
        return stats

    def status(self) -> dict:
        """Every observed class's :meth:`class_status` (ops surface)."""
        with self._mu:
            classes = list(self._obs)
        now = time.monotonic()
        return {"thresholds": dict(self.thresholds),
                "window_s": self.window_s,
                "classes": {c: self.class_status(c, now) for c in classes}}

    def _evaluate(self, qclass: str, now: float, *,
                  request_id: Optional[str] = None) -> list[dict]:
        stats = self.class_status(qclass, now)
        if stats is None or not stats["breached"]:
            return []
        fired = []
        for obj, v in stats["objectives"].items():
            if not v["breached"]:
                continue
            key = (qclass, obj)
            with self._mu:
                last = self._last_alarm.get(key)
                if last is not None and now - last < self.cooldown_s:
                    continue
                self._last_alarm[key] = now
                self.breach_count += 1
            breach = {"class": qclass, "objective": obj,
                      "limit": v["limit"], "observed": v["observed"],
                      "window_n": stats["n"]}
            fired.append(breach)
            if metrics.enabled():
                metrics.count("exec.slo.breach", in_trace=True)
                metrics.count(f"exec.slo.breach.{obj}", in_trace=True)
            structured_log.event("slo.breach", **breach)
            flight.incident("slo_breach", request_id=request_id, **breach)
        return fired
