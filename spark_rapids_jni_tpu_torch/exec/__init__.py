"""Concurrent query-serving runtime (default-off, ``SRJT_EXEC=1``).

The port's copy of the JAX package's ``exec/``.  The single-query engine
(scan → ops → CUDA-graph replay) answers "how fast is one query"; this
subsystem answers the serving question — many concurrent requests
sharing ONE card, one memory budget and one set of caches.  Parts, each
its own module:

* :mod:`.scheduler` — bounded worker pool + priority queue, typed
  backpressure, deadlines (``SRJT_EXEC_WORKERS``,
  ``SRJT_EXEC_QUEUE_DEPTH``), and cross-request coalescing: same-plan
  requests batch into ONE launch (``SRJT_EXEC_COALESCE_MS``,
  ``SRJT_EXEC_COALESCE_MAX``), bit-identical to serial execution.
* :mod:`.admission` — per-request device-memory gate with graceful
  degradation (``SRJT_EXEC_INFLIGHT_BYTES``): defer under pressure, force
  the memory-lean sorted join engine when a request can never fit dense.
* :mod:`.plan_cache` — LRU of compiled (CUDA-graph) plans keyed on
  (query, input fingerprint) so the warm loop is one replay per request
  (``SRJT_EXEC_PLAN_CACHE_CAP``), with size-fingerprint plan sharing
  across refreshed same-shape data (``SRJT_EXEC_PLAN_SIZE_FP``).
* :mod:`.placement` — per-device replica state (``SRJT_EXEC_DEVICES``):
  each device its own executor lifecycle, admission ledger, and
  identity-keyed placement cache; the scheduler routes whole requests to
  replicas and fails them over across the quarantine → probation →
  recovery lifecycle (``SRJT_EXEC_RECOVERY``).
* :mod:`.prefetch` — double-buffered staging overlapping the next
  request's scan with current execution (``SRJT_EXEC_PREFETCH_DEPTH``).
* :mod:`.slo` — rolling-window SLO watchdog over resolved requests
  (``SRJT_SLO_P95_MS`` and friends); breaches alarm through the
  flight-recorder black box (``utils/flight.py``).
* :mod:`.artifacts` — the persistent AOT store of capture tapes
  (``SRJT_AOT_DIR``): a fresh process rehydrates a plan without its eager
  capture run; the scheduler pre-hydrates the costliest at startup.

Correctness contract: concurrency, admission degradation, plan caching,
and prefetch NEVER change results — only latency
(``tests/test_torch_exec.py`` holds the served results bit-identical to
serial eager execution on the CPU).
"""

from __future__ import annotations

from ..utils import knobs

from . import artifacts
from .admission import AdmissionController, AdmissionGrant, request_bytes
from .artifacts import ArtifactStore, get_store
from .errors import (ExecDeadlineExceeded, ExecError, ExecQueueFull,
                     ExecShutdown)
from .placement import Replica, build_replicas, device_name, local_devices
from .plan_cache import PlanCache
from .prefetch import Prefetcher
from .scheduler import QueryScheduler, QueryTicket
from .slo import SloWatchdog, thresholds_from_env

__all__ = [
    "AdmissionController", "AdmissionGrant", "ArtifactStore", "artifacts",
    "ExecDeadlineExceeded",
    "ExecError", "ExecQueueFull", "ExecShutdown", "PlanCache", "Prefetcher",
    "QueryScheduler", "QueryTicket", "Replica", "SloWatchdog",
    "build_replicas", "device_name", "enabled", "get_store", "local_devices",
    "request_bytes", "thresholds_from_env",
]


def enabled() -> bool:
    """True when the serving runtime is switched on (``SRJT_EXEC``)."""
    return knobs.get("SRJT_EXEC")
