"""Fault injection — the resilience-testing tool (libcufaultinj parity).

The port's copy of the JAX package's ``faultinj/injector.py``.  The
reference ships ``libcufaultinj.so``: a CUPTI interceptor that matches
CUDA API callbacks against a JSON config and injects faults so the
framework above can prove its retry/quarantine logic.  Here the
interception points are the framework's own dispatch sites (the serving
runtime checks ``exec.dispatch``) and, with ``faultinj/torch_shim.py``
installed, the port's host → device copies, kernel builds and launches
(``torch.h2d``, ``torch.build``, ``torch.launch``).  Parity, feature for
feature:

* config matched by site name or ``"*"``
* per-rule ``percent`` dice and decrementing ``interceptionCount`` budget
  under a lock
* injection types: raise (the CUDA trap/assert analogs become exception
  classes) or a substituted return value
* hot reload of the JSON config — a watcher thread picks up edits without
  restarting, mtime polling standing in for inotify
* seeded RNG for reproducible schedules

Config schema (mirrors ``faultinj/README.md:104-141``)::

    {
      "logLevel": "info",
      "dynamic": true,                  # hot reload on/off
      "seed": 42,
      "sites": {
        "convert_to_rows": {
          "percent": 50,                # dice per interception
          "interceptionCount": 10,      # budget; -1 = unlimited
          "injectionType": "device_error"   # or "oom", "substitute"
          "substituteResult": null          # for injectionType substitute
        },
        "*": { ... }                    # wildcard, lowest precedence
      }
    }

Two extensions over the reference schema serve the chaos harness
(multi-device serving, ``exec/scheduler.py``):

* ``device`` — the rule fires only when the interception happens inside a
  matching :func:`device_scope` (the scheduler wraps each replica's
  dispatch in its device's scope).  The analog of pinning libcufaultinj
  to one GPU's CUDA context.  A device-mismatched named rule does NOT
  fall through to ``"*"`` — the site is configured, just not for this
  device.
* ``maxHits`` (alias ``max_hits``) — an absolute cap on how many times
  the rule fires, independent of ``interceptionCount`` (which budgets
  *interceptions*, i.e. dice rolls).  ``maxHits: 1`` is the one-shot
  kill: exactly one fatal fault, then the
  device is genuinely healthy again for the recovery probe's canary.
"""

from __future__ import annotations

import functools
import json
import os
import random
import threading
import time
from typing import Any, Callable, Optional

from ..analysis import sanitize

ENV_CONFIG_PATH = "FAULT_INJECTOR_CONFIG_PATH"   # same env var as faultinj.cu:93


class InjectedDeviceError(RuntimeError):
    """Analog of the injected PTX trap: the device is gone (fatal)."""


class InjectedOomError(MemoryError):
    """Injected allocation failure (RMM OOM analog)."""


_INJECTION_TYPES = ("device_error", "oom", "substitute")

# thread-local device scope: the scheduler marks which replica's device a
# worker thread is currently dispatching for, so device-targeted rules can
# discriminate (the CUDA-context analog; one process, many logical devices)
_tls = threading.local()


class device_scope:
    """Mark the current thread as dispatching on device ``name`` (e.g.
    ``"cuda:0"``); nestable context manager."""

    def __init__(self, name: Optional[str]):
        self.name = name
        self._prev: Optional[str] = None

    def __enter__(self) -> "device_scope":
        self._prev = getattr(_tls, "device", None)
        _tls.device = self.name
        return self

    def __exit__(self, *exc) -> None:
        _tls.device = self._prev


def current_device() -> Optional[str]:
    """The innermost :class:`device_scope` name on this thread, or None."""
    return getattr(_tls, "device", None)


class _Rule:
    def __init__(self, spec: dict):
        self.percent = float(spec.get("percent", 100.0))
        self.count = int(spec.get("interceptionCount", -1))
        self.injection_type = spec.get("injectionType", "device_error")
        if self.injection_type not in _INJECTION_TYPES:
            raise ValueError(f"unknown injectionType {self.injection_type!r}")
        self.substitute = spec.get("substituteResult")
        self.device = spec.get("device")         # None = any device
        mh = spec.get("maxHits", spec.get("max_hits", -1))
        self.max_hits = int(mh) if mh is not None else -1
        self.hits = 0


class FaultInjector:
    def __init__(self):
        self._lock = sanitize.tracked_lock("faultinj.injector")
        self._rules: dict[str, _Rule] = {}
        self._rng = random.Random()
        self._enabled = False
        self._config_path: Optional[str] = None
        self._watcher: Optional[threading.Thread] = None
        self._watcher_stop = threading.Event()
        self._mtime = 0.0
        self.injected_count = 0   # observability: how many faults fired

    # -- config -------------------------------------------------------------
    def load_dict(self, cfg: dict) -> None:
        """Arm rules from an in-memory config dict (same schema as the
        JSON file, minus ``dynamic``) — the chaos harness's programmatic
        entry point for mid-run fault schedules."""
        rules = {name: _Rule(spec)
                 for name, spec in cfg.get("sites", {}).items()}
        with self._lock:
            self._rules = rules
            self._rng = random.Random(cfg.get("seed"))

    def load_config(self, path: str) -> None:
        with open(path) as f:
            cfg = json.load(f)
        self.load_dict(cfg)
        with self._lock:
            self._config_path = path
            self._mtime = os.path.getmtime(path)
        if cfg.get("dynamic"):
            if self._watcher is None:
                self._start_watcher()
        elif self._watcher is not None:
            # config edited to dynamic:false → freeze the schedule
            self._watcher_stop.set()
            self._watcher = None

    def _start_watcher(self) -> None:
        # mtime polling in a daemon thread — the portable stand-in for the
        # reference's inotify watcher (faultinj.cu:419-470)
        self._watcher_stop.clear()

        def watch():
            while not self._watcher_stop.wait(0.25):
                path = self._config_path
                if not path:
                    continue
                try:
                    m = os.path.getmtime(path)
                except OSError:
                    continue
                if m != self._mtime:
                    # record the observed mtime first so a bad edit is not
                    # re-parsed on every poll until the file changes again
                    self._mtime = m
                    try:
                        self.load_config(path)
                    except Exception:
                        pass   # keep the old config on a bad edit; the
                        # watcher must survive any parse/coerce error
                        # (TypeError from e.g. "percent": null included)

        self._watcher = threading.Thread(target=watch, daemon=True,
                                         name="faultinj-watcher")
        self._watcher.start()

    # -- lifecycle ----------------------------------------------------------
    def enable(self, config_path: Optional[str] = None) -> None:
        path = config_path or os.environ.get(ENV_CONFIG_PATH)
        if path:
            self.load_config(path)
        self._enabled = True

    def disable(self) -> None:
        self._enabled = False
        self._watcher_stop.set()
        if self._watcher is not None:
            self._watcher.join(timeout=2)
            self._watcher = None
        with self._lock:
            self._rules = {}
            self.injected_count = 0

    # -- interception -------------------------------------------------------
    def check(self, site: str):
        """Called at a fault site.  Returns None (no fault), raises, or
        returns (True, substitute_value) for a substituted result."""
        if not self._enabled:
            return None
        dev = current_device()
        with self._lock:
            rule = self._rules.get(site) or self._rules.get("*")
            if rule is None:
                return None
            if rule.device is not None and rule.device != dev:
                return None
            if rule.count == 0:
                return None
            if rule.max_hits >= 0 and rule.hits >= rule.max_hits:
                return None
            if self._rng.uniform(0, 100) >= rule.percent:
                return None
            if rule.count > 0:
                rule.count -= 1
            rule.hits += 1
            self.injected_count += 1
            injection_type = rule.injection_type
            substitute = rule.substitute
        if injection_type == "device_error":
            raise InjectedDeviceError(
                f"[faultinj] injected device error at site {site!r}")
        if injection_type == "oom":
            raise InjectedOomError(
                f"[faultinj] injected allocation failure at site {site!r}")
        return (True, substitute)


_global = FaultInjector()


def get_injector() -> FaultInjector:
    return _global


def enable(config_path: Optional[str] = None) -> None:
    _global.enable(config_path)


def disable() -> None:
    _global.disable()


def fault_site(name: str) -> Callable:
    """Decorator marking a framework entry point as an injectable site:
    a rule for ``name`` (or ``"*"``) raises there, or returns its
    substitute in place of the call."""

    def wrap(fn: Callable) -> Callable:
        @functools.wraps(fn)
        def inner(*args: Any, **kwargs: Any):
            hit = _global.check(name)
            if hit is not None:
                return hit[1]
            return fn(*args, **kwargs)

        inner.__fault_site__ = name
        return inner

    return wrap
