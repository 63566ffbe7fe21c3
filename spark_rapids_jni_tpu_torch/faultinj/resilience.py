"""Retry/quarantine/recovery policy harness — the "framework above" contract.

The reference's fault injector exists to prove that the framework above the
native library (Spark + the RAPIDS plugin) reacts correctly to GPU faults:
non-fatal errors are retried, fatal errors quarantine the executor, and
nothing deadlocks (``faultinj/README.md:3-16``).  This module provides the
same contract for this framework so resilience tests have a first-party
subject: a :class:`ResilientExecutor` that classifies failures from the
device layer (the injector's faults at the dispatch sites) and applies
Spark-like policy.  The port's copy of the JAX package's
``faultinj/resilience.py``, with its classification: an allocation
failure is :class:`InjectedOomError` or a ``MemoryError``; a real
``torch.cuda.OutOfMemoryError`` is neither, as XLA's is not, so it fails
the request without a retry.

Lifecycle (the executor-replacement model, one state machine per device)::

    healthy ──fatal fault──▶ quarantined ──recover()──▶ probation
       ▲                          ▲                         │
       │                          └────fault during─────────┤
       └──────────first successful submit (canary)──────────┘

``quarantined`` fails every submit fast — the scheduler drains and
relocates that replica's work.  ``recover()`` (called by the scheduler's
recovery probe) moves to ``probation``: the next submit is the canary —
success re-admits the executor, another fatal fault re-quarantines it
(and the probe's backoff/ejection policy decides what happens next).

Transient faults (allocation failures) retry in place with JITTERED
EXPONENTIAL backoff: ``backoff_s`` seeds the schedule, each retry doubles
it up to ``backoff_max_s``, and a uniform jitter factor decorrelates
replicas retrying into the same pressure spike (the classic thundering-
herd fix; Spark's task-retry backoff does the same).
"""

from __future__ import annotations

import random
import time
from typing import Any, Callable, Optional

from ..analysis import sanitize
from ..utils import flight
from .injector import InjectedDeviceError, InjectedOomError


class DeviceQuarantined(RuntimeError):
    """The executor refused work because a fatal device fault occurred."""


class ResilientExecutor:
    """Runs device closures with retry (transient) / quarantine (fatal) /
    probation (recovery canary).

    Policy mirrors the Spark executor contract the reference's tool tests
    (``faultinj/README.md:3-16``): allocation failures and other transient
    errors are retried up to ``max_retries`` with jittered exponential
    backoff; a device error (the PTX-trap analog,
    :class:`InjectedDeviceError`) is fatal — the executor quarantines
    itself and every subsequent submit fails fast until a recovery probe
    calls :meth:`recover` and a canary submit succeeds.

    ``device`` names the device this executor fronts (e.g. ``"cuda:0"``) so
    quarantine incidents and recovery events carry per-device identity in
    a multi-replica scheduler.
    """

    def __init__(self, max_retries: int = 2, backoff_s: float = 0.0,
                 backoff_max_s: float = 2.0, jitter: float = 0.5,
                 device: Optional[str] = None, seed: Optional[int] = None):
        self.max_retries = max_retries
        self.backoff_s = backoff_s
        self.backoff_max_s = backoff_max_s
        self.jitter = max(float(jitter), 0.0)
        self.device = device
        self._mu = sanitize.tracked_lock("faultinj.resilience")
        self.state = "healthy"          # healthy | quarantined | probation
        self.retry_count = 0            # observability
        self.fatal_count = 0
        self.recovery_count = 0
        self._rng = random.Random(seed)

    @property
    def quarantined(self) -> bool:
        """Back-compat view: True while submits fail fast."""
        return self.state == "quarantined"

    def backoff_delay(self, attempt: int) -> float:
        """The sleep before retry ``attempt`` (1-based): exponential in
        the attempt, capped at ``backoff_max_s``, with multiplicative
        uniform jitter in ``[1, 1+jitter]``.  0 when backoff is off."""
        if self.backoff_s <= 0:
            return 0.0
        base = min(self.backoff_s * (2.0 ** (attempt - 1)),
                   self.backoff_max_s)
        return base * (1.0 + self.jitter * self._rng.random())

    def recover(self) -> bool:
        """Move a quarantined executor to probation: the NEXT submit is
        the canary — success re-admits, a fatal fault re-quarantines.
        Returns False (no-op) unless currently quarantined."""
        with self._mu:
            if self.state != "quarantined":
                return False
            self.state = "probation"
        flight.record("resilience.probation", device=self.device)
        return True

    def fail_probation(self) -> None:
        """Abort an unfinished canary: probation falls back to
        quarantined (a canary that errored without a fatal fault —
        e.g. a miscompare — must not leave the executor half-admitted)."""
        with self._mu:
            if self.state == "probation":
                self.state = "quarantined"

    def _quarantine(self, exc: BaseException) -> None:
        with self._mu:
            self.fatal_count += 1
            self.state = "quarantined"
            fatal = self.fatal_count
        flight.incident("quarantine", device=self.device, error=repr(exc),
                        fatal_count=fatal)

    def submit(self, fn: Callable[[], Any]) -> Any:
        with self._mu:
            if self.state == "quarantined":
                raise DeviceQuarantined(
                    f"executor is quarantined (device {self.device})")
            probation = self.state == "probation"
        attempts = 0
        while True:
            try:
                out = fn()
            except InjectedDeviceError as e:
                # fatal: device state unknown — quarantine (the plugin's
                # "shut down the executor so the cluster manager replaces
                # it" behavior; here replacement is the recovery probe)
                self._quarantine(e)
                raise DeviceQuarantined(
                    "fatal device fault — executor quarantined "
                    f"(device {self.device})")
            except (InjectedOomError, MemoryError):
                attempts += 1
                if attempts > self.max_retries:
                    raise
                self.retry_count += 1
                delay = self.backoff_delay(attempts)
                if delay:
                    time.sleep(delay)
                continue
            if probation:
                with self._mu:
                    if self.state == "probation":
                        self.state = "healthy"
                        self.recovery_count += 1
                flight.record("resilience.recovered", device=self.device,
                              recovery_count=self.recovery_count)
            return out
