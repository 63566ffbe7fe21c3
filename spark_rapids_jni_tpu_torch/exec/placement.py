"""Per-device replica state for the multi-device serving runtime.

The port's copy of the JAX package's ``exec/placement.py``.  One
:class:`Replica` per device: the device, its own
:class:`~..faultinj.resilience.ResilientExecutor` (fault lifecycle is per
device — one card's fatal fault must not quarantine the pool), its own
:class:`~.admission.AdmissionController` (``SRJT_EXEC_INFLIGHT_BYTES`` is a
PER-DEVICE cap; re-admission after failover charges the *target*
device), and an identity-keyed placement cache.

Placement model (data-parallel replication): requests are independent, so
the scheduler routes whole requests to distinct devices and replicates
their inputs.  The placement cache makes the copy *once* per (source
tensor, device): repeat requests over the same resident tables reuse the
same device-resident copies, which also keeps the plan cache's identity
fingerprints stable per device.

The walker preserves column structure: a ``DictColumn`` is placed as
codes + dictionary (its ``data`` would materialize the byte payload), a
``LazyColumn`` is forced first (placement is an output boundary for
laziness — the copy must exist to move).

``build_replicas(n, device="cpu")`` gives ``n`` replicas that all run on
the CPU, each a device of its own to the fault lifecycle, the admission
ledger and the plan cache (``cpu:0`` … ``cpu:<n-1>``): the counterpart of
the JAX tests' forced host devices, so that relocation, recovery and
ejection run without cards.  ``.to("cpu")`` of a CPU tensor is the tensor
itself, so their placement moves nothing.
"""

from __future__ import annotations

import contextlib
import time

import torch

from ..analysis import sanitize
from ..faultinj import injector as finj
from ..faultinj.resilience import ResilientExecutor
from ..models import compiled as C
from ..utils import flight, metrics
from ..utils.syncs import WeakIdMemo
from .admission import AdmissionController


def local_devices(n_devices: int, device=None) -> list:
    """The first ``n_devices`` devices: cards (``torch.cuda.device_count()``
    of them; raises when asked for more, or without one), or with
    ``device="cpu"`` that many CPU replicas, which share the host.  The
    mesh builders' one source of handles (``parallel/mesh.py``)."""
    from ..parallel.mesh import local_devices as mesh_devices
    return mesh_devices(max(int(n_devices), 1), device)


def device_name(device, index: int = 0) -> str:
    """Canonical device label, e.g. ``"cuda:1"`` (a CPU replica:
    ``"cpu:<replica index>"``) — the id the fault injector's ``device``
    rules and incident snapshots use."""
    if device.type == "cpu":
        return f"cpu:{index}"
    return f"{device.type}:{device.index if device.index is not None else 0}"


class Replica:
    """One device's serving state: executor lifecycle, admission ledger,
    placement cache, and recovery-probe bookkeeping."""

    def __init__(self, index: int, device, *, inflight_bytes=None,
                 max_retries: int = 2):
        self.index = index
        self.device = torch.device(device)
        self.name = device_name(self.device, index)
        self.resilient = ResilientExecutor(max_retries=max_retries,
                                           device=self.name)
        self.admission = AdmissionController(inflight_bytes,
                                             device=self.name)
        # source-tensor identity → device-resident copy; weak on the
        # source so a dropped table releases both copies
        self._placed = WeakIdMemo()
        self.ejected = False            # terminal: probes gave up
        self.fail_streak = 0            # consecutive failed probes
        self.next_probe_at = 0.0        # monotonic instant of next probe
        self.probe_armed = False        # recovery probe owns this replica
        self.active = 0                 # in-flight requests (gauge)
        self.completed = 0              # served ok (per-device QPS)
        # several scheduler workers dispatch to the same replica, so the
        # counters above are mutated only through the note_* methods
        self._mu = sanitize.tracked_lock(f"exec.placement.replica{index}")

    # -- counters (thread-safe: shared across scheduler workers) -------------

    def note_active(self, n: int = 1) -> None:
        """In-flight delta: +n at dispatch, -n when the batch resolves."""
        with self._mu:
            self.active += n

    def note_completed(self, n: int = 1) -> None:
        with self._mu:
            self.completed += n

    def note_probe_failed(self) -> int:
        """Bump and return the consecutive-failure streak."""
        with self._mu:
            self.fail_streak += 1
            return self.fail_streak

    def note_probe_ok(self) -> None:
        with self._mu:
            self.fail_streak = 0

    # -- state ---------------------------------------------------------------

    def state(self) -> str:
        if self.ejected:
            return "ejected"
        return self.resilient.state

    def serving(self) -> bool:
        """True when this replica may pull new work off the queue."""
        return not self.ejected and self.resilient.state == "healthy"

    def recoverable(self) -> bool:
        """True while the recovery probe still owns this replica's fate."""
        return not self.ejected

    def scope(self, pin_device: bool = True):
        """The dispatch context for this replica: its card as the current
        CUDA device (so that tensors made without a device land there)
        and the fault injector's device scope (so ``device``-targeted
        rules can hit it).  ``pin_device=False`` sets only the injector
        scope, as the single-device scheduler does."""
        @contextlib.contextmanager
        def _scope():
            with contextlib.ExitStack() as stack:
                if pin_device and self.device.type == "cuda":
                    stack.enter_context(torch.cuda.device(self.device))
                stack.enter_context(finj.device_scope(self.name))
                yield
        return _scope()

    def synchronize(self) -> None:
        """Wait for this replica's current CUDA stream (nothing on a CPU
        replica): an asynchronous device fault raises here."""
        if self.device.type == "cuda":
            with C.device_work():
                torch.cuda.current_stream(self.device).synchronize()

    # -- placement -----------------------------------------------------------

    def _place_tensor(self, a):
        if a is None:
            return None
        if a.device == self.device:
            return a
        hit = self._placed.get((a,))
        if hit is not None:
            if metrics.recording():
                metrics.count("exec.place.hit")
            return hit
        with C.device_work():
            out = a.to(self.device)
        self._placed.put((a,), out)
        if metrics.recording():
            metrics.count("exec.place.copy")
            metrics.count("exec.place.bytes", int(a.nbytes))
        return out

    def _place_column(self, c):
        from ..column import Column, DictColumn, force_column
        c = force_column(c)
        if isinstance(c, DictColumn):
            return DictColumn(self._place_tensor(c.codes),
                              self._place_column(c.dictionary),
                              self._place_tensor(c.validity))
        return Column(c.dtype, self._place_tensor(c.data),
                      self._place_tensor(c.offsets),
                      self._place_tensor(c.validity))

    def place(self, tables):
        """``tables`` (dict / Table / Column / sequence nests) with every
        payload tensor resident on this replica's device.  Identity-cached
        per source tensor: repeat requests over resident tables reuse the
        same device copies (stable plan-cache fingerprints per device)."""
        from ..column import Column, Table
        if tables is None:
            return None
        if isinstance(tables, dict):
            return {k: self.place(v) for k, v in tables.items()}
        if isinstance(tables, Table):
            return Table([self._place_column(c) for c in tables.columns],
                         tables.host_decoded_cols)
        if isinstance(tables, Column):
            return self._place_column(tables)
        if isinstance(tables, (list, tuple)):
            return type(tables)(self.place(v) for v in tables)
        return tables

    # -- recovery probe support ----------------------------------------------

    def canary(self) -> None:
        """One small device computation through the same dispatch path real
        requests take (fault site + device scope), checked on the host.
        Raises ``DeviceQuarantined`` when the device is still faulting."""
        def _probe():
            finj.get_injector().check("exec.dispatch")
            n = 64
            with C.device_work():
                got = int(torch.arange(n, dtype=torch.int32,
                                       device=self.device).sum())
            if got != n * (n - 1) // 2:
                raise RuntimeError(
                    f"canary miscompare on {self.name}: {got}")
            return got

        with self.scope():
            self.resilient.submit(_probe)

    def schedule_probe(self, base_s: float, max_s: float, rng) -> None:
        """Set the next probe instant with jittered exponential backoff in
        the consecutive-failure streak."""
        back = min(base_s * (2.0 ** self.fail_streak), max_s)
        self.next_probe_at = time.monotonic() \
            + back * (1.0 + 0.5 * rng.random())

    def eject(self, reason: str = "probe failures") -> None:
        """Terminal ejection: the probe gave up on this device."""
        self.ejected = True
        flight.incident("ejected", device=self.name, reason=reason,
                        fail_streak=self.fail_streak,
                        fatal_count=self.resilient.fatal_count)
        if metrics.recording():
            metrics.count("exec.failover.ejected")

    def snapshot(self) -> dict:
        """Ops-surface view (flight probes, ``ops_state``)."""
        return {"device": self.name, "index": self.index,
                "state": self.state(), "active": self.active,
                "completed": self.completed,
                "fail_streak": self.fail_streak,
                "retries": self.resilient.retry_count,
                "fatal_faults": self.resilient.fatal_count,
                "recoveries": self.resilient.recovery_count,
                "inflight_bytes": self.admission.inflight_bytes()}


def build_replicas(n_devices: int, *, device=None, inflight_bytes=None,
                   max_retries: int = 2) -> list[Replica]:
    """Replicas over the first ``n_devices`` cards (:func:`local_devices`),
    or ``n_devices`` CPU replicas with ``device="cpu"``."""
    devs = local_devices(n_devices, device)
    return [Replica(i, d, inflight_bytes=inflight_bytes,
                    max_retries=max_retries)
            for i, d in enumerate(devs)]
