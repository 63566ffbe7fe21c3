"""Multi-replica serving of the PyTorch port under injected device faults,
on CPU replicas.

The port's counterpart of ``tests/test_chaos.py``.  ``QueryScheduler(
devices=N, device="cpu")`` serves on N CPU replicas (``cpu:0`` …), each
with its own fault lifecycle, admission ledger and plan-cache variant,
as the JAX tests' forced host devices are.  The contract: a fatal device
fault mid-run loses NO request — they fail over to healthy replicas and
resolve bit-identical to serial execution; the victim walks quarantine →
probation → recovery (or ejection after repeated probe failures); and
everything joins in bounded time.

Which replica serves first is thread-wakeup order, so device-targeted
schedules first DISCOVER the serving device and then arm the rule at it.
"""

import torch_one_thread  # noqa: F401  (first: one intra-op thread)
import time

import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu_torch import exec as xc
from spark_rapids_jni_tpu_torch import types as T
from spark_rapids_jni_tpu_torch.column import Column, DictColumn, Table
from spark_rapids_jni_tpu_torch.exec.placement import Replica, device_name
from spark_rapids_jni_tpu_torch.faultinj import injector as finj
from spark_rapids_jni_tpu_torch.faultinj.resilience import DeviceQuarantined
from spark_rapids_jni_tpu_torch.models import compiled
from spark_rapids_jni_tpu_torch.utils import flight, metrics

CPU = "cpu"


@pytest.fixture(autouse=True)
def _chaos_env():
    metrics.set_enabled(True)
    metrics.reset()
    flight.reset()
    yield
    finj.get_injector().disable()
    metrics.reset()
    metrics.set_enabled(None)


def _mktab(n, seed):
    rng = np.random.default_rng(seed)
    return Table([Column.from_numpy(rng.integers(0, 100, n).astype(np.int32),
                                    device=CPU),
                  Column.from_numpy(rng.integers(0, 7, n).astype(np.int32),
                                    device=CPU)])


def _q_sum(tbls):
    t = tbls["t"]
    return Table([Column(T.DType(T.TypeId.INT64),
                         t.columns[0].data.to(torch.int64).sum().reshape(1))])


def _same(a, b) -> bool:
    at, bt = [], []
    if compiled._flatten(a, at) != compiled._flatten(b, bt):
        return False
    return all(torch.equal(x, y) for x, y in zip(at, bt))


def _incident_kinds():
    return {e["kind"] for e in flight.events()
            if e["kind"].startswith("incident:")}


def _wait_replica(sched, index, pred, timeout=15.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        snap = sched.ops_state()["replicas"][index]
        if pred(snap):
            return snap
        time.sleep(0.02)
    return sched.ops_state()["replicas"][index]


def _arm(cfg):
    inj = finj.get_injector()
    inj.load_dict(cfg)
    inj.enable()
    return inj


def _one_shot_kill():
    return {"seed": 1, "sites": {"exec.dispatch": {
        "percent": 100, "injectionType": "device_error", "maxHits": 1}}}


def test_fatal_fault_mid_run_fails_over_bit_identical():
    """One-shot fatal fault mid-run on 4 CPU replicas: every request
    still resolves bit-identical to serial; the victim quarantines,
    requests fail over, and the recovery probe re-admits it."""
    tables = {"t": _mktab(4096, 0)}
    oracle = _q_sum(tables)
    t_start = time.monotonic()
    with xc.QueryScheduler(workers=4, devices=4, probe_base_s=0.02,
                           probe_max_s=0.2, device=CPU) as sched:
        assert [r.name for r in sched.replicas] == [
            "cpu:0", "cpu:1", "cpu:2", "cpu:3"]
        inj = _arm(_one_shot_kill())
        tickets = [sched.submit("q", _q_sum, tables) for _ in range(16)]
        for tk in tickets:
            assert _same(tk.result(timeout=120), oracle), \
                "request lost or corrupted under chaos"
        assert inj.injected_count == 1
        vi = next(i for i, r in enumerate(sched.replicas)
                  if r.resilient.fatal_count >= 1)
        snap = _wait_replica(
            sched, vi,
            lambda s: s["state"] == "healthy" and s["recoveries"] >= 1)
        assert snap["state"] == "healthy", snap
        assert snap["fatal_faults"] == 1 and snap["recoveries"] == 1, snap
        relocated = [tk for tk in tickets if tk.relocations > 0]
        assert relocated, "no request failed over"
        assert all(tk.device != sched.replicas[vi].name or tk.relocations
                   == 0 for tk in relocated)
        counters = metrics.snapshot()["counters"]
        assert counters.get("exec.failover.relocated", 0) >= 1
        assert counters.get("exec.failover.recovered", 0) >= 1
        kinds = _incident_kinds()
        assert {"incident:quarantine", "incident:failover",
                "incident:recovery"} <= kinds, kinds
        # the recovered replica serves again, correctly
        after = [sched.submit("q", _q_sum, tables) for _ in range(8)]
        for tk in after:
            assert _same(tk.result(timeout=60), oracle)
    assert time.monotonic() - t_start < 90


def test_multi_device_routing_spreads_load():
    tables = {"t": _mktab(512, 1)}

    def slow(tbls):
        time.sleep(0.03)
        return _q_sum(tbls)

    with xc.QueryScheduler(workers=4, devices=4, coalesce_ms=0,
                           device=CPU) as sched:
        tickets = [sched.submit("slow", slow, tables, compiled=False)
                   for _ in range(16)]
        for tk in tickets:
            assert _same(tk.result(timeout=120), _q_sum(tables))
        used = {tk.device for tk in tickets}
        assert len(used) >= 2, f"all requests pinned to {used}"
        counters = metrics.snapshot()["counters"]
        per_dev = {r.name: counters.get(
            "exec.device." + r.name.replace(":", "") + ".completed", 0)
            for r in sched.replicas}
        assert sum(per_dev.values()) == 16, per_dev


def test_compiled_plans_are_per_replica_variants():
    """Replicas never share a compiled plan: each caches under its own
    ``d<k>`` variant, and every replica's results equal serial."""
    tables = {"t": _mktab(1024, 5)}
    oracle = _q_sum(tables)

    def slow(tbls):
        time.sleep(0.02)
        return _q_sum(tbls)

    with xc.QueryScheduler(workers=2, devices=2, coalesce_ms=0,
                           device=CPU) as sched:
        tickets = [sched.submit("s", slow, tables) for _ in range(12)]
        for tk in tickets:
            assert _same(tk.result(timeout=60), oracle)
        variants = {k[1] for k in sched.plans._d}
    assert variants <= {"d0", "d1"} and variants


def test_ejection_after_repeated_probe_failures():
    tables = {"t": _mktab(1024, 2)}
    oracle = _q_sum(tables)
    with xc.QueryScheduler(workers=2, devices=2, probe_base_s=0.5,
                           probe_max_s=0.6, eject_after=2,
                           device=CPU) as sched:
        inj = _arm(_one_shot_kill())
        tickets = [sched.submit("q", _q_sum, tables) for _ in range(6)]
        for tk in tickets:
            assert _same(tk.result(timeout=120), oracle)
        vi = next(i for i, r in enumerate(sched.replicas)
                  if r.resilient.fatal_count >= 1)
        victim = sched.replicas[vi].name
        inj.load_dict({"seed": 1, "sites": {
            "exec.dispatch": {"percent": 100,
                              "injectionType": "device_error",
                              "device": victim}}})
        snap = _wait_replica(sched, vi, lambda s: s["state"] == "ejected")
        assert snap["state"] == "ejected", snap
        counters = metrics.snapshot()["counters"]
        assert counters.get("exec.failover.probe_failed", 0) >= 2
        assert counters.get("exec.failover.ejected", 0) == 1
        assert "incident:ejected" in _incident_kinds()
        inj.disable()
        tk = sched.submit("q", _q_sum, tables)
        assert _same(tk.result(timeout=60), oracle)
        assert tk.device != victim


def test_whole_pool_quarantined_fails_fast_and_drains():
    tables = {"t": _mktab(256, 3)}
    _arm({"seed": 1, "sites": {"exec.dispatch": {
        "percent": 100, "injectionType": "device_error"}}})
    with xc.QueryScheduler(workers=2, devices=2, recovery=False,
                           coalesce_ms=0, device=CPU) as sched:
        tickets = [sched.submit("q", _q_sum, tables) for _ in range(8)]
        for tk in tickets:
            with pytest.raises(DeviceQuarantined):
                tk.result(timeout=60)
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            try:
                sched.submit("after", _q_sum, tables)
            except DeviceQuarantined:
                break
            time.sleep(0.01)
        else:
            pytest.fail("pool-wide quarantine did not fail fast")


def test_transient_oom_at_dispatch_is_retried():
    """An ``oom`` rule with one interception is retried in place and the
    request gives the right answer."""
    tables = {"t": _mktab(300, 6)}
    inj = _arm({"seed": 1, "sites": {"exec.dispatch": {
        "percent": 100, "injectionType": "oom", "interceptionCount": 1}}})
    with xc.QueryScheduler(workers=1, device=CPU) as sched:
        out = sched.run("q", _q_sum, tables)
    assert _same(out, _q_sum(tables))
    assert inj.injected_count == 1
    assert metrics.snapshot()["counters"].get("exec.retries") == 1


def test_local_devices_and_replica_names():
    assert xc.local_devices(3, CPU) == [torch.device("cpu")] * 3
    reps = xc.build_replicas(2, device=CPU)
    assert [r.name for r in reps] == ["cpu:0", "cpu:1"]
    assert device_name(torch.device("cuda", 1)) == "cuda:1"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            xc.local_devices(1)
    else:
        with pytest.raises(ValueError):
            xc.local_devices(torch.cuda.device_count() + 1)


def test_placement_keeps_dictionary_structure():
    """Replica.place keeps a DictColumn as codes + dictionary (nothing
    materialized); on a CPU replica the tensors are the sources."""
    rep = Replica(1, CPU)
    dictionary = Column.strings_from_list(["aa", "bbb", "cc"], device=CPU)
    codes = torch.tensor([2, 0, 1, 1, 0], dtype=torch.int32)
    tab = Table([Column.from_numpy(np.arange(5, dtype=np.int32),
                                   device=CPU),
                 DictColumn(codes, dictionary)])
    placed = rep.place({"t": tab})["t"]
    assert isinstance(placed.columns[1], DictColumn)
    assert placed.columns[1]._mat is None and tab.columns[1]._mat is None
    assert placed.columns[1].codes is codes
    assert placed.columns[0].data is tab.columns[0].data
    assert placed.columns[1].to_pylist() == tab.columns[1].to_pylist()


def test_placement_scope_sets_device_identity():
    rep = Replica(2, CPU)
    assert rep.name == "cpu:2"
    with rep.scope():
        assert finj.current_device() == rep.name
    assert finj.current_device() is None
    rep.canary()                          # healthy: passes
    assert rep.resilient.state == "healthy"


def test_prefetch_slot_discarded_on_queue_deadline():
    tables = {"t": _mktab(256, 4)}

    def blocker_q(tbls):
        time.sleep(0.3)
        return _q_sum(tbls)

    with xc.QueryScheduler(workers=1, devices=1, coalesce_ms=0,
                           device=CPU) as sched:
        blocker = sched.submit("blocker", blocker_q, tables,
                               compiled=False)
        doomed = sched.submit("doomed", _q_sum, loader=lambda: tables,
                              timeout_s=0.01, compiled=False)
        with pytest.raises(xc.ExecDeadlineExceeded):
            doomed.result(timeout=60)
        blocker.result(timeout=60)
        counters = metrics.snapshot()["counters"]
        assert counters.get("exec.prefetch.discarded", 0) >= 1, counters
