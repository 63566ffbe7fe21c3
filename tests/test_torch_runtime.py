"""The runtime's host-only modules of the PyTorch port against the JAX
package's, on the same inputs, and their CPU behaviour.

Metrics (histogram quantiles and snapshots, the Chrome-trace keys, the
Prometheus text), the flight recorder (the ring, the incident JSON), the
structured log, the SLO watchdog, ``parse_bytes``, the fault injector's
decisions under one config and seed, the resilient executor's backoff
under one seed and the lock-order watchdog's violations are copies of
the JAX package's modules: each must give the JAX function's output.
Beside them: the knobs' registration, the budget's spill order, a spill
and fault-back round trip, the device lock of ``models/compiled.py``, and
the capture faults on the Mortgage ETL's path (its tape is as long
eagerly as compiled, and its compiled run makes no call that would
synchronise on the card).
"""

import torch_one_thread  # noqa: F401  (first: one intra-op thread)
import json
import pathlib
import sys
import threading
import time

import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu.analysis import sanitize as jsanitize
from spark_rapids_jni_tpu.exec import slo as jslo
from spark_rapids_jni_tpu.faultinj import injector as jinjector
from spark_rapids_jni_tpu.faultinj import resilience as jresilience
from spark_rapids_jni_tpu.memory import budget as jbudget
from spark_rapids_jni_tpu.memory import spill as jspill
from spark_rapids_jni_tpu.utils import flight as jflight
from spark_rapids_jni_tpu.utils import knobs as jknobs
from spark_rapids_jni_tpu.utils import metrics as jmetrics
from spark_rapids_jni_tpu.utils import structured_log as jlog

from spark_rapids_jni_tpu_torch.analysis import sanitize
from spark_rapids_jni_tpu_torch.exec import slo
from spark_rapids_jni_tpu_torch.faultinj import injector, resilience
from spark_rapids_jni_tpu_torch.memory import budget, spill
from spark_rapids_jni_tpu_torch.models import compiled, mortgage
from spark_rapids_jni_tpu_torch.utils import flight, knobs, metrics
from spark_rapids_jni_tpu_torch.utils import structured_log as log
from spark_rapids_jni_tpu_torch.utils import syncs

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "tools"))
import torch_mortgage_parquet as MW  # noqa: E402

CPU = "cpu"


@pytest.fixture
def both_metrics():
    for m in (metrics, jmetrics):
        m.set_enabled(True)
        m.reset()
    yield
    for m in (metrics, jmetrics):
        m.reset()
        m.set_enabled(None)


def _observations(seed=0, n=300):
    rng = np.random.default_rng(seed)
    vals = np.concatenate([rng.exponential(20.0, n), [0.0, 0.5, 4096.0]])
    return [float(v) for v in vals]


# --- metrics ------------------------------------------------------------------


def test_histogram_quantiles_and_snapshot_equal_jax(both_metrics):
    for v in _observations():
        for m in (metrics, jmetrics):
            m.observe("exec.e2e_ms", v)
            m.count("exec.completed")
            m.gauge("exec.inflight_bytes", v)
            m.gauge_max("hbm.live_bytes.peak", v)
    for q in (0, 1, 25, 50, 90, 95, 99, 99.9, 100):
        assert metrics.percentile("exec.e2e_ms", q) \
            == jmetrics.percentile("exec.e2e_ms", q), q
        assert metrics.percentile("exec.e2e_ms", q, window_s=600) \
            == jmetrics.percentile("exec.e2e_ms", q, window_s=600), q
    assert metrics.percentile("nothing", 50) is None
    mine, theirs = metrics.snapshot(), jmetrics.snapshot()
    assert mine == theirs
    assert metrics.to_prometheus() == jmetrics.to_prometheus()


def test_chrome_trace_keys_equal_jax(both_metrics):
    for m in (metrics, jmetrics):
        with m.span("query:q3", degraded=False):
            with m.span("batch", size=2):
                m.count("exec.plan_cache.hit")
            m.annotate(rows=7)
        m.observe("exec.stage.queue_ms", 1.5)
        m.ledger_add("q3", runs=1)
    mine, theirs = metrics.chrome_trace(), jmetrics.chrome_trace()
    assert set(mine) == set(theirs)
    for k in ("srjtCounters", "srjtGauges", "srjtHistograms", "srjtLedger"):
        assert mine[k] == theirs[k], k

    def shape(trace):
        return [(e["name"], e["ph"], sorted(e), e.get("args"))
                for e in trace["traceEvents"]]
    assert shape(mine) == shape(theirs)
    assert [r["name"] for r in metrics.span_roots()] == ["query:q3"]
    assert metrics.stage_breakdown().keys() \
        == jmetrics.stage_breakdown().keys()


def test_recording_is_off_under_replay_and_when_disabled(both_metrics):
    with syncs.replay([]):
        metrics.count("x")
        metrics.count("y", in_trace=True)
    assert metrics.snapshot()["counters"] == {"y": 1}
    metrics.set_enabled(False)
    assert metrics.span("s") is metrics.span("t")     # the shared no-op
    metrics.count("z")
    assert "z" not in metrics.snapshot()["counters"]


def test_device_memory_census_on_the_cpu_reads_zero(both_metrics):
    """Divergence from the JAX package: torch keeps no list of live CPU
    tensors, so the census reads 0 there and sets no per-device gauge."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert metrics.sample_hbm() == 0
    gauges = metrics.snapshot()["gauges"]
    assert gauges["hbm.live_bytes"] == 0
    assert not any(k.startswith("hbm.device") for k in gauges)


def test_metrics_http_server_serves_prometheus(both_metrics, monkeypatch):
    import urllib.request
    monkeypatch.delenv("SRJT_METRICS_PORT", raising=False)
    assert metrics.start_http_server() is None      # no port: a no-op
    srv = metrics.start_http_server(port=0)
    try:
        metrics.count("exec.completed", 3)
        url = f"http://127.0.0.1:{srv.server_port}/metrics"
        body = urllib.request.urlopen(url, timeout=10).read().decode()
        assert "srjt_exec_completed 3" in body
    finally:
        metrics.stop_http_server()


# --- flight recorder and structured log ---------------------------------------


@pytest.fixture
def both_flight():
    for f in (flight, jflight):
        f.reset()
    yield
    for f in (flight, jflight):
        f.reset()


def _strip(ev):
    return {k: v for k, v in ev.items() if k not in ("ts", "tid")}


def test_flight_ring_equals_jax(both_flight):
    for f in (flight, jflight):
        f.set_capacity(8)
        for i in range(12):
            f.record("exec.submit", rid=f"q#{i}", qdepth=i)
        f.record("exec.coalesce", rid="q#11", batch=["q#10", "q#11"])
    try:
        mine = [_strip(e) for e in flight.events()]
        assert mine == [_strip(e) for e in jflight.events()]
        assert len(mine) == 8 and mine[0]["rid"] == "q#5"
        for rid in ("q#10", "q#11"):
            assert [_strip(e) for e in flight.events(request_id=rid)] \
                == [_strip(e) for e in jflight.events(request_id=rid)]
    finally:
        for f in (flight, jflight):
            f.set_capacity(knobs.get("SRJT_FLIGHT_N"))


def test_incident_json_keys_equal_jax(both_flight, both_metrics, tmp_path,
                                      monkeypatch):
    mine_dir, theirs_dir = tmp_path / "port", tmp_path / "jax"
    snaps = {}
    for name, f, d in (("port", flight, mine_dir),
                       ("jax", jflight, theirs_dir)):
        monkeypatch.setenv("SRJT_INCIDENT_DIR", str(d))
        monkeypatch.setenv("SRJT_INCIDENT_PER_KIND", "2")
        f.register_probe("scheduler.queue_depth", lambda: 3)
        f.register_probe("broken", lambda: 1 / 0)
        try:
            f.record("exec.submit", rid="q#1")
            paths = [f.incident("deadline", request_id="q#1",
                                batch=["q#1", "q#2"], stage="queue",
                                e2e_ms=1.5) for _ in range(3)]
        finally:
            f.unregister_probe("scheduler.queue_depth")
            f.unregister_probe("broken")
        assert paths[0] and paths[1] and paths[2] is None   # capped at 2
        with open(paths[0]) as fh:
            snaps[name] = json.load(fh)
    mine, theirs = snaps["port"], snaps["jax"]
    assert set(mine) == set(theirs)
    for k in ("kind", "request_id", "batch", "fields"):
        assert mine[k] == theirs[k], k
    assert [_strip(e) for e in mine["events"]] \
        == [_strip(e) for e in theirs["events"]]
    assert mine["probes"]["scheduler.queue_depth"] == 3
    assert mine["probes"]["broken"].startswith("<probe error")
    assert set(mine["metrics"]) == set(theirs["metrics"])


def test_structured_log_lines_equal_jax(tmp_path):
    lines = {}
    for name, lg in (("port", log), ("jax", jlog)):
        path = tmp_path / f"{name}.log"
        lg.configure("json", str(path))
        try:
            with lg.bound(request_id="q3#7"):
                lg.event("exec.resolve", duration_s=0.0125, outcome="ok")
                lg.event("slo.breach", request_id="mine", objective="p95")
            lg.event("after", x=1)
        finally:
            lg.configure("off")
        lines[name] = [json.loads(t) for t in path.read_text().splitlines()]
    strip = [[{k: v for k, v in r.items() if k != "ts"} for r in lines[n]]
             for n in ("port", "jax")]
    assert strip[0] == strip[1]
    assert strip[0][0] == {"event": "exec.resolve", "duration_ms": 12.5,
                           "request_id": "q3#7", "outcome": "ok"}


# --- SLO watchdog --------------------------------------------------------------


def test_slo_status_over_one_stream_equals_jax(both_metrics):
    th = {"p50_ms": 10.0, "p95_ms": 40.0, "error_rate": 0.05,
          "deadline_rate": 0.02, "defer_rate": 0.5}
    mine = slo.SloWatchdog(thresholds=th, window_s=600, min_n=8,
                           cooldown_s=3600)
    theirs = jslo.SloWatchdog(thresholds=th, window_s=600, min_n=8,
                              cooldown_s=3600)
    rng = np.random.default_rng(3)
    fired = ([], [])
    for i, v in enumerate(_observations(3, 60)):
        outcome = ("error" if i % 17 == 0 else
                   "deadline" if i % 23 == 0 else "ok")
        kw = dict(outcome=outcome, degraded=bool(rng.random() < 0.1),
                  deferred=i % 3 == 0, relocated=i % 29 == 0)
        qclass = "q3" if i % 2 else "q7"
        fired[0].extend(mine.observe(qclass, v, **kw))
        fired[1].extend(theirs.observe(qclass, v, **kw))
    assert fired[0] == fired[1] and fired[0]
    assert mine.status() == theirs.status()
    assert mine.breach_count == theirs.breach_count


def test_slo_watchdog_breach_cooldown_and_disabled():
    assert not slo.SloWatchdog(thresholds={}).enabled()
    w = slo.SloWatchdog(thresholds={"p95_ms": 10.0}, window_s=60,
                        min_n=4, cooldown_s=3600)
    for _ in range(3):
        assert w.observe("q", 100.0) == []       # below min population
    fired = w.observe("q", 100.0, request_id="q#3")
    assert len(fired) == 1 and fired[0]["objective"] == "p95_ms"
    assert w.observe("q", 100.0) == []           # cooldown holds
    assert w.class_status("q")["objectives"]["p95_ms"]["breached"]


def test_slo_thresholds_from_env_equal_jax(monkeypatch):
    monkeypatch.setenv("SRJT_SLO_P99_MS", "250")
    monkeypatch.setenv("SRJT_SLO_RELOCATE_RATE", "0.1")
    monkeypatch.setenv("SRJT_SLO_P50_MS", " ")
    assert slo.thresholds_from_env() == jslo.thresholds_from_env() \
        == {"p99_ms": 250.0, "relocate_rate": 0.1}


# --- knobs, parse_bytes --------------------------------------------------------

RUNTIME_KNOBS = (
    ["SRJT_EXEC"]
    + [k for k in jknobs.REGISTRY if k.startswith("SRJT_EXEC_")]
    + [k for k in jknobs.REGISTRY if k.startswith("SRJT_SLO_")]
    + ["SRJT_METRICS_PORT", "SRJT_METRICS_WINDOW_N", "SRJT_FLIGHT",
       "SRJT_FLIGHT_N", "SRJT_INCIDENT_DIR", "SRJT_INCIDENT_PER_KIND",
       "SRJT_HBM_BUDGET", "SRJT_SANITIZE"])


@pytest.mark.parametrize("name", RUNTIME_KNOBS)
def test_runtime_knob_registered_as_in_jax(name, monkeypatch):
    mine, theirs = knobs.REGISTRY[name], jknobs.REGISTRY[name]
    assert mine.default == theirs.default
    monkeypatch.delenv(name, raising=False)
    assert knobs.get(name) == jknobs.get(name)
    for raw in ("0", "1", "off", "7", "2.5", "64m", ""):
        monkeypatch.setenv(name, raw)
        try:
            want = jknobs.get(name)
        except (ValueError, TypeError) as e:
            with pytest.raises(type(e)):
                knobs.get(name)
            continue
        assert knobs.get(name) == want, raw


def test_aot_and_arena_knobs_wait_for_their_modules():
    # the AOT store has its module (exec/artifacts.py): its knobs are the
    # JAX package's, defaults included, but for SRJT_AOT_XLA_CACHE (XLA's
    # executable cache has no torch counterpart); the arena has its module
    # too now (memory/arena.py), and its knobs are the JAX package's
    aot = {k for k in knobs.REGISTRY if k.startswith("SRJT_AOT_")}
    assert aot == {k for k in jknobs.REGISTRY if k.startswith("SRJT_AOT_")
                   and k != "SRJT_AOT_XLA_CACHE"}
    arena = {"SRJT_HBM_ARENA", "SRJT_ARENA_ZEROS_CAP", "SRJT_HOSTCACHE_CAP",
             "SRJT_INDEX_CACHE_CAP"}
    assert all(knobs.REGISTRY[k].default == jknobs.REGISTRY[k].default
               for k in aot | arena)


@pytest.mark.parametrize("raw", ["512m", "2g", "1.5k", "65536", " 3T ",
                                 "", "none", "unlimited", "off", None, 4096,
                                 7.9])
def test_parse_bytes_equals_jax(raw):
    assert budget.parse_bytes(raw) == jbudget.parse_bytes(raw)


# --- fault injection and the resilient executor -------------------------------

_INJECT_CFG = {"seed": 42, "sites": {
    "exec.dispatch": {"percent": 40, "interceptionCount": 9,
                      "injectionType": "oom"},
    "other": {"percent": 100, "injectionType": "substitute",
              "substituteResult": 17, "maxHits": 2},
    "pinned": {"percent": 100, "injectionType": "device_error",
               "device": "cuda:1"},
    "*": {"percent": 10, "injectionType": "device_error"}}}


def _decisions(mod):
    inj = mod.FaultInjector()
    inj.load_dict(_INJECT_CFG)
    inj._enabled = True
    out = []
    for i in range(120):
        site = ("exec.dispatch", "other", "pinned", "wild")[i % 4]
        dev = "cuda:1" if i % 8 == 2 else "cuda:0"
        with mod.device_scope(dev):
            try:
                out.append(("ok", inj.check(site)))
            except Exception as e:
                out.append((type(e).__name__, None))
    return out, inj.injected_count


def test_injector_decisions_equal_jax():
    mine, theirs = _decisions(injector), _decisions(jinjector)
    assert mine == theirs
    kinds = {d[0] for d in mine[0]}
    assert kinds >= {"ok", "InjectedOomError", "InjectedDeviceError"}
    assert ("ok", (True, 17)) in mine[0]


def test_injector_hot_reload(tmp_path):
    path = tmp_path / "faults.json"
    cfg = {"dynamic": True, "seed": 1,
           "sites": {"s": {"percent": 100, "injectionType": "oom"}}}
    path.write_text(json.dumps(cfg))
    inj = injector.FaultInjector()
    try:
        inj.enable(str(path))
        with pytest.raises(injector.InjectedOomError):
            inj.check("s")
        time.sleep(0.05)
        cfg["sites"] = {}
        path.write_text(json.dumps(cfg))
        import os
        os.utime(path, (time.time() + 5, time.time() + 5))
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and inj._rules:
            time.sleep(0.05)
        assert not inj._rules and inj.check("s") is None
    finally:
        inj.disable()


def test_resilient_backoff_delays_equal_jax():
    mine = resilience.ResilientExecutor(backoff_s=0.01, backoff_max_s=0.1,
                                        jitter=0.5, seed=7)
    theirs = jresilience.ResilientExecutor(backoff_s=0.01,
                                           backoff_max_s=0.1, jitter=0.5,
                                           seed=7)
    got = [mine.backoff_delay(a) for a in range(1, 9)]
    assert got == [theirs.backoff_delay(a) for a in range(1, 9)]
    assert all(d <= 0.1 * 1.5 for d in got)
    assert resilience.ResilientExecutor().backoff_delay(3) == 0.0


def test_resilient_lifecycle():
    ex = resilience.ResilientExecutor(max_retries=2, device="cpu:0")
    n = {"calls": 0}

    def oom_twice():
        n["calls"] += 1
        if n["calls"] <= 2:
            raise MemoryError("transient")
        return 5

    assert ex.submit(oom_twice) == 5 and ex.retry_count == 2

    def fatal():
        raise injector.InjectedDeviceError("trap")
    with pytest.raises(resilience.DeviceQuarantined):
        ex.submit(fatal)
    assert ex.quarantined
    with pytest.raises(resilience.DeviceQuarantined):
        ex.submit(lambda: 1)
    assert ex.recover() and ex.state == "probation"
    assert ex.submit(lambda: 1) == 1
    assert ex.state == "healthy" and ex.recovery_count == 1


# --- lock-order watchdog ------------------------------------------------------


def _inversion(mod, monkeypatch, mode):
    monkeypatch.setenv("SRJT_SANITIZE", mode)
    mod.reset()
    a, b = mod.tracked_lock("test.a"), mod.tracked_lock("test.b")
    with a:
        with b:
            pass
    error = None
    try:
        with b:
            with a:
                pass
    except Exception as e:
        error = type(e).__name__
    strip = [{k: v for k, v in x.items() if k != "prior_stack"}
             for x in mod.violations()]
    mod.reset()
    return strip, error


@pytest.mark.parametrize("mode", ["1", "strict"])
def test_lock_order_violations_equal_jax(mode, monkeypatch):
    mine = _inversion(sanitize, monkeypatch, mode)
    assert mine == _inversion(jsanitize, monkeypatch, mode)
    assert mine[0] == [{"acquiring": "test.a", "while_holding": "test.b",
                        "established_path": ["test.a", "test.b"]}]
    assert mine[1] == ("LockOrderError" if mode == "strict" else None)


def test_sanitizer_off_gives_plain_locks(monkeypatch):
    monkeypatch.delenv("SRJT_SANITIZE", raising=False)
    assert type(sanitize.tracked_lock("x")) is type(threading.Lock())
    monkeypatch.setenv("SRJT_SANITIZE", "1")
    assert "tracked" in repr(sanitize.tracked_rlock("x"))


def test_recapture_tripwire_equals_jax(monkeypatch):
    monkeypatch.setenv("SRJT_SANITIZE", "1")
    for mod in (sanitize, jsanitize):
        mod.reset()
        for _ in range(3):
            mod.note_trace("q3#0")
        with mod.allow_retrace():
            mod.note_trace("q3#0")
    assert [(e["key"], e["count"]) for e in sanitize.retrace_events()] \
        == [(e["key"], e["count"]) for e in jsanitize.retrace_events()] \
        == [("q3#0", 2), ("q3#0", 3)]
    monkeypatch.setenv("SRJT_SANITIZE", "strict")
    with pytest.raises(sanitize.RetraceError):
        sanitize.note_trace("q3#0")
    for mod in (sanitize, jsanitize):
        mod.reset()


# --- memory budget and spill --------------------------------------------------


def _spill_order(bmod, smod, monkeypatch):
    """Register four residents, charge past the limit, and return which
    spilled, in order, and the ledger."""
    monkeypatch.setenv("SRJT_HBM_BUDGET", "1000")
    bmod.set_enabled(None)
    bmod.reset()
    smod.reset()
    spilled = []
    try:
        for k in range(4):
            smod.register(("r", k), 200, "test",
                          lambda k=k: spilled.append(k) or 200)
        smod.touch(("r", 0))                  # 0 becomes most recent
        fits = bmod.charge(500, tag="query")
        with pytest.raises(bmod.HbmBudgetExceeded):
            bmod.charge(10_000, tag="big", strict=True)
        return spilled, fits, bmod.in_use(), bmod.peak(), \
            smod.registered_bytes()
    finally:
        bmod.reset()
        smod.reset()
        monkeypatch.delenv("SRJT_HBM_BUDGET")
        bmod.set_enabled(None)


def test_budget_spill_order_equals_jax(monkeypatch):
    mine = _spill_order(budget, spill, monkeypatch)
    assert mine == _spill_order(jbudget, jspill, monkeypatch)
    assert mine[0][:2] == [1, 2]


def test_budget_query_scope_and_card_limit(monkeypatch):
    monkeypatch.delenv("SRJT_HBM_BUDGET", raising=False)
    assert not budget.enabled() or budget.process_limit() is not None
    if not torch.cuda.is_available():
        assert budget.process_limit() is None      # no card, no limit
    budget.set_enabled(True)
    try:
        with budget.query_budget("q", limit_bytes="1k") as q:
            assert budget.limit_now() == 1024
            assert budget.charge(100)
            budget.release(100)
        assert q.peak >= 100 and budget.current() is None
    finally:
        budget.reset()
        budget.set_enabled(None)


def test_spill_round_trip_is_bit_exact():
    rng = np.random.default_rng(1)
    f = rng.standard_normal(1000)
    f[::7] = np.nan
    arrays = {"f64": torch.from_numpy(f.copy()),
              "i64": torch.from_numpy(rng.integers(-2**62, 2**62, 999)),
              "u8": torch.from_numpy(rng.integers(0, 256, 1001)
                                     .astype(np.uint8)),
              "none": None}
    keep = {k: (None if v is None else v.clone()) for k, v in arrays.items()}
    sa = spill.SpillableArrays("test", arrays)
    assert sa.nbytes == 1000 * 8 + 999 * 8 + 1001
    assert sa.spill() == sa.nbytes and sa.spilled
    assert sa.spill() == 0
    back = sa.get()
    assert not sa.spilled
    for k, v in keep.items():
        if v is None:
            assert back[k] is None
            continue
        assert back[k].device == v.device and back[k].dtype == v.dtype
        assert torch.equal(back[k].view(torch.uint8), v.view(torch.uint8))


def test_spillable_arrays_concurrent_faultback():
    data = torch.arange(4096, dtype=torch.int32)
    for _ in range(20):
        sa = spill.SpillableArrays("t", {"d": data.clone()})
        assert sa.spill() > 0
        outs, errs = [], []

        def reader():
            try:
                outs.append(sa.get()["d"])
            except Exception as e:
                errs.append(e)
        ts = [threading.Thread(target=reader) for _ in range(4)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=30)
        assert not errs, errs
        assert all(torch.equal(o, data) for o in outs)


def test_spillable_table_leaves_cpu_tables_alone(monkeypatch):
    """A table's spill moves card tensors only: on the CPU there is
    nothing to move, and unregistering gives the table back as it was."""
    from spark_rapids_jni_tpu_torch.column import Column, Table
    t = Table([Column.from_numpy(np.arange(10, dtype=np.int64),
                                 device=CPU)])
    st = spill.SpillableTable(t, "test")
    assert st.nbytes == 0 and st.spill() == 0 and st.faultback() == 0
    monkeypatch.setenv("SRJT_HBM_BUDGET", "1m")
    budget.set_enabled(None)
    try:
        assert spill.register_table(t, "exec.prefetch") is None
    finally:
        monkeypatch.delenv("SRJT_HBM_BUDGET")
        budget.set_enabled(None)


# --- the device lock ----------------------------------------------------------


def test_device_lock_shared_exclusive_and_reentry():
    lock = compiled.DeviceLock("test.device")
    events = []
    inside = threading.Event()
    release = threading.Event()

    def reader():
        with lock.shared():
            inside.set()
            release.wait(10)
            events.append("reader out")

    def writer():
        with lock.exclusive():
            events.append("writer in")

    r = threading.Thread(target=reader)
    r.start()
    assert inside.wait(10)
    with lock.shared():                  # shared beside the reader
        with lock.shared():              # reentrant
            pass
        with pytest.raises(RuntimeError, match="wait for itself"):
            with lock.exclusive():
                pass
    w = threading.Thread(target=writer)
    w.start()
    time.sleep(0.1)
    assert events == []                  # the writer waits for the reader
    release.set()
    r.join(10)
    w.join(10)
    assert events == ["reader out", "writer in"]
    with lock.exclusive():
        with lock.exclusive(), lock.shared():   # reentrant in a capture
            pass


# --- the capture faults on the Mortgage ETL's path ----------------------------


@pytest.fixture(scope="module")
def mortgage_files():
    return MW.mortgage_parquet(300, 6, 5)[0]


def test_etl_tape_as_long_eagerly_as_compiled(mortgage_files):
    """Every size the ETL reads goes through the funnel: the eager capture
    run records its tape, and a compiled run resolves exactly as many
    sizes from it (``run`` raises otherwise), with the eager result's
    bits and no call that would synchronise on the card.  The capture
    runs on tables whose dictionary columns an eager run materialized
    already, the replays on fresh ones, as the card's graph replays over
    fresh copies: a materialized column resolves the same sizes, in the
    same order, as a fresh one."""
    from test_torch_compiled import NoHostSync, assert_bit_equal
    tables = mortgage.load_tables(mortgage_files, device=CPU)
    want = mortgage.etl_tables(tables)
    cq = compiled.compile_query(mortgage.etl_tables, tables)
    assert cq.tape
    fresh = mortgage.load_tables(mortgage_files, device=CPU)
    seen = []
    with syncs.replay(cq.tape, collect=seen):
        compiled._materialized(mortgage.etl_tables(fresh))
    assert [int(v) for v in seen] == list(cq.tape)
    assert_bit_equal(cq.run(fresh), want)
    again = mortgage.load_tables(mortgage_files, device=CPU)
    before = syncs.sync_count()
    with NoHostSync():
        got = cq.run_unchecked(again)
    assert syncs.sync_count() == before
    assert_bit_equal(got, want)


def test_dictionary_gather_bounds_go_through_the_funnel():
    """B6's bounds check reads the codes' least and greatest through
    ``syncs.scalar``: two tape entries, none read under replay, and a
    stale tape is caught by the check, not by an index out of bounds."""
    from spark_rapids_jni_tpu_torch.rowconv import bytepath
    mat = torch.arange(12, dtype=torch.int32).reshape(4, 3)
    idx = torch.tensor([3, 0, 2, 2], dtype=torch.int32)
    tape = []
    with syncs.capture(tape):
        want = bytepath.gather_rows(mat, idx)
    assert tape == [0, 3]
    seen = []
    with syncs.replay(tape, collect=seen):
        got = bytepath.gather_rows(mat, idx)
    assert torch.equal(got, want) and [int(s) for s in seen] == [0, 3]
    with syncs.replay([0, 3], collect=seen):
        bytepath.gather_rows(mat, torch.tensor([7, 0], dtype=torch.int32))
    with pytest.raises(IndexError):
        bytepath.gather_rows(mat, torch.tensor([4], dtype=torch.int32))


def test_constant_tables_are_built_once_a_device():
    from spark_rapids_jni_tpu_torch.ops import strings
    a = strings._const("pow10", strings._POW10[:19], torch.int64, CPU)
    b = strings._const("pow10", strings._POW10[:19], torch.int64,
                       torch.device(CPU))
    assert a is b and a[18] == 10 ** 18
