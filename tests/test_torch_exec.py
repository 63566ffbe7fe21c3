"""The serving runtime of the PyTorch port (``exec/``), on the CPU.

The port's counterpart of ``tests/test_exec_runtime.py``: concurrency,
admission degradation, plan caching, coalescing and prefetch change
LATENCY, never results, and overload is a typed failure (queue full,
deadline, shutdown, quarantine), never a stall.  The scheduler serves on
CPU replicas (``device="cpu"``); TPC-DS runs on the 40,000-row data of
``tests/torch_tpcds_cases.py`` with one intra-op thread:

* the concurrent mix from 4 client threads is bit-identical to the
  port's serial eager runs, and equal to the JAX package's serial
  results as the other TPC-DS tests hold them (floats within ``RTOL``);
* typed backpressure, deadlines and shutdown; the plan cache's hit, miss,
  eviction, expiry, size-fingerprint hit, stale-tape recompile and
  single flight; coalesced bursts, batch splits over the cap and
  ``run_vmapped`` batches; prefetch hit, miss and the
  take-before-stage race; admission defer and degrade parity; lifecycle
  tracing and linked batch rids; SLO breach incidents; ``ops_state``.
"""

import torch_one_thread  # noqa: F401  (first: one intra-op thread)
import functools
import gc
import json
import threading
import time

import numpy as np
import pytest
import torch

import spark_rapids_jni_tpu_torch as pt
from spark_rapids_jni_tpu_torch import exec as xc
from spark_rapids_jni_tpu_torch import types as T
from spark_rapids_jni_tpu_torch.column import Column, LazyColumn, Table
from spark_rapids_jni_tpu_torch.models import compiled, tpcds, tpcds_plans
from spark_rapids_jni_tpu_torch.models import tpcds_sql as TS
from spark_rapids_jni_tpu_torch.ops import join_plan
from spark_rapids_jni_tpu_torch.utils import flight, metrics, syncs

from torch_jax_columns import assert_same_table
from torch_tpcds_cases import (CPU, RTOL,  # noqa: F401
                               _jax_native_library, data, jax_results_of,
                               jax_tables_of, port_tables)

QNAMES = ["q3", "q7", "q65", "q36_rollup"]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _metrics_on():
    metrics.set_enabled(True)
    metrics.reset()
    yield
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


def _q_slow(tbls):
    time.sleep(0.1)
    return _q_sum(tbls)


def _bits(t):
    return t.view(torch.int64) if t.dtype == torch.float64 else t


def _same(a, b) -> bool:
    """Two results hold the same structure and the same bits."""
    at, bt = [], []
    if compiled._flatten(a, at) != compiled._flatten(b, bt):
        return False
    return all(torch.equal(_bits(x), _bits(y)) for x, y in zip(at, bt))


def _counters():
    return metrics.snapshot()["counters"]


def _query(name, data):
    return functools.partial(tpcds.QUERIES[name], **data[3][name])


@pytest.fixture(scope="module")
def qfns(data):
    return {q: _query(q, data) for q in QNAMES}


@pytest.fixture(scope="module")
def serial(qfns, port_tables):
    return {q: fn(port_tables) for q, fn in qfns.items()}


@pytest.fixture(scope="module")
def jax_results(data):
    return jax_results_of(QNAMES, data)


# --- TPC-DS differential -----------------------------------------------------


def _serve_mix(tables, qfns, **sched_kw):
    """Each query submitted once from each of 4 client threads; the
    tickets by (client, query)."""
    tickets, errs = {}, []
    with xc.QueryScheduler(workers=4, device=CPU, **sched_kw) as sched:
        def client(i):
            try:
                for q in QNAMES:
                    tickets[(i, q)] = sched.submit(q, qfns[q], tables)
            except Exception as e:       # surfaced to the test
                errs.append(e)
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not errs, errs
        results = {k: tk.result(timeout=300) for k, tk in tickets.items()}
    return results


@pytest.fixture(scope="module")
def served(qfns, port_tables):
    metrics.set_enabled(True)
    metrics.reset()
    results = _serve_mix(port_tables, qfns)
    return results, _counters()


def test_concurrent_mix_counts(served):
    _, counters = served
    assert counters.get("exec.completed", 0) == 16
    # 4 distinct (query, fingerprint) keys; the other 12 requests hit
    assert counters.get("exec.plan_cache.miss", 0) == 4
    assert counters.get("exec.plan_cache.hit", 0) == 12
    assert counters.get("exec.failed", 0) == 0


@pytest.mark.parametrize("name", QNAMES)
def test_served_bit_identical_to_serial(name, served, serial):
    results, _ = served
    for i in range(4):
        assert _same(results[(i, name)], serial[name]), (i, name)


@pytest.mark.parametrize("name", QNAMES)
def test_served_matches_jax(name, served, jax_results):
    results, _ = served
    want = jax_results[name]
    for i in range(4):
        got = results[(i, name)]
        assert got.schema == [pt.DType(pt.TypeId(int(c.dtype.id)),
                                       c.dtype.scale)
                              for c in want.columns]
        assert_same_table(got, want, rtol=RTOL)


def test_concurrent_eager_under_budget_and_index_evictions(
        qfns, port_tables, serial, monkeypatch):
    """Eager serving (the build-index cache is live only outside
    capture/replay) with the budget ledger on and an index cache so small
    that every concurrent join evicts its neighbour."""
    from spark_rapids_jni_tpu_torch.memory import budget, spill
    monkeypatch.setenv("SRJT_HBM_BUDGET", "64m")
    monkeypatch.setattr(join_plan, "INDEX_CACHE_CAP", 4096)
    budget.set_enabled(None)
    spill.reset()
    budget.reset()
    try:
        with xc.QueryScheduler(workers=4, device=CPU) as sched:
            tickets = [(q, sched.submit(q, qfns[q], port_tables,
                                        compiled=False))
                       for _ in range(2) for q in QNAMES]
            for q, tk in tickets:
                assert _same(tk.result(timeout=300), serial[q]), q
    finally:
        monkeypatch.undo()
        budget.set_enabled(None)
        spill.reset()
        budget.reset()
    assert _counters().get("exec.failed", 0) == 0


def test_degraded_admission_parity(qfns, port_tables, serial):
    """A cap every request exceeds: all requests degrade to the sorted
    engine, complete, and match the dense serial run bit for bit."""
    tickets = []
    with xc.QueryScheduler(workers=2, inflight_bytes=4096,
                           device=CPU) as sched:
        for q in QNAMES:
            tickets.append((q, sched.submit(q, qfns[q], port_tables,
                                            compiled=False)))
        for q, tk in tickets:
            assert _same(tk.result(timeout=300), serial[q]), q
            assert tk.degraded
    c = _counters()
    assert c.get("exec.admission.degraded", 0) >= len(QNAMES)
    assert c.get("exec.failed", 0) == 0


def test_degraded_compiled_plan_is_its_own_variant(qfns, port_tables,
                                                   serial):
    """A degraded compiled request caches under the ``sorted`` variant and
    still equals the dense serial run."""
    with xc.QueryScheduler(workers=1, inflight_bytes=4096,
                           device=CPU) as sched:
        tk = sched.submit("q3", qfns["q3"], port_tables)
        assert _same(tk.result(timeout=300), serial["q3"])
        assert tk.degraded
        keys = list(sched.plans._d)
    assert keys and all(k[1] == "sorted" for k in keys)


# --- backpressure / deadlines / lifecycle ------------------------------------


def test_queue_full_typed():
    tables = {"t": _mktab(100, 0)}
    with xc.QueryScheduler(workers=1, queue_depth=2, device=CPU) as sched:
        held, full = [], 0
        for _ in range(10):
            try:
                held.append(sched.submit("s", _q_slow, tables,
                                         compiled=False))
            except xc.ExecQueueFull as e:
                full += 1
                assert e.depth == 2
        assert full >= 1
        for tk in held:
            tk.result(timeout=60)
    assert _counters().get("exec.queue.rejected") == full


def test_deadline_in_queue_typed():
    tables = {"t": _mktab(100, 0)}
    with xc.QueryScheduler(workers=1, queue_depth=4, device=CPU) as sched:
        blocker = sched.submit("s", _q_slow, tables, compiled=False)
        tk = sched.submit("dl", _q_slow, tables, compiled=False,
                          timeout_s=0.001)
        with pytest.raises(xc.ExecDeadlineExceeded) as ei:
            tk.result(timeout=60)
        assert ei.value.stage == "queue"
        blocker.result(timeout=60)


def test_shutdown_drains_typed():
    tables = {"t": _mktab(100, 0)}
    sched = xc.QueryScheduler(workers=1, queue_depth=8, device=CPU)
    held = [sched.submit("s", _q_slow, tables, compiled=False)
            for _ in range(5)]
    sched.shutdown(wait=True)
    outcomes = []
    for tk in held:
        try:
            tk.result(timeout=10)
            outcomes.append("ok")
        except xc.ExecShutdown:
            outcomes.append("shutdown")
    assert "shutdown" in outcomes          # queued requests drained
    with pytest.raises(xc.ExecShutdown):
        sched.submit("late", _q_slow, tables)


def test_quarantine_fail_fast():
    from spark_rapids_jni_tpu_torch.faultinj.injector import \
        InjectedDeviceError
    from spark_rapids_jni_tpu_torch.faultinj.resilience import \
        DeviceQuarantined
    tables = {"t": _mktab(100, 0)}

    def q_fatal(tbls):
        raise InjectedDeviceError("ptx trap analog")

    # recovery=False: quarantine is terminal, every later submit fails
    # fast (the recovery lifecycle is tests/test_torch_failover.py's)
    with xc.QueryScheduler(workers=1, recovery=False, device=CPU) as sched:
        tk = sched.submit("fatal", q_fatal, tables, compiled=False)
        with pytest.raises(DeviceQuarantined):
            tk.result(timeout=60)
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            try:
                sched.submit("after", _q_sum, tables, compiled=False)
            except DeviceQuarantined:
                break
            time.sleep(0.01)
        else:
            pytest.fail("quarantine did not fail fast")
    assert _counters().get("exec.quarantined", 0) >= 1


def test_transient_oom_retries():
    from spark_rapids_jni_tpu_torch.faultinj.injector import InjectedOomError
    tables = {"t": _mktab(100, 0)}
    state = {"n": 0}

    def q_flaky(tbls):
        state["n"] += 1
        if state["n"] == 1:
            raise InjectedOomError("transient")
        return _q_sum(tbls)

    with xc.QueryScheduler(workers=1, device=CPU) as sched:
        out = sched.run("flaky", q_flaky, tables, compiled=False)
    assert _same(out, _q_sum(tables))
    assert _counters().get("exec.retries", 0) >= 1


def test_real_runtime_error_is_not_retried():
    """Only the JAX package's classes retry: any other error (a
    ``torch.cuda.OutOfMemoryError`` is a RuntimeError, not a
    MemoryError) fails the request at once."""
    tables = {"t": _mktab(100, 0)}
    calls = {"n": 0}

    def q_bad(tbls):
        calls["n"] += 1
        raise RuntimeError("CUDA out of memory (simulated)")

    with xc.QueryScheduler(workers=1, device=CPU) as sched:
        tk = sched.submit("bad", q_bad, tables, compiled=False)
        with pytest.raises(RuntimeError, match="simulated"):
            tk.result(timeout=60)
    assert calls["n"] == 1
    assert _counters().get("exec.failed", 0) == 1


def test_lazy_eager_result_forced_inside_the_request():
    """An eager result's lazy columns are forced by the worker, inside
    the request (and its budget scope), not by the client."""
    tables = {"t": _mktab(64, 5)}
    forced_on = []

    def q_lazy(tbls):
        col = tbls["t"].columns[0]

        def thunk():
            forced_on.append(threading.current_thread().name)
            return Column(col.dtype, col.data.clone())
        return Table([LazyColumn(col.dtype, col.num_rows, CPU, thunk)])

    with xc.QueryScheduler(workers=1, device=CPU) as sched:
        out = sched.run("lazy", q_lazy, tables, compiled=False)
    assert not isinstance(out.columns[0], LazyColumn)
    assert torch.equal(out.columns[0].data, tables["t"].columns[0].data)
    assert forced_on and forced_on[0].startswith("srjt-exec-")


def test_scheduler_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        xc.QueryScheduler(workers=1)


# --- admission ----------------------------------------------------------------


def test_request_bytes_equals_the_jax_packages(data, port_tables):
    """The same TPC-DS tables cost the same bytes in both packages, table
    by table and all five at once; a shared tensor counts once."""
    from spark_rapids_jni_tpu import exec as jxc
    jax_tables = jax_tables_of(data)
    for name in port_tables:
        assert xc.request_bytes(port_tables[name]) \
            == jxc.request_bytes(jax_tables[name]), name
    assert xc.request_bytes(port_tables) == jxc.request_bytes(jax_tables)
    twice = [port_tables, port_tables]
    assert xc.request_bytes(twice) == xc.request_bytes(port_tables)


def test_request_bytes_neither_forces_nor_materializes():
    """A lazy column not yet forced counts nothing and stays unforced; a
    dictionary column counts its codes, validity and dictionary, not the
    chars it would materialize."""
    from spark_rapids_jni_tpu_torch.column import DictColumn
    dictionary = Column.strings_from_list(["ab", "cde", "f"], device=CPU)
    codes = torch.tensor([2, 0, 1, 1, 0] * 100, dtype=torch.int32)
    dcol = DictColumn(codes, dictionary)
    calls = []
    lazy = LazyColumn(T.DType(T.TypeId.INT32), 500, CPU,
                      lambda: calls.append(1) or Column.from_numpy(
                          np.zeros(500, np.int32), device=CPU))
    got = xc.request_bytes(Table([dcol, lazy]))
    assert got == codes.nbytes + dictionary.data.nbytes \
        + dictionary.offsets.nbytes
    assert not calls and not lazy.forced and dcol._mat is None


def test_admission_deferred_then_serves():
    tables = {"t": _mktab(5000, 3)}
    est = xc.request_bytes(tables)
    assert est > 0
    oracle = _q_sum(tables)
    with xc.QueryScheduler(workers=4, inflight_bytes=int(est * 1.5),
                           device=CPU) as sched:
        tks = [sched.submit(f"q{i}", _q_slow, tables, compiled=False)
               for i in range(4)]
        for tk in tks:
            assert _same(tk.result(timeout=60), oracle)
            assert not tk.degraded       # fits the cap → dense path
    c = _counters()
    assert c.get("exec.admission.deferred", 0) >= 1
    assert c.get("exec.admission.degraded", 0) == 0


def test_admission_deadline_typed():
    ctl = xc.AdmissionController(cap_bytes=1000)
    grant = ctl.admit(800, name="hold")
    with pytest.raises(xc.ExecDeadlineExceeded):
        ctl.admit(500, name="late", deadline=time.monotonic() + 0.05)
    grant.release()
    with ctl.admit(500, name="now") as g:
        assert not g.degrade


# --- plan cache ---------------------------------------------------------------


def test_plan_cache_hit_and_counters():
    tables = {"t": _mktab(1000, 1)}
    cache = xc.PlanCache(cap=4)
    a = cache.run("s", _q_sum, tables)
    b = cache.run("s", _q_sum, tables)
    c = cache.run("s", _q_sum, tables)
    assert _same(a, b) and _same(b, c)
    snap = _counters()
    assert snap.get("exec.plan_cache.miss") == 1
    assert snap.get("exec.plan_cache.hit") == 2
    # the second hit runs the verified, unchecked path
    assert snap.get("compiled.replay_run", 0) >= 1


def test_plan_cache_eviction_capacity():
    cache = xc.PlanCache(cap=1)
    t1 = {"t": _mktab(500, 1)}
    t2 = {"t": _mktab(500, 2)}
    a1 = cache.run("s", _q_sum, t1)
    a2 = cache.run("s", _q_sum, t2)      # evicts t1's entry
    assert len(cache) == 1
    b1 = cache.run("s", _q_sum, t1)      # identity miss again
    assert _same(a1, b1) and _same(a1, _q_sum(t1))
    assert _same(a2, _q_sum(t2))
    snap = _counters()
    assert snap.get("exec.plan_cache.evictions", 0) >= 2
    # same shape: one capture, the evicted re-entries adopt the warm plan
    # through the size-fingerprint index and revalidate
    assert snap.get("exec.plan_cache.miss") == 1
    assert snap.get("exec.plan_cache.size_hit") == 2
    assert snap.get("exec.plan_cache.revalidate") == 2
    assert not snap.get("exec.plan_cache.hit")


def test_plan_cache_eviction_capacity_no_size_sharing():
    cache = xc.PlanCache(cap=1, share_by_size=False)
    t1 = {"t": _mktab(500, 1)}
    t2 = {"t": _mktab(500, 2)}
    cache.run("s", _q_sum, t1)
    cache.run("s", _q_sum, t2)
    cache.run("s", _q_sum, t1)
    snap = _counters()
    assert snap.get("exec.plan_cache.miss") == 3
    assert not snap.get("exec.plan_cache.size_hit")


def test_plan_cache_expiry_on_gc():
    cache = xc.PlanCache(cap=4)
    tables = {"t": _mktab(500, 4)}
    cache.run("s", _q_sum, tables)
    assert len(cache) == 1
    del tables
    gc.collect()
    assert len(cache) == 0                  # weakref death evicted it


def test_plan_cache_refreshed_data_size_fp_hit():
    cache = xc.PlanCache(cap=4)
    t1 = {"t": _mktab(800, 5)}
    t2 = {"t": _mktab(800, 6)}              # same shape, other data
    a1 = cache.run("s", _q_sum, t1)
    a2 = cache.run("s", _q_sum, t2)
    assert _same(a1, _q_sum(t1)) and _same(a2, _q_sum(t2))
    assert not _same(a1, a2)
    snap = _counters()
    assert snap.get("exec.plan_cache.miss") == 1
    assert snap.get("exec.plan_cache.size_hit") == 1
    assert snap.get("exec.plan_cache.revalidate") == 1
    assert len(cache) == 2                  # distinct identity entries


def test_plan_cache_in_place_write_is_a_new_key():
    """An in-place write bumps the tensor's ``_version``: the identity key
    misses and the size index revalidates the plan on the new values."""
    cache = xc.PlanCache(cap=4)
    t = {"t": _mktab(300, 7)}
    cache.run("s", _q_sum, t)
    t["t"].columns[0].data.add_(1)
    assert _same(cache.run("s", _q_sum, t), _q_sum(t))
    assert _counters().get("exec.plan_cache.size_hit") == 1


def test_plan_cache_size_fp_stale_tape_recompiles():
    """A data-DEPENDENT size defeats the shape fingerprint: the adopted
    plan's revalidation catches the mismatch and recaptures."""

    def q_dyn(tbls):
        d = tbls["t"].columns[0].data
        n = syncs.scalar((d > 50).sum())
        return Table([Column(T.DType(T.TypeId.INT32),
                             torch.arange(n, dtype=torch.int32))])

    cache = xc.PlanCache(cap=4)
    rng = np.random.default_rng(0)
    t1 = {"t": Table([Column.from_numpy(
        rng.integers(0, 100, 600).astype(np.int32), device=CPU)])}
    t2 = {"t": Table([Column.from_numpy(
        rng.integers(0, 100, 600).astype(np.int32), device=CPU)])}
    a1 = cache.run("dyn", q_dyn, t1)
    a2 = cache.run("dyn", q_dyn, t2)
    assert _same(a1, q_dyn(t1)) and _same(a2, q_dyn(t2))
    assert a1.num_rows != a2.num_rows       # sizes really diverged
    snap = _counters()
    assert snap.get("exec.plan_cache.size_hit") == 1
    assert snap.get("exec.plan_cache.stale", 0) >= 1
    assert snap.get("compiled.tape_mismatch", 0) >= 1


def test_plan_cache_single_flight():
    tables = {"t": _mktab(2000, 7)}
    cache = xc.PlanCache(cap=4)
    barrier = threading.Barrier(4)
    outs, errs = [], []

    def worker():
        try:
            barrier.wait(timeout=30)
            outs.append(cache.run("s", _q_sum, tables))
        except Exception as e:
            errs.append(e)

    threads = [threading.Thread(target=worker) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not errs, errs
    assert all(_same(outs[0], o) for o in outs[1:])
    # one capture in all: racing misses wait for one build
    assert _counters().get("exec.plan_cache.miss") == 1
    assert compiled.COUNTS["capture"] >= 1


# --- cross-request coalescing -------------------------------------------------


def _burst(sched, reqs):
    """Submit behind a slow eager blocker so the requests pile up in the
    queue and the dequeuing worker can coalesce them."""
    blocker = sched.submit("blocker", _q_slow, {"t": _mktab(50, 99)},
                           compiled=False)
    tks = [sched.submit(name, qfn, tbls, **kw)
           for name, qfn, tbls, kw in reqs]
    return blocker, tks


def test_coalesced_burst_bit_identical(qfns, port_tables, serial):
    reqs = [(q, qfns[q], port_tables, {}) for q in QNAMES[:2]
            for _ in range(4)]
    with xc.QueryScheduler(workers=1, coalesce_ms=100, device=CPU) as sched:
        blocker, tks = _burst(sched, reqs)
        blocker.result(timeout=60)
        for (q, _, _, _), tk in zip(reqs, tks):
            assert _same(tk.result(timeout=300), serial[q]), q
    snap = metrics.snapshot()
    assert snap["counters"].get("exec.completed", 0) == 9
    hist = snap["histograms"].get("exec.batch.size")
    assert hist is not None and hist["max"] >= 2
    assert "exec.stage.coalesce_ms" in snap["histograms"]
    # every compiled request is exactly one of hit/miss/size_hit
    c = snap["counters"]
    assert (c.get("exec.plan_cache.hit", 0)
            + c.get("exec.plan_cache.miss", 0)
            + c.get("exec.plan_cache.size_hit", 0)) == 8


def test_mixed_shapes_do_not_coalesce():
    t_a = {"t": _mktab(500, 1)}
    t_b = {"t": _mktab(700, 2)}              # another shape
    with xc.QueryScheduler(workers=1, coalesce_ms=100, device=CPU) as sched:
        blocker, tks = _burst(sched, [("s", _q_sum, t_a, {}),
                                      ("s", _q_sum, t_b, {}),
                                      ("s", _q_sum, t_a, {}),
                                      ("s", _q_sum, t_b, {})])
        blocker.result(timeout=60)
        outs = [tk.result(timeout=60) for tk in tks]
    assert _same(outs[0], _q_sum(t_a)) and _same(outs[0], outs[2])
    assert _same(outs[1], _q_sum(t_b)) and _same(outs[1], outs[3])
    hist = metrics.snapshot()["histograms"].get("exec.batch.size")
    assert hist is None or hist["max"] <= 2


def test_deadline_fires_during_coalesce_window():
    tables = {"t": _mktab(400, 3)}
    oracle = _q_sum(tables)
    with xc.QueryScheduler(workers=1, coalesce_ms=200, device=CPU) as sched:
        blocker, (tk_ok, tk_dl) = _burst(
            sched, [("s", _q_sum, tables, {}),
                    ("s", _q_sum, tables, {"timeout_s": 0.01})])
        blocker.result(timeout=60)
        assert _same(tk_ok.result(timeout=60), oracle)
        with pytest.raises(xc.ExecDeadlineExceeded) as ei:
            tk_dl.result(timeout=60)
        assert ei.value.stage == "queue"
    assert _counters().get("exec.deadline.queue", 0) >= 1


def test_batch_admission_split_over_cap():
    tabs = [{"t": _mktab(2000, 10 + i)} for i in range(4)]   # same shape
    one = xc.request_bytes(tabs[0])
    with xc.QueryScheduler(workers=1, coalesce_ms=100,
                           inflight_bytes=int(one * 2.5),
                           device=CPU) as sched:
        blocker, tks = _burst(sched, [("s", _q_sum, t, {}) for t in tabs])
        blocker.result(timeout=60)
        for t, tk in zip(tabs, tks):
            assert _same(tk.result(timeout=60), _q_sum(t))
    c = _counters()
    assert c.get("exec.batch.split", 0) >= 1
    assert c.get("exec.admission.degraded", 0) == 0


def test_batched_distinct_buffers_replay_in_turn():
    """Distinct same-shape working sets with warm verified plans are
    offered to ``run_vmapped``, which runs them in turn under the tape as
    one batch on the CPU (one launch of a K-member graph on the card):
    each result equals its own run, and the first batch's parity check
    passes."""
    tabs = [{"t": _mktab(1500, 20 + i)} for i in range(3)]   # same shape
    plans = xc.PlanCache(cap=8)
    oracles = []
    for t in tabs:
        plans.run("s", _q_sum, t)
        oracles.append(plans.run("s", _q_sum, t))  # 2nd → verified
    with xc.QueryScheduler(workers=1, coalesce_ms=100, plan_cache=plans,
                           device=CPU) as sched:
        blocker, tks = _burst(sched, [("s", _q_sum, t, {}) for t in tabs])
        blocker.result(timeout=60)
        for o, tk in zip(oracles, tks):
            assert _same(tk.result(timeout=60), o)
    c = _counters()
    assert c.get("compiled.batch_replay", 0) >= 1
    assert c.get("compiled.batch_parity_check", 0) == 1
    assert c.get("compiled.batch_unsupported", 0) == 0
    assert metrics.snapshot()["histograms"]["exec.batch.size"]["max"] >= 2


# --- prefetch -----------------------------------------------------------------


def test_prefetch_hit_and_inline_miss():
    pf = xc.Prefetcher(depth=2)
    try:
        assert pf.stage("a", lambda: {"t": _mktab(200, 8)})
        assert pf._slots["a"]["done"].wait(30)   # staged, not racing take
        got = pf.take("a")
        assert _same(_q_sum(got), _q_sum({"t": _mktab(200, 8)}))
        got = pf.take("nope", loader=lambda: {"t": _mktab(100, 9)})
        assert got["t"].num_rows == 100
    finally:
        pf.close()
    snap = _counters()
    assert snap.get("exec.prefetch.hit") == 1
    assert snap.get("exec.prefetch.miss") == 1


def test_prefetch_take_before_stage_race():
    """take() claiming a still-queued slot loads inline instead of
    waiting for a staging pass that will never run."""
    pf = xc.Prefetcher(depth=2)
    try:
        for i in range(50):
            pf.stage(i, lambda i=i: i * 2)
            t0 = time.monotonic()
            assert pf.take(i, loader=lambda i=i: i * 2) == i * 2
            assert time.monotonic() - t0 < 5
    finally:
        pf.close()


def test_prefetch_depth_bound():
    pf = xc.Prefetcher(depth=1)
    try:
        ev = threading.Event()
        assert pf.stage("slow", lambda: (ev.wait(10), 1)[1])
        assert not pf.stage("b", lambda: 2)      # buffer full → rejected
        ev.set()
        assert pf.take("slow") == 1
    finally:
        pf.close()
    assert _counters().get("exec.prefetch.rejected") == 1


def test_loader_requests_served_from_the_prefetcher(data, qfns, serial):
    """Requests submitted with ``loader=`` are scanned by the prefetch
    thread and served equal to the serial runs on loaded tables."""
    files = data[0]
    with xc.QueryScheduler(workers=1, device=CPU) as sched:
        blocker = sched.submit("blocker", _q_slow, {"t": _mktab(50, 1)},
                               compiled=False)
        tks = [sched.submit("q3", qfns["q3"],
                            loader=lambda: tpcds.load_tables(files,
                                                             device=CPU))
               for _ in range(2)]
        blocker.result(timeout=60)
        for tk in tks:
            assert _same(tk.result(timeout=300), serial["q3"])
    assert _counters().get("exec.prefetch.hit", 0) >= 1


# --- gate, tracing, incidents, SLO, ops state --------------------------------


def test_exec_enabled_gate(monkeypatch):
    monkeypatch.delenv("SRJT_EXEC", raising=False)
    assert not xc.enabled()
    monkeypatch.setenv("SRJT_EXEC", "1")
    assert xc.enabled()
    monkeypatch.setenv("SRJT_EXEC", "off")
    assert not xc.enabled()


def test_request_lifecycle_traced_end_to_end():
    flight.reset()
    tables = {"t": _mktab(100, 0)}
    with xc.QueryScheduler(workers=1, device=CPU) as sched:
        tk = sched.submit("lc", _q_sum, tables)
        tk.result(timeout=60)
    assert tk.rid == "lc#0"
    kinds = [e["kind"] for e in flight.events(request_id=tk.rid)]
    assert kinds[0] == "exec.submit"
    assert "exec.dequeue" in kinds
    assert kinds[-1] == "exec.resolve"
    resolve = flight.events(request_id=tk.rid)[-1]
    assert resolve["outcome"] == "ok" and resolve["e2e_ms"] >= 0
    for st in ("queue", "admission", "dispatch", "ready"):
        assert f"{st}_s" in tk.timings
    hists = metrics.snapshot()["histograms"]
    for st in ("queue", "admission", "dispatch", "ready"):
        assert hists[f"exec.stage.{st}_ms"]["count"] >= 1
    assert hists["exec.e2e_ms"]["count"] == 1


def test_coalesced_batch_links_member_rids(qfns, port_tables):
    flight.reset()
    plans = xc.PlanCache()
    for _ in range(2):                      # warm + verify the plan
        plans.run("q3", qfns["q3"], port_tables)
    with xc.QueryScheduler(workers=1, plan_cache=plans, coalesce_ms=200,
                           device=CPU) as sched:
        blocker = sched.submit("s", _q_slow, {"t": _mktab(100, 0)},
                               compiled=False)
        tks = [sched.submit("q3", qfns["q3"], port_tables)
               for _ in range(3)]
        blocker.result(timeout=60)
        for tk in tks:
            tk.result(timeout=120)
    rids = [tk.rid for tk in tks]
    launches = [e for e in flight.events()
                if e["kind"] == "exec.batch.launch"]
    assert launches and set(launches[0]["batch"]) == set(rids)
    for tk in tks:
        assert tk.batch_rids is not None and set(tk.batch_rids) == set(rids)


def test_deadline_breach_dumps_incident_snapshot(tmp_path, monkeypatch):
    monkeypatch.setenv("SRJT_INCIDENT_DIR", str(tmp_path))
    flight.reset()
    tables = {"t": _mktab(100, 0)}
    with xc.QueryScheduler(workers=1, queue_depth=4, device=CPU) as sched:
        blocker = sched.submit("s", _q_slow, tables, compiled=False)
        tk = sched.submit("dl", _q_slow, tables, compiled=False,
                          timeout_s=0.001)
        with pytest.raises(xc.ExecDeadlineExceeded):
            tk.result(timeout=60)
        blocker.result(timeout=60)
    snaps = sorted(tmp_path.glob("incident-deadline-*.json"))
    assert snaps, "a deadline breach dumps a snapshot"
    with open(snaps[0]) as f:
        snap = json.load(f)
    assert snap["kind"] == "deadline"
    assert snap["request_id"] == tk.rid
    mine = [e for e in snap["events"] if e.get("rid") == tk.rid]
    assert {"exec.submit", "exec.resolve"} <= {e["kind"] for e in mine}
    assert "scheduler.queue_depth" in snap["probes"]


def test_default_deadline_env(monkeypatch):
    monkeypatch.setenv("SRJT_EXEC_DEADLINE", "0.001")
    tables = {"t": _mktab(100, 0)}
    with xc.QueryScheduler(workers=1, queue_depth=4, device=CPU) as sched:
        assert sched.default_timeout_s == 0.001
        blocker = sched.submit("s", _q_slow, tables, compiled=False,
                               timeout_s=600)
        tk = sched.submit("dl", _q_slow, tables, compiled=False)
        with pytest.raises(xc.ExecDeadlineExceeded):
            tk.result(timeout=60)          # the env deadline applied
        blocker.result(timeout=60)


def test_scheduler_fires_slo_breach_incident(tmp_path, monkeypatch):
    monkeypatch.setenv("SRJT_INCIDENT_DIR", str(tmp_path))
    monkeypatch.setenv("SRJT_SLO_P95_MS", "0.000001")
    monkeypatch.setenv("SRJT_SLO_MIN_N", "2")
    tables = {"t": _mktab(100, 0)}
    with xc.QueryScheduler(workers=1, device=CPU) as sched:
        for _ in range(3):
            sched.submit("slowq", _q_sum, tables).result(timeout=60)
    assert _counters().get("exec.slo.breach", 0) >= 1
    assert list(tmp_path.glob("incident-slo_breach-*.json"))


def test_ops_state():
    tables = {"t": _mktab(100, 0)}
    with xc.QueryScheduler(workers=2, device=CPU) as sched:
        sched.submit("r", _q_sum, tables).result(timeout=60)
        st = sched.ops_state()
        assert st["workers"] == 2 and st["queue_depth"] == 0
        assert st["devices"] == 1 and st["quarantined"] is False
        assert st["plan_cache"]["miss"] == 1
        assert [r["state"] for r in st["replicas"]] == ["healthy"]
        assert st["replicas"][0]["device"] == "cpu:0"
        assert "slo" in st
    # shutdown unregistered the scheduler's flight probes
    assert not any(k.startswith("scheduler.")
                   for k in flight.sample_probes())


# --- plan-tree and SQL queries through the serving runtime -------------------


def test_plan_lowered_queries_serve_bit_identical(data, port_tables, serial):
    """A qfn lowered from an optimized plan tree rides the scheduler
    unchanged, named by its plan fingerprint, and equals the hand-fused
    query."""
    names = [q for q in QNAMES if q in tpcds_plans.PLANS]
    qfns = {q: tpcds_plans.plan_fn(q, **data[3][q])[0] for q in names}
    with xc.QueryScheduler(workers=2, device=CPU) as sched:
        for _ in range(2):               # second round: plan-cache hits
            for q in names:
                tk = sched.submit(qfns[q].plan_fingerprint, qfns[q],
                                  port_tables)
                assert _same(tk.result(timeout=300), serial[q]), q
    c = _counters()
    assert c.get("exec.completed", 0) == 2 * len(names)
    assert c.get("exec.plan_cache.miss", 0) == len(names)
    assert c.get("exec.plan_cache.hit", 0) == len(names)


def test_submit_sql_serves_and_memoizes(data, port_tables, serial):
    """``submit_sql`` names the request by the plan's fingerprint, reuses
    one qfn per (fingerprint, schema), and serves the hand-fused query's
    bits; malformed SQL raises at submit with a flight incident."""
    from spark_rapids_jni_tpu_torch import sql
    p = dict(TS.PARAMS.get("q3", {}))
    p.update({k: v for k, v in data[3]["q3"].items() if k in p})
    with xc.QueryScheduler(workers=2, device=CPU) as sched:
        tks = [sched.submit_sql(TS.SQL["q3"], port_tables,
                                schemas=TS.TABLE_SCHEMAS, params=p)
               for _ in range(3)]
        for tk in tks:
            assert _same(tk.result(timeout=300), serial["q3"])
        assert len(sched._sql_qfns) == 1
        assert tks[0].name == next(iter(sched._sql_qfns))[0]
        flight.reset()
        with pytest.raises(sql.SqlError):
            sched.submit_sql("SELEC nonsense", port_tables,
                             schemas=TS.TABLE_SCHEMAS)
    assert any(e["kind"] == "incident:sql_parse_error"
               for e in flight.events())
    c = _counters()
    assert c.get("sql.submitted") == 3
    assert c.get("exec.plan_cache.miss") == 1
