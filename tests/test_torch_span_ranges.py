"""The port's spans are ``torch.profiler`` ranges on the profiler's clock.

A recorded ``utils.metrics`` span opens a range of its name on the thread
that runs it, and its exported start lies on the clock of the profiler's
events; with metrics off a span is the shared no-op and opens nothing.
The serving path's waits, dispatch and replay are such spans, each with
its request id, and portbench's serve readers read them from a trace
built here by hand.  The span tree keeps at most ``ROOTS_MAX`` roots.
"""

import torch_one_thread  # noqa: F401  (first: one intra-op thread)

import threading

import numpy as np
import pytest
import torch
from torch.profiler import record_function

from portbench import harness
from spark_rapids_jni_tpu_torch import exec as xc
from spark_rapids_jni_tpu_torch import types as T
from spark_rapids_jni_tpu_torch.column import Column, Table
from spark_rapids_jni_tpu_torch.utils import metrics, tracing

CPU = torch.device("cpu")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture
def metrics_on():
    metrics.set_enabled(True)
    metrics.reset()
    yield
    metrics.reset()
    metrics.set_enabled(None)


def _profile():
    return harness._profile(torch)


def _host(prof) -> list:
    """(name, start_ns, end_ns, thread) of the profile's host ranges."""
    return harness.TraceView.from_profile(prof, 1.0).host


def _q_sum(tbls):
    t = tbls["t"]
    return Table([Column(T.DType(T.TypeId.INT64),
                         t.columns[0].data.to(torch.int64).sum().reshape(1))])


# --- one span, one range, one clock ----------------------------------------


def test_span_is_a_range_on_the_profilers_clock(metrics_on):
    with metrics.span("warm"):
        pass
    with _profile() as prof:
        with record_function("outer"):
            with metrics.span("x"):
                pass
    host = {n: (s, t) for n, s, _, t in _host(prof)}
    assert "x" in host and host["x"][1] == host["outer"][1]
    ev = next(e for e in metrics.chrome_trace()["traceEvents"]
              if e["name"] == "x")
    assert abs(ev["ts"] - host["x"][0] / 1e3) < 1000     # µs


def test_span_off_is_the_shared_noop():
    metrics.set_enabled(False)
    try:
        assert metrics.span("x") is metrics.span("y")
        with _profile() as prof:
            with metrics.span("x"):
                pass
        assert "x" not in {h[0] for h in _host(prof)}
    finally:
        metrics.set_enabled(None)


@pytest.mark.parametrize("on", [True, False])
def test_traced_opens_one_range(on):
    @tracing.traced("traced_entry")
    def entry():
        return 1
    metrics.set_enabled(on)
    metrics.reset()
    try:
        with _profile() as prof:
            entry()
        names = [h[0] for h in _host(prof)]
        assert names.count("traced_entry") == 1
        assert [r["name"] for r in metrics.span_roots()] \
            == (["traced_entry"] if on else [])
    finally:
        metrics.reset()
        metrics.set_enabled(None)


def test_span_tree_is_bounded(metrics_on):
    for i in range(metrics.ROOTS_MAX + 3):
        with metrics.span(f"r{i}"):
            pass
    roots = metrics.span_roots()
    assert len(roots) == metrics.ROOTS_MAX
    assert roots[0]["name"] == "r3"
    assert roots[-1]["name"] == f"r{metrics.ROOTS_MAX + 2}"


@pytest.mark.gpu
@pytest.mark.parametrize("on_worker", [False, True])
def test_graph_kernels_carry_their_launch(cuda, metrics_on, on_worker):
    """A replayed graph's kernels carry the correlation of their
    ``cudaGraphLaunch``, on the thread of the ``compiled.replay`` span
    around it, also on a thread that was running before the profiler
    started (a serving worker): the device time of the work launched
    inside the range holds the graph's kernels."""
    x = torch.ones(1 << 20, device=cuda)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        (x * 2 + 1).sum()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        (x * 2 + 1).sum()
    torch.cuda.synchronize()

    def replay():
        with metrics.span("compiled.replay"):
            graph.replay()
        torch.cuda.synchronize()
    go = threading.Event()
    worker = threading.Thread(target=lambda: (go.wait(30), replay()))
    if on_worker:
        worker.start()
    with _profile() as prof:
        if on_worker:
            go.set()
            worker.join(30)
            assert not worker.is_alive()
        else:
            replay()
    view = harness.TraceView.from_profile(prof, 1.0)
    launches = {s for n, s, _, _ in view.host if n == "cudaGraphLaunch"}
    assert len(view.device) >= 2 and len(launches) == 1
    assert all(view.launch[c][0] in launches for *_, c in view.device)
    threads = {n: t for n, _, _, t in view.host
               if n in ("compiled.replay", "cudaGraphLaunch")}
    assert threads["compiled.replay"] == threads["cudaGraphLaunch"], threads
    assert view.busy_in("compiled.replay") == pytest.approx(view.busy_s)


# --- the serving path's ranges ---------------------------------------------


def _kids(node) -> list:
    return [c["name"] for c in node.get("children", [])]


def _find(node, name):
    if node["name"] == name:
        return node
    for c in node.get("children", []):
        hit = _find(c, name)
        if hit is not None:
            return hit
    return None


def test_lone_request_ranges(metrics_on):
    tables = {"t": Table([Column.from_numpy(np.arange(64, dtype=np.int32),
                                            device=CPU)])}
    sched = xc.QueryScheduler(workers=1, coalesce_ms=20, device="cpu")
    try:
        metrics.set_enabled(False)
        for _ in range(3):          # capture, checked run, steady replay
            sched.submit("q_sum", _q_sum, tables).result(timeout=60)
        metrics.set_enabled(True)
        with _profile() as prof:
            tk = sched.submit("q_sum", _q_sum, tables)
            assert int(tk.result(timeout=60).columns[0].data[0]) == 2016
            sched.shutdown()        # ends the worker's exec.wait
    finally:
        sched.shutdown()
    roots = metrics.span_roots()
    order = [r["name"] for r in roots]
    # a worker that went back to the queue after metrics came on records
    # the wait the request ends first
    assert order[-5:] == ["exec.coalesce", "exec.admission", "query:q_sum",
                          "exec.resolve", "exec.wait"], order
    assert order[:-5] in ([], ["exec.wait"]), order
    assert len({e["tid"] for e in metrics.chrome_trace()["traceEvents"]
                if e["ph"] == "X"}) == 1
    by = {r["name"]: r for r in roots[-5:]}
    assert by["exec.coalesce"]["dur_ms"] >= 15.0
    query = by["query:q_sum"]
    assert _kids(query) == ["exec.dispatch", "exec.ready"]
    dispatch = query["children"][0]
    assert _kids(dispatch)[0] == "plan_cache.lookup"
    assert _find(dispatch, "compiled.replay") is not None
    for name in ("exec.coalesce", "exec.admission", "exec.resolve"):
        assert by[name]["attrs"]["rid"] == tk.rid, name
    assert dispatch["attrs"]["rid"] == tk.rid
    # the same ranges in the profiler's trace, on the worker's one thread
    host = _host(prof)
    names = ("exec.coalesce", "exec.admission", "exec.dispatch",
             "plan_cache.lookup", "compiled.replay", "exec.ready",
             "exec.resolve", "exec.wait")
    threads = {t for n, _, _, t in host if n in names}
    assert {n for n, _, _, _ in host} >= set(names) and len(threads) == 1
    view = harness.TraceView([], host, {}, 1.0)
    (d0, d1, _), = view.ranges("exec.dispatch")
    (r0, r1, _), = view.ranges("compiled.replay")
    assert d0 <= r0 <= r1 <= d1


# --- portbench's serve readers on a trace built by hand --------------------

# worker threads 1 and 2, client thread 3; the device is busy over
# [0, 100], [200, 300], [500, 600], [800, 900] ns of a 1000 ns slice,
# idle over (100, 200), (300, 500), (600, 800) and (900, 1000)
_DEVICE = [("k", 0, 100, 1), ("k", 200, 300, 2), ("k", 500, 600, 3),
           ("k", 800, 900, 4)]
_HOST = [
    ("exec.dispatch", 0, 100, 1), ("compiled.replay", 5, 95, 1),
    ("cudaGraphLaunch", 10, 20, 1),
    ("exec.wait", 100, 1000, 1),
    ("exec.dispatch", 190, 310, 2), ("compiled.replay", 195, 305, 2),
    ("cudaGraphLaunch", 196, 199, 2),
    # (300, 500): worker 1 waits, worker 2 waits for the plan's lock: counted
    ("compiled.lock", 310, 560, 2),
    # (600, 800): worker 2 replays, so only some workers wait
    ("compiled.replay", 560, 900, 2),
    ("cudaGraphLaunch", 561, 562, 2), ("cudaGraphLaunch", 580, 590, 3),
    # (900, 1000): only worker 1 waits; worker 2 has no range
]
_LAUNCH = {1: (10, 1), 2: (196, 2), 3: (561, 2), 4: (580, 3)}
_FACTS = {"histograms": {"exec.stage.coalesce_ms":
                         {"count": 4, "total": 16.4}}}


def _view(host=_HOST, device=_DEVICE, facts=_FACTS):
    # a 1000 ns slice: window_s in seconds
    return harness.TraceView(list(device), list(host), dict(_LAUNCH),
                             1000e-9, dict(facts))


@pytest.mark.parametrize("metric,view,want", [
    ("exec.coalesce_ms", _view(), 4.1),
    ("exec.coalesce_ms", _view(facts={}), None),
    ("exec.coalesce_ms", _view(facts={"histograms": {
        "exec.stage.coalesce_ms": {"count": 0, "total": 0}}}), None),
    # the work launched in replays: [0, 100] and [200, 300] and
    # [500, 600], over three replays
    ("plan.replay_device_ms", _view(), 300e-9 * 1e3 / 3),
    ("plan.replay_device_ms",
     _view(host=[h for h in _HOST if h[0] != "compiled.replay"]), None),
    # gap (300, 500) only: at 700 worker 2 replays, at 950 it has no
    # range, at 150 worker 2 has no range either
    ("device_idle.serve.waiting", _view(), 200 / 1000),
    ("device_idle.serve.waiting",
     _view(host=[h for h in _HOST if h[0] not in ("exec.dispatch",
                                                  "exec.wait")]), None),
    ("device_idle.serve.waiting", _view(device=[]), None),
    # every gap's middle lies in worker 1's exec.wait; without it the
    # slice ends at 900 and (100, 200) is the one gap with no range open
    # at its middle
    ("device_idle.serve.unattributed", _view(), 0.0),
    ("device_idle.serve.unattributed",
     _view(host=[h for h in _HOST if h[0] != "exec.wait"]), 100 / 1000),
    ("device_idle.serve.unattributed", _view(device=[]), None),
])
def test_serve_readers(metric, view, want):
    got = harness.load_reader(metric).read(view)
    if want is None:
        assert got is None
    else:
        assert got == pytest.approx(want, rel=1e-9, abs=1e-15)
