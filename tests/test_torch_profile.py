"""Tracing, per-node profiles and the join repairs of the PyTorch port
(``utils/tracing.py``, ``plan/profile.py``, ``ops/join.py``,
``plan/stats.py``), on the CPU.

The port's counterpart of ``tests/test_profile.py``, held against the
JAX package on the TPC-DS data of ``tests/torch_tpcds_cases.py`` (one
intra-op thread):

* the join repair: q_store_counts' capture tape has the JAX package's
  length (a left join reads its match count unconditionally), and with
  metrics on an unseen join's prior (the ``join.match_rows`` mean)
  reorders a plan into the JAX package's optimized fingerprint;
* profiles: the 8 plan queries under ``explain_analyze`` give results
  bit-identical to their unprofiled runs, node trees (operator, line,
  fingerprint, estimated / input / output rows, join engine, op events)
  equal to the JAX package's, each node's rows equal to the numpy oracle
  (``tools/torch_plan_oracle.py``), and the rendered text equal to the
  JAX package's but for times and byte counts;
* profiling off is one bool check; capture/replay with the validity
  syncs; mispredictions and stats feedback; JSON artifacts; the flight
  probe; the compile ledger;
* ``tools/trace_report.py``, ``tools/profile_report.py`` and
  ``tools/bench_history.py`` read the port's Chrome trace and profile
  artifacts;
* ``@traced`` entries show as ``torch.profiler`` ranges, feed a metrics
  span and a structured-log event, and vanish with tracing off.
"""

import torch_one_thread  # noqa: F401  (first: one intra-op thread)
import functools
import json
import pathlib
import re
import sys

import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu.models import compiled as jcompiled
from spark_rapids_jni_tpu.models import tpcds as jtpcds
from spark_rapids_jni_tpu.models import tpcds_plans as jplans
from spark_rapids_jni_tpu.plan import ir as jir
from spark_rapids_jni_tpu.plan import profile as jprofile
from spark_rapids_jni_tpu.plan import rules as jrules
from spark_rapids_jni_tpu.plan import stats as jstats
from spark_rapids_jni_tpu.utils import metrics as jmetrics

from spark_rapids_jni_tpu_torch.column import Column, Table
from spark_rapids_jni_tpu_torch.models import compiled, tpcds, tpcds_plans
from spark_rapids_jni_tpu_torch.parquet import device_scan
from spark_rapids_jni_tpu_torch.plan import ir, lower, profile, rules
from spark_rapids_jni_tpu_torch.plan import stats as plan_stats
from spark_rapids_jni_tpu_torch.rowconv import convert
from spark_rapids_jni_tpu_torch.utils import (flight, metrics,
                                              structured_log, tracing)

from torch_tpcds_cases import (CPU, _jax_native_library,  # noqa: F401
                               assert_identical, data, jax_tables_of,
                               port_tables)

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "tools"))
import bench_history  # noqa: E402
import profile_report  # noqa: E402
import torch_plan_oracle  # noqa: E402
import trace_report  # noqa: E402

PLAN_NAMES = list(tpcds_plans.PLANS)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def prof_on():
    profile.set_enabled(True)
    profile.reset()
    yield profile
    profile.set_enabled(None)


@pytest.fixture
def both_metrics():
    for m in (metrics, jmetrics):
        m.set_enabled(True)
        m.reset()
    yield
    for m in (metrics, jmetrics):
        m.reset()
        m.set_enabled(None)


@pytest.fixture(scope="module")
def encoded(data):
    return torch_plan_oracle.encode_arrays(data[2])


@pytest.fixture(scope="module")
def writer_tables(data):
    return tpcds.load_tables(data[1], device=CPU)


def _col(a, validity=None):
    return Column.from_numpy(np.asarray(a), validity=validity, device=CPU)


# --- the join repair ---------------------------------------------------------


def test_q_store_counts_tape_matches_jax(data, port_tables):
    params = data[3]["q_store_counts"]
    cq = compiled.compile_query(
        functools.partial(tpcds.QUERIES["q_store_counts"], **params),
        port_tables)
    jcq = jcompiled.CompiledQuery(
        functools.partial(jtpcds.QUERIES["q_store_counts"], **params),
        jax_tables_of(data))
    assert len(cq.tape) == len(jcq.tape) == 15
    assert_identical(cq.run(port_tables), cq.expected)


def _reorder_tree(ir_mod):
    """Join(Join(store_sales, Join(item, store)), date_dim): the inner
    dimension is itself a join, which no stats have seen — only the
    ``join.match_rows`` prior can rank it against date_dim."""
    dim = ir_mod.Join(ir_mod.Scan("item"), ir_mod.Scan("store"),
                      ("i_manager_id",), ("s_store_sk",))
    return ir_mod.Join(
        ir_mod.Join(ir_mod.Scan("store_sales"), dim, ("ss_item_sk",),
                    ("i_item_sk",)),
        ir_mod.Scan("date_dim"), ("ss_sold_date_sk",), ("d_date_sk",))


def _join_both(seed: int) -> None:
    """One left join with repeated build keys in each package (the pair
    expansion and the left join's match-count read)."""
    from spark_rapids_jni_tpu import Column as JColumn, Table as JTable
    from spark_rapids_jni_tpu.ops import left_join as jleft_join
    from spark_rapids_jni_tpu_torch.ops import left_join
    rng = np.random.default_rng(seed)
    lk = rng.integers(0, 40, 300).astype(np.int32)
    rk = rng.integers(0, 30, 200).astype(np.int32)
    left_join(Table([_col(lk)]), Table([_col(rk)]), 0, 0)
    jleft_join(JTable([JColumn.from_numpy(lk)]),
               JTable([JColumn.from_numpy(rk)]), 0, 0)


@pytest.mark.parametrize("on", [False, True], ids=["metrics_off",
                                                   "metrics_on"])
def test_join_prior_reorders_as_jax(both_metrics, on):
    for m in (metrics, jmetrics):
        m.set_enabled(on)
    _join_both(5)
    if on:
        h = metrics.snapshot()["histograms"]["join.match_rows"]
        jh = jmetrics.snapshot()["histograms"]["join.match_rows"]
        assert (h["count"], h["total"]) == (jh["count"], jh["total"])
    fps = []
    for irm, rl, st, schemas in (
            (ir, rules, plan_stats, tpcds_plans.TABLE_SCHEMAS),
            (jir, jrules, jstats, jplans.TABLE_SCHEMAS)):
        stats = st.CardinalityStats()
        # date_dim seen once, at fewer rows than any join gives
        stats.observe(irm.fingerprint(irm.Scan("date_dim")), 1)
        res = rl.optimize(_reorder_tree(irm), schemas, stats=stats,
                          rules=[rl.JoinReorder()])
        fps.append((irm.fingerprint(res.tree),
                    [e.rule for e in res.events]))
    assert fps[0] == fps[1]
    assert (fps[0][1] == ["join_reorder"]) == on


# --- profiles ----------------------------------------------------------------


def _node_facts(rec, jax: bool) -> tuple:
    ops = [dict(o) for o in rec.ops]
    return (rec.op, rec.line, rec.node_id, rec.est_rows, rec.in_rows,
            rec.out_rows, rec.engine, json.dumps(ops, sort_keys=True),
            [_node_facts(c, jax) for c in rec.children])


_TIMES = re.compile(r"time=\S+ self=\S+( fence=\S+)?|wall \S+ ms|bytes=\d+ ")


# the queries also held against the JAX package's profiles (the others
# against the oracle and their unprofiled runs only: the JAX package
# compiles each new op shape on the CPU, which the gate's time cannot
# spend eight times)
JAX_PROFILED = ("q3", "q55", "q65", "q_having")


@pytest.mark.parametrize("name", PLAN_NAMES)
def test_explain_analyze_matches_jax_and_oracle(data, port_tables, encoded,
                                                prof_on, name):
    params = data[3][name]
    tree = tpcds_plans.PLANS[name](**params)
    plan_stats.GLOBAL.clear()
    jstats.GLOBAL.clear()
    want = lower.execute(tpcds_plans.optimized(name, **params).tree,
                         lower.TableCatalog(port_tables,
                                            tpcds_plans.TABLE_SCHEMAS),
                         record_stats=False)
    text, out, prof = profile.analyze(tree, tpcds_plans.TABLE_SCHEMAS,
                                      port_tables)
    assert_identical(out, want)
    assert "== EXPLAIN ANALYZE ==" in text and "rows est=" in text
    if name in JAX_PROFILED:
        jprofile.set_enabled(True)
        try:
            jtext = jprofile.explain_analyze(
                jplans.PLANS[name](**params), jplans.TABLE_SCHEMAS,
                jax_tables_of(data))
            jprof = jprofile.completed(1)[0]
        finally:
            jprofile.set_enabled(None)
        assert [_node_facts(r, False) for r in prof.roots] == \
            [_node_facts(r, True) for r in jprof.roots]
        assert _TIMES.sub("", text) == _TIMES.sub("", jtext)
    oracle = torch_plan_oracle.node_rows(
        tpcds_plans.optimized(name, **params).tree, None, encoded)
    for rec in prof.nodes():
        assert rec.out_rows == oracle[rec.node_id], (name, rec.line)
    # the prior was corrected from the observed run
    assert plan_stats.GLOBAL.rows_for(
        tpcds_plans.optimized(name, **params).tree) == float(out.num_rows)


def test_profiled_writer_tables_bit_identical(data, writer_tables, prof_on):
    name = "q65"
    params = data[3][name]
    qfn, _ = tpcds_plans.plan_fn(name, **params)
    profile.set_enabled(False)
    want = qfn(writer_tables)
    profile.set_enabled(True)
    with profile.query(name) as pr:
        got = qfn(writer_tables)
    assert_identical(got, want)
    assert sum(1 for _ in pr.nodes()) >= 4 and pr.finished
    assert all(r.fence_ms is None for r in pr.nodes())   # no card here


def test_disabled_mode_is_one_bool_check(monkeypatch):
    profile.set_enabled(False)

    class Boom:
        def __getattr__(self, k):
            raise AssertionError("node_enter touched state while off")
    monkeypatch.setattr(profile, "_tls", Boom())
    monkeypatch.setattr(ir, "fingerprint", Boom())
    assert profile.node_enter(object()) is None
    profile.set_enabled(None)


def test_disabled_execution_records_nothing(data, port_tables):
    profile.set_enabled(False)
    profile.reset()
    qfn, _ = tpcds_plans.plan_fn("q3", **data[3]["q3"])
    with profile.query("off") as pr:
        qfn(port_tables)
    assert pr is None and profile.completed() == []
    profile.set_enabled(None)


def _nullable_case():
    rng = np.random.default_rng(7)
    n = 3000
    valid = rng.random(n) > 0.25
    tables = {
        "fact": Table([_col(rng.integers(0, 50, n).astype(np.int64)),
                       _col(rng.integers(1, 9, n).astype(np.int64),
                            validity=valid)]),
        "dim": Table([_col(np.arange(50, dtype=np.int64)),
                      _col((np.arange(50) % 5).astype(np.int32))]),
    }
    schemas = {"fact": ["f_sk", "f_qty"], "dim": ["d_sk", "d_tag"]}
    tree = ir.Sort(ir.Aggregate(
        ir.Join(ir.Scan("fact"), ir.Scan("dim"), ("f_sk",), ("d_sk",)),
        ("d_tag",), (("f_qty", "sum", "total"),)), ("d_tag",))
    return tables, lower.compile_plan(tree, schemas)


def test_capture_replay_identical_branches(prof_on, monkeypatch):
    """Profiling with the validity syncs through compile_query: the
    capture and the replay resolve the same tape, with one validity read
    per nullable column per node on it; with profiling off the tape is
    the unprofiled one."""
    tables, qfn = _nullable_case()
    profile.set_enabled(False)
    base = compiled.compile_query(qfn, tables)
    monkeypatch.setenv("SRJT_PROFILE", "1")
    monkeypatch.setenv("SRJT_PROFILE_VALIDITY", "1")
    profile.set_enabled(None)
    assert profile._validity
    cq = compiled.compile_query(qfn, tables)
    assert len(cq.tape) > len(base.tape)
    assert_identical(cq.run(tables), cq.expected)
    assert_identical(cq.run_unchecked(tables), cq.expected)
    assert_identical(cq.expected, base.expected)
    monkeypatch.setenv("SRJT_PROFILE", "0")
    profile.set_enabled(None)
    assert compiled.compile_query(qfn, tables).tape == base.tape


def test_validity_density_recorded(prof_on, monkeypatch):
    monkeypatch.setenv("SRJT_PROFILE", "1")
    monkeypatch.setenv("SRJT_PROFILE_VALIDITY", "1")
    profile.set_enabled(None)
    n = 1000
    valid = np.zeros(n, bool)
    valid[: n // 4] = True                 # 25% valid
    tables = {"t": Table([_col(np.arange(n, dtype=np.int64)),
                          _col(np.arange(n, dtype=np.int64),
                               validity=valid)])}
    schemas = {"t": ["a", "b"]}
    tree = ir.Filter(ir.Scan("t"), ir.Cmp("<", ir.Col("a"), ir.Lit(n)))
    with profile.query("validity") as pr:
        lower.execute(tree, lower.TableCatalog(tables, schemas),
                      record_stats=False)
    fracs = [r.valid_frac for r in pr.nodes() if r.valid_frac is not None]
    assert fracs and all(abs(f - 0.25) < 1e-9 for f in fracs)


def test_mispredict_flag_and_stats_feedback(prof_on):
    n = 2000
    tables = {"t": Table([_col(np.arange(n, dtype=np.int64))])}
    schemas = {"t": ["a"]}
    tree = ir.Filter(ir.Scan("t"), ir.Cmp("<", ir.Col("a"), ir.Lit(10)))
    fp = ir.fingerprint(tree)
    plan_stats.GLOBAL.observe(fp, 2000)    # stale prior: 2000 rows
    with profile.query("mis") as pr:
        lower.execute(tree, lower.TableCatalog(tables, schemas),
                      record_stats=True)
    root = pr.roots[0]
    assert root.est_rows == 2000 and root.out_rows == 10
    assert root.mispredicted()
    assert "mispredict" in json.dumps(root.as_dict())
    assert root.ops == [{"op": "filter", "rows_in": 2000, "rows_kept": 10}]
    assert plan_stats.GLOBAL.rows_for(tree) != 2000


def test_artifacts_reports_and_trace(data, port_tables, prof_on, tmp_path,
                                     monkeypatch, both_metrics):
    """SRJT_PROFILE_DIR artifacts, the compile ledger in them, and the
    three report tools over the port's artifacts and Chrome trace."""
    monkeypatch.setenv("SRJT_PROFILE_DIR", str(tmp_path / "prof"))
    qfn, tree = tpcds_plans.plan_fn("q3", **data[3]["q3"])
    cq = compiled.compile_query(qfn, port_tables)
    with metrics.query_span("q3"):
        with profile.query("q3 run", qfn.plan_fingerprint) as pr:
            cq.run(port_tables)
            qfn(port_tables)
    files = sorted((tmp_path / "prof").glob("profile-*.json"))
    assert len(files) == 1
    doc = json.loads(files[0].read_text())
    assert doc["fingerprint"] == qfn.plan_fingerprint and doc["finished"]
    assert doc["compile_ledger"]["captures"] == 1
    agg = profile_report.flatten(profile_report.load_profiles(
        str(tmp_path / "prof")))
    assert {n.node_id for n in pr.nodes()} == set(agg)
    assert profile_report.main(["pr", str(tmp_path / "prof")]) == 0
    assert profile_report.main(["pr", str(tmp_path / "prof"), "--regress",
                                str(tmp_path / "prof")]) == 0
    trace = tmp_path / "trace.json"
    metrics.export_chrome_trace(str(trace))
    events, extras = trace_report.load_events(str(trace))
    by_node = trace_report.summarize(events, by_node=True)
    assert len(by_node) == len(set(agg))
    names = trace_report.summarize(events)
    assert any(k.startswith("plan.node:") for k in names)
    assert extras["srjtCounters"]["plan.profile.queries"] == 1
    assert trace_report.main(["tr", str(trace)]) == 0
    (tmp_path / "PROFILE_BENCH.json").write_text(json.dumps(
        {"q3": {"wall_ms": doc["wall_ms"], "nodes": len(agg)}}))
    hist = bench_history.collect(str(tmp_path))
    assert {m["metric"] for m in hist["metrics"]} == {"q3.wall_ms",
                                                      "q3.nodes"}


def test_flight_probe_embeds_partial_profile(prof_on):
    seen = {}
    tables = {"t": Table([_col(np.arange(10, dtype=np.int64))])}

    class Catalog(lower.TableCatalog):
        def scan(self, node):
            seen.update(flight.sample_probes())
            return super().scan(node)
    tree = ir.Filter(ir.Scan("t"), ir.Cmp("<", ir.Col("a"), ir.Lit(5)))
    with profile.query("probe"):
        lower.execute(tree, Catalog(tables, {"t": ["a"]}),
                      record_stats=False)
    prof_dict = next(iter(seen["plan.active_profile"].values()))
    assert prof_dict["name"] == "probe" and not prof_dict["finished"]
    assert prof_dict["open"]               # the in-flight node stack


# --- tracing -----------------------------------------------------------------


def test_traced_ranges_spans_and_log(data, tmp_path, both_metrics):
    raw = data[0]["store"]
    t = Table([_col(np.arange(100, dtype=np.int32))])
    with torch.profiler.profile() as p:
        device_scan.scan_table(raw, device=CPU)
        convert.convert_from_rows(convert.convert_to_rows(t)[0], t.schema)
    keys = {a.key for a in p.key_averages()}
    for name in ("parquet_scan_table_device", "parquet.scan.walk",
                 "parquet.scan.upload", "parquet.scan.decode",
                 "convert_to_rows", "convert_from_rows"):
        assert name in keys, name
    roots = metrics.span_roots()
    assert {"parquet_scan_table_device", "convert_to_rows",
            "convert_from_rows"} <= {r["name"] for r in roots}
    assert metrics.counter_value("rowconv.to_rows.rows") == 100
    log = tmp_path / "log.jsonl"
    structured_log.configure("json", str(log))
    try:
        convert.convert_to_rows(t)
    finally:
        structured_log.configure("off")
    assert '"convert_to_rows"' in log.read_text()
    tracing.set_enabled(False)
    try:
        with torch.profiler.profile() as p:
            convert.convert_to_rows(t)
        assert "convert_to_rows" not in {a.key for a in p.key_averages()}
    finally:
        tracing.set_enabled(None)
