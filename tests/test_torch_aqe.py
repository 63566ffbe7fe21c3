"""Adaptive query execution of the port (``plan/adaptive.py``) against the
JAX package's, on the CPU.

Mirrors ``tests/test_aqe.py``: the star plan whose big dimension joins
first (replan), the sparse build side that the static rule indexes
sorted and the observed probe side flips to dense (engine_flip), a hot
build key (skew advisory); the knob off being the static path; an
ambient engine pin winning over the probe; the regression incident;
capture and replay under AQE; the plan cache keeping the ``+aqe`` variant
apart; EXPLAIN's adaptive appendix and ``explain_analyze``'s ``mode:``.
The same seeded numpy tables go through both packages: results equal
exactly (integers and keys), adaptive equal to static bit for bit, and
each decision list equal to the JAX package's, detail for detail.  The
JAX package's runs are made once a module.
"""

import torch_one_thread  # noqa: F401  (first: one intra-op thread)
import numpy as np
import pytest

from spark_rapids_jni_tpu.column import Column as JColumn, Table as JTable
from spark_rapids_jni_tpu.plan import adaptive as jadaptive
from spark_rapids_jni_tpu.plan import ir as jir
from spark_rapids_jni_tpu.plan import lower as jlower
from spark_rapids_jni_tpu.plan import rules as jrules
from spark_rapids_jni_tpu.plan import stats as jstats
from spark_rapids_jni_tpu.utils import knobs as jknobs

from spark_rapids_jni_tpu_torch.column import Column, Table
from spark_rapids_jni_tpu_torch.exec.plan_cache import PlanCache
from spark_rapids_jni_tpu_torch.models.compiled import compile_query
from spark_rapids_jni_tpu_torch.ops import join_plan
from spark_rapids_jni_tpu_torch.plan import adaptive, ir, lower, profile
from spark_rapids_jni_tpu_torch.plan import rules
from spark_rapids_jni_tpu_torch.plan import stats as plan_stats
from spark_rapids_jni_tpu_torch.utils import flight, knobs, metrics

from torch_jax_columns import assert_same_table
from torch_tpcds_cases import assert_identical

CPU = "cpu"
AQE_KNOBS = ["SRJT_AQE", "SRJT_AQE_REPLAN_MIN_ROWS", "SRJT_AQE_SKEW_FACTOR",
             "SRJT_HBM_ARENA", "SRJT_ARENA_ZEROS_CAP", "SRJT_HOSTCACHE_CAP",
             "SRJT_JOIN_ENGINE", "SRJT_INDEX_CACHE_CAP"]


def _star_arrays():
    """Fact + a big non-selective dimension + a small selective one, in
    the adversarial order (the big dimension joins first)."""
    rng = np.random.default_rng(21)
    n = 6000
    return {
        "fact": [rng.integers(0, 900, n).astype(np.int64),
                 rng.integers(0, 400, n).astype(np.int64),
                 rng.integers(1, 9, n).astype(np.int64)],
        "dim_big": [np.arange(900, dtype=np.int64),
                    (np.arange(900) % 11).astype(np.int32)],
        "dim_small": [np.arange(24, dtype=np.int64),
                      (np.arange(24) % 3).astype(np.int32)],
    }


def _star_tree(I):
    return I.FusedJoinAggregate(
        I.Join(I.Scan("fact"), I.Scan("dim_big"),
               ("f_big_sk",), ("big_sk",)),
        I.Scan("dim_small"), ("f_small_sk",), ("small_sk",),
        ("b_tag",), (("f_qty", "sum", "total"), ("f_qty", "count", "cnt")))


STAR_SCHEMAS = {"fact": ["f_big_sk", "f_small_sk", "f_qty"],
                "dim_big": ["big_sk", "b_tag"],
                "dim_small": ["small_sk", "s_tag"]}


def _sparse_arrays():
    """600 build keys scattered over [0, 15000): the static rule says
    sorted, the observed 20,000 probe rows say dense."""
    rng = np.random.default_rng(4)
    n = 20_000
    return {
        "fact": [rng.integers(0, 15_000, n).astype(np.int64),
                 rng.integers(1, 9, n).astype(np.int64)],
        "dim": [rng.permutation(15_000)[:600].astype(np.int64),
                (np.arange(600) % 7).astype(np.int32)],
    }


def _skew_arrays():
    """A dense build side with one hot key: 400 of its 1,000 rows."""
    rng = np.random.default_rng(9)
    keys = np.arange(1000, dtype=np.int64)
    keys[:400] = 7
    return {
        "fact": [rng.integers(0, 1000, 5000).astype(np.int64),
                 rng.integers(1, 9, 5000).astype(np.int64)],
        "dim": [rng.permutation(keys), (np.arange(1000) % 5).astype(
            np.int32)],
    }


def _fja_tree(I):
    return I.FusedJoinAggregate(
        I.Scan("fact"), I.Scan("dim"), ("f_sk",), ("d_sk",),
        ("d_tag",), (("f_qty", "sum", "total"),))


FJA_SCHEMAS = {"fact": ["f_sk", "f_qty"], "dim": ["d_sk", "d_tag"]}


def _port_tables(arrays):
    return {k: Table([Column.from_numpy(a, device=CPU) for a in cols])
            for k, cols in arrays.items()}


def _jax_tables(arrays):
    return {k: JTable([JColumn.from_numpy(a) for a in cols])
            for k, cols in arrays.items()}


def _decisions(report):
    return [(d.kind, d.detail) for d in report.decisions()]


def _jax_run(arrays, tree, schemas, aqe: bool):
    """The JAX package's result (static, or adaptive with its decision
    list), with its knob set for the call only."""
    import os
    old = os.environ.get("SRJT_AQE")
    os.environ["SRJT_AQE"] = "1" if aqe else "0"
    try:
        cat = jlower.TableCatalog(_jax_tables(arrays), schemas)
        if not aqe:
            return jlower.execute(tree, cat, record_stats=False), None
        report = jadaptive.AdaptiveReport()
        out = jadaptive.execute_adaptive(tree, cat, record_stats=False,
                                         report=report)
        return out, report
    finally:
        if old is None:
            os.environ.pop("SRJT_AQE", None)
        else:
            os.environ["SRJT_AQE"] = old


@pytest.fixture(scope="module")
def jax_results():
    """The JAX package's static and adaptive runs of the three cases."""
    out = {}
    for name, arrays, tree, schemas in (
            ("star", _star_arrays(), _star_tree(jir), STAR_SCHEMAS),
            ("sparse", _sparse_arrays(), _fja_tree(jir), FJA_SCHEMAS),
            ("skew", _skew_arrays(), _fja_tree(jir), FJA_SCHEMAS)):
        static, _ = _jax_run(arrays, tree, schemas, False)
        adapt, report = _jax_run(arrays, tree, schemas, True)
        out[name] = (static, adapt, _decisions(report))
    return out


CASES = {"star": (_star_arrays, _star_tree, STAR_SCHEMAS),
         "sparse": (_sparse_arrays, _fja_tree, FJA_SCHEMAS),
         "skew": (_skew_arrays, _fja_tree, FJA_SCHEMAS)}


@pytest.fixture
def mx():
    metrics.set_enabled(True)
    metrics.reset()
    yield metrics
    metrics.set_enabled(None)


def _case(name):
    arrays_of, tree_of, schemas = CASES[name]
    return _port_tables(arrays_of()), schemas, tree_of(ir)


def _static(tables, schemas, tree, monkeypatch):
    monkeypatch.setenv("SRJT_AQE", "0")
    return lower.execute(tree, lower.TableCatalog(tables, schemas),
                         record_stats=False)


def _adaptive(tables, schemas, tree, monkeypatch):
    monkeypatch.setenv("SRJT_AQE", "1")
    report = adaptive.AdaptiveReport()
    out = adaptive.execute_adaptive(
        tree, lower.TableCatalog(tables, schemas), record_stats=False,
        report=report)
    return out, report


def test_aqe_off_is_static_path(jax_results, mx, monkeypatch):
    tables, schemas, tree = _case("star")
    got = _static(tables, schemas, tree, monkeypatch)
    assert_same_table(got, jax_results["star"][0])
    snap = metrics.snapshot()["counters"]
    assert not any(k.startswith("plan.aqe") for k in snap), snap


@pytest.mark.parametrize("name,kind", [("star", "replan"),
                                       ("sparse", "engine_flip"),
                                       ("skew", "skew_advisory")])
def test_decisions_bit_identical_and_equal_to_jax(name, kind, jax_results,
                                                  mx, monkeypatch):
    """Adaptive equals static bit for bit and the JAX package's result
    exactly, and the decisions (kind and detail) are the JAX package's."""
    tables, schemas, tree = _case(name)
    static = _static(tables, schemas, tree, monkeypatch)
    got, report = _adaptive(tables, schemas, tree, monkeypatch)
    assert_identical(got, static)
    jstatic, jgot, jdecisions = jax_results[name]
    assert_same_table(got, jgot)
    assert_same_table(static, jstatic)
    assert _decisions(report) == jdecisions
    assert kind in {k for k, _ in _decisions(report)}
    fired = {"replan": "plan.aqe.replan.fired",
             "engine_flip": "plan.aqe.engine_flip.fired",
             "skew_advisory": "plan.aqe.skew_split.advisory"}[kind]
    assert metrics.counter_value(fired) >= 1


def test_execute_and_compile_plan_route_on_knob(jax_results, monkeypatch):
    tables, schemas, tree = _case("star")
    monkeypatch.setenv("SRJT_AQE", "1")
    via_route = lower.execute(tree, lower.TableCatalog(tables, schemas),
                              record_stats=False)
    assert_same_table(via_route, jax_results["star"][1])
    qfn = lower.compile_plan(tree, schemas)
    assert qfn.aqe_variant == "aqe"
    assert qfn.plan_fingerprint == ir.fingerprint(tree)
    assert_same_table(qfn(tables), jax_results["star"][1])
    assert _decisions(qfn.last_report) == jax_results["star"][2]
    monkeypatch.setenv("SRJT_AQE", "0")
    assert not hasattr(lower.compile_plan(tree, schemas), "aqe_variant")


def test_ambient_force_engine_wins_over_probe(mx, monkeypatch):
    tables, schemas, tree = _case("sparse")
    static = _static(tables, schemas, tree, monkeypatch)
    for pin in ("force", "knob"):
        metrics.reset()
        if pin == "knob":
            monkeypatch.setenv("SRJT_JOIN_ENGINE", "sorted")
            assert join_plan.forced_engine() == "sorted"
            got, report = _adaptive(tables, schemas, tree, monkeypatch)
            monkeypatch.delenv("SRJT_JOIN_ENGINE")
        else:
            with join_plan.force_engine("sorted"):
                got, report = _adaptive(tables, schemas, tree, monkeypatch)
        assert_identical(got, static)
        assert "engine_flip" not in {k for k, _ in _decisions(report)}
        assert metrics.counter_value("plan.aqe.engine_flip.fired") == 0
    assert join_plan.forced_engine() is None


def test_regression_fires_flight_incident(mx, monkeypatch):
    tables, schemas, tree = _case("sparse")
    monkeypatch.setenv("SRJT_AQE", "1")
    flight.reset()
    # the prior claims one row; the stage observes more than twice that
    plan_stats.GLOBAL.observe(ir.fingerprint(tree), 1)
    try:
        adaptive.execute_adaptive(
            tree, lower.TableCatalog(tables, schemas), record_stats=False)
        assert metrics.counter_value("plan.aqe.regression") >= 1
        assert metrics.counter_value("flight.incident.aqe_regression") >= 1
    finally:
        plan_stats.GLOBAL.clear()


@pytest.mark.parametrize("name", ["star", "sparse"])
def test_capture_replay_with_aqe(name, jax_results, monkeypatch):
    """A compiled adaptive query's capture and replay take the same
    branches: the tape fits, the replay equals the static result, and
    the replay's decisions are the capture's."""
    tables, schemas, tree = _case(name)
    static = _static(tables, schemas, tree, monkeypatch)
    monkeypatch.setenv("SRJT_AQE", "1")
    qfn = lower.compile_plan(tree, schemas)
    cq = compile_query(qfn, tables)
    captured = _decisions(qfn.last_report)
    for got in (cq.run(tables), cq.run_unchecked(tables)):
        assert_identical(got, static)
    assert _decisions(qfn.last_report) == captured == jax_results[name][2]


def test_plan_cache_variant_separates_aqe(monkeypatch):
    tables, schemas, tree = _case("star")
    monkeypatch.setenv("SRJT_AQE", "0")
    static_qfn = lower.compile_plan(tree, schemas)
    monkeypatch.setenv("SRJT_AQE", "1")
    aqe_qfn = lower.compile_plan(tree, schemas)
    cache = PlanCache(cap=8)
    e1 = cache.get_or_compile("q", static_qfn, tables)
    e2 = cache.get_or_compile("q", aqe_qfn, tables)
    assert e1 is not e2, "the adaptive qfn adopted the static tape"
    assert cache.get_or_compile("q", static_qfn, tables) is e1
    assert cache.get_or_compile("q", aqe_qfn, tables) is e2
    assert {k[1] for k in cache._d} == {"", "aqe"}


def test_explain_adaptive_equals_jax(jax_results, monkeypatch):
    """EXPLAIN with the adaptive appendix is the JAX package's text (both
    with no priors: their stats cleared, their metrics off)."""
    arrays = _star_arrays()
    tables = _port_tables(arrays)
    monkeypatch.setenv("SRJT_AQE", "1")
    metrics.set_enabled(False)
    plan_stats.GLOBAL.clear()
    jstats.GLOBAL.clear()
    got = adaptive.explain_adaptive(_star_tree(ir), STAR_SCHEMAS, tables)
    want = jadaptive.explain_adaptive(_star_tree(jir), STAR_SCHEMAS,
                                      _jax_tables(arrays))
    assert got == want
    assert "== Adaptive execution ==" in got
    assert rules.explain(_star_tree(ir), STAR_SCHEMAS) == jrules.explain(
        _star_tree(jir), STAR_SCHEMAS)
    metrics.set_enabled(None)


def test_explain_analyze_mode_and_annotations(monkeypatch):
    """``explain_analyze`` says ``mode: adaptive`` under the knob, and the
    decision sites annotate the profiled nodes."""
    tables, schemas, tree = _case("sparse")
    monkeypatch.setenv("SRJT_AQE", "1")
    text, out, prof = profile.analyze(tree, schemas, tables)
    assert "mode: adaptive" in text
    assert any(d.startswith("engine_flip: ")
               for n in prof.nodes() for d in n.decisions)
    assert any(n.engine == "dense" for n in prof.nodes())
    monkeypatch.setenv("SRJT_AQE", "0")
    assert "mode: static" in profile.analyze(tree, schemas, tables)[0]
    plan_stats.GLOBAL.clear()
    jstats.GLOBAL.clear()


@pytest.mark.parametrize("name", AQE_KNOBS)
def test_slice_knob_registered_as_in_jax(name, monkeypatch):
    """The slice's eight knobs: the JAX package's defaults and parsers."""
    mine, theirs = knobs.REGISTRY[name], jknobs.REGISTRY[name]
    assert mine.default == theirs.default
    monkeypatch.delenv(name, raising=False)
    assert knobs.get(name) == jknobs.get(name)
    for raw in ("0", "1", "off", "7", "2.5", "64m", "dense", ""):
        monkeypatch.setenv(name, raw)
        try:
            want = jknobs.get(name)
        except (ValueError, TypeError) as e:
            with pytest.raises(type(e)):
                knobs.get(name)
            continue
        assert knobs.get(name) == want, raw
