"""The port's planner (``spark_rapids_jni_tpu_torch.plan``) against the JAX
package's, on the CPU.

Mirrors ``tests/test_plan.py`` (fixpoint, pushdown through joins, join
reorder with and without cardinality stats, the executor feeding the
stats, fingerprints, schema errors, EXPLAIN, row-group pruning, the
``SRJT_PLAN_*`` knobs) and ``tests/test_tpcds.py``'s plan-tree tests (the
8 ``models.tpcds_plans`` queries bit-identical to the hand-fused
``models.tpcds.QUERIES``, from the optimized and the unoptimized tree,
through a ``FileCatalog``, and compiled).  The port's trees must also have
the JAX package's fingerprints, byte for byte, and the crafted star query
the JAX package's result.  Knobs are set with ``monkeypatch``; the stats
sidecar goes to a temporary path.
"""

import torch_one_thread  # noqa: F401  (first: one intra-op thread)
import io

import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu import plan as JP
from spark_rapids_jni_tpu.column import Column as JColumn, Table as JTable
from spark_rapids_jni_tpu.models import tpcds_plans as jtpcds_plans
from spark_rapids_jni_tpu.plan import ir as jir

from spark_rapids_jni_tpu_torch import plan as P
from spark_rapids_jni_tpu_torch.column import Column, Table, force_column
from spark_rapids_jni_tpu_torch.models import compiled, tpcds, tpcds_plans
from spark_rapids_jni_tpu_torch.parquet import device_scan
from spark_rapids_jni_tpu_torch.plan import ir, lower, rules, stats
from spark_rapids_jni_tpu_torch.utils import syncs

from torch_jax_columns import assert_same_table
from torch_tpcds_cases import (CPU, _jax_native_library,  # noqa: F401
                               assert_identical, data, port_tables)

SCHEMAS = {
    "fact": ["f_d1_sk", "f_d2_sk", "f_qty", "f_price", "f_pad"],
    "dim1": ["d1_sk", "d1_group", "d1_tag"],
    "dim2": ["d2_sk", "d2_group", "d2_tag"],
}
PLAN_QUERIES = list(tpcds_plans.PLANS)


def _arrays():
    rng = np.random.default_rng(3)
    n = 4000
    return {
        "fact": [rng.integers(1, 40, n).astype(np.int32),
                 rng.integers(1, 25, n).astype(np.int32),
                 rng.integers(1, 9, n).astype(np.int64),
                 rng.integers(1, 1000, n).astype(np.int64),
                 rng.integers(0, 2, n).astype(np.int32)],
        "dim1": [np.arange(1, 40, dtype=np.int32),
                 (np.arange(1, 40) % 5).astype(np.int32),
                 (np.arange(1, 40) % 7).astype(np.int32)],
        "dim2": [np.arange(1, 25, dtype=np.int32),
                 (np.arange(1, 25) % 3).astype(np.int32),
                 (np.arange(1, 25) % 4).astype(np.int32)],
    }


@pytest.fixture(scope="module")
def tables():
    return {name: Table([Column.from_numpy(a, device=CPU) for a in cols])
            for name, cols in _arrays().items()}


def _two_dim_tree(m=ir):
    j = m.Join(m.Join(m.Scan("fact"), m.Scan("dim1"),
                      ("f_d1_sk",), ("d1_sk",)),
               m.Scan("dim2"), ("f_d2_sk",), ("d2_sk",))
    f = m.Filter(j, m.And((
        m.Cmp("==", m.Col("d1_group"), m.Lit(2)),
        m.Cmp("==", m.Col("d2_group"), m.Lit(1)))))
    return m.Sort(m.Aggregate(f, ("d1_tag", "d2_tag"),
                              (("f_qty", "sum", "total_qty"),)),
                  ("d1_tag", "d2_tag"))


def _rows(table):
    cols = [force_column(c).to_numpy().tolist() for c in table]
    return sorted(zip(*cols)) if cols else []


def test_fixpoint_terminates_and_is_idempotent():
    res = P.optimize(_two_dim_tree(), SCHEMAS)
    assert res.converged
    assert res.passes <= 10
    assert res.events
    res2 = P.optimize(res.tree, SCHEMAS)
    assert res2.converged
    assert not res2.events
    assert ir.fingerprint(res2.tree) == ir.fingerprint(res.tree)


def test_pushdown_through_join_structure_and_results(tables):
    res = P.optimize(_two_dim_tree(), SCHEMAS)
    scans = {n.table: n for n in ir.walk(res.tree)
             if isinstance(n, ir.Scan)}
    assert "d1_group" in ir.expr_columns(scans["dim1"].predicate)
    assert scans["dim2"].predicate is not None
    assert not any(isinstance(n, ir.Filter) for n in ir.walk(res.tree))
    assert "f_pad" not in scans["fact"].columns
    assert any(isinstance(n, ir.FusedJoinAggregate)
               for n in ir.walk(res.tree))
    cat = P.TableCatalog(tables, SCHEMAS)
    raw = P.execute(_two_dim_tree(), cat, record_stats=False)
    opt = P.execute(res.tree, cat, record_stats=False)
    assert _rows(opt) == _rows(raw)


def test_star_query_equals_the_jax_packages(tables):
    """The same arrays through both packages' optimizer and lowering: the
    same optimized fingerprint, the same result table."""
    jtables = {name: JTable([JColumn.from_numpy(a) for a in cols])
               for name, cols in _arrays().items()}
    jres = JP.optimize(_two_dim_tree(jir), SCHEMAS)
    res = P.optimize(_two_dim_tree(), SCHEMAS)
    assert ir.fingerprint(res.tree) == jir.fingerprint(jres.tree)
    assert [(e.rule, e.detail) for e in res.events] == [
        (e.rule, e.detail) for e in jres.events]
    got = P.execute(res.tree, P.TableCatalog(tables, SCHEMAS),
                    record_stats=False)
    want = JP.execute(jres.tree, JP.TableCatalog(jtables, SCHEMAS),
                      record_stats=False)
    assert_same_table(got, want)


def test_join_reorder_noop_without_stats():
    tree = ir.Join(ir.Join(ir.Scan("fact"), ir.Scan("dim1"),
                           ("f_d1_sk",), ("d1_sk",)),
                   ir.Scan("dim2"), ("f_d2_sk",), ("d2_sk",))
    res = P.optimize(tree, SCHEMAS, stats=None)
    assert not any(ev.rule == "join_reorder" for ev in res.events)
    assert any(ev.rule == "join_reorder" for ev in res.rejections)
    assert ir.fingerprint(res.tree) == ir.fingerprint(tree)
    res2 = P.optimize(tree, SCHEMAS, stats=P.CardinalityStats())
    assert not any(ev.rule == "join_reorder" for ev in res2.events)
    assert any(ev.rule == "join_reorder" for ev in res2.rejections)
    # no metrics prior in the port: an unseen join has no estimate
    assert P.CardinalityStats().rows_for(tree) is None


def test_join_reorder_fires_with_stats(tables):
    tree = ir.Join(ir.Join(ir.Scan("fact"), ir.Scan("dim1"),
                           ("f_d1_sk",), ("d1_sk",)),
                   ir.Scan("dim2"), ("f_d2_sk",), ("d2_sk",))
    st = P.CardinalityStats()
    st.observe(ir.fingerprint(ir.Scan("dim1")), 1000)
    st.observe(ir.fingerprint(ir.Scan("dim2")), 3)
    rules.reset_counts()
    res = P.optimize(tree, SCHEMAS, stats=st)
    assert any(ev.rule == "join_reorder" for ev in res.events)
    assert rules.COUNTS["rule.fired.join_reorder"] >= 1
    assert isinstance(res.tree, ir.Project)
    assert ir.schema_of(res.tree, SCHEMAS) == ir.schema_of(tree, SCHEMAS)
    cat = P.TableCatalog(tables, SCHEMAS)
    raw = P.execute(tree, cat, record_stats=False)
    opt = P.execute(res.tree, cat, record_stats=False)
    assert _rows(opt) == _rows(raw)
    st2 = P.CardinalityStats()
    st2.observe(ir.fingerprint(ir.Scan("dim1")), 3)
    st2.observe(ir.fingerprint(ir.Scan("dim2")), 1000)
    res2 = P.optimize(tree, SCHEMAS, stats=st2)
    assert not any(ev.rule == "join_reorder" for ev in res2.events)


def test_executor_feeds_global_stats(tables):
    P.GLOBAL_STATS.clear()
    tree = ir.Join(ir.Scan("fact"), ir.Scan("dim1"),
                   ("f_d1_sk",), ("d1_sk",))
    out = P.execute(tree, P.TableCatalog(tables, SCHEMAS))
    assert P.GLOBAL_STATS.rows_for(tree) == float(out.num_rows)
    assert P.GLOBAL_STATS.rows_for(ir.Scan("fact")) == float(
        tables["fact"].num_rows)
    # fed by the executor, the stats reorder the next optimize
    three = ir.Join(tree, ir.Scan("dim2"), ("f_d2_sk",), ("d2_sk",))
    P.GLOBAL_STATS.observe(ir.fingerprint(ir.Scan("dim2")), 1)
    res = P.optimize(three, SCHEMAS, stats=P.GLOBAL_STATS)
    assert any(ev.rule == "join_reorder" for ev in res.events)
    P.GLOBAL_STATS.clear()


def test_stats_lru_cap_and_sidecar(tmp_path, monkeypatch):
    st = stats.CardinalityStats(max_entries=2)
    for i in range(3):
        st.observe(f"plan:{i}", i)
    assert len(st) == 2 and st.evictions == 1
    path = tmp_path / "stats.json"
    assert st.save_sidecar(str(path))
    back = stats.CardinalityStats()
    assert back.load_sidecar(str(path)) == 2
    assert back.rows_for(ir.Scan("x")) is None
    path.write_text("{not json")
    assert stats.CardinalityStats().load_sidecar(str(path)) == 0
    # the knob's sidecar is merged into GLOBAL once, before optimize
    # consults stats
    good = tmp_path / "good.json"
    stats.atomic_write_json(str(good), {"version": 1, "rows": {
        ir.fingerprint(ir.Scan("dim1")): 1000,
        ir.fingerprint(ir.Scan("dim2")): 3}})
    monkeypatch.setenv("SRJT_PLAN_STATS_PATH", str(good))
    monkeypatch.setattr(stats, "_sidecar_loaded", False)
    P.GLOBAL_STATS.clear()
    tree = ir.Join(ir.Join(ir.Scan("fact"), ir.Scan("dim1"),
                           ("f_d1_sk",), ("d1_sk",)),
                   ir.Scan("dim2"), ("f_d2_sk",), ("d2_sk",))
    res = P.optimize(tree, SCHEMAS, stats=P.GLOBAL_STATS)
    assert any(ev.rule == "join_reorder" for ev in res.events)
    P.GLOBAL_STATS.clear()


def test_fingerprint_stability():
    t1, t2 = _two_dim_tree(), _two_dim_tree()
    assert t1 is not t2
    assert ir.fingerprint(t1) == ir.fingerprint(t2)
    a = ir.Filter(ir.Scan("dim1"), ir.And((
        ir.Cmp("==", ir.Col("d1_group"), ir.Lit(2)),
        ir.Cmp("<", ir.Col("d1_tag"), ir.Lit(np.int64(5))))))
    b = ir.Filter(ir.Scan("dim1"), ir.And((
        ir.Cmp("<", ir.Col("d1_tag"), ir.Lit(5)),
        ir.Cmp("==", ir.Col("d1_group"), ir.Lit(2)))))
    assert ir.fingerprint(a) == ir.fingerprint(b)
    c = ir.Filter(ir.Scan("dim1"),
                  ir.Cmp("==", ir.Col("d1_group"), ir.Lit(3)))
    assert ir.fingerprint(a) != ir.fingerprint(c)
    assert ir.fingerprint(c) == jir.fingerprint(jir.Filter(
        jir.Scan("dim1"), jir.Cmp("==", jir.Col("d1_group"), jir.Lit(3))))
    with pytest.raises(ir.PlanError):
        ir.Lit(torch.tensor(3))


def test_schema_validation_errors():
    with pytest.raises(ir.PlanError):
        ir.schema_of(ir.Scan("nope"), SCHEMAS)
    with pytest.raises(ir.PlanError):
        ir.schema_of(ir.Filter(ir.Scan("dim1"),
                               ir.Cmp("==", ir.Col("bogus"), ir.Lit(1))),
                     SCHEMAS)
    with pytest.raises(ir.PlanError):
        ir.schema_of(ir.Join(ir.Scan("dim1"), ir.Scan("dim1"),
                             ("d1_sk",), ("d1_sk",)), SCHEMAS)
    with pytest.raises(ir.PlanError):
        P.compile_plan(ir.Project(ir.Scan("dim1"), ("d2_sk",)), SCHEMAS)


def test_explain_renders_both_trees():
    text = P.explain(_two_dim_tree(), SCHEMAS)
    assert "== Logical plan ==" in text
    assert "== Optimized plan" in text
    assert "fired    filter_pushdown" in text
    assert "fired    fuse_join_aggregate" in text
    assert "FusedJoinAggregate" in text
    assert text == JP.explain(_two_dim_tree(jir), SCHEMAS)


def test_rowgroup_pruning_end_to_end():
    pa = pytest.importorskip("pyarrow")
    pq = pytest.importorskip("pyarrow.parquet")
    n = 1000
    key = np.arange(n, dtype=np.int32)
    val = (key * 3).astype(np.int64)
    buf = io.BytesIO()
    pq.write_table(pa.table({"key": pa.array(key), "val": pa.array(val)}),
                   buf, use_dictionary=False, row_group_size=100)
    raw = buf.getvalue()
    device_scan.reset_counts()
    full = device_scan.scan_table(raw, device=CPU)
    pruned = device_scan.scan_table(
        raw, rowgroup_predicate=[("key", "eq", 250)], device=CPU)
    assert device_scan.COUNTS["rowgroups_pruned"] == 9
    assert device_scan.COUNTS["rowgroups_kept"] == 1
    assert full.num_rows == n
    assert pruned.num_rows == 100
    got = pruned[0].to_numpy()
    assert got.min() == 200 and got.max() == 299
    np.testing.assert_array_equal(pruned[1].to_numpy(),
                                  got.astype(np.int64) * 3)
    # through the planner: a FileCatalog scan prunes the same groups and
    # masks the rest, equal to the mask over the whole table
    tree = ir.Scan("t", ("key", "val"),
                   ir.Between(ir.Col("key"), lo=150, hi=349))
    device_scan.reset_counts()
    out = P.execute(tree, P.FileCatalog({"t": raw}, device=CPU),
                    record_stats=False)
    assert device_scan.COUNTS["rowgroups_kept"] == 3
    assert out[0].to_numpy().tolist() == list(range(150, 350))


def test_plan_disable_env(monkeypatch):
    monkeypatch.setenv("SRJT_PLAN_OPT", "0")
    res = P.optimize(_two_dim_tree(), SCHEMAS)
    assert not res.events and res.passes == 0
    monkeypatch.delenv("SRJT_PLAN_OPT")
    monkeypatch.setenv("SRJT_PLAN_RULES", "projection_pushdown")
    res2 = P.optimize(_two_dim_tree(), SCHEMAS)
    assert {ev.rule for ev in res2.events} == {"projection_pushdown"}
    monkeypatch.delenv("SRJT_PLAN_RULES")
    monkeypatch.setenv("SRJT_PLAN_MAX_PASSES", "1")
    res3 = P.optimize(_two_dim_tree(), SCHEMAS)
    assert res3.passes == 1 and not res3.converged


# --- the 8 TPC-DS plan queries ------------------------------------------


def _plan_params(name, data):
    return data[3][name]


@pytest.mark.parametrize("name", PLAN_QUERIES)
def test_plan_fingerprint_equals_the_jax_packages(name):
    res = tpcds_plans.optimized(name)
    jres = jtpcds_plans.optimized(name)
    assert ir.fingerprint(res.tree) == jir.fingerprint(jres.tree)
    assert ir.render(res.tree) == jir.render(jres.tree)
    raw = tpcds_plans.PLANS[name]()
    assert not any(isinstance(n, ir.FusedJoinAggregate)
                   for n in ir.walk(raw))
    assert any(ev.rule == "fuse_join_aggregate" for ev in res.events)
    assert any(ev.rule in ("projection_pushdown", "filter_pushdown")
               for ev in res.events)


@pytest.mark.parametrize("name", PLAN_QUERIES)
def test_plan_tree_matches_hand_fused(name, data, port_tables):
    """The optimized and the unoptimized tree give the hand-fused query's
    table bit for bit, and the optimized tree's tape holds the hand-fused
    query's sizes (the same count, the same values)."""
    params = _plan_params(name, data)
    qfn, tree = tpcds_plans.plan_fn(name, **params)
    assert qfn.plan_fingerprint == ir.fingerprint(tree)
    assert qfn.plan_output_names == list(ir.schema_of(
        tree, tpcds_plans.TABLE_SCHEMAS))
    exp = tpcds.QUERIES[name](port_tables, **params)
    got_tape, want_tape = [], []
    with syncs.capture(got_tape):
        got = qfn(port_tables)
    with syncs.capture(want_tape):
        tpcds.QUERIES[name](port_tables, **params)
    assert got.num_rows > 0
    assert_identical(got, exp)
    assert len(got_tape) == len(want_tape)
    assert sorted(got_tape) == sorted(want_tape)
    cat = P.TableCatalog(port_tables, tpcds_plans.TABLE_SCHEMAS)
    raw = tpcds_plans.PLANS[name](**params)
    assert_identical(P.execute(raw, cat, record_stats=False), exp)


@pytest.mark.parametrize("name", PLAN_QUERIES)
def test_plan_file_catalog_matches_hand_fused(name, data, port_tables):
    """Scans read the parquet bytes (columns and row groups pruned, rows
    pruned by the fused filter): bit-identical all the same; a complete
    fused filter skips the scan's mask."""
    files = data[0]
    params = _plan_params(name, data)
    res = tpcds_plans.optimized(name, **params)
    lower.reset_counts()
    device_scan.reset_counts()
    out = P.execute(res.tree, P.FileCatalog(dict(files), device=CPU),
                    record_stats=False)
    assert_identical(out, tpcds.QUERIES[name](port_tables, **params))
    assert lower.COUNTS["scan.columns_pruned"] > 0
    pred_scans = sum(isinstance(n, ir.Scan) and n.predicate is not None
                     for n in ir.walk(res.tree))
    assert lower.COUNTS["scan.filter_fused"] == pred_scans
    assert device_scan.COUNTS["rowfilter.complete"] == pred_scans


def test_plan_compiled_matches_hand_fused(data, port_tables):
    params = _plan_params("q42", data)
    qfn, _ = tpcds_plans.plan_fn("q42", **params)
    cq = compiled.compile_query(qfn, port_tables)
    exp = tpcds.QUERIES["q42"](port_tables, **params)
    assert_identical(cq.run(port_tables), exp)
    assert_identical(cq.run_unchecked(port_tables), exp)
    assert qfn.plan_fingerprint.startswith("plan:")
