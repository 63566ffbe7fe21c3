"""Streaming ingest + incremental maintenance of the PyTorch port
(``stream/``, ``ops.groupby``'s partial states), on the CPU.

The port's counterpart of ``tests/test_stream.py``, held against the JAX
package on the same pyarrow files and seeded numpy inputs:

* delta scans — empty delta, a delta across a file boundary, the
  watermark, the ``until`` snapshot, extend-file prefix validation,
  pruning composed with a delta scan — each row equal to the JAX
  package's ``DeltaTable`` scan;
* merge-state equivalence for every mergeable aggregate against the
  port's full ``groupby_aggregate`` (exact where ``merge_exact``: ints,
  decimals, counts, min/max; floats within 1e-9 as the JAX tests hold
  them) and against the JAX package's merged states;
* view classification — the same kind and fallback reason as the JAX
  package for every plan shape; an incremental view's refresh after each
  append bit-identical to a full recompute and to the JAX package's;
* ``QueryScheduler.submit_refresh`` on CPU replicas.
"""

import torch_one_thread  # noqa: F401  (first: one intra-op thread)
import io
import threading

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

import jax.numpy as jnp

from benchmarks import tpcds_data
from spark_rapids_jni_tpu import types as JT
from spark_rapids_jni_tpu.column import Column as JColumn
from spark_rapids_jni_tpu.column import Table as JTable
from spark_rapids_jni_tpu.models import tpcds as jtpcds
from spark_rapids_jni_tpu.ops import groupby as JG
from spark_rapids_jni_tpu.plan import ir as jir
from spark_rapids_jni_tpu.stream import DeltaTable as JDeltaTable
from spark_rapids_jni_tpu.stream import ViewRegistry as JViewRegistry

from spark_rapids_jni_tpu_torch import exec as xc
from spark_rapids_jni_tpu_torch import types as T
from spark_rapids_jni_tpu_torch.column import Column, Table, force_column
from spark_rapids_jni_tpu_torch.models import tpcds, tpcds_plans
from spark_rapids_jni_tpu_torch.ops import apply_boolean_mask
from spark_rapids_jni_tpu_torch.ops import groupby as G
from spark_rapids_jni_tpu_torch.ops.copying import concat_tables
from spark_rapids_jni_tpu_torch.plan import ir, lower
from spark_rapids_jni_tpu_torch.stream import DeltaTable, ViewRegistry
from spark_rapids_jni_tpu_torch.utils import metrics

from torch_jax_columns import assert_same_table

CPU = "cpu"


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


def _bitcmp(a: Table, b: Table, tag=""):
    """Two port tables hold the same bits (absent validity = all valid)."""
    assert a.num_rows == b.num_rows, (tag, a.num_rows, b.num_rows)
    assert len(a.columns) == len(b.columns), tag
    for i in range(len(a.columns)):
        x, y = force_column(a[i]), force_column(b[i])
        assert x.dtype == y.dtype, (tag, i, x.dtype, y.dtype)
        dx, dy = x.data, y.data
        if dx.dtype == torch.float64:
            dx, dy = dx.view(torch.int64), dy.view(torch.int64)
        assert torch.equal(dx, dy), f"{tag} col {i} data"
        if x.offsets is not None or y.offsets is not None:
            assert torch.equal(x.offsets, y.offsets), f"{tag} col {i} offs"
        assert torch.equal(x.validity_or_true(), y.validity_or_true()), \
            f"{tag} col {i} validity"


def _blob(n, start=0, row_group_size=4):
    tab = pa.table({
        "k": pa.array(np.arange(start, start + n, dtype=np.int32)),
        "v": pa.array((np.arange(start, start + n) * 3).astype(np.int64)),
    })
    buf = io.BytesIO()
    pq.write_table(tab, buf, compression="SNAPPY", use_dictionary=False,
                   row_group_size=row_group_size)
    return buf.getvalue()


# --- delta scans -------------------------------------------------------------


def _pair(files):
    return (DeltaTable("t", files=files, device=CPU),
            JDeltaTable("t", files=files))


def _same_scan(d, jd, **kw):
    got, want = d.scan(**kw), jd.scan(**kw)
    assert_same_table(got, want)
    return got


class TestDeltaScan:
    def test_empty_delta_keeps_schema(self):
        d, jd = _pair([_blob(10)])
        t = _same_scan(d, jd, since=d.watermark())
        assert t.num_rows == 0 and t.num_columns == 2
        assert metrics.counter_value("stream.delta.rowgroups") == 0
        assert d.schema() == jd.schema() == ["k", "v"]
        assert d.column_dtype("v") == T.int64

    def test_delta_spans_file_boundary(self):
        d, jd = _pair([_blob(10)])                      # groups [4, 4, 2]
        for x in (d, jd):
            x.append_file(_blob(6, start=100))          # groups [4, 2]
        t = _same_scan(d, jd, since=(1,))
        assert t.num_rows == 12
        assert torch.equal(force_column(t[0]).data[:6],
                           torch.arange(4, 10, dtype=torch.int32))
        assert metrics.counter_value("stream.delta.rowgroups") == 4

    def test_watermark_until_and_epoch(self):
        d, jd = _pair([_blob(10)])
        wm = d.watermark()
        assert d.epoch == jd.epoch == 1 and wm == jd.watermark() == (3,)
        assert d.scan(since=wm).num_rows == 0
        for x in (d, jd):
            x.append_file(_blob(4, start=50))
        assert d.watermark() == (3, 1) and d.epoch == 2
        _same_scan(d, jd, since=wm)
        assert d.total_rows(wm) == 4 and d.total_rows() == 14
        assert d.delta_bytes(wm) == jd.delta_bytes(wm) > 0
        assert d.delta_bytes(d.watermark()) == 0
        assert _same_scan(d, jd, until=(1,)).num_rows == 4
        assert _same_scan(d, jd, since=(1,), until=(3,)).num_rows == 6

    def test_extend_file_prefix_validation(self):
        d, jd = _pair([_blob(8)])                       # groups [4, 4]
        d.extend_file(0, _blob(12))                     # groups [4, 4, 4]
        assert d.watermark() == (3,)
        with pytest.raises(ValueError):
            d.extend_file(0, _blob(12, row_group_size=5))
        base = tpcds_data.append_rows(8, seed=3, row_group_size=4)
        d2, jd2 = _pair([base])
        wm = d2.watermark()
        ext = tpcds_data.append_rows(4, seed=4, row_group_size=4, base=base)
        d2.extend_file(0, ext)
        jd2.extend_file(0, ext)
        assert _same_scan(d2, jd2, since=wm).num_rows == 4

    def test_pruning_composes_with_delta_scan(self):
        d, jd = _pair([_blob(16)])                      # k sorted per group
        wm = d.watermark()
        for x in (d, jd):
            x.append_file(_blob(16, start=100))
        t = _same_scan(d, jd, columns=["v"], since=wm,
                       rowgroup_predicate=[("k", "ge", 108)])
        assert t.num_columns == 1 and t.num_rows == 8
        assert metrics.counter_value("plan.scan.rowgroups_pruned") == 2


# --- mergeable aggregate states ---------------------------------------------


def _state_host(n, seed, null_frac=0.3):
    r = np.random.default_rng(seed)
    valid = r.random(n) > null_frac
    return (r.integers(0, 7, n).astype(np.int32),
            r.integers(-50, 50, n).astype(np.int64), valid,
            r.normal(0, 10, n), r.integers(-10**6, 10**6, n).astype(np.int64))


def _state_tab(n, seed, null_frac=0.3):
    k, i64, valid, f64, dec = _state_host(n, seed, null_frac)
    v = torch.from_numpy(valid)
    return Table([
        Column(T.int32, torch.from_numpy(k)),
        Column(T.int64, torch.from_numpy(i64), validity=v),
        Column(T.float64, torch.from_numpy(f64), validity=v),
        Column(T.decimal64(-2), torch.from_numpy(dec), validity=v),
    ])


def _jstate_tab(n, seed, null_frac=0.3):
    k, i64, valid, f64, dec = _state_host(n, seed, null_frac)
    v = jnp.asarray(valid)
    return JTable([
        JColumn(JT.int32, jnp.asarray(k)),
        JColumn(JT.int64, jnp.asarray(i64), validity=v),
        JColumn.from_values(JT.float64, jnp.asarray(f64), validity=v),
        JColumn(JT.decimal64(-2), jnp.asarray(dec), validity=v),
    ])


_ALL_AGGS = [(1, "sum"), (1, "count"), (1, "min"), (1, "max"), (1, "mean"),
             (1, "var"), (1, "std"), (2, "sum"), (2, "mean"), (2, "min"),
             (2, "max"), (2, "var"), (2, "std"), (3, "sum"), (3, "min"),
             (3, "max"), (3, "mean"), (3, "count")]


def _spec(tab, aggs=_ALL_AGGS):
    return G.plan_aggregate_states(
        aggs, {i: c.dtype for i, c in enumerate(tab.columns)}, 1)


def _merged(a, b, spec, aggs=_ALL_AGGS):
    return G.finalize_aggregate_states(spec, G.merge_aggregate_states(
        spec, G.partial_aggregate_states(a, [0], aggs, spec=spec),
        G.partial_aggregate_states(b, [0], aggs, spec=spec)))


class TestMergeStates:
    @pytest.mark.parametrize("agg", range(len(_ALL_AGGS)),
                             ids=[f"{c}-{a}" for c, a in _ALL_AGGS])
    def test_merge_equivalence(self, agg):
        # partition B is null-heavy (90%) so all-null groups and
        # validity-merging actually exercise
        aggs = [_ALL_AGGS[agg]]
        a, b = _state_tab(400, 1), _state_tab(250, 2, null_frac=0.9)
        spec = _spec(a, aggs)
        merged = _merged(a, b, spec, aggs)
        expect = G.groupby_aggregate(concat_tables([a, b]), [0], aggs)
        _bitcmp(Table([merged[0]]), Table([expect[0]]), "keys")
        o = spec.outs[0]
        x, y = force_column(expect[1]), force_column(merged[1])
        assert x.dtype == y.dtype
        assert torch.equal(x.validity_or_true(), y.validity_or_true())
        if o.exact:
            assert torch.equal(x.data, y.data), o
        else:
            np.testing.assert_allclose(y.data.numpy(), x.data.numpy(),
                                       rtol=1e-9, atol=1e-9)
        # and the JAX package's merged states give the same values
        ja, jb = _jstate_tab(400, 1), _jstate_tab(250, 2, null_frac=0.9)
        jspec = JG.plan_aggregate_states(
            aggs, {i: c.dtype for i, c in enumerate(ja.columns)}, 1)
        jgot = JG.finalize_aggregate_states(jspec, JG.merge_aggregate_states(
            jspec, JG.partial_aggregate_states(ja, [0], aggs, spec=jspec),
            JG.partial_aggregate_states(jb, [0], aggs, spec=jspec)))
        assert (o.exact, o.mode, spec.states) == \
            (jspec.outs[0].exact, jspec.outs[0].mode, jspec.states)
        assert_same_table(merged, jgot, rtol=None if o.exact else 1e-9)

    def test_unmerged_finalize_bit_identical(self):
        # an UNMERGED state reproduces groupby_aggregate exactly for EVERY
        # aggregate — float sums, var, std included
        tab = _state_tab(500, 5)
        spec = _spec(tab)
        got = G.finalize_aggregate_states(
            spec, G.partial_aggregate_states(tab, [0], _ALL_AGGS, spec=spec))
        _bitcmp(got, G.groupby_aggregate(tab, [0], _ALL_AGGS), "unmerged")

    def test_empty_partition_merge_is_identity(self):
        a = _state_tab(300, 7)
        spec = _spec(a)
        sa = G.partial_aggregate_states(a, [0], _ALL_AGGS, spec=spec)
        se = G.partial_aggregate_states(_state_tab(0, 8), [0], _ALL_AGGS,
                                        spec=spec)
        assert se.num_rows == 0
        _bitcmp(G.finalize_aggregate_states(
                    spec, G.merge_aggregate_states(spec, sa, se)),
                G.finalize_aggregate_states(spec, sa), "empty-merge")
        assert G.merge_aggregate_states(spec, None, sa) is sa

    def test_string_keys_and_exactness_plan(self):
        r = np.random.default_rng(9)
        keys = Column.strings_from_list([f"g{i % 5}" for i in range(200)],
                                        device=CPU)
        vals = Column(T.int64, torch.from_numpy(
            r.integers(0, 99, 200).astype(np.int64)))
        tab = Table([keys, vals])
        aggs = [(1, "sum"), (1, "mean"), (1, "count")]
        spec = _spec(tab, aggs)
        assert spec.exact
        lo = apply_boolean_mask(tab, torch.arange(200) < 120)
        hi = apply_boolean_mask(tab, torch.arange(200) >= 120)
        _bitcmp(_merged(lo, hi, spec, aggs),
                G.groupby_aggregate(tab, [0], aggs), "strkeys")
        for agg, dt in (("sum", T.float64), ("var", T.int64),
                        ("min", T.float64), ("sum", T.decimal64(-2)),
                        ("mean", T.decimal64(-2)), ("mean", T.int32)):
            assert G.merge_exact(agg, dt) == JG.merge_exact(
                agg, JT.DType(JT.TypeId(int(dt.id)), dt.scale)), (agg, dt)

    def test_rejects_unsupported(self):
        tab = _state_tab(10, 1)
        with pytest.raises(ValueError):
            G.plan_aggregate_states([(1, "first")], {1: tab[1].dtype}, 1)
        with pytest.raises(ValueError):
            G.partial_aggregate_states(tab, [], [(1, "sum")])


# --- view registry -----------------------------------------------------------


def _mini_files():
    return tpcds_data.generate(n_sales=12_000, n_items=400, seed=11,
                               row_group_size=1024)


def _cents_view_plan(ir):
    j = ir.Join(ir.Join(ir.Scan("store_sales"), ir.Scan("item"),
                        ("ss_item_sk",), ("i_item_sk",)),
                ir.Scan("date_dim"), ("ss_sold_date_sk",), ("d_date_sk",))
    f = ir.Filter(j, ir.And((
        ir.Cmp("==", ir.Col("i_manufact_id"), ir.Lit(436)),
        ir.Cmp("==", ir.Col("d_moy"), ir.Lit(11)))))
    keys = ("d_year", "i_brand_id", "i_brand")
    return ir.Sort(ir.Aggregate(f, keys, (
        ("ss_sales_price_cents", "sum", "sum_cents"),
        ("ss_quantity", "mean", "avg_qty"),
        ("ss_quantity", "count", "n"))), keys)


def _shapes(ir):
    """Plan shapes and their names: one incremental, the fallbacks."""
    return {
        "cents": _cents_view_plan(ir),
        "brand_minmax": ir.Aggregate(
            ir.Join(ir.Scan("store_sales"), ir.Scan("item"),
                    ("ss_item_sk",), ("i_item_sk",)),
            ("i_category",), (("ss_sales_price_cents", "max", "hi"),
                              ("ss_ext_sales_price", "min", "lo"),
                              ("ss_quantity", "sum", "q"))),
        "win": ir.Aggregate(
            ir.Window(ir.Scan("store_sales"), "row_number",
                      ("ss_store_sk",), ("ss_sold_date_sk",), "rn"),
            ("ss_store_sk",), (("rn", "max", "max_rn"),)),
        "total": ir.Aggregate(ir.Scan("store_sales"), (),
                              (("ss_quantity", "sum", "s"),)),
        "varv": ir.Aggregate(ir.Scan("store_sales"), ("ss_store_sk",),
                             (("ss_ext_sales_price", "var", "v"),)),
        "fsum": ir.Aggregate(ir.Scan("store_sales"), ("ss_store_sk",),
                             (("ss_ext_sales_price", "sum", "s"),)),
        "left_fact_right": ir.Aggregate(
            ir.Join(ir.Scan("item"), ir.Scan("store_sales"),
                    ("i_item_sk",), ("ss_item_sk",), how="left"),
            ("i_brand_id",), (("ss_quantity", "count", "n"),)),
    }


@pytest.fixture(scope="module")
def mini():
    files = _mini_files()
    return (files, tpcds.load_tables(files, device=CPU),
            jtpcds.load_tables(files))


def _registry(mini, **kw):
    files, tables, _ = mini
    delta = DeltaTable("store_sales", files=[files["store_sales"]],
                       device=CPU)
    statics = {k: tables[k] for k in ("item", "date_dim", "store")}
    schemas = {k: tpcds_plans.TABLE_SCHEMAS[k] for k in statics}
    return delta, ViewRegistry(delta, statics, schemas, **kw)


def _jregistry(mini, **kw):
    files, _, jtables = mini
    from spark_rapids_jni_tpu.models import tpcds_plans as jplans
    delta = JDeltaTable("store_sales", files=[files["store_sales"]])
    statics = {k: jtables[k] for k in ("item", "date_dim", "store")}
    schemas = {k: jplans.TABLE_SCHEMAS[k] for k in statics}
    return delta, JViewRegistry(delta, statics, schemas, **kw)


def _full(reg, v):
    cat = lower.TableCatalog({**reg.statics, reg.delta.name: reg.delta.scan()},
                             reg.schemas)
    return lower.execute(v.tree, cat, record_stats=False)


def _append(seed):
    return tpcds_data.append_rows(12_000 // 64, seed=seed, n_items=400,
                                  row_group_size=1024)


class TestViewRegistry:
    @pytest.mark.parametrize("shape", list(_shapes(ir)))
    def test_classifier_matches_jax(self, mini, shape):
        _, reg = _registry(mini)
        _, jreg = _jregistry(mini)
        v = reg.register_view(_shapes(ir)[shape], name=shape)
        jv = jreg.register_view(_shapes(jir)[shape], name=shape)
        assert (v.kind, v.reason, v.exact) == (jv.kind, jv.reason, jv.exact)
        assert v.fingerprint == jv.fingerprint
        if v.kind == "full":
            assert metrics.counter_value("stream.view.fallback") == 1
        reg.close()
        jreg.close()

    @pytest.mark.parametrize("shape", ["cents", "brand_minmax"])
    def test_incremental_refresh_bit_identical(self, mini, shape):
        delta, reg = _registry(mini)
        jdelta, jreg = _jregistry(mini)
        v = reg.register_view(_shapes(ir)[shape], name=shape)
        jv = jreg.register_view(_shapes(jir)[shape], name=shape)
        assert v.kind == "incremental" and v.exact, v.reason
        _bitcmp(reg.refresh(v), _full(reg, v), "epoch0")
        for e in (1, 2):
            blob = _append(100 + e)
            delta.append_file(blob)
            jdelta.append_file(blob)
            c0 = metrics.counter_value("stream.delta.rowgroups")
            got = reg.refresh(v)
            assert metrics.counter_value("stream.delta.rowgroups") - c0 == 1
            _bitcmp(got, _full(reg, v), f"epoch{e}")
            if shape == "cents":
                # the JAX package's refresh compiles each new shape on the
                # CPU: one shape holds the port's against it
                assert_same_table(got, jreg.refresh(jv))
        assert metrics.counter_value("stream.refresh.incremental") == 2
        assert reg.register_view(_shapes(ir)[shape]) is v
        assert reg.stats()["incremental"] == 1
        reg.close()
        jreg.close()

    def test_rollup_view_is_full(self, mini):
        """A rollup aggregate refreshes as a full recompute: several
        grouping levels and a grouping_id, which one keyed state cannot
        hold.  (The JAX package classifies it incremental and refreshes
        the finest level alone; the port departs from it here.)"""
        delta, reg = _registry(mini)
        v = reg.register_view(ir.Aggregate(
            ir.Join(ir.Scan("store_sales"), ir.Scan("item"),
                    ("ss_item_sk",), ("i_item_sk",)),
            ("i_category_id", "i_brand_id"), (("ss_quantity", "sum", "q"),),
            grouping="rollup"), name="rollup")
        assert (v.kind, v.reason) == ("full", "grouping:rollup")
        delta.append_file(_append(5))
        got = reg.refresh(v)
        assert got.num_columns == 4
        _bitcmp(got, _full(reg, v), "rollup")
        reg.close()

    def test_full_view_and_allow_approx(self, mini):
        delta, reg = _registry(mini)
        w = reg.register_view(_shapes(ir)["win"], name="win")
        delta.append_file(_append(7))
        _bitcmp(reg.refresh(w), _full(reg, w), "window")
        assert metrics.counter_value("stream.refresh.full") == 1
        reg.close()
        delta, reg = _registry(mini, allow_approx=True)
        v = reg.register_view(ir.Aggregate(
            ir.Scan("store_sales"), ("ss_store_sk",),
            (("ss_ext_sales_price", "var", "v"),
             ("ss_ext_sales_price", "mean", "m"))), name="varv")
        assert v.kind == "incremental" and not v.exact
        delta.append_file(_append(77))
        got, expect = reg.refresh(v), _full(reg, v)
        assert got.num_rows == expect.num_rows
        for i in (1, 2):
            np.testing.assert_allclose(force_column(got[i]).data.numpy(),
                                       force_column(expect[i]).data.numpy(),
                                       rtol=1e-9, atol=1e-9)
        reg.close()

    def test_refresh_through_scheduler(self, mini):
        delta, reg = _registry(mini)
        v = reg.register_view(_cents_view_plan(ir), name="q3c")
        qfn = lower.compile_plan(v.tree, dict(reg.schemas))
        base = {**reg.statics, "store_sales": delta.scan()}
        stop = threading.Event()
        errs: list = []

        def querier():
            while not stop.is_set():
                try:
                    sched.run("q3c", qfn, base)
                except Exception as e:     # noqa: BLE001
                    errs.append(e)
                    return
        with xc.QueryScheduler(workers=2, device=CPU) as sched:
            th = threading.Thread(target=querier)
            th.start()
            try:
                for e in (1, 2, 3):
                    delta.append_file(_append(200 + e))
                    assert reg.delta_bytes(v) > 0
                    got = sched.submit_refresh(reg, v).result()
                    _bitcmp(got, _full(reg, v), f"epoch{e}")
            finally:
                stop.set()
                th.join()
        assert not errs
        assert metrics.counter_value("stream.refresh.submitted") == 3
        assert metrics.counter_value("stream.refresh.incremental") == 3
        reg.close()
