"""The ETL→ML handoff of the PyTorch port (``ml/``, ``rowconv.convert.
fixed_rows_to_matrix``, ``models.mortgage.feature_spec``), on the CPU.

The port's counterpart of ``tests/test_ml.py``, held against the JAX
package on the same seeded numpy inputs:

* feature packs bit-identical to the JAX package's and to the numpy
  oracle of the lane rules (``tools/torch_ml_oracle.py``), through both
  pack engines; dictionary categoricals never materialize; imputation
  and label rules; the Mortgage ETL's ``feature_spec`` on its own output;
* the host PRNG (``ml/prng.py``): threefry words, ``fold_in``, ``split``
  and both engines' epoch permutations equal to ``jax.random`` for
  several (seed, epoch);
* training: the closed-form gradients against ``jax.grad``; losses and
  params after 2 epochs within rtol 1e-5, atol 1e-6 of the JAX
  ``Trainer`` from the same ``params_from_numpy`` start, fused and not;
  a float64 replay (``tools/torch_ml_oracle.py``); no sync between the
  epochs;
* capture/replay of a feature plan; served predictions bit-identical to
  ``predict_table`` through ``QueryScheduler`` on CPU replicas, also
  under an injected device fault; a JAX-trained model served by the
  port; the FeatureView online store against a from-scratch pack.
"""

import torch_one_thread  # noqa: F401  (first: one intra-op thread)
import functools
import io
import pathlib
import sys

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

import jax
import jax.numpy as jnp

from spark_rapids_jni_tpu import ml as jml
from spark_rapids_jni_tpu import types as JT
from spark_rapids_jni_tpu.column import Column as JColumn
from spark_rapids_jni_tpu.column import DictColumn as JDictColumn
from spark_rapids_jni_tpu.column import Table as JTable

from spark_rapids_jni_tpu_torch import exec as xc
from spark_rapids_jni_tpu_torch import ml
from spark_rapids_jni_tpu_torch import types as T
from spark_rapids_jni_tpu_torch.column import (Column, DictColumn, Table,
                                               force_column)
from spark_rapids_jni_tpu_torch.faultinj import injector as finj
from spark_rapids_jni_tpu_torch.ml import features as F
from spark_rapids_jni_tpu_torch.ml import prng
from spark_rapids_jni_tpu_torch.models import compiled as C
from spark_rapids_jni_tpu_torch.models import mortgage
from spark_rapids_jni_tpu_torch.plan import ir
from spark_rapids_jni_tpu_torch.rowconv import convert as RC
from spark_rapids_jni_tpu_torch.rowconv.layout import compute_row_layout
from spark_rapids_jni_tpu_torch.stream import DeltaTable, ViewRegistry
from spark_rapids_jni_tpu_torch.utils import metrics, syncs

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "tools"))
import torch_ml_oracle as MLO  # noqa: E402
import torch_mortgage_parquet as MW  # noqa: E402

CPU = "cpu"
# the JAX Trainer against the port's: float32 steps in another op order
RTOL, ATOL = 1e-5, 1e-6


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
    finj.get_injector().disable()
    metrics.reset()
    metrics.set_enabled(None)


def _bits(x) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(x, dtype=np.float32)).view(
        np.uint32)


def _same_bits(a, b) -> None:
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    np.testing.assert_array_equal(_bits(a), _bits(b))


# --- feature packs -----------------------------------------------------------


_STR_VOCAB = ["red", "green", "blue", "", "aa\x00b"]


def _mixed_host(n=257, seed=0):
    rng = np.random.default_rng(seed)
    return dict(
        i64=rng.integers(-1000, 1000, n).astype(np.int64),
        i32=rng.integers(0, 100, n).astype(np.int32),
        i32_null=rng.random(n) < 0.25,
        f64=rng.normal(size=n) * 1e3,
        f32=rng.normal(size=n).astype(np.float32),
        b8=rng.integers(0, 2, n).astype(bool),
        dec=rng.integers(-10**6, 10**6, n).astype(np.int64),
        strs=[None if rng.random() < 0.2
              else _STR_VOCAB[rng.integers(0, 5)] for _ in range(n)])


_NAMES = ["i64", "i32", "f64", "f32", "b8", "dec", "s"]


def _mixed(h):
    return Table([
        Column(T.int64, torch.from_numpy(h["i64"])),
        Column(T.int32, torch.from_numpy(h["i32"]),
               validity=torch.from_numpy(~h["i32_null"])),
        Column(T.float64, torch.from_numpy(h["f64"])),
        Column(T.float32, torch.from_numpy(h["f32"])),
        Column(T.bool8, torch.from_numpy(h["b8"].astype(np.uint8))),
        Column(T.decimal64(-3), torch.from_numpy(h["dec"])),
        Column.strings_from_list(h["strs"], device=CPU)])


def _jmixed(h):
    return JTable([
        JColumn.from_numpy(h["i64"]),
        JColumn(JT.int32, jnp.asarray(h["i32"]),
                validity=jnp.asarray(~h["i32_null"])),
        JColumn.from_numpy(h["f64"]),
        JColumn(JT.float32, jnp.asarray(h["f32"])),
        JColumn.from_numpy(h["b8"]),
        JColumn(JT.decimal64(-3), jnp.asarray(h["dec"])),
        JColumn.strings_from_list(h["strs"])])


def _spec(mod):
    return mod.FeatureSpec.of([
        mod.Feature("i64"), mod.Feature("i32", impute="mean"),
        mod.Feature("f64"), mod.Feature("f32"), mod.Feature("b8"),
        mod.Feature("dec"), mod.Feature("s", impute=("const", -1.0))])


def _oracle(h):
    X, _ = MLO.pack([
        ("INT64", 0, h["i64"], None, "error"),
        ("INT32", 0, h["i32"], ~h["i32_null"], "mean"),
        ("FLOAT64", 0, h["f64"], None, "error"),
        ("FLOAT32", 0, h["f32"], None, "error"),
        ("BOOL8", 0, h["b8"], None, "error"),
        ("DECIMAL64", -3, h["dec"], None, "error"),
        ("STRING", 0, np.array(h["strs"], dtype=object), None,
         ("const", -1.0))])
    return X


class TestFeaturePack:
    @pytest.mark.parametrize("engine", ["rowconv", "stack"])
    @pytest.mark.parametrize("seed", [0, 3])
    def test_bit_identical_to_jax_and_oracle(self, engine, seed):
        h = _mixed_host(seed=seed)
        fb = _spec(F).pack(_mixed(h), _NAMES, engine=engine)
        assert fb.X.dtype == torch.float32 and fb.num_features == 7
        _same_bits(fb.X, _oracle(h))
        jfb = _spec(jml).pack(_jmixed(h), _NAMES, engine=engine)
        _same_bits(fb.X, jfb.X)

    def test_multi_batch_rowconv_pack(self):
        n = 300
        vals = np.random.default_rng(7).normal(size=(n, 3)).astype(
            np.float32)
        tbl = Table([Column(T.float32, torch.from_numpy(vals[:, i].copy()))
                     for i in range(3)])
        layout = compute_row_layout(tbl.schema)
        batches = RC.convert_to_rows(
            tbl, max_batch_bytes=layout.fixed_row_size * 64)
        assert len(batches) > 1
        mats = [RC.fixed_rows_to_matrix(b, layout) for b in batches]
        _same_bits(torch.cat(mats), vals)
        with pytest.raises(ValueError):
            RC.fixed_rows_to_matrix(batches[0], compute_row_layout(
                [T.float32, T.int32, T.float32]))

    def test_dict_categorical_never_materializes(self):
        strs = ["b", "a", "c", "a", None, "b"] * 40
        codes = torch.tensor([1, 0, 2, 0, 0, 1] * 40, dtype=torch.int32)
        dcol = DictColumn(codes, Column.strings_from_list(["a", "b", "c"],
                                                          device=CPU),
                          validity=torch.tensor([s is not None
                                                 for s in strs]))
        spec = F.FeatureSpec.of([F.Feature("s", impute=("const", -1.0))])
        fb = spec.pack(Table([dcol]), ["s"])
        assert dcol._mat is None
        rank = {"a": 0.0, "b": 1.0, "c": 2.0}
        _same_bits(fb.X[:, 0], np.array(
            [-1.0 if s is None else rank[s] for s in strs], np.float32))
        jd = JDictColumn(jnp.asarray(codes.numpy()),
                         JColumn.strings_from_list(["a", "b", "c"]),
                         validity=jnp.asarray(dcol.validity.numpy()))
        jfb = jml.FeatureSpec.of([jml.Feature("s", impute=("const", -1.0))]
                                 ).pack(JTable([jd]), ["s"])
        _same_bits(fb.X, jfb.X)

    def test_dict_and_plain_paths_agree_when_null_free(self):
        strs = ["b", "a", "c", "a", "c", "b"] * 40
        codes = torch.tensor([1, 0, 2, 0, 2, 1] * 40, dtype=torch.int32)
        dcol = DictColumn(codes, Column.strings_from_list(["a", "b", "c"],
                                                          device=CPU))
        spec = F.FeatureSpec.of([F.Feature("s")])
        a = spec.pack(Table([dcol]), ["s"])
        b = spec.pack(Table([Column.strings_from_list(strs, device=CPU)]),
                      ["s"])
        _same_bits(a.X, b.X)
        _same_bits(a.X[:, 0], MLO.lane("STRING", 0,
                                       np.array(strs, dtype=object)))

    def test_imputation_policies(self):
        vals = np.array([1, -2, 3, 4, 5], np.int64)
        valid = np.array([True, False, True, False, True])
        col = Column(T.int64, torch.from_numpy(vals),
                     validity=torch.from_numpy(valid))
        for policy in ("zero", ("const", 9.5), "mean"):
            fb = F.FeatureSpec.of([F.Feature("v", impute=policy)]).pack(
                Table([col]), ["v"])
            _same_bits(fb.X[:, 0], MLO.lane("INT64", 0, vals, valid,
                                            policy))
        with pytest.raises(ValueError, match="imputation"):
            F.FeatureSpec.of([F.Feature("v")]).pack(Table([col]), ["v"])
        with pytest.raises(ValueError):
            F.Feature("v", impute="median")

    def test_label_binarization(self):
        y = np.array([0, 1, 3, 0, 2], np.int64)
        tbl = Table([Column.from_numpy(np.arange(5, dtype=np.int64),
                                       device=CPU),
                     Column.from_numpy(y, device=CPU)])
        spec = F.FeatureSpec.of([F.Feature("x")], label="d",
                                label_transform=("gt", 0.0))
        fb = spec.pack(tbl, ["x", "d"])
        _same_bits(fb.y, (y > 0).astype(np.float32))
        fb2 = spec.pack(Table([tbl[0]]), ["x"], with_label=False)
        assert fb2.y is None and tuple(fb2.X.shape) == (5, 1)

    def test_mortgage_feature_spec_on_etl_output(self):
        files, _ = MW.mortgage_parquet(n_loans=3000, periods_per_loan=4,
                                       seed=11)
        t = mortgage.etl_tables(mortgage.load_tables(files, device=CPU))
        spec = mortgage.feature_spec()
        assert spec.feature_names == tuple(
            c for c in mortgage.FEATURE_COLS
            if c not in ("loan_id", "max_delinquency"))
        fb = spec.pack(t, mortgage.FEATURE_COLS)
        cols = []
        for f in spec.features + (spec.label,):
            c = force_column(t[mortgage.FEATURE_COLS.index(f.name)])
            cols.append((c.dtype.id.name, c.dtype.scale, c.data.numpy(),
                         None if c.validity is None
                         else c.validity.numpy(), f.impute))
        X, y = MLO.pack(cols[:-1], cols[-1], spec.label_transform)
        assert tuple(fb.X.shape) == (3000, 8)
        _same_bits(fb.X, X)
        _same_bits(fb.y, y)


# --- the host PRNG -----------------------------------------------------------


class TestPrng:
    @pytest.mark.parametrize("seed", [0, 7, 123456789, 2**40 + 5])
    def test_keys_bits_and_permutations_match_jax(self, seed):
        k = jax.random.PRNGKey(seed)
        assert prng.prng_key(seed) == tuple(int(v) for v in np.asarray(k))
        assert prng.split(prng.prng_key(seed), 3) == [
            tuple(int(v) for v in r) for r in np.asarray(
                jax.random.split(k, 3))]
        for epoch in (0, 1, 1000):
            fk = jax.random.fold_in(k, jnp.uint32(epoch))
            pk = prng.fold_in(prng.prng_key(seed), epoch)
            assert pk == tuple(int(v) for v in np.asarray(fk))
            np.testing.assert_array_equal(
                prng.bits(pk, 4),
                np.asarray(jax.random.bits(fk, (4,), jnp.uint32)))
            for n in (1, 203, 5000):
                np.testing.assert_array_equal(
                    prng.permutation(pk, n),
                    np.asarray(jax.random.permutation(fk, n)))

    @pytest.mark.parametrize("shuffle", ["feistel", "sort"])
    @pytest.mark.parametrize("n", [203, 1024, 5000])
    def test_epoch_batches_match_jax(self, shuffle, n):
        rng = np.random.default_rng(n)
        X = rng.normal(size=(n, 2)).astype(np.float32)
        y = np.arange(n, dtype=np.float32)
        pipe = ml.BatchPipeline(F.FeatureBatch(torch.from_numpy(X),
                                               torch.from_numpy(y)),
                                batch_size=50, seed=9, shuffle=shuffle)
        jpipe = jml.BatchPipeline(jml.FeatureBatch(jnp.asarray(X),
                                                   jnp.asarray(y)),
                                  batch_size=50, seed=9, shuffle=shuffle)
        for e in (0, 3):
            xb, yb = pipe.epoch_arrays(e)
            jxb, jyb = jpipe.epoch_arrays(e)
            _same_bits(xb, jxb)
            _same_bits(yb, jyb)
        rows = pipe.permutation(2).numpy()
        np.testing.assert_array_equal(np.sort(rows), np.arange(n))
        assert not np.array_equal(rows, np.arange(n))


# --- training ----------------------------------------------------------------


def _data(n=512, k=3, seed=4):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, k)).astype(np.float32)
    y = (X @ rng.normal(size=k).astype(np.float32) > 0).astype(np.float32)
    return X, y


def _pipes(X, y, batch=64, seed=4):
    return (ml.BatchPipeline(F.FeatureBatch(torch.from_numpy(X),
                                            torch.from_numpy(y)),
                             batch_size=batch, seed=seed),
            jml.BatchPipeline(jml.FeatureBatch(jnp.asarray(X),
                                               jnp.asarray(y)),
                              batch_size=batch, seed=seed))


_PAIRS = {"logreg-adam": ("logistic_regression", "adam", {"lr": 0.05}),
          "logreg-sgd": ("logistic_regression", "sgd",
                         {"lr": 0.3, "momentum": 0.9}),
          "linreg-sgd": ("linear_regression", "sgd",
                         {"lr": 0.05, "momentum": 0.5}),
          "linreg-adam": ("linear_regression", "adam", {"lr": 0.05})}


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(got, want) -> None:
    if isinstance(want, dict):
        for k in want:
            _close(got[k], want[k])
        return
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64),
                               rtol=RTOL, atol=ATOL)


class TestTrain:
    @pytest.mark.parametrize("model", ["logistic_regression",
                                       "linear_regression"])
    def test_closed_form_gradients_match_jax_grad(self, model):
        X, y = _data(n=64)
        rng = np.random.default_rng(1)
        w = rng.normal(size=3).astype(np.float32)
        b = np.float32(0.3)
        jm, m = getattr(jml, model)(), getattr(ml, model)()
        jg = jax.grad(jm.loss)({"w": jnp.asarray(w), "b": jnp.float32(b)},
                               jnp.asarray(X), jnp.asarray(y))
        tr = ml.Trainer(m, ml.sgd(lr=1.0))
        params = {"w": torch.from_numpy(w.copy()), "b": torch.tensor(b)}
        vel = tr.opt.init(params)
        loss = tr.train_step(params, vel, torch.from_numpy(X),
                             torch.from_numpy(y))
        # one SGD step of lr 1 from zero velocity moves by the gradient
        _close(vel, _np_tree(jg))
        _close(float(loss), float(jm.loss({"w": jnp.asarray(w),
                                           "b": jnp.float32(b)},
                                          jnp.asarray(X), jnp.asarray(y))))

    @pytest.mark.parametrize("fuse", [True, False], ids=["fused", "steps"])
    @pytest.mark.parametrize("pair", list(_PAIRS))
    def test_two_epochs_match_jax_trainer(self, pair, fuse):
        model, opt, kw = _PAIRS[pair]
        X, y = _data()
        pipe, jpipe = _pipes(X, y)
        jtr = jml.Trainer(getattr(jml, model)(), getattr(jml, opt)(**kw),
                          donate=False, fuse=fuse)
        jp, jo = jtr.init(3)
        jres = jtr.fit(jpipe, 2, params=jp, opt_state=jo)
        params, ostate = ml.params_from_numpy(*_np_tree((jp, jo)),
                                              device=CPU)
        tr = ml.Trainer(getattr(ml, model)(), getattr(ml, opt)(**kw),
                        fuse=fuse)
        res = tr.fit(pipe, 2, params=params, opt_state=ostate)
        _close(res.losses, jres.losses)
        got = ml.params_to_numpy(res.params, res.opt_state)
        _close(got[0], _np_tree(jres.params))
        _close(got[1], _np_tree(jres.opt_state))
        # the caller's starting params are left as they were
        assert not params["w"].any()

    def test_float64_replay_and_determinism(self):
        X, y = _data(seed=9)
        pipe, _ = _pipes(X, y, seed=9)
        res = ml.Trainer(ml.logistic_regression(),
                         ml.adam(lr=0.01)).fit(pipe, 3)
        epochs = [tuple(a.numpy() for a in pipe.epoch_arrays(e))
                  for e in range(3)]
        losses, p = MLO.replay(epochs, "logreg", "adam",
                               {"w": np.zeros(3), "b": 0.0}, {"lr": 0.01})
        np.testing.assert_allclose(res.losses, losses, rtol=1e-5)
        np.testing.assert_allclose(res.params["w"].numpy(), p["w"],
                                   rtol=1e-4, atol=1e-6)
        res2 = ml.Trainer(ml.logistic_regression(),
                          ml.adam(lr=0.01)).fit(pipe, 3)
        np.testing.assert_array_equal(res.losses, res2.losses)

    def test_no_sync_between_epochs(self):
        X, y = _data(n=1024, k=4, seed=2)
        pipe, _ = _pipes(X, y, batch=128, seed=1)
        tr = ml.Trainer(ml.logistic_regression(), ml.adam(lr=0.01))
        params, ostate = tr.init(pipe.k, CPU)
        base = syncs.sync_count()
        for e in range(4):
            Xb, yb = pipe.epoch_arrays(e)
            loss = tr.run_epoch(params, ostate, Xb, yb)
        assert syncs.sync_count() == base
        assert np.isfinite(float(loss))
        res = tr.fit(pipe, 3)
        assert syncs.sync_count() == base + 1        # the one loss read
        assert res.final_loss == res.losses[-1]


# --- capture/replay and serving ------------------------------------------------


def test_feature_plan_roundtrip():
    n = 200
    rng = np.random.default_rng(5)
    strs = [["x", "y", "zz", None][i % 4] for i in range(n)]
    tables = {"t": Table([
        Column.from_numpy(rng.integers(0, 9, n).astype(np.int32),
                          device=CPU),
        Column.strings_from_list(strs, device=CPU)])}
    spec = F.FeatureSpec.of([F.Feature("a"),
                             F.Feature("s", impute=("const", -1.0))])
    tree = ir.Filter(ir.Scan("t"), ir.Cmp(">", ir.Col("a"), ir.Lit(2)))
    qfn = F.compile_feature_plan(tree, {"t": ["a", "s"]}, spec,
                                 with_label=False)
    assert qfn.plan_fingerprint.endswith(":ml.features")
    eager = qfn(tables)
    cq = C.compile_query(qfn, tables)
    assert isinstance(cq.expected, F.FeatureBatch)
    for _ in range(2):
        got = cq.run(tables)
        _same_bits(got.X, eager.X)


def _servable(seed=1, n=512, params=None):
    rng = np.random.default_rng(seed)
    tables = {"t": Table([
        Column.from_numpy(rng.integers(0, 50, n).astype(np.int64),
                          device=CPU),
        Column(T.float32, torch.from_numpy(
            rng.normal(size=n).astype(np.float32)))])}
    spec = F.FeatureSpec.of([F.Feature("a"), F.Feature("b")])
    if params is None:
        params = {"w": torch.from_numpy(rng.normal(size=2).astype(
                      np.float32)), "b": torch.tensor(np.float32(0.25))}
    sv = ml.ServableModel.from_plan(f"sv{seed}", ir.Scan("t"),
                                    {"t": ["a", "b"]}, spec,
                                    ml.logistic_regression(), params)
    return sv, tables


class TestServe:
    def test_predict_through_scheduler_bit_identical(self):
        sv, tables = _servable(seed=21)
        ml.register_servable(sv)
        assert sv.name in ml.servables() and ml.get_servable(sv.name) is sv
        oracle = sv.predict_table(tables)[0].data
        with xc.QueryScheduler(workers=2, devices=2, device=CPU) as sched:
            got = [sched.submit_predict(sv.name, tables).result(timeout=60)
                   for _ in range(4)]
        for t in got:
            _same_bits(t[0].data, oracle)
        assert metrics.counter_value("ml.predict.submitted") == 4

    def test_predict_bit_identical_under_device_fault(self):
        sv, tables = _servable(seed=22)
        oracle = sv.predict_table(tables)[0].data
        inj = finj.get_injector()
        with xc.QueryScheduler(workers=4, devices=4, probe_base_s=0.02,
                               probe_max_s=0.2, device=CPU) as sched:
            inj.load_dict({"seed": 1, "sites": {
                "exec.dispatch": {"percent": 100,
                                  "injectionType": "device_error",
                                  "maxHits": 1}}})
            inj.enable()
            tickets = [sched.submit_predict(sv, tables) for _ in range(8)]
            for tk in tickets:
                _same_bits(tk.result(timeout=120)[0].data, oracle)
            assert inj.injected_count == 1
            assert any(tk.relocations > 0 for tk in tickets)

    def test_jax_trained_model_served_by_port(self):
        X, y = _data()
        _, jpipe = _pipes(X, y)
        jres = jml.Trainer(jml.logistic_regression(), jml.adam(lr=0.05),
                           donate=False).fit(jpipe, 2)
        params, _ = ml.params_from_numpy(_np_tree(jres.params), device=CPU)
        sv, tables = _servable(seed=3, params={
            "w": params["w"][:2].clone(), "b": params["b"]})
        got = sv.predict_table(tables)[0].data
        a = tables["t"][0].data.numpy().astype(np.float32)
        b = tables["t"][1].data.numpy()
        jpred = jres.model.predict(
            {"w": jres.params["w"][:2], "b": jres.params["b"]},
            jnp.stack([jnp.asarray(a), jnp.asarray(b)], axis=1))
        np.testing.assert_allclose(got.numpy(), np.asarray(jpred),
                                   rtol=RTOL, atol=ATOL)


# --- the online feature store ------------------------------------------------


def _blob(n, start=0):
    tab = pa.table({
        "k": pa.array(np.arange(start, start + n, dtype=np.int32)),
        "v": pa.array((np.arange(start, start + n) * 3).astype(np.int64)),
    })
    buf = io.BytesIO()
    pq.write_table(tab, buf, row_group_size=4, use_dictionary=False)
    return buf.getvalue()


class TestFeatureView:
    def test_online_refresh_matches_full_recompute(self):
        delta = DeltaTable("f", files=[_blob(16)], device=CPU)
        reg = ViewRegistry(delta, {}, {})
        plan = ir.Aggregate(ir.Scan("f"), ("k",),
                            (("v", "sum", "sv"), ("v", "count", "nv")))
        spec = F.FeatureSpec.of([F.Feature("k"), F.Feature("sv")],
                                label="nv")
        fv = ml.FeatureView(reg, plan, spec)
        try:
            assert fv.view.kind == "incremental"
            assert fv.current().num_rows == 16
            for start in (100, 200):
                delta.append_file(_blob(8, start=start))
                fb = fv.refresh()
                oracle = spec.pack(reg.refresh(fv.view), fv.names)
                _same_bits(fb.X, oracle.X)
                _same_bits(fb.y, oracle.y)
            assert metrics.counter_value("stream.refresh.incremental") >= 2
            assert fv.repacks >= 3
        finally:
            fv.close()

    def test_refresh_through_scheduler_repacks(self):
        delta = DeltaTable("f", files=[_blob(12)], device=CPU)
        reg = ViewRegistry(delta, {}, {})
        plan = ir.Aggregate(ir.Scan("f"), ("k",), (("v", "sum", "sv"),))
        spec = F.FeatureSpec.of([F.Feature("k"), F.Feature("sv")])
        fv = ml.FeatureView(reg, plan, spec, with_label=False)
        try:
            fv.refresh()
            delta.append_file(_blob(6, start=500))
            with xc.QueryScheduler(workers=1, device=CPU) as sched:
                sched.submit_refresh(reg, fv.view).result(timeout=60)
            assert fv.current().num_rows == 18
        finally:
            fv.close()
