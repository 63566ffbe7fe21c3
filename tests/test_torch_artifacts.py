"""The persistent AOT tape store of the PyTorch port
(``exec/artifacts.py``, ``_version.py``), on the CPU.

The port's counterpart of ``tests/test_artifacts.py``: a persisted
artifact either rehydrates a plan with ZERO eager capture runs and
bit-identical results, or degrades to the ordinary capture — corrupted
files, version skew and stale tapes are misses, never errors:

* round trip — tape bit-identity (sizes past 2^32 included), the
  versioned document, the manifest ranked by cost; the tape the port
  persists for a query equals the one the JAX package persists;
* geometry — power-of-two bucketing folds nearby sizes onto one key as
  the JAX package's does, exact mode keeps them apart, opaque objects
  make the key unstable;
* fallback — a corrupt artifact, torch/CUDA/package version skew and a
  stale tape (wrong sizes, wrong length) degrade to a live capture,
  whose write-back heals the artifact;
* integration — a populated store serves a fresh ``PlanCache`` and a
  ``QueryScheduler`` (CPU replicas) with no capture run; the scheduler's
  warm-up thread pre-hydrates the manifest; the JAX package's
  ``SRJT_AOT_XLA_CACHE`` is not registered.
"""

import torch_one_thread  # noqa: F401  (first: one intra-op thread)
import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from spark_rapids_jni_tpu import types as JT
from spark_rapids_jni_tpu.column import Column as JColumn
from spark_rapids_jni_tpu.column import Table as JTable
from spark_rapids_jni_tpu.exec import artifacts as jartifacts
from spark_rapids_jni_tpu.exec.plan_cache import PlanCache as JPlanCache
from spark_rapids_jni_tpu.ops import filter as JF

import spark_rapids_jni_tpu_torch as pt
from spark_rapids_jni_tpu_torch import exec as xc
from spark_rapids_jni_tpu_torch import types as T
from spark_rapids_jni_tpu_torch.column import Column, Table
from spark_rapids_jni_tpu_torch.exec import artifacts
from spark_rapids_jni_tpu_torch.exec.plan_cache import PlanCache
from spark_rapids_jni_tpu_torch.models import compiled
from spark_rapids_jni_tpu_torch.ops import filter as F
from spark_rapids_jni_tpu_torch.utils import knobs, metrics

from torch_tpcds_cases import assert_identical


@pytest.fixture(autouse=True)
def _metrics_on():
    metrics.set_enabled(True)
    metrics.reset()
    yield
    metrics.reset()
    metrics.set_enabled(None)


@pytest.fixture
def aot_dir(tmp_path, monkeypatch):
    d = str(tmp_path / "aot")
    monkeypatch.setenv("SRJT_AOT_DIR", d)
    return d


def _host(n, seed=7):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 50, n).astype(np.int32),
            rng.standard_normal(n).astype(np.float32))


def _mktab(n, seed=7):
    a, b = _host(n, seed)
    return {"t": Table([Column(T.int32, torch.from_numpy(a)),
                        Column(T.float32, torch.from_numpy(b))])}


def _jmktab(n, seed=7):
    a, b = _host(n, seed)
    return {"t": JTable([JColumn(JT.int32, jnp.asarray(a)),
                         JColumn(JT.float32, jnp.asarray(b))])}


def _q_filter(tbls):
    # a query with a tape: the compaction count is a resolved size
    t = tbls["t"]
    return F.apply_boolean_mask(t, t.columns[0].data < 25)


def _jq_filter(tbls):
    t = tbls["t"]
    return JF.apply_boolean_mask(t, t.columns[0].data < 25)


def _count(name):
    return metrics.counter_value(name)


def _materialized(t):
    return compiled._materialized(t)


def _skewed(env: str, part: str) -> str:
    """``env`` with its ``part`` version field changed."""
    return ";".join(f + ".x" if f.startswith(part) else f
                    for f in env.split(";"))


# --- round trip --------------------------------------------------------------


def test_tape_roundtrip_bit_identity(aot_dir):
    store = artifacts.get_store()
    geom = artifacts.geometry_key(_mktab(100))
    tape = (0, 1, 3, 2**40 + 17, 7)     # past 2^32: JSON ints stay exact
    assert store.put("planA", "v1", geom, tape, name="qa", cost_ms=9.5)
    assert store.lookup("planA", "v1", geom) == tape
    store._mem.clear()
    assert store.lookup("planA", "v1", geom) == tape
    with open(store.path_for("planA", "v1", geom)) as f:
        doc = json.load(f)
    assert doc["version"] == artifacts.STORE_VERSION
    assert tuple(doc["tape"]) == tape
    assert doc["env"] == artifacts.env_fingerprint()
    assert f"torch{torch.__version__}" in doc["env"]
    assert f"pkg{pt.__version__}" in doc["env"]


def test_persisted_tape_equals_jax_package(aot_dir, tmp_path, monkeypatch):
    tables = _mktab(500)
    PlanCache().run("qf", _q_filter, tables)
    store = artifacts.get_store()
    (entry,) = store.manifest_entries()
    monkeypatch.setenv("SRJT_AOT_DIR", str(tmp_path / "jaot"))
    JPlanCache().run("qf", _jq_filter, _jmktab(500))
    (jentry,) = jartifacts.get_store().manifest_entries()
    jtape = jartifacts.get_store().lookup(
        "qf", "", jartifacts.geometry_key(_jmktab(500)))
    tape = store.lookup("qf", "", artifacts.geometry_key(tables))
    assert tape == jtape and len(tape) == entry[1]["tape_len"] == \
        jentry[1]["tape_len"] == 1


def test_manifest_ranked_by_cost(aot_dir):
    store = artifacts.get_store()
    geom = artifacts.geometry_key(_mktab(100))
    store.put("cheap", "", geom, (1,), cost_ms=2.0)
    store.put("dear", "", geom, (2,), cost_ms=50.0)
    store.put("mid", "", geom, (3,), cost_ms=10.0)
    assert [e["plan"] for _, e in store.manifest_entries()] == \
        ["dear", "mid", "cheap"]


def test_variant_and_key_isolation(aot_dir):
    store = artifacts.get_store()
    geom = artifacts.geometry_key(_mktab(100))
    store.put("p", "", geom, (1, 2))
    assert store.lookup("p", "sorted", geom) is None
    assert store.lookup("other", "", geom) is None
    assert store.lookup("p", "", geom) == (1, 2)


# --- geometry keys -----------------------------------------------------------


@pytest.mark.parametrize("a,b", [(900, 1000), (1024, 1025), (1000, 1000),
                                 (1, 2), (0, 1)])
def test_geometry_buckets_as_jax(a, b):
    for buckets in (True, False):
        same = artifacts.geometry_key(_mktab(a), buckets=buckets) == \
            artifacts.geometry_key(_mktab(b), buckets=buckets)
        jsame = jartifacts.geometry_key(_jmktab(a), buckets=buckets) == \
            jartifacts.geometry_key(_jmktab(b), buckets=buckets)
        assert same == jsame, (a, b, buckets)


def test_geometry_dtype_lazy_and_opaque():
    c, b = _mktab(1000), _mktab(1000)
    c["t"].columns[0].data = c["t"].columns[0].data.to(torch.int64)
    assert artifacts.geometry_key(c) != artifacts.geometry_key(b)
    lazy = {"t": F.gather(b["t"], torch.arange(900))}
    lazy2 = {"t": F.gather(b["t"], torch.arange(1000))}
    assert artifacts.geometry_key(lazy) == artifacts.geometry_key(lazy2)
    assert artifacts.geometry_key(lazy, buckets=False) != \
        artifacts.geometry_key(lazy2, buckets=False)

    class Opaque:
        pass
    assert artifacts.geometry_key({"t": b["t"], "cfg": Opaque()}) is None
    assert _count("aot.unstable_key") >= 1


# --- fallback: corrupt / skew / stale ---------------------------------------


def test_corrupt_artifact_degrades_to_capture(aot_dir):
    store = artifacts.get_store()
    tables = _mktab(500)
    out = PlanCache().run("qf", _q_filter, tables)
    geom = artifacts.geometry_key(tables)
    path = store.path_for("qf", "", geom)
    assert os.path.exists(path)
    with open(path, "w") as f:
        f.write('{"version": 1, "tape": [1, 2')     # a torn write
    store._mem.clear()
    metrics.reset()
    assert_identical(PlanCache().run("qf", _q_filter, tables), out)
    assert _count("compiled.capture") == 1
    assert _count("compiled.rehydrate") == 0
    assert _count("aot.reject") >= 1
    store._mem.clear()
    assert store.lookup("qf", "", geom) is not None


@pytest.mark.parametrize("skew", ["torch", "cuda", "pkg", "version"])
def test_version_skew_rejected(aot_dir, skew):
    store = artifacts.get_store()
    geom = artifacts.geometry_key(_mktab(100))
    store.put("p", "", geom, (5, 6))
    path = store.path_for("p", "", geom)
    with open(path) as f:
        doc = json.load(f)
    if skew == "version":
        doc["version"] = artifacts.STORE_VERSION + 1
    else:
        doc["env"] = _skewed(doc["env"], skew)
    with open(path, "w") as f:
        json.dump(doc, f)
    store._mem.clear()
    assert store.lookup("p", "", geom) is None
    assert _count("aot.reject") == 1


def test_stale_tape_rehydrate_recaptures(aot_dir):
    store = artifacts.get_store()
    tables = _mktab(500)
    geom = artifacts.geometry_key(tables)
    store.put("qf", "", geom, (3,))             # a wrong resolved size
    out = PlanCache().run("qf", _q_filter, tables)
    assert_identical(out, _materialized(_q_filter(tables)))
    assert _count("compiled.rehydrate") == 1
    assert _count("exec.plan_cache.stale") == 1
    assert _count("compiled.capture") == 1
    metrics.reset()
    store._mem.clear()
    assert_identical(PlanCache().run("qf", _q_filter, tables), out)
    assert _count("compiled.capture") == 0
    assert _count("compiled.rehydrate") == 1


def test_stale_wrong_length_tape_recaptures(aot_dir):
    tables = _mktab(500)
    artifacts.get_store().put("qf", "", artifacts.geometry_key(tables), ())
    out = PlanCache().run("qf", _q_filter, tables)
    assert_identical(out, _materialized(_q_filter(tables)))
    assert _count("exec.plan_cache.stale") == 1
    assert _count("compiled.capture") == 1


# --- integration: plan cache + scheduler ------------------------------------


def test_plan_cache_zero_capture_from_store(aot_dir):
    tables = _mktab(500)
    oracle = PlanCache().run("qf", _q_filter, tables)
    assert _count("compiled.capture") == 1
    assert _count("aot.write") == 1
    metrics.reset()
    out = PlanCache().run("qf", _q_filter, tables)
    assert_identical(oracle, out)
    assert _count("compiled.capture") == 0
    assert _count("compiled.rehydrate") == 1
    assert _count("exec.plan_cache.aot_hit") == 1
    led = metrics.ledger_snapshot().get("_q_filter", {})
    assert led.get("rehydrates") == 1 and "captures" not in led


def test_scheduler_serves_zero_capture_and_warms_up(aot_dir, monkeypatch):
    monkeypatch.setenv("SRJT_AOT_WARMUP", "4")
    tables = _mktab(800)
    with xc.QueryScheduler(workers=2, device="cpu") as sched:
        oracle = sched.run("qf", _q_filter, tables)
    assert _count("compiled.capture") == 1
    metrics.reset()
    artifacts.get_store()._mem.clear()
    with xc.QueryScheduler(workers=2, device="cpu") as sched:
        assert sched._warmup_thread is not None
        sched._warmup_thread.join(timeout=30)
        assert _count("aot.preloaded") >= 1
        assert _count("exec.aot.warmed") >= 1
        out = sched.run("qf", _q_filter, tables)
    assert_identical(oracle, out)
    assert _count("compiled.capture") == 0
    assert _count("compiled.rehydrate") == 1


def test_disabled_store_writes_nothing(tmp_path, monkeypatch):
    monkeypatch.delenv("SRJT_AOT_DIR", raising=False)
    assert not artifacts.enabled()
    assert artifacts.get_store() is None
    tables = _mktab(300)
    assert_identical(PlanCache().run("qf", _q_filter, tables),
                     _materialized(_q_filter(tables)))
    assert _count("aot.write") == 0
    assert list(tmp_path.iterdir()) == []
    with xc.QueryScheduler(workers=1, device="cpu") as sched:
        assert sched._warmup_thread is None


def test_jax_only_knobs_not_registered():
    # XLA's executable cache and buffer donation have no torch
    # counterpart, so their knobs are not ported
    for name in ("SRJT_AOT_XLA_CACHE", "SRJT_ML_DONATE"):
        assert name not in knobs.REGISTRY
        with pytest.raises(KeyError):
            knobs.get(name)
    assert knobs.get("SRJT_AOT_WARMUP") == 8
