"""Public names of the port against the JAX package's, on the CPU.

* the query budget's default limit: ``query_budget`` without a limit is
  sized as the JAX package's ``memory.budget.default_limit`` is, from
  ``SRJT_HBM_BUDGET`` or the recorded ``join.expand.pair_elements``
  histogram; without either the JAX package has no limit and the port
  takes the card's memory (None on the CPU);
* ``Column.null_count``, ``Column.validity_bitmask``,
  ``Table.from_pydict``, ``DType.is_timestamp``, ``DType.is_numeric``,
  ``utils.bitmask.pack_bits_np`` and ``unpack_bits_np`` on the same
  inputs;
* the sub-packages' re-exports.
"""

import torch_one_thread  # noqa: F401  (first: one intra-op thread)
import importlib

import numpy as np
import pytest

import jax.numpy as jnp
from spark_rapids_jni_tpu import Column as JColumn, Table as JTable
from spark_rapids_jni_tpu import types as JT
from spark_rapids_jni_tpu.memory import budget as jbudget
from spark_rapids_jni_tpu.utils import bitmask as jbitmask
from spark_rapids_jni_tpu.utils import metrics as jmetrics

import spark_rapids_jni_tpu_torch as pt
from spark_rapids_jni_tpu_torch.memory import budget
from spark_rapids_jni_tpu_torch.utils import bitmask, metrics, syncs

CPU = "cpu"


@pytest.fixture
def both_metrics(monkeypatch):
    """Both packages' metrics on and empty, and no SRJT_HBM_BUDGET."""
    monkeypatch.delenv("SRJT_HBM_BUDGET", raising=False)
    was = metrics.enabled(), jmetrics.enabled()
    for m in (metrics, jmetrics):
        m.set_enabled(True)
        m.reset()
    yield
    metrics.set_enabled(was[0])
    jmetrics.set_enabled(was[1])


def _limit() -> object:
    with budget.query_budget("q") as q:
        return q.limit


def test_histogram_max_reads_one_histogram(both_metrics):
    assert metrics.histogram_max("join.expand.pair_elements") is None
    for n in (7, 90, 3):
        metrics.observe("join.expand.pair_elements", n)
    assert metrics.histogram_max("join.expand.pair_elements") == 90
    assert metrics.histogram_max("join.expand.other") is None


@pytest.mark.parametrize("pairs", [[10], [1000, 3_000_000, 20],
                                   [50_000_000], [419_430, 419_431]])
def test_default_limit_from_the_histogram_equals_jax(both_metrics, pairs):
    for n in pairs:
        metrics.observe("join.expand.pair_elements", n)
        jmetrics.observe("join.expand.pair_elements", n)
    want = jbudget.default_limit()
    assert want is not None
    assert budget.default_limit() == want
    assert _limit() == want


@pytest.mark.parametrize("knob", ["3g", "512m", "4096"])
def test_default_limit_from_the_knob_equals_jax(both_metrics, monkeypatch,
                                                knob):
    metrics.observe("join.expand.pair_elements", 123)   # the knob wins
    jmetrics.observe("join.expand.pair_elements", 123)
    monkeypatch.setenv("SRJT_HBM_BUDGET", knob)
    assert _limit() == jbudget.default_limit() == budget.parse_bytes(knob)


def test_default_limit_without_either_is_the_card(both_metrics,
                                                  monkeypatch):
    assert jbudget.default_limit() is None
    assert _limit() is None                 # no card here
    monkeypatch.setattr(budget, "card_bytes", lambda: 80 << 30)
    assert _limit() == 80 << 30


def test_explicit_limit_is_kept(both_metrics):
    metrics.observe("join.expand.pair_elements", 10)
    with budget.query_budget("q", limit_bytes="2k") as q:
        assert q.limit == 2048


@pytest.mark.parametrize("n", [0, 1, 7, 8, 9, 100])
def test_null_count_and_bitmask_equal_jax(n):
    rng = np.random.default_rng(n)
    vals = rng.integers(0, 99, n).astype(np.int32)
    for valid in (None, rng.random(n) < 0.6):
        mine = pt.Column.from_numpy(vals, validity=valid, device=CPU)
        theirs = JColumn.from_numpy(vals, validity=valid)
        before = syncs.sync_count()
        assert mine.null_count == theirs.null_count
        assert syncs.sync_count() - before == (valid is not None)
        np.testing.assert_array_equal(mine.validity_bitmask().numpy(),
                                      np.asarray(theirs.validity_bitmask()))


def test_from_pydict_equals_jax():
    data = {"i": [1, None, 3, 4], "s": ["a", None, "ccc", ""],
            "f": [1.5, 2.0, None, -0.0], "n": [None, None, None, None]}
    dtypes = {"n": pt.int16}
    mine = pt.Table.from_pydict(data, dtypes, device=CPU)
    theirs = JTable.from_pydict(data, {"n": JT.int16})
    assert [(int(d.id), d.scale) for d in mine.schema] == \
        [(int(d.id), d.scale) for d in theirs.schema]
    for p, j in zip(mine.columns, theirs.columns):
        assert p.to_pylist() == j.to_pylist()
        assert p.null_count == j.null_count


def test_dtype_predicates_equal_jax():
    for tid in pt.TypeId:
        if tid in (pt.TypeId.LIST, pt.TypeId.STRUCT):
            continue
        dt = pt.DType(tid, -2 if "DECIMAL" in tid.name else 0)
        jdt = JT.DType(JT.TypeId(int(tid)), dt.scale)
        assert (dt.is_timestamp, dt.is_numeric) == (jdt.is_timestamp,
                                                    jdt.is_numeric), tid


@pytest.mark.parametrize("n", [0, 1, 8, 13, 64, 1001])
def test_bits_np_equal_jax(n):
    valid = np.random.default_rng(n).random(n) < 0.5
    packed = bitmask.pack_bits_np(valid)
    np.testing.assert_array_equal(packed, jbitmask.pack_bits_np(valid))
    np.testing.assert_array_equal(bitmask.unpack_bits_np(packed, n), valid)
    np.testing.assert_array_equal(bitmask.unpack_bits_np(packed, n),
                                  jbitmask.unpack_bits_np(packed, n))
    np.testing.assert_array_equal(
        packed, np.asarray(jbitmask.pack_bits(jnp.asarray(valid))))


REEXPORTS = [("exec", "ArtifactStore"), ("exec", "get_store"),
             ("exec", "artifacts"), ("sql", "Query"),
             ("plan", "NodeProfile"), ("plan", "QueryProfile"),
             ("plan", "explain_analyze"), ("models", "q6"),
             ("faultinj", "fault_site"), ("utils", "bitmask"),
             ("utils", "tracing")]


@pytest.mark.parametrize("pkg,name", REEXPORTS)
def test_reexports_import(pkg, name):
    mine = importlib.import_module(f"spark_rapids_jni_tpu_torch.{pkg}")
    theirs = importlib.import_module(f"spark_rapids_jni_tpu.{pkg}")
    assert hasattr(theirs, name)
    assert getattr(mine, name) is not None
