"""TPC-H Q1 of the port against the JAX package's, on the CPU.

``spark_rapids_jni_tpu_torch.models.tpch_q1.run`` and
``spark_rapids_jni_tpu.models.tpch_q1.run`` read the same lineitem files:
pyarrow's ``benchmarks/tpch_data.generate(n=20_000, seed=9)`` (FLBA
decimals, all dictionary pages, SNAPPY) and the numpy writer's Q1 layout
(``l_extendedprice`` PLAIN FLBA; with and without nulls).  Keys, types,
counts and the unscaled decimal sums must be equal, the means within a
relative 1e-12; ``chip_smoke.py``'s integer oracle must agree with both.
"""

import torch_one_thread  # noqa: F401  (first: one intra-op thread)
import pathlib
import sys

import numpy as np
import pytest

import jax.numpy as jnp  # noqa: F401  (JAX on the CPU, set by conftest)
from benchmarks import tpch_data
from spark_rapids_jni_tpu.models import tpch_q1 as jq1

import spark_rapids_jni_tpu_torch as pt
from spark_rapids_jni_tpu_torch.models import tpch_q1 as pq1

from test_torch_scan import JAX_NATIVE_LOADED
from torch_jax_columns import assert_same

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tools"))
import chip_smoke  # noqa: E402
import torch_lineitem_parquet as W  # noqa: E402

CUTOFF = 10561 - 90
MEANS = (6, 7, 8)
RTOL = 1e-12


@pytest.fixture(scope="module", autouse=True)
def _jax_native_library():
    # the JAX scan loads libsrjt.so; test_torch_scan loads it at import,
    # under its file lock, so that parallel workers do not race its build
    if not JAX_NATIVE_LOADED:
        pytest.fail("the JAX package's native library does not load")


def assert_q1_equal(p, j):
    assert p.num_rows == j.num_rows
    for ci, (pc, jc) in enumerate(zip(p.columns, j.columns)):
        assert_same(pc, jc, RTOL if ci in MEANS else None, what=f"col {ci}")


@pytest.fixture(scope="module")
def tpch():
    """pyarrow's file and the JAX package's Q1 of it (the JAX call's first
    run compiles and builds its native library: once a module)."""
    raw, ints = tpch_data.generate(n=20_000, seed=9)
    return raw, ints, jq1.run(raw, CUTOFF)


def test_q1_matches_jax(tpch):
    raw, _, want = tpch
    got = pq1.run(raw, CUTOFF, device="cpu")
    assert got.num_rows == 3
    assert got.schema == [pt.string, pt.string, pt.int64, pt.decimal64(-2),
                          pt.decimal128(-4), pt.decimal128(-6), pt.float64,
                          pt.float64, pt.float64, pt.int64]
    assert_q1_equal(got, want)


def test_q1_matches_integer_oracle(tpch):
    """The port's Q1 of the tpch_data file against exact integers from the
    generator's arrays (its own oracle, not chip_smoke's: that one reads
    the numpy writer's arrays)."""
    raw, ints, _ = tpch
    got = pq1.run(raw, CUTOFF, device="cpu")
    keep = ints["ship"] <= CUTOFF
    keys = sorted(set(zip(ints["flags"][keep], ints["status"][keep])))
    assert list(zip(got[0].to_pylist(), got[1].to_pylist())) == keys
    for g, (f, s) in enumerate(keys):
        m = keep & (ints["flags"] == f) & (ints["status"] == s)
        price = ints["price_c"][m].astype(object)
        disc, tax = ints["disc_c"][m], ints["tax_c"][m]
        dp = price * (100 - disc)
        assert got[2].to_pylist()[g] == int(ints["qty"][m].sum())
        assert got[3].to_pylist()[g] == int(price.sum())
        assert got[4].to_pylist()[g] == int(dp.sum())
        assert got[5].to_pylist()[g] == int((dp * (100 + tax)).sum())
        assert got[9].to_pylist()[g] == int(m.sum())
        np.testing.assert_allclose(
            got[8].to_numpy()[g], int(disc.sum()) / 100 / int(m.sum()),
            rtol=RTOL)


def test_q1_empty_after_cutoff_matches_jax(tpch):
    raw, _, _ = tpch
    got = pq1.run(raw, -10**6, device="cpu")
    want = jq1.run(raw, -10**6)
    assert got.num_rows == want.num_rows == 0
    assert got[4].data.shape == (0, 2) and got[5].data.shape == (0, 2)
    assert_q1_equal(got, want)


@pytest.mark.parametrize("null_fraction", [0.0, 0.1])
def test_q1_of_numpy_writer_file_matches_jax_and_oracle(null_fraction):
    """The numpy writer's Q1 layout (PLAIN FLBA prices, dictionary FLBA
    discounts and taxes; OPTIONAL with 10% nulls, a null key among the
    groups) through both packages and chip_smoke's integer oracle."""
    raw, data, valid = W.lineitem_parquet(
        12_000, 5, row_group_rows=5000, null_fraction=null_fraction,
        pages_per_chunk=2, columns=W.LINEITEM_Q1)
    got = pq1.run(raw, CUTOFF, device="cpu")
    assert_q1_equal(got, jq1.run(raw, CUTOFF))
    chip_smoke.check_q1(pt.types, got, chip_smoke.q1_oracle(
        W, data, valid, CUTOFF), "numpy writer Q1")
