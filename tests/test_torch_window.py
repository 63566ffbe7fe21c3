"""The port's scans and window functions against the JAX package's, on
the CPU.

``ops/scan.py`` and ``ops/window.py`` of ``spark_rapids_jni_tpu_torch``
take the same numpy-seeded columns as their JAX counterparts, nulls
among them: the cases of ``tests/test_copying_scan.py::TestScan`` and
``tests/test_window.py``, every type the JAX package scans, and
partition keys of every kind (null, FLOAT64 with -0.0 and NaN, STRING,
dictionary, DECIMAL128, several columns).  Integer, decimal, rank and
count results and lag/lead payloads must be equal (FLOAT64 lag/lead as
bits); float running sums and extremes within a relative 1e-12, NaN
where the JAX package has NaN (the two sum in other orders, and torch's
``maximum`` keeps the first of -0.0 and 0.0 where XLA's keeps 0.0).
"""

import torch_one_thread  # noqa: F401  (first: one intra-op thread)
import numpy as np
import pandas as pd
import pytest

from spark_rapids_jni_tpu.ops import scan as jscan
from spark_rapids_jni_tpu.ops import window as jwindow

import spark_rapids_jni_tpu_torch as pt
from spark_rapids_jni_tpu_torch.ops import scan, window as W
from spark_rapids_jni_tpu_torch.ops import decimal128 as d128

from test_torch_ops import make_column
from torch_jax_columns import assert_same, to_jax

CPU = "cpu"
N = 500
RTOL = 1e-12

# every type the JAX package scans: (dtype, values)
SCAN_KINDS = {
    "int8": (pt.int8, lambda r, n: r.integers(-9, 9, n)),
    "int16": (pt.int16, lambda r, n: r.integers(-900, 900, n)),
    "int32": (pt.int32, lambda r, n: r.integers(-2**30, 2**30, n)),
    "int64": (pt.int64, lambda r, n: r.integers(-2**40, 2**40, n)),
    "uint8": (pt.uint8, lambda r, n: r.integers(0, 256, n)),
    "uint16": (pt.uint16, lambda r, n: r.integers(0, 2**16, n)),
    "uint32": (pt.uint32, lambda r, n: r.integers(0, 2**32, n)),
    "uint64": (pt.uint64, lambda r, n: r.integers(0, 2**40, n)),
    "bool8": (pt.bool8, lambda r, n: r.integers(0, 2, n)),
    "float32": (pt.float32, lambda r, n: r.integers(-99, 99, n) / 4),
    "float64": (pt.float64, lambda r, n: r.integers(-99, 99, n) / 8),
    "float64_nan": (pt.float64, lambda r, n: r.choice(
        np.array([-0.0, 0.0, 1.5, -2.5, np.nan, np.inf]), n)),
    "decimal32": (pt.decimal32(-2),
                  lambda r, n: r.integers(-10**6, 10**6, n)),
    "decimal64": (pt.decimal64(-3),
                  lambda r, n: r.integers(-10**9, 10**9, n)),
    "timestamp_days": (pt.timestamp_days,
                       lambda r, n: r.integers(0, 20000, n)),
}


def _scan_column(kind, seed, nulls):
    rng = np.random.default_rng(seed)
    dt, draw = SCAN_KINDS[kind]
    valid = (rng.random(N) >= 0.2) if nulls else None
    return pt.Column.from_numpy(draw(rng, N), dt, valid, device=CPU)


def _same(got, want, floats_to_rtol=True):
    """Equal, or floats within RTOL (NaN matching NaN, -0.0 matching
    0.0) where ``floats_to_rtol``."""
    rtol = RTOL if floats_to_rtol and got.dtype.storage.kind == "f" else None
    assert_same(got, want, rtol)


# -- scans ---------------------------------------------------------------


@pytest.mark.parametrize("nulls", [False, True], ids=["valid", "nulls"])
@pytest.mark.parametrize("kind", list(SCAN_KINDS))
def test_scans_match_jax(kind, nulls):
    col = _scan_column(kind, len(kind), nulls)
    jcol = to_jax(col)
    for name in ("cumulative_sum", "cumulative_min", "cumulative_max",
                 "cumulative_count"):
        got = getattr(scan, name)(col)
        want = getattr(jscan, name)(jcol)
        _same(got, want)


def test_cumsum_matches_pandas():
    rng = np.random.default_rng(7)
    vals = rng.integers(-50, 50, 100).astype(np.int32)
    valid = rng.random(100) < 0.8
    got = scan.cumulative_sum(pt.Column.from_numpy(vals, validity=valid,
                                                   device=CPU))
    want = pd.Series(np.where(valid, vals, np.nan)).fillna(0).cumsum()
    np.testing.assert_array_equal(got.data.numpy(),
                                  want.to_numpy().astype(np.int64))
    # null rows stay null (cudf's EXCLUDE policy)
    assert got.to_pylist() == [int(w) if v else None
                               for w, v in zip(want, valid)]


def test_cumsum_decimal32_widens_and_float32_sums_in_float64():
    vals = np.full(1100, 2_000_000, np.int32)
    out = scan.cumulative_sum(pt.Column.from_numpy(vals, pt.decimal32(-2),
                                                   device=CPU))
    assert out.dtype == pt.decimal64(-2)
    assert int(out.data[-1]) == int(vals.astype(np.int64).sum())
    f = scan.cumulative_sum(pt.Column.from_numpy(
        np.asarray([1.5, 2.5, -1.0], np.float32), device=CPU))
    assert f.dtype == pt.float64
    assert f.data.tolist() == [1.5, 4.0, 3.0]


def test_cumcount_and_empty_scans():
    col = pt.Column.from_numpy(np.arange(5, dtype=np.int32),
                               validity=np.asarray([1, 0, 1, 1, 0], bool),
                               device=CPU)
    assert scan.cumulative_count(col).data.tolist() == [1, 1, 2, 3, 3]
    empty = pt.Column.from_numpy(np.zeros(0, np.int64), device=CPU)
    for name in ("cumulative_sum", "cumulative_min", "cumulative_max",
                 "cumulative_count"):
        assert getattr(scan, name)(empty).num_rows == 0


@pytest.mark.parametrize("kind", ["string", "decimal128"])
def test_scans_reject_what_jax_rejects(kind):
    col = make_column(kind, np.random.default_rng(1), 10)
    with pytest.raises(TypeError):
        scan.cumulative_sum(col)
    with pytest.raises(TypeError):
        jscan.cumulative_sum(to_jax(col))


# -- windows -------------------------------------------------------------

# partition keys: the kinds of make_column, and several columns
PARTITION_CASES = {
    "int": ["int"], "int_valid": ["int_valid"], "float": ["float"],
    "string": ["string"], "dict": ["dict"], "decimal128": ["decimal128"],
    "multi": ["string", "int"],
}
# value columns every window function runs over
VALUE_KINDS = ["int64", "float64", "decimal64", "int8"]


def _window_table(part_kinds, seed, n=N):
    """[partition keys..., an int64 order key with nulls and ties, a
    float order key, value columns...]."""
    rng = np.random.default_rng(seed)
    cols = []
    for k in part_kinds:
        if k == "int_valid":
            cols.append(make_column("int", rng, n, nulls=False))
        else:
            cols.append(make_column(k, rng, n))
    okey = pt.Column.from_numpy(rng.integers(0, 40, n), validity=(
        rng.random(n) >= 0.1), device=CPU)
    fkey = make_column("float", rng, n)
    vals = []
    for kind in VALUE_KINDS:
        dt, draw = SCAN_KINDS[kind]
        vals.append(pt.Column.from_numpy(draw(rng, n), dt,
                                         rng.random(n) >= 0.2, device=CPU))
    return pt.Table(cols + [okey, fkey] + vals)


@pytest.mark.parametrize("descending", [False, True], ids=["asc", "desc"])
@pytest.mark.parametrize("case", list(PARTITION_CASES))
def test_window_functions_match_jax(case, descending):
    kinds = PARTITION_CASES[case]
    t = _window_table(kinds, len(case) + 3 * descending)
    jt = to_jax(t)
    np_ = len(kinds)
    parts, orders = list(range(np_)), [np_, np_ + 1]
    asc = [not descending, True]
    spec = W.WindowSpec(t, parts, orders, asc)
    jspec = jwindow.WindowSpec(jt, parts, orders, asc)
    assert_same(W.row_number(spec), jwindow.row_number(jspec))
    for keys in ([np_], [np_, np_ + 1], [np_ + 1]):
        assert_same(W.rank(spec, keys), jwindow.rank(jspec, keys))
        assert_same(W.dense_rank(spec, keys), jwindow.dense_rank(jspec,
                                                                 keys))
    for vi in range(np_ + 2, t.num_columns):
        for off in (1, 2, 7):
            assert_same(W.lag(spec, vi, off), jwindow.lag(jspec, vi, off))
            assert_same(W.lead(spec, vi, off), jwindow.lead(jspec, vi, off))
        assert_same(W.running_count(spec, vi),
                    jwindow.running_count(jspec, vi))
        for name in ("running_sum", "running_max", "running_min"):
            _same(getattr(W, name)(spec, vi), getattr(jwindow, name)(jspec,
                                                                    vi))


def test_float_partition_keys_follow_spark_equality():
    """-0.0 and 0.0 are one partition, every NaN one more; within a
    partition the rows keep the sort's order, -0.0 before 0.0."""
    part = pt.Column.from_numpy(
        np.array([0.0, -0.0, np.nan, -np.nan, 0.0, 2.0]), device=CPU)
    okey = pt.Column.from_numpy(np.arange(6), device=CPU)
    t = pt.Table([part, okey])
    spec = W.WindowSpec(t, [0], [1])
    assert W.row_number(spec).data.tolist() == [2, 1, 1, 2, 3, 1]
    assert_same(W.row_number(spec),
                jwindow.row_number(jwindow.WindowSpec(to_jax(t), [0], [1])))


def _pandas_data(n=400, parts=7, seed=0):
    rng = np.random.default_rng(seed)
    part = rng.integers(0, parts, n).astype(np.int32)
    okey = rng.integers(0, 50, n).astype(np.int64)
    vals = rng.integers(-100, 100, n).astype(np.int64)
    valid = rng.random(n) < 0.85
    t = pt.Table([pt.Column.from_numpy(part, device=CPU),
                  pt.Column.from_numpy(okey, device=CPU),
                  pt.Column.from_numpy(vals, validity=valid, device=CPU)])
    df = pd.DataFrame({"p": part, "o": okey,
                       "v": np.where(valid, vals, np.nan)})
    return t, df


def test_windows_match_pandas():
    t, df = _pandas_data()
    spec = W.WindowSpec(t, [0], [1])
    srt = df.sort_values(["p", "o"], kind="stable")
    rn = (srt.groupby("p").cumcount() + 1).sort_index()
    np.testing.assert_array_equal(W.row_number(spec).data.numpy(), rn)
    np.testing.assert_array_equal(
        W.rank(spec, [1]).data.numpy(),
        df.groupby("p")["o"].rank(method="min").to_numpy().astype(np.int64))
    np.testing.assert_array_equal(
        W.dense_rank(spec, [1]).data.numpy(),
        df.groupby("p")["o"].rank(method="dense").to_numpy().astype(np.int64))
    rs = srt.groupby("p")["v"].transform(lambda s: s.fillna(0).cumsum())
    rc = srt.groupby("p")["v"].transform(lambda s: s.notna().cumsum())
    np.testing.assert_array_equal(W.running_sum(spec, 2).data.numpy(),
                                  rs.sort_index().to_numpy().astype(np.int64))
    np.testing.assert_array_equal(W.running_count(spec, 2).data.numpy(),
                                  rc.sort_index().to_numpy())
    valid = t[2].validity.numpy()
    for name, fn in (("running_max", "cummax"), ("running_min", "cummin")):
        want = getattr(srt.groupby("p")["v"], fn)().sort_index().to_numpy()
        got = getattr(W, name)(spec, 2).data.numpy().astype(float)
        np.testing.assert_array_equal(got[valid], want[valid])


def test_lag_lead_over_string_partitions():
    part = pt.Column.strings_from_list(["a", "b", "a", "b", "a"], device=CPU)
    okey = pt.Column.from_numpy(np.asarray([1, 1, 2, 2, 3]), device=CPU)
    vals = pt.Column.from_numpy(np.asarray([10, 20, 30, 40, 50]), device=CPU)
    spec = W.WindowSpec(pt.Table([part, okey, vals]), [0], [1])
    assert W.lag(spec, 2).to_pylist() == [None, None, 10, 20, 30]
    assert W.lead(spec, 2).to_pylist() == [30, 40, 50, None, None]
    assert W.lag(spec, 2, offset=2).to_pylist() == [None, None, None, None,
                                                    10]


def test_lag_of_a_null_value_is_null_and_descending_order():
    part = pt.Column.from_numpy(np.zeros(3, np.int32), device=CPU)
    okey = pt.Column.from_numpy(np.arange(3, dtype=np.int64), device=CPU)
    vals = pt.Column.from_numpy(np.asarray([1, 0, 3]),
                                validity=np.asarray([True, False, True]),
                                device=CPU)
    spec = W.WindowSpec(pt.Table([part, okey, vals]), [0], [1])
    assert W.lag(spec, 2).to_pylist() == [None, 1, None]
    down = W.WindowSpec(pt.Table([part, okey, vals]), [0], [1],
                        ascending=[False])
    assert W.row_number(down).data.tolist() == [3, 2, 1]


def test_null_keys_rank_apart_tie_and_partition_together():
    zeros = pt.Column.from_numpy(np.zeros(2, np.int32), device=CPU)
    # a NULL order key and a valid one with the same payload rank apart
    ok = pt.Column.from_numpy(np.zeros(2, np.int64),
                              validity=np.asarray([False, True]), device=CPU)
    spec = W.WindowSpec(pt.Table([zeros, ok]), [0], [1])
    assert W.rank(spec, [1]).data.tolist() == [1, 2]
    assert W.dense_rank(spec, [1]).data.tolist() == [1, 2]
    # NULL order keys tie whatever their payloads
    ok = pt.Column.from_numpy(np.asarray([3, 9]),
                              validity=np.asarray([False, False]), device=CPU)
    spec = W.WindowSpec(pt.Table([zeros, ok]), [0], [1])
    assert W.rank(spec, [1]).data.tolist() == [1, 1]
    assert W.dense_rank(spec, [1]).data.tolist() == [1, 1]
    # NULL partition keys with different payloads: one partition
    part = pt.Column.from_numpy(np.asarray([5, 7], np.int32),
                                validity=np.asarray([False, False]),
                                device=CPU)
    okey = pt.Column.from_numpy(np.asarray([1, 2]), device=CPU)
    spec = W.WindowSpec(pt.Table([part, okey]), [0], [1])
    assert W.row_number(spec).data.tolist() == [1, 2]


def test_window_scans_reject_decimal128_and_strings():
    t = pt.Table([pt.Column.from_numpy(np.zeros(2, np.int32), device=CPU),
                  pt.Column.from_numpy(np.arange(2), device=CPU),
                  d128.from_pyints([1, 2], device=CPU),
                  pt.Column.strings_from_list(["a", "b"], device=CPU)])
    spec = W.WindowSpec(t, [0], [1])
    for fn in (W.running_sum, W.running_max, W.running_min):
        with pytest.raises(TypeError, match="DECIMAL128"):
            fn(spec, 2)
    with pytest.raises(TypeError, match="STRING"):
        W.lag(spec, 3)


def test_empty_window():
    t = pt.Table([pt.Column.from_numpy(np.zeros(0, np.int32), device=CPU),
                  pt.Column.from_numpy(np.zeros(0, np.int64), device=CPU)])
    spec = W.WindowSpec(t, [0], [1])
    for out in (W.row_number(spec), W.rank(spec, [1]),
                W.dense_rank(spec, [1]), W.lag(spec, 1),
                W.running_sum(spec, 1), W.running_max(spec, 1),
                W.running_count(spec, 1)):
        assert out.num_rows == 0


def test_running_extremes_cross_many_doubling_steps():
    """Partitions of every length up to thousands of rows: the doubling
    scan's steps each stay inside a partition."""
    rng = np.random.default_rng(11)
    n = 5000
    part = np.repeat(np.arange(40), rng.multinomial(n - 40, [1 / 40] * 40)
                     + 1).astype(np.int32)
    vals = rng.integers(-10**6, 10**6, n)
    t = pt.Table([pt.Column.from_numpy(part, device=CPU),
                  pt.Column.from_numpy(np.arange(n), device=CPU),
                  pt.Column.from_numpy(vals, validity=rng.random(n) > 0.3,
                                       device=CPU)])
    spec = W.WindowSpec(t, [0], [1])
    jspec = jwindow.WindowSpec(to_jax(t), [0], [1])
    assert_same(W.running_max(spec, 2), jwindow.running_max(jspec, 2))
    assert_same(W.running_min(spec, 2), jwindow.running_min(jspec, 2))
    assert_same(W.running_count(spec, 2), jwindow.running_count(jspec, 2))
