"""The port's ``ops/decimal128.py`` against the JAX package's, bit for bit,
on the CPU.

The same Python ints (numpy-seeded, with nulls, and the extremes of the
128-bit range: 2^127 - 1, -(2^127 - 1), -2^127, -1 and 0) go through
each function of both packages; lanes, validity and types must be equal.
A limb product can pass 2^63 in int64: these cases show that torch wraps
it as JAX does.
"""

import torch_one_thread  # noqa: F401  (first: one intra-op thread)
import numpy as np
import pytest
import torch

import jax.numpy as jnp  # noqa: F401  (JAX on the CPU, set by conftest)
from spark_rapids_jni_tpu import types as JT
from spark_rapids_jni_tpu.ops import decimal128 as jd

import spark_rapids_jni_tpu_torch as pt
from spark_rapids_jni_tpu_torch.ops import decimal128 as pd

from torch_jax_columns import assert_same, to_jax

CPU = "cpu"
EXTREMES = [(1 << 127) - 1, -((1 << 127) - 1), -(1 << 127), -1, 0]
N = 400


def _values(seed: int, nulls: bool) -> list:
    rng = np.random.default_rng(seed)
    vals = list(EXTREMES)
    for bits in (8, 40, 63, 64, 96, 127):
        hi = 1 << bits
        vals += [int(v) * (hi // 2**40 or 1) + int(w) for v, w in zip(
            rng.integers(-2**40, 2**40, N // 6),
            rng.integers(0, 2**40, N // 6))]
    vals = [max(min(v, (1 << 127) - 1), -(1 << 127)) for v in vals]
    if nulls:
        drop = rng.random(len(vals)) < 0.15
        drop[:len(EXTREMES)] = False
        vals = [None if d else v for v, d in zip(vals, drop)]
    return vals


def _pair(values, scale=0):
    p = pd.from_pyints(values, scale, device=CPU)
    return p, jd.from_pyints(values, scale)


@pytest.mark.parametrize("nulls", [False, True])
def test_from_pyints_matches_jax(nulls):
    p, j = _pair(_values(1, nulls), -3)
    assert_same(p, j)
    assert p.to_pylist() == _values(1, nulls)


@pytest.mark.parametrize("op", ["add", "sub", "mul"])
@pytest.mark.parametrize("nulls", [False, True])
def test_binary_ops_match_jax(op, nulls):
    a, ja = _pair(_values(2, nulls), -2)
    vals_b = _values(3, nulls)[::-1]
    b, jb = _pair(vals_b, -2)
    assert_same(getattr(pd, op)(a, b), getattr(jd, op)(ja, jb), what=op)


def test_negate_and_extremes_wrap_like_jax():
    a, ja = _pair(EXTREMES * 3)
    assert_same(pd.negate(a), jd.negate(ja))
    # every pair of extremes through the 4×4 limb product
    xs = [x for x in EXTREMES for _ in EXTREMES]
    ys = [y for _ in EXTREMES for y in EXTREMES]
    p = pd.mul(pd.from_pyints(xs, device=CPU), pd.from_pyints(ys, device=CPU))
    j = jd.mul(jd.from_pyints(xs), jd.from_pyints(ys))
    assert_same(p, j)
    mod = 1 << 128
    want = [((x * y) % mod) - (mod if (x * y) % mod >= mod // 2 else 0)
            for x, y in zip(xs, ys)]
    assert p.to_pylist() == want


@pytest.mark.parametrize("dtype", [np.int64, np.int32, np.int8])
def test_mul_int_matches_jax(dtype):
    a, ja = _pair(_values(4, True), -2)
    rng = np.random.default_rng(5)
    info = np.iinfo(dtype)
    ints = rng.integers(info.min, info.max, len(a), dtype=dtype,
                        endpoint=True)
    ints[:3] = [info.min, info.max, -1]
    b = pt.Column.from_numpy(ints, device=CPU)
    jb = to_jax(b)
    assert_same(pd.mul_int(a, b), jd.mul_int(ja, jb))
    assert_same(pd.mul_int(a, b, -7), jd.mul_int(ja, jb, -7))


@pytest.mark.parametrize("new_scale", [-12, -3, -2, 0, 1, 7, 20])
def test_rescale_matches_jax(new_scale):
    a, ja = _pair(_values(6, True), -2)
    assert_same(pd.rescale(a, new_scale), jd.rescale(ja, new_scale))


def test_rescale_rounds_half_away_from_zero():
    vals = [15, 25, -15, -25, 14, -14, 0]
    a, ja = _pair(vals, -1)
    p = pd.rescale(a, 0)
    assert_same(p, jd.rescale(ja, 0))
    assert p.to_pylist() == [2, 3, -2, -3, 1, -1, 0]


@pytest.mark.parametrize("descending", [False, True])
def test_sort_key_lanes_and_compares_match_jax(descending):
    a, ja = _pair(_values(7, False))
    for got, want in zip(pd.sort_key_lanes(a, descending),
                         jd.sort_key_lanes(ja, descending)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    b, jb = _pair(_values(8, True)[::-1])
    assert_same(pd.less_than(a, b), jd.less_than(ja, jb))
    assert_same(pd.equal_to(a, a), jd.equal_to(ja, ja))
    assert_same(pd.equal_to(a, b), jd.equal_to(ja, jb))


@pytest.mark.parametrize("nulls", [False, True])
def test_sums_match_jax(nulls):
    a, ja = _pair(_values(9, nulls), -4)
    assert_same(pd.sum_(a), jd.sum_(ja))
    seg = np.random.default_rng(10).integers(0, 13, len(a))
    assert_same(pd.segmented_sum(a, torch.from_numpy(seg), 13),
                jd.segmented_sum(ja, jnp.asarray(seg), 13))


@pytest.mark.parametrize("source", ["int32", "int64", "uint64", "decimal32",
                                    "decimal64"])
def test_widen_and_narrow_match_jax(source):
    rng = np.random.default_rng(11)
    dt = {"int32": pt.int32, "int64": pt.int64, "uint64": pt.uint64,
          "decimal32": pt.decimal32(-2), "decimal64": pt.decimal64(-5)}[source]
    info = np.iinfo(dt.storage)
    vals = rng.integers(info.min, info.max, 300, dtype=dt.storage,
                        endpoint=True)
    vals[:2] = [info.min, info.max]
    valid = rng.random(300) > 0.2
    p = pt.Column.from_numpy(vals, dt, valid, device=CPU)
    j = to_jax(p)
    w, jw = pd.widen(p), jd.widen(j)
    assert_same(w, jw)
    assert_same(pd.widen(p, -9), jd.widen(j, -9))
    if dt.is_decimal:
        assert_same(pd.narrow(w, dt), jd.narrow(jw, JT.DType(
            JT.TypeId(int(dt.id)), dt.scale)))


@pytest.mark.parametrize("scale", [0, -2, -38, 5])
def test_to_float64_matches_jax(scale):
    a, ja = _pair(_values(12, True), scale)
    assert_same(pd.to_float64(a), jd.to_float64(ja))
