"""The port's ``ops.cast`` against the JAX package's, on the CPU: every
branch, with the cases of ``tests/test_ops.py`` (the numeric, bool and
decimal casts) and ``TestCasts`` of ``tests/test_decimal128.py`` (into
and out of DECIMAL128), each on the same column through both packages
and against the values those tests expect.  The STRING branches are
held in ``tests/test_torch_strings.py``; here each is reached once."""

import torch_one_thread  # noqa: F401  (first: one intra-op thread)
import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu.ops import cast as jcast

import spark_rapids_jni_tpu_torch as pt
from spark_rapids_jni_tpu_torch import types as T
from spark_rapids_jni_tpu_torch.ops import cast
from spark_rapids_jni_tpu_torch.ops import decimal128 as d128

from torch_jax_columns import assert_same, jdtype, payload, to_jax


def col(vals, dtype, valid=None):
    return pt.Column.from_numpy(np.asarray(vals, dtype.storage), dtype,
                                valid, device="cpu")


def same_cast(c, to, expect=None, rtol=None):
    got = cast(c, to)
    assert_same(got, jcast(to_jax(c), jdtype(to)), rtol)
    if expect is not None:
        assert got.to_pylist() == expect
    return got


# -- tests/test_ops.py:21-50 ------------------------------------------------

def test_cast_numeric_widening_and_narrowing():
    c = col([1, -2, 300], T.int32)
    same_cast(c, T.int64, [1, -2, 300])
    assert same_cast(c, T.float32).data.dtype == torch.float32
    same_cast(c, T.int8, [1, -2, 44])                 # 300 wraps


def test_cast_bool():
    c = col([0, 3, -1], T.int32)
    b = same_cast(c, T.bool8, [False, True, True])
    same_cast(b, T.int64, [0, 1, 1])


def test_cast_decimal_rescale_round_half_away():
    c = col([1234, -1234, 1250, -1250, 1249], T.decimal64(-3))
    same_cast(c, T.decimal64(-2), [123, -123, 125, -125, 125])


def test_cast_decimal_to_float_and_back():
    c = col([12345, -500], T.decimal64(-2))
    f = same_cast(c, T.float64)
    np.testing.assert_allclose(f.data.numpy(), [123.45, -5.0])
    same_cast(f, T.decimal64(-2), [12345, -500])


# -- every other branch -------------------------------------------------------

VALID = [True, False, True, True, True]


@pytest.mark.parametrize("src,dst", [
    (T.int64, T.int32), (T.int32, T.int16), (T.int16, T.uint8),
    (T.uint8, T.int64), (T.int64, T.float64), (T.float64, T.int32),
    (T.float32, T.float64), (T.int32, T.timestamp_days),
    (T.timestamp_days, T.int64), (T.float64, T.bool8), (T.bool8, T.float64),
    (T.bool8, T.int16)])
def test_cast_plain_types(src, dst):
    vals = {"f": [1.5, -2.25, 0.0, 3e3, -7.75], "u": [0, 1, 200, 7, 255]}.get(
        src.storage.kind, [1, -2, 300, 0, 70000])
    if src.id == T.TypeId.BOOL8:
        vals = [1, 0, 1, 0, 1]
    info = None if src.storage.kind == "f" else np.iinfo(src.storage)
    if info is not None:
        vals = [min(max(v, int(info.min)), int(info.max)) for v in vals]
    same_cast(col(vals, src, VALID), dst)


@pytest.mark.parametrize("scale_from,scale_to", [(-3, -1), (-1, -3), (0, -2),
                                                 (-2, 0), (2, -1), (-4, 2)])
@pytest.mark.parametrize("storage", ["decimal32", "decimal64"])
def test_cast_decimal_rescale(storage, scale_from, scale_to):
    make = getattr(T, storage)
    rng = np.random.default_rng(100 + scale_from * 7 + scale_to)
    v = rng.integers(-10**6, 10**6, 200)
    v[:6] = [0, 5, -5, 15, -15, 149]
    same_cast(col(v, make(scale_from), rng.random(200) >= 0.1),
              make(scale_to))
    same_cast(col(v, make(scale_from)), T.decimal64(scale_to))


@pytest.mark.parametrize("to", [T.int64, T.int32, T.float64])
def test_cast_decimal_to_number(to):
    c = col([12345, -12355, 50, -50, 0], T.decimal64(-2), VALID)
    same_cast(c, to)


def test_cast_decimal_to_float32():
    """The JAX package keeps float64 values in a FLOAT32 column here; the
    port stores float32, so the values compare rounded to float32."""
    c = col([12345, -12355, 50, -50, 0], T.decimal64(-2), VALID)
    got = cast(c, T.float32)
    want = payload(jcast(to_jax(c), jdtype(T.float32)))
    assert got.data.dtype == torch.float32
    np.testing.assert_array_equal(got.data.numpy(), want.astype(np.float32))


@pytest.mark.parametrize("src", [T.int64, T.int32, T.float64, T.bool8])
@pytest.mark.parametrize("scale", [-2, 0, 1])
def test_cast_number_to_decimal(src, scale):
    vals = ([1.25, -3.5, 0.005, 1e6, -2.675] if src == T.float64
            else [1, 0, 1, 1, 0] if src == T.bool8
            else [125, -35, 0, 10**6, -2675])
    same_cast(col(vals, src, VALID), T.decimal64(scale))
    same_cast(col(vals, src), T.decimal32(scale))


def test_cast_same_type_is_identity():
    c = col([1, 2], T.int64)
    assert cast(c, T.int64) is c


def test_cast_string_branches():
    s = pt.Column.strings_from_list(["12", "-3", None, "x"], device="cpu")
    for to in (T.int64, T.int16, T.uint32, T.uint64, T.decimal64(-1),
               T.decimal32(0), T.bool8, T.timestamp_days):
        same_cast(s, to)
    for src in (col([1, -2], T.int64), col([5, 6], T.uint16),
                col([1234, -5], T.decimal32(-3)), col([0, 1], T.bool8),
                col([0, -1], T.timestamp_days)):
        same_cast(src, T.string)


@pytest.mark.parametrize("src,to", [
    (T.float64, T.string), (T.string, T.float64), (T.timestamp_ms, T.string),
    (T.string, T.DType(T.TypeId.DURATION_DAYS)),
    (T.decimal128(0), T.string), (T.string, T.decimal128(0)),
    (T.decimal128(0), T.timestamp_days)])
def test_cast_unsupported_raises(src, to):
    if src == T.string:
        c = pt.Column.strings_from_list(["1"], device="cpu")
    elif src.id == T.TypeId.DECIMAL128:
        c = d128.from_pyints([1], device="cpu")
    else:
        c = col([1], src)
    with pytest.raises(NotImplementedError):
        cast(c, to)


# -- TestCasts of tests/test_decimal128.py:146-190 --------------------------

class TestCasts:
    def test_widen_int64(self):
        vals = [0, 1, -1, 2**62, -(2**62), None]
        c = col([0 if v is None else v for v in vals], T.int64,
                [v is not None for v in vals])
        same_cast(c, T.decimal128(0), vals)

    def test_widen_decimal64_rescale(self):
        same_cast(col([123, -45], T.decimal64(-2)), T.decimal128(-4),
                  [12300, -4500])

    def test_narrow_back(self):
        out = same_cast(d128.from_pyints([123456, -789], scale=-2,
                                         device="cpu"),
                        T.decimal64(-2), [123456, -789])
        assert out.dtype == T.decimal64(-2)

    def test_to_float64(self):
        c = d128.from_pyints([12345, -67890, 2**70], scale=-2, device="cpu")
        got = same_cast(c, T.float64)
        np.testing.assert_allclose(
            got.data.numpy(), [123.45, -678.90, float(2**70) * 1e-2],
            rtol=1e-12)

    def test_float_to_decimal128(self):
        same_cast(col([1.25, -3.5], T.float64), T.decimal128(-2),
                  [125, -350])

    def test_float_to_decimal128_large(self):
        same_cast(col([1e20, -1e24, 1e30], T.float64), T.decimal128(0),
                  [int(np.float64(1e20)), -int(np.float64(1e24)),
                   int(np.float64(1e30))])

    def test_uint64_above_2_63_widens_unsigned(self):
        same_cast(col([2**63, 2**64 - 1], T.uint64), T.decimal128(0),
                  [2**63, 2**64 - 1])

    def test_narrow_scale_reduction(self):
        same_cast(d128.from_pyints([12345, -12355], scale=-2, device="cpu"),
                  T.decimal64(0), [123, -124])

    @pytest.mark.parametrize("to", [T.decimal128(-1), T.decimal128(-5),
                                    T.int64, T.int32])
    def test_decimal128_rescale_and_narrow(self, to):
        c = d128.from_pyints([12345, -12355, None, 0, 2**40], scale=-3,
                             device="cpu")
        same_cast(c, to)

    @pytest.mark.parametrize("src", [T.int32, T.bool8, T.decimal32(-2)])
    def test_widen_others(self, src):
        same_cast(col([1, 0, 1], src, [True, False, True]), T.decimal128(-1))
