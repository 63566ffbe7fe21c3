"""The port's parsers, formatters and string transforms against the JAX
package's, on the CPU.

Each case runs the same column, plain or dictionary-encoded and with
nulls, through ``spark_rapids_jni_tpu_torch.ops.strings`` (or ``cast``)
and through the JAX package's; the results must have the same type,
validity and bytes.  The cases are those of ``tests/test_strings.py``
(``test_upper_lower``, ``test_substring``, ``test_concat``,
``TestFormat``, ``TestCastStringEdges``,
``TestFormatUnsignedAndDecimalEdges``) and of ``tests/test_mortgage.py``
(``TestParseKernels``, ``TestParseStrictness``), with the Python values
those tests expect, and seeded ones: negative and pre-1970 days,
INT64_MIN, uint64 values from 2^63 on.
"""

import torch_one_thread  # noqa: F401  (first: one intra-op thread)
import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu.ops import cast as jcast
from spark_rapids_jni_tpu.ops import strings as JS

import spark_rapids_jni_tpu_torch as pt
from spark_rapids_jni_tpu_torch import types as T
from spark_rapids_jni_tpu_torch.ops import cast
from spark_rapids_jni_tpu_torch.ops import strings as S

from torch_jax_columns import assert_same, jdtype, to_jax


def strings(vals, dictionary: bool = False):
    """A port STRING column of ``vals`` (None: null) on the CPU, plain or
    as a DictColumn of its distinct values."""
    if not dictionary:
        return pt.Column.strings_from_list(vals, device="cpu")
    words = sorted({v for v in vals if v is not None})
    codes = torch.tensor([0 if v is None else words.index(v) for v in vals],
                         dtype=torch.int32)
    valid = [v is not None for v in vals]
    return pt.DictColumn(
        codes, pt.Column.strings_from_list(words or [""], device="cpu"),
        None if all(valid) else torch.tensor(valid))


def numbers(vals, dtype, valid=None):
    return pt.Column.from_numpy(np.asarray(vals, dtype.storage), dtype,
                                valid, device="cpu")


def same(fn, jfn, col, *args, expect=None):
    """``fn(col, *args)`` equals ``jfn(to_jax(col), *args)`` (and
    ``expect``, a Python list, where given); returns the port's."""
    got = fn(col, *args)
    assert_same(got, jfn(to_jax(col), *args))
    if expect is not None:
        assert got.to_pylist() == expect
    return got


def same_cast(col, to, expect=None):
    return same(cast, lambda c, t: jcast(c, jdtype(t)), col, to,
                expect=expect)


KINDS = pytest.mark.parametrize("dictionary", [False, True],
                                ids=["plain", "dict"])


# -- case, substrings, concatenation (tests/test_strings.py:203-230) ------

@KINDS
def test_upper_lower(dictionary):
    vals = ["Spark", "TPU", "mixed Case 123", None, ""]
    col = strings(vals, dictionary)
    up = same(S.upper, JS.upper, col,
              expect=[None if v is None else v.upper() for v in vals])
    low = same(S.lower, JS.lower, col,
               expect=[None if v is None else v.lower() for v in vals])
    # a dictionary column transforms its dictionary and keeps its codes
    for out in (up, low):
        assert isinstance(out, pt.DictColumn) == dictionary
        if dictionary:
            assert out.codes is col.codes


@KINDS
@pytest.mark.parametrize("start,length", [(0, 3), (2, None), (1, 1), (5, 4),
                                          (40, None)])
def test_substring(start, length, dictionary):
    vals = ["hello", "ab", "", None, "longer payload"]
    out = same(S.substring, JS.substring, strings(vals, dictionary), start,
               length, expect=[None if v is None else
                               (v[start:] if length is None
                                else v[start:start + length]) for v in vals])
    assert isinstance(out, pt.DictColumn) == dictionary


def test_substring_negative_start_rejected():
    with pytest.raises(ValueError):
        S.substring(strings(["a"]), -1)


@KINDS
def test_concat(dictionary):
    a = strings(["x", "", None, "ab"], dictionary)
    b = strings(["1", "2", "3", None])
    got = S.concat(a, b)
    assert_same(got, JS.concat(to_jax(a), to_jax(b)))
    assert got.to_pylist() == ["x1", "2", None, None]


def test_concat_empty_sides():
    a, b = strings(["", ""]), strings(["", "q"])
    for x, y in ((a, b), (b, a), (a, a)):
        assert_same(S.concat(x, y), JS.concat(to_jax(x), to_jax(y)))


@KINDS
def test_concat_seeded(dictionary):
    rng = np.random.default_rng(4)
    words = ["", "a", "bc", "tpu-native", "Spark ✓", "zz top"]
    va = [None if rng.random() < 0.2 else words[i]
          for i in rng.integers(0, len(words), 300)]
    vb = [None if rng.random() < 0.2 else words[i]
          for i in rng.integers(0, len(words), 300)]
    a, b = strings(va, dictionary), strings(vb)
    got = S.concat(a, b)
    assert_same(got, JS.concat(to_jax(a), to_jax(b)))
    assert got.to_pylist() == [None if x is None or y is None else x + y
                               for x, y in zip(va, vb)]


# -- the parsers (tests/test_mortgage.py:100-172) --------------------------

class TestParseKernels:
    @KINDS
    def test_to_int64_matches_python(self, dictionary):
        vals = ["0", "-1", "123456789012345678", "+42", "", "9x", "--1",
                None, "007"]
        same(S.to_int64, JS.to_int64, strings(vals, dictionary),
             expect=[0, -1, 123456789012345678, 42, None, None, None, None,
                     7])

    @KINDS
    def test_to_decimal_matches_python(self, dictionary):
        vals = ["3.14159", "-2.5", "100", "0.005", "1.", ".25", "1.2.3",
                None, "abc"]
        same(S.to_decimal, JS.to_decimal, strings(vals, dictionary), -3,
             expect=[3142, -2500, 100000, 5, 1000, 250, None, None, None])

    @KINDS
    def test_to_date_roundtrip_numpy(self, dictionary):
        rng = np.random.default_rng(0)
        days = rng.integers(-20000, 40000, 500)
        dates = (np.datetime64("1970-01-01") + days).astype("datetime64[D]")
        iso = [str(d) for d in dates]
        out = same(S.to_date, JS.to_date, strings(iso, dictionary))
        np.testing.assert_array_equal(out.data.numpy(), days)
        mdy = [f"{d.astype(object).month:02d}/{d.astype(object).day:02d}/"
               f"{d.astype(object).year:04d}" for d in dates]
        out2 = same(S.to_date, JS.to_date, strings(mdy, dictionary),
                    "%m/%d/%Y")
        np.testing.assert_array_equal(out2.data.numpy(), days)

    def test_to_date_pre_1970_and_year_zero(self):
        days = np.array([-1, -365, -719162, -719528, -146097, -25567, 0,
                         2932896], np.int64)
        iso = [str(np.datetime64("1970-01-01") + int(d)) for d in days]
        iso[3] = "0000-01-01"          # numpy writes year 0 as 0000
        out = same(S.to_date, JS.to_date, strings(iso))
        np.testing.assert_array_equal(out.data.numpy(), days)

    def test_to_date_unsupported_format(self):
        with pytest.raises(NotImplementedError):
            S.to_date(strings(["2020"]), "%Y")

    @KINDS
    def test_to_bool(self, dictionary):
        vals = ["true", "FALSE", " yes ", "0", "x", None, "T", "nO", "1 ",
                "", "yess", "\tY\n"]
        same(S.to_bool, JS.to_bool, strings(vals, dictionary),
             expect=[True, False, True, False, None, None, True, False,
                     True, None, None, True])


class TestParseStrictness:
    def test_to_int64_overflow_is_null(self):
        vals = ["99999999999999999999", "9223372036854775808",
                "000000000000000000005", "123456789012345678"]
        same(S.to_int64, JS.to_int64, strings(vals),
             expect=[None, None, 5, 123456789012345678])

    def test_to_decimal_overflow_is_null(self):
        same(S.to_decimal, JS.to_decimal,
             strings(["99999999999999999999.5", "1.5"]), -3,
             expect=[None, 1500])

    def test_to_date_rejects_impossible_dates(self):
        vals = ["2021-02-31", "2020-02-29", "2019-02-29", "2021-04-31",
                "2020/01/02", "2020-1x-02", "2020-01-02", "2020-01-022",
                "2020-01-2"]
        same(S.to_date, JS.to_date, strings(vals),
             expect=[None, 18321, None, None, None, None, 18263, None,
                     None])

    def test_to_date_mdy_separators(self):
        same(S.to_date, JS.to_date,
             strings(["02/29/2020", "02-29-2020", "13/01/2020"]),
             "%m/%d/%Y", expect=[18321, None, None])

    def test_whitespace_trimmed_like_spark(self):
        same(S.to_int64, JS.to_int64,
             strings([" 42", "42 ", "  -7  ", " ", "1 2"]),
             expect=[42, 42, -7, None, None])

    def test_to_decimal_positive_scale_rounds(self):
        same(S.to_decimal, JS.to_decimal, strings(["255", "244", "-255"]),
             1, expect=[26, 24, -26])

    def test_all_ascii_whitespace_trimmed(self):
        same(S.to_int64, JS.to_int64,
             strings(["42\n", "\r42", "\t42\x0b", "4\n2"]),
             expect=[42, 42, 42, None])

    @pytest.mark.parametrize("scale", [-4, -2, 0, 2])
    def test_to_decimal_seeded(self, scale):
        rng = np.random.default_rng(8 + scale)
        vals = [f"{x:.{int(rng.integers(0, 7))}f}"
                for x in rng.uniform(-1e6, 1e6, 400)]
        vals += ["", " 1.5 ", "+.5", "-", ".", "5.", "1e3", None]
        same(S.to_decimal, JS.to_decimal, strings(vals), scale)


# -- the formatters (tests/test_strings.py:287-400) ------------------------

class TestFormat:
    def test_format_int64_edges(self):
        vals = [0, 7, -7, 123456, -(2**63), 2**63 - 1, -1, 10**18, None]
        col = numbers([0 if v is None else v for v in vals], T.int64,
                      [v is not None for v in vals])
        same(S.format_int64, JS.format_int64, col,
             expect=[None if v is None else str(v) for v in vals])

    def test_format_int64_random_vs_python(self):
        rng = np.random.default_rng(0)
        v = rng.integers(-10**17, 10**17, 3000)
        same(S.format_int64, JS.format_int64, numbers(v, T.int64),
             expect=[str(x) for x in v.tolist()])

    @pytest.mark.parametrize("dt", ["int8", "int16", "int32", "uint8",
                                    "uint16", "uint32"])
    def test_format_narrow_ints(self, dt):
        info = np.iinfo(dt)
        v = np.array([info.min, info.max, 0, 1, info.max // 3], dt)
        col = numbers(v, T.DType(T.TypeId[dt.upper()]))
        same(S.format_int64, JS.format_int64, col,
             expect=[str(x) for x in v.tolist()])

    def test_format_decimal(self):
        same(S.format_decimal, JS.format_decimal,
             numbers([12345, -5, 0, -12000], T.decimal64(-2)),
             expect=["123.45", "-0.05", "0.00", "-120.00"])
        same(S.format_decimal, JS.format_decimal,
             numbers([45], T.decimal32(2)), expect=["4500"])

    def test_cast_string_roundtrip(self):
        parsed = same_cast(strings(["12345", "-7", None, "junk"]), T.int64,
                           expect=[12345, -7, None, None])
        same_cast(parsed, T.string, expect=["12345", "-7", None, None])
        dec = same_cast(strings(["1.25", "-3.5"]), T.decimal64(-2))
        same_cast(dec, T.string, expect=["1.25", "-3.50"])

    def test_cast_string_to_int32(self):
        out = same_cast(strings(["42", "-1"]), T.int32, expect=[42, -1])
        assert out.dtype == T.int32

    def test_cast_string_to_date(self):
        same_cast(strings(["1970-01-02", "bad"]), T.timestamp_days,
                  expect=[1, None])


class TestCastStringEdges:
    @KINDS
    def test_bool_roundtrip(self, dictionary):
        c = strings(["true", "FALSE", " yes ", "0", "x", None], dictionary)
        b = same_cast(c, T.bool8,
                      expect=[True, False, True, False, None, None])
        same_cast(b, T.string,
                  expect=["true", "false", "true", "false", None, None])

    def test_date_roundtrip(self):
        days = np.asarray([0, 18321, -1, 2932896], np.int32)
        s = same_cast(numbers(days, T.timestamp_days), T.string,
                      expect=["1970-01-01", "2020-02-29", "1969-12-31",
                              "9999-12-31"])
        back = same_cast(s, T.timestamp_days)
        np.testing.assert_array_equal(back.data.numpy(), days)

    def test_string_to_narrow_int_overflow_null(self):
        same_cast(strings(["300", "42", "-129", "127"]), T.int8,
                  expect=[None, 42, None, 127])

    def test_string_to_decimal32_overflow_null(self):
        same_cast(strings(["9999999999", "12.5"]), T.decimal32(-1),
                  expect=[None, 125])

    def test_timestamp_us_to_string_rejected(self):
        c = numbers([0], T.timestamp_us)
        with pytest.raises(NotImplementedError):
            cast(c, T.string)
        with pytest.raises(NotImplementedError):
            cast(strings(["1"]), T.timestamp_us)


class TestFormatUnsignedAndDecimalEdges:
    def test_uint64_above_2_63(self):
        same_cast(numbers([2**63, 2**64 - 1, 0], T.uint64), T.string,
                  expect=["9223372036854775808", "18446744073709551615",
                          "0"])

    def test_string_to_uint64(self):
        same_cast(strings(["5", "-1", "42"]), T.uint64, expect=[5, None, 42])

    def test_decimal_int64_min(self):
        same(S.format_decimal, JS.format_decimal,
             numbers([-(2**63)], T.decimal64(-2)),
             expect=["-92233720368547758.08"])

    def test_decimal_positive_scale_no_wrap(self):
        same(S.format_decimal, JS.format_decimal,
             numbers([10**18, -3], T.decimal64(2)),
             expect=[str(10**20), "-300"])

    def test_decimal_positive_scale_zero(self):
        same(S.format_decimal, JS.format_decimal,
             numbers([0, 3], T.decimal64(2)), expect=["0", "300"])


# -- seeded edges: INT64_MIN, uint64 from 2^63, negative days ---------------

def test_format_int64_seeded_extremes():
    rng = np.random.default_rng(6)
    v = np.concatenate([rng.integers(-2**63, 2**63 - 1, 2000,
                                     dtype=np.int64, endpoint=True),
                        [-(2**63), -(2**63) + 1, 2**63 - 1, 0, -1]])
    valid = rng.random(v.shape[0]) >= 0.1
    same(S.format_int64, JS.format_int64, numbers(v, T.int64, valid),
         expect=[str(x) if ok else None for x, ok in zip(v.tolist(), valid)])


def test_format_uint64_seeded_above_2_63():
    rng = np.random.default_rng(7)
    v = np.concatenate([rng.integers(2**63, 2**64 - 1, 1000, dtype=np.uint64,
                                     endpoint=True),
                        rng.integers(0, 2**63, 1000, dtype=np.uint64),
                        np.array([2**63, 2**64 - 1, 10**19, 10**19 - 1, 0],
                                 np.uint64)])
    same(S.format_int64, JS.format_int64, numbers(v, T.uint64),
         expect=[str(x) for x in v.tolist()])


@pytest.mark.parametrize("scale", [-1, -2, -4, -9, -18, 1, 3])
def test_format_decimal_seeded(scale):
    rng = np.random.default_rng(30 - scale)
    v = np.concatenate([rng.integers(-2**63, 2**63 - 1, 1000, dtype=np.int64,
                                     endpoint=True),
                        rng.integers(-10**6, 10**6, 1000),
                        [-(2**63), 2**63 - 1, 0, -1, 1]])
    valid = rng.random(v.shape[0]) >= 0.1
    got = same(S.format_decimal, JS.format_decimal,
               numbers(v, T.decimal64(scale), valid))
    for x, ok, s in zip(v.tolist(), valid, got.to_pylist()):
        if not ok:
            assert s is None
        elif scale > 0:
            assert s == (str(x) + "0" * scale if x else "0")
        else:
            k = -scale
            mag = abs(x)
            want = f"{mag // 10 ** k}.{mag % 10 ** k:0{k}d}"
            assert s == ("-" + want if x < 0 else want)


def test_format_date_negative_and_pre_1970_days():
    rng = np.random.default_rng(9)
    days = np.concatenate([rng.integers(-719528, 2932897, 3000),
                           [-719528, -719529, 2932896, 2932897, -1, 0,
                            -25567, -146097, -10**6]]).astype(np.int32)
    valid = rng.random(days.shape[0]) >= 0.1
    got = same(S.format_date, JS.format_date,
               numbers(days, T.timestamp_days, valid))
    for d, ok, s in zip(days.tolist(), valid, got.to_pylist()):
        in_range = -719528 <= d <= 2932896          # 0000-01-01..9999-12-31
        if not ok or not in_range:
            assert s is None
        else:
            want = str(np.datetime64("1970-01-01") + d)
            assert s == (want if d != -719528 else "0000-01-01")
    # and back: a date's text parses to its day
    back = same(S.to_date, JS.to_date, got)
    ok = got.validity_or_true().numpy()
    np.testing.assert_array_equal(back.data.numpy()[ok], days[ok])


def test_format_bool():
    col = numbers([1, 0, 1, 2], T.bool8, [True, True, False, True])
    same(S.format_bool, JS.format_bool, col,
         expect=["true", "false", None, "true"])


def test_empty_columns():
    for fn, jfn in ((S.format_int64, JS.format_int64),
                    (S.format_bool, JS.format_bool)):
        dt = T.int64 if fn is S.format_int64 else T.bool8
        same(fn, jfn, numbers([], dt), expect=[])
    same(S.to_int64, JS.to_int64, strings([]), expect=[])
    same(S.to_date, JS.to_date, strings([]), expect=[])
    same(S.upper, JS.upper, strings([]), expect=[])
    same(S.substring, JS.substring, strings(["", None]), 1,
         expect=["", None])
