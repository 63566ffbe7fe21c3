"""Arrow interchange of the port (``utils/arrow.py``) against the JAX
package's, on the CPU.

Mirrors ``tests/test_arrow.py``: fixed-width types, strings, decimals of
every width (38 digits included), dates and timestamps, nulls, chunked
arrays, tables with duplicate names, unsupported types.  For each, the
port's ``from_arrow`` gives the JAX package's column (type, validity,
payload) and its ``to_arrow`` the JAX package's pyarrow array, exactly;
and the pyarrow-free buffer level (``to_arrow_buffers`` /
``from_arrow_buffers``, what runs on the card, where there is no
pyarrow) round-trips a table byte for byte, sliced arrays included.
"""

import torch_one_thread  # noqa: F401  (first: one intra-op thread)
import decimal

import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_jni_tpu.utils import arrow as JA

from spark_rapids_jni_tpu_torch import types as T
from spark_rapids_jni_tpu_torch.column import Column, Table
from spark_rapids_jni_tpu_torch.utils import arrow as A

from torch_jax_columns import assert_same

CPU = "cpu"
D = decimal.Decimal

ARRAYS = {
    "int32": pa.array([1, None, -3], pa.int32()),
    "int64": pa.array([2**40, 0, None], pa.int64()),
    "int64_big": pa.array([2**62 + 1, None], pa.int64()),
    "float64": pa.array([1.5, None, -2.25], pa.float64()),
    "float32": pa.array([1.5, -0.0, None], pa.float32()),
    "uint8": pa.array([0, 255, None], pa.uint8()),
    "int16": pa.array([-7, 300, None], pa.int16()),
    "bool": pa.array([True, None, False], pa.bool_()),
    "date32": pa.array([0, 18321, None], pa.date32()),
    "ts_us": pa.array([0, 10**15, None], pa.timestamp("us")),
    "ts_s": pa.array([3, None, -4], pa.timestamp("s")),
    "string": pa.array(["a", None, "bcd", ""]),
    "dec7": pa.array([D("1.25"), None, D("-3.50")], pa.decimal128(7, 2)),
    "dec15": pa.array([D("1234567890.12345"), None], pa.decimal128(15, 5)),
    "dec30": pa.array([D("123456789012345678901.55"), None],
                      pa.decimal128(30, 2)),
    "dec38": pa.array([D("123456789012345678901234567890.12"), None,
                       D("-99999999999999999999999999999999.99")],
                      pa.decimal128(38, 2)),
}


@pytest.mark.parametrize("name", list(ARRAYS))
def test_from_and_to_arrow_equal_jax(name):
    arr = ARRAYS[name]
    col = A.from_arrow(arr, device=CPU)
    jcol = JA.from_arrow(arr)
    assert_same(col, jcol, what=name)
    back = A.to_arrow(col)
    assert back.equals(JA.to_arrow(jcol)), name
    assert back.to_pylist() == arr.to_pylist()


def test_chunked_and_sliced_arrays():
    ch = pa.chunked_array([pa.array([1, 2], pa.int64()),
                           pa.array([3], pa.int64())])
    assert A.to_arrow(A.from_arrow(ch, device=CPU)).to_pylist() == [1, 2, 3]
    for arr in (pa.array(list(range(20)), pa.int64()),
                pa.array([True, False, None] * 7),
                pa.array(["ab", None, "c"] * 7),
                pa.array([D("1.5"), None] * 9, pa.decimal128(20, 1))):
        sl = arr.slice(5, 11)
        col = A.from_arrow(sl, device=CPU)
        assert col.to_pylist() == JA.from_arrow(sl).to_pylist()
        assert A.to_arrow(col).to_pylist() == sl.to_pylist()


def test_null_slot_payloads_come_back_zero():
    """A null slot's bytes are not kept: zero payload, empty string, as
    the JAX package's round trip gives."""
    arr = pa.Array.from_buffers(
        pa.int32(), 3, [pa.py_buffer(np.packbits([1, 0, 1],
                                                 bitorder="little")),
                        pa.py_buffer(np.asarray([4, 99, 6], np.int32))], 1)
    col = A.from_arrow(arr, device=CPU)
    assert col.data.tolist() == [4, 0, 6]
    assert_same(col, JA.from_arrow(arr))
    s = pa.Array.from_buffers(
        pa.string(), 3, [pa.py_buffer(np.packbits([1, 0, 1],
                                                  bitorder="little")),
                         pa.py_buffer(np.asarray([0, 1, 4, 5], np.int32)),
                         pa.py_buffer(b"axyzb")], 1)
    col = A.from_arrow(s, device=CPU)
    assert col.data.tolist() == list(b"ab")
    assert_same(col, JA.from_arrow(s))


def test_table_roundtrip_and_duplicate_names():
    tbl = pa.table({"a": pa.array([1, 2], pa.int32()),
                    "s": pa.array(["x", None]),
                    "d": pa.array([D("9.99")] * 2, pa.decimal128(10, 2))})
    t = A.table_from_arrow(tbl, device=CPU)
    assert t.num_columns == 3 and t.num_rows == 2
    back = A.table_to_arrow(t, names=["a", "s", "d"])
    assert back.equals(JA.table_to_arrow(JA.table_from_arrow(tbl),
                                         names=["a", "s", "d"]))
    dup = A.table_to_arrow(Table([Column.from_numpy(np.asarray([1], np.int32),
                                                    device=CPU)] * 2),
                           names=["k", "k"])
    assert dup.num_columns == 2


def test_decimal_widths_leave_as_decimal128():
    col = Column.from_numpy(np.asarray([9223372036854775807], np.int64),
                            T.decimal64(-2), device=CPU)
    out = A.to_arrow(col)
    assert out.type == pa.decimal128(38, 2)
    assert out.to_pylist() == [D("92233720368547758.07")]
    c32 = Column.from_numpy(np.asarray([-5, 7], np.int32), T.decimal32(-1),
                            device=CPU)
    assert A.to_arrow(c32).to_pylist() == [D("-0.5"), D("0.7")]


def test_unsupported_types_raise():
    # LIST and STRUCT are exchanged now (tests/test_torch_nested.py); a
    # MAP, a large list and a zoned timestamp are not
    with pytest.raises(NotImplementedError):
        A.from_arrow(pa.array([[("k", 1)]], pa.map_(pa.string(),
                                                     pa.int64())),
                     device=CPU)
    with pytest.raises(NotImplementedError):
        A.from_arrow(pa.array([[1, 2]], pa.large_list(pa.int64())),
                     device=CPU)
    with pytest.raises(NotImplementedError):
        A.from_arrow(pa.array([1], pa.timestamp("s", tz="UTC")), device=CPU)


def test_buffer_round_trip_of_a_table_is_byte_equal():
    """The card's path: every column through its Arrow buffers and back,
    no pyarrow, byte for byte (the lineitem shapes: ints, dates, decimals
    of both widths, a float, strings; with and without nulls)."""
    rng = np.random.default_rng(1)
    n = 1000
    valid = rng.random(n) < 0.9
    cols = [
        Column.from_numpy(rng.integers(0, 10**6, n).astype(np.int64),
                          device=CPU),
        # zero under its nulls: a null slot's payload does not come back
        Column.from_numpy(np.where(valid, rng.integers(0, 9, n), 0).astype(
            np.int32), validity=valid, device=CPU),
        Column.from_numpy(rng.integers(8000, 11000, n).astype(np.int32),
                          T.timestamp_days, device=CPU),
        Column.from_numpy(rng.integers(-10**9, 10**9, n).astype(np.int64),
                          T.decimal64(-2), device=CPU),
        Column.from_numpy(rng.integers(-10**6, 10**6, n).astype(np.int32),
                          T.decimal32(-2), device=CPU),
        Column.from_numpy(rng.standard_normal(n), device=CPU),
        Column.strings_from_list([f"s{i}" * (i % 4) for i in range(n)],
                                 device=CPU),
        Column.from_numpy((rng.random(n) < 0.5).astype(np.uint8), T.bool8,
                          device=CPU),
    ]
    for c in cols:
        a = A.to_arrow_buffers(c)
        back = A.from_arrow_buffers(a, device=CPU)
        assert back.dtype == c.dtype
        if c.dtype.id == T.TypeId.FLOAT64:
            assert torch.equal(back.data.view(torch.int64),
                               c.data.view(torch.int64))
        else:
            assert torch.equal(back.data, c.data)
        assert (back.validity is None) == (c.validity is None)
        if c.validity is not None:
            assert torch.equal(back.validity, c.validity)
        if c.offsets is not None:
            assert torch.equal(back.offsets, c.offsets)
