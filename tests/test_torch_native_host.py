"""The port's host tier against the JAX package's, on the CPU.

The port builds its own JVM-facing library from
``spark_rapids_jni_tpu_torch/csrc`` (``_native.jni_library``): the host
C++ JCUDF engine, the host tables and row batches, the footer engine.  Its
``rowconv/native.py`` and ``rowconv/host.py`` are held byte for byte against
the JAX package's over the JAX package's own ``libsrjt.so``, and against
the port's ``convert_to_rows`` / ``convert_from_rows`` on CPU tensors (the
reference pairs two engines the same way, ``tests/row_conversion.cpp:49-58``);
then the host tables' safety checks, after ``tests/test_host_table_safety.py``,
on the port's library.  Tables come from numpy with a seed; tolerance is 0
(FLOAT64 compares as bits).
"""

import torch_one_thread  # noqa: F401  (first: one intra-op thread)
import ctypes as C

import numpy as np
import pytest

from spark_rapids_jni_tpu import native as jnative
from spark_rapids_jni_tpu.rowconv import host as jhost
from spark_rapids_jni_tpu.rowconv import native as jcpp

import spark_rapids_jni_tpu_torch as pt
from spark_rapids_jni_tpu_torch import _native
from spark_rapids_jni_tpu_torch.rowconv import host as phost
from spark_rapids_jni_tpu_torch.rowconv import native as pcpp
from spark_rapids_jni_tpu_torch.rowconv.layout import compute_row_layout

from torch_jax_columns import assert_same, to_jax
from torch_jni_env import load_jax_native

CPU = "cpu"
INT32, STRING, DECIMAL128 = 3, 24, 27
JAX_NATIVE_LOADED = load_jax_native()


@pytest.fixture(scope="module")
def jlib():
    if not JAX_NATIVE_LOADED:
        pytest.fail("the JAX package's native library does not load")
    return jnative.load()


@pytest.fixture(scope="module")
def lib():
    return _native.jni_library()


def _fixed_table(n=257, seed=3):
    rng = np.random.default_rng(seed)
    return pt.Table([
        pt.Column.from_numpy(rng.integers(-1000, 1000, n, dtype=np.int64),
                             validity=rng.random(n) < 0.8, device=CPU),
        pt.Column.from_numpy(rng.integers(-100, 100, n, dtype=np.int32),
                             device=CPU),
        pt.Column.from_numpy(rng.standard_normal(n).astype(np.float32),
                             device=CPU),
        pt.Column.from_numpy(rng.integers(0, 2, n).astype(np.uint8),
                             pt.bool8, device=CPU),
        pt.Column.from_numpy(rng.integers(-9, 9, n, dtype=np.int8),
                             validity=rng.random(n) < 0.5, device=CPU),
        pt.Column.from_numpy(rng.integers(0, 10**6, n, dtype=np.int32),
                             pt.decimal32(-2), device=CPU),
        pt.Column.from_numpy(rng.standard_normal(n), pt.float64,
                             validity=rng.random(n) < 0.9, device=CPU),
        pt.Column.from_numpy(rng.integers(-10**15, 10**15, n),
                             pt.decimal64(-4), device=CPU),
    ])


def _string_table(n=131, seed=4):
    rng = np.random.default_rng(seed)
    words = ["", "a", "tpu", "columnar", "x" * 40, "μνξ"]
    return pt.Table([
        pt.Column.from_numpy(rng.integers(0, 1000, n, dtype=np.int32),
                             validity=rng.random(n) < 0.9, device=CPU),
        pt.Column.strings_from_list(
            [None if rng.random() < 0.2 else words[rng.integers(len(words))]
             for _ in range(n)], device=CPU),
        pt.Column.from_numpy(rng.integers(0, 100, n, dtype=np.int16),
                             device=CPU),
        pt.Column.strings_from_list(
            [words[rng.integers(len(words))] for _ in range(n)], device=CPU),
        pt.Column.from_numpy(rng.standard_normal(n), pt.float64, device=CPU),
    ])


TABLES = {"fixed": _fixed_table, "strings": _string_table,
          "one_row": lambda: _string_table(1, 7),
          "fixed_empty": lambda: _fixed_table(0, 1)}


@pytest.mark.parametrize("case", ["fixed", "strings"])
def test_layout_native_matches_jax_and_layout(jlib, case):
    table = TABLES[case]()
    layout = compute_row_layout(table.schema)
    got = pcpp.layout_native(table.schema)
    assert got == jcpp.layout_native(to_jax(table).schema)
    assert got == (layout.column_starts, layout.validity_offset,
                   layout.fixed_plus_validity, layout.fixed_row_size)


@pytest.mark.parametrize("case", list(TABLES))
def test_to_rows_np_matches_jax_and_device_path(jlib, case):
    table = TABLES[case]()
    rows, offs = pcpp.to_rows_np(table)
    want_rows, want_offs = jcpp.to_rows_np(to_jax(table))
    np.testing.assert_array_equal(rows, want_rows)
    np.testing.assert_array_equal(offs, want_offs)
    batch, = pt.convert_to_rows(table)
    np.testing.assert_array_equal(batch.host_bytes(), rows)
    np.testing.assert_array_equal(batch.offsets.numpy(), offs)


@pytest.mark.parametrize("case", list(TABLES))
def test_from_rows_np_matches_jax_and_device_path(jlib, case):
    table = TABLES[case]()
    rows, offs = pcpp.to_rows_np(table)
    back = pcpp.from_rows_np(rows, offs, table.schema, device=CPU)
    jback = jcpp.from_rows_np(rows, offs, to_jax(table).schema)
    dev = pt.convert_from_rows(pt.convert_to_rows(table)[0], table.schema)
    for ci, (got, orig) in enumerate(zip(back.columns, table.columns)):
        assert_same(got, jback.columns[ci], what=f"column {ci} vs JAX")
        assert_same(got, to_jax(dev.columns[ci]), what=f"column {ci} vs GPU path")
        assert_same(got, to_jax(orig), what=f"column {ci} round trip")


def test_from_rows_np_takes_word_rows(jlib):
    """A row stream held as uint32 words decodes as its bytes."""
    table = _fixed_table(64, 11)
    rows, offs = pcpp.to_rows_np(table)
    back = pcpp.from_rows_np(rows.view(np.uint32), offs, table.schema,
                             device=CPU)
    for ci, (got, orig) in enumerate(zip(back.columns, table.columns)):
        assert_same(got, to_jax(orig), what=f"column {ci}")


@pytest.mark.parametrize("n", [0, 1, 300])
def test_host_fixed_engine_matches_jax(jlib, n):
    table = _fixed_table(n, 5 + n)
    rows = phost.to_rows_fixed_np(table)
    np.testing.assert_array_equal(rows, jhost.to_rows_fixed_np(to_jax(table)))
    np.testing.assert_array_equal(rows.reshape(-1), pcpp.to_rows_np(table)[0])
    datas, valid = phost.from_rows_fixed_np(rows, table.schema)
    jdatas, jvalid = jhost.from_rows_fixed_np(rows, to_jax(table).schema)
    np.testing.assert_array_equal(valid, jvalid)
    for ci, (got, want) in enumerate(zip(datas, jdatas)):
        # the JAX package holds FLOAT64 as uint32 bit pairs: compare bytes
        np.testing.assert_array_equal(
            np.ascontiguousarray(got).view(np.uint8).reshape(-1),
            np.ascontiguousarray(want).view(np.uint8).reshape(-1),
            err_msg=f"column {ci}")
        assert got.dtype == table.columns[ci].data.numpy().dtype


def test_host_fixed_engine_refuses_strings():
    table = _string_table(4)
    with pytest.raises(ValueError, match="fixed-width"):
        phost.to_rows_fixed_np(table)
    with pytest.raises(ValueError, match="fixed-width"):
        phost.from_rows_fixed_np(np.zeros((4, 32), np.uint8), table.schema)


# ---------------------------------------------------------------------------
# host table safety (tests/test_host_table_safety.py on the port's library)
# ---------------------------------------------------------------------------

def _ptr(a):
    return a.ctypes.data_as(C.c_void_p)


def _string_handle(lib, chars_per_row: int, n: int):
    """One int32 column and one string column of constant-length strings,
    as a host table handle of ``lib``."""
    ints = np.arange(n, dtype=np.int32)
    offs = np.arange(n + 1, dtype=np.int32) * chars_per_row
    chars = np.full(offs[-1], ord("x"), dtype=np.uint8)
    h_int = lib.srjt_column_fixed(INT32, 0, n, _ptr(ints), None)
    h_str = lib.srjt_column_string(n, _ptr(offs), _ptr(chars), None)
    t = lib.srjt_table((C.c_void_p * 2)(h_int, h_str), 2)
    lib.srjt_column_free(h_int)
    lib.srjt_column_free(h_str)
    return t


def _batches(lib, rows) -> list:
    out = []
    for b in range(lib.srjt_rows_num_batches(rows)):
        size = lib.srjt_rows_batch_size(rows, b)
        n = lib.srjt_rows_batch_rows(rows, b)
        data = C.cast(lib.srjt_rows_batch_data(rows, b), C.POINTER(C.c_uint8))
        offs = C.cast(lib.srjt_rows_batch_offsets(rows, b),
                      C.POINTER(C.c_int32))
        out.append((bytes(np.ctypeslib.as_array(data, (size,))) if size
                    else b"", np.ctypeslib.as_array(offs, (n + 1,)).copy()))
    return out


def test_oversized_row_fails_instead_of_hanging(lib):
    lib.srjt_debug_set_max_batch_bytes(64)
    try:
        t = _string_handle(lib, chars_per_row=200, n=4)  # each row > 64 B
        assert not lib.srjt_to_rows(t)
        lib.srjt_table_free(t)
    finally:
        lib.srjt_debug_set_max_batch_bytes(0)


def test_small_limit_batches_as_jax_library(lib, jlib):
    """Under a 256-byte limit both libraries cut 64 rows into the same
    batches (the 32-row rule), with the same bytes."""
    got = {}
    for name, l in (("port", lib), ("jax", jlib)):
        l.srjt_debug_set_max_batch_bytes(256)
        try:
            t = _string_handle(l, chars_per_row=8, n=64)
            rows = l.srjt_to_rows(t)
            assert rows
            got[name] = _batches(l, rows)
            l.srjt_rows_free(rows)
            l.srjt_table_free(t)
        finally:
            l.srjt_debug_set_max_batch_bytes(0)
    assert len(got["port"]) > 1
    assert len(got["port"]) == len(got["jax"])
    for (a, ao), (b, bo) in zip(got["port"], got["jax"]):
        assert a == b
        np.testing.assert_array_equal(ao, bo)


BAD_OFFSETS = {
    "non_monotonic": ([0, 40, 20, 64], 3),
    "not_from_zero": ([8, 32, 64], 2),
    "short_of_the_end": ([0, 32, 48], 2),
    "negative": ([0, -4, 64], 2),
}


@pytest.mark.parametrize("case", list(BAD_OFFSETS))
def test_import_rejects_bad_offsets(lib, case):
    data = np.zeros(64, dtype=np.uint8)
    offsets, n = BAD_OFFSETS[case]
    offsets = np.asarray(offsets, dtype=np.int32)
    assert not lib.srjt_rows_import(_ptr(data), len(data), _ptr(offsets), n)
    h = lib.srjt_rows_import(_ptr(data), len(data),
                             _ptr(np.array([0, 32, 64], np.int32)), 2)
    assert h
    assert not lib.srjt_rows_import_append(h, _ptr(data), len(data),
                                           _ptr(offsets), n)
    assert lib.srjt_rows_num_batches(h) == 1
    lib.srjt_rows_free(h)


def _from_rows(lib, rows_handle, type_ids):
    tids = np.asarray(type_ids, dtype=np.int32)
    return lib.srjt_from_rows(rows_handle, 0, _ptr(tids), None, len(tids))


def test_from_rows_rejects_short_rows(lib):
    # int32 + string: 4 (int) + 4 (pad) + 8 (slot) + 1 (validity) → 24 B
    data = np.zeros(16, dtype=np.uint8)
    h = lib.srjt_rows_import(_ptr(data), 16, _ptr(np.array([0, 16], np.int32)),
                             1)
    assert h
    assert not _from_rows(lib, h, [INT32, STRING])
    lib.srjt_rows_free(h)


def _one_row(lib, t):
    rows = lib.srjt_to_rows(t)
    assert rows
    (buf, _), = _batches(lib, rows)
    lib.srjt_rows_free(rows)
    lib.srjt_table_free(t)
    return np.frombuffer(buf, np.uint8).copy()


@pytest.mark.parametrize("corrupt", ["length_past_row", "offset_before_fixed"])
def test_from_rows_rejects_out_of_row_string_slot(lib, corrupt):
    buf = _one_row(lib, _string_handle(lib, chars_per_row=8, n=1))
    offs = np.array([0, buf.size], dtype=np.int32)
    h = lib.srjt_rows_import(_ptr(buf), buf.size, _ptr(offs), 1)
    back = _from_rows(lib, h, [INT32, STRING])
    assert back                       # the clean row decodes
    lib.srjt_table_free(back)
    lib.srjt_rows_free(h)
    # the slot's offset at bytes 4..8, its length at 8..12
    bad = buf.copy()
    if corrupt == "length_past_row":
        bad[8:12] = np.frombuffer(np.int32(2**31 - 1).tobytes(), np.uint8)
    else:
        bad[4:8] = np.frombuffer(np.int32(2).tobytes(), np.uint8)
    h = lib.srjt_rows_import(_ptr(bad), bad.size, _ptr(offs), 1)
    assert not _from_rows(lib, h, [INT32, STRING])
    lib.srjt_rows_free(h)


def test_from_rows_rejects_overlapping_string_slots(lib):
    """A second slot pointing back at the first column's chars is refused:
    each slot's offset must be the running cursor."""
    chars = np.frombuffer(b"abcd", dtype=np.uint8).copy()
    offs = np.array([0, 4], dtype=np.int32)
    h1 = lib.srjt_column_string(1, _ptr(offs), _ptr(chars), None)
    h2 = lib.srjt_column_string(1, _ptr(offs), _ptr(chars), None)
    t = lib.srjt_table((C.c_void_p * 2)(h1, h2), 2)
    lib.srjt_column_free(h1)
    lib.srjt_column_free(h2)
    buf = _one_row(lib, t)
    offsets = np.array([0, buf.size], dtype=np.int32)
    h = lib.srjt_rows_import(_ptr(buf), buf.size, _ptr(offsets), 1)
    back = _from_rows(lib, h, [STRING, STRING])
    assert back
    lib.srjt_table_free(back)
    lib.srjt_rows_free(h)
    bad = buf.copy()
    bad[8:12] = bad[0:4]              # slot 2's offset := slot 1's
    h = lib.srjt_rows_import(_ptr(bad), bad.size, _ptr(offsets), 1)
    assert not _from_rows(lib, h, [STRING, STRING])
    lib.srjt_rows_free(h)


@pytest.mark.parametrize("which", ["port", "jax"])
def test_host_columns_refuse_decimal128_and_missing_offsets(lib, jlib, which):
    """The host tables keep the JAX library's type set: no DECIMAL128."""
    l = lib if which == "port" else jlib
    data = np.zeros(32, dtype=np.uint8)
    assert not l.srjt_column_fixed(DECIMAL128, 0, 2, _ptr(data), None)
    assert not l.srjt_column_string(2, None, _ptr(data), None)
    assert not l.srjt_table((C.c_void_p * 1)(), 0)
