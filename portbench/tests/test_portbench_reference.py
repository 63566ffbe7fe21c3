"""The NumPy references against hand-built cases, pyarrow and the port's
plain CPU path at tiny sizes, and the controls against the checks."""

from __future__ import annotations

import io
import struct

import numpy as np
import pytest

from portbench import control
from portbench.data import parquet as W
from portbench.data import tpch_lineitem as L
from portbench.data import tpcds_star as D
from portbench.reference import jcudf
from portbench.reference import tpcds_oracle as O

from .conftest import tiny_cell

SPAN = D.sales_span({"sales_first_date": "1998-01-02", "sales_days": 1827})


def _star(n_sales, n_items, seed):
    return D.tpcds_arrays(n_sales, n_sales // 4, n_items, 73049, 12, SPAN,
                          seed)


def _strings(items):
    lens = np.array([len(s) for s in items], np.int64)
    offs = np.zeros(len(items) + 1, np.int64)
    np.cumsum(lens, out=offs[1:])
    return np.frombuffer(b"".join(items), np.uint8), offs


def test_layout_by_hand():
    lay = jcudf.layout(["int8", "int64", "string", "int32"])
    # int8 at 0, int64 aligned to 8, the string slot aligned to 4, int32
    assert lay["starts"] == [0, 8, 16, 24]
    assert lay["validity_at"] == 28 and lay["validity_bytes"] == 1
    assert lay["chars_at"] == 29 and lay["fixed_row"] == 32


def test_fixed_rows_by_hand():
    cols = [("int32", np.array([1, -2], np.int32)),
            ("int64", np.array([3, 4], np.int64)),
            ("int8", np.array([5, 6], np.int8), np.array([True, False]))]
    data, offs = jcudf.encode(cols)
    row0 = (struct.pack("<i", 1) + b"\0" * 4 + struct.pack("<q", 3)
            + b"\x05" + b"\x07" + b"\0" * 6)
    row1 = (struct.pack("<i", -2) + b"\0" * 4 + struct.pack("<q", 4)
            + b"\x06" + b"\x03" + b"\0" * 6)
    assert offs.tolist() == [0, 24, 48]
    assert data.tobytes() == row0 + row1


def test_string_rows_by_hand():
    cols = [("int32", np.array([7, 8], np.int32)),
            ("string", _strings([b"ab", b""])),
            ("string", _strings([b"xyz", b"q"]), np.array([True, True]))]
    data, offs = jcudf.encode(cols)
    # slots: int32 at 0, strings at 4 and 12, validity at 20, chars at 21
    row0 = (struct.pack("<i", 7) + struct.pack("<II", 21, 2)
            + struct.pack("<II", 23, 3) + b"\x07" + b"abxyz" + b"\0" * 6)
    row1 = (struct.pack("<i", 8) + struct.pack("<II", 21, 0)
            + struct.pack("<II", 21, 1) + b"\x07" + b"q" + b"\0" * 2)
    assert data.tobytes() == row0 + row1
    assert offs.tolist() == [0, 32, 56]


def test_null_string_has_no_chars():
    cols = [("string", _strings([b"abc", b"de"]), np.array([False, True]))]
    data, offs = jcudf.encode(cols)
    assert offs.tolist() == [0, 16, 32]
    assert data[8] == 0b0 and data[16 + 8] == 0b1
    assert data[16 + 9:16 + 11].tobytes() == b"de"


@pytest.mark.parametrize("seed", [0, 2**31 + 7])
def test_round_trip(seed):
    rng = np.random.default_rng(seed)
    n = 3000
    words = [bytes(rng.integers(97, 123, k, dtype=np.uint8))
             for k in rng.integers(0, 40, n)]
    cols = [("int64", rng.integers(-2**62, 2**62, n)),
            ("string", _strings(words), rng.random(n) > 0.1),
            ("float64", rng.random(n)),
            ("int16", rng.integers(-5, 5, n).astype(np.int16))]
    data, offs = jcudf.encode(cols)
    assert (np.diff(offs) % 8 == 0).all()
    back = jcudf.decode(data, offs, [c[0] for c in cols])
    assert jcudf.value_mismatches(back, cols) == 0
    back[0][1][5] += 1
    assert jcudf.value_mismatches(back, cols) == 1


def test_against_the_port_on_the_cpu():
    """The reference's bytes equal the port's plain path's on a scanned
    lineitem slice (both dictionary and plain strings)."""
    import spark_rapids_jni_tpu_torch as pt
    from spark_rapids_jni_tpu_torch.parquet import device_scan
    data = L.generate_lineitem(3000, 11)
    data["l_comment"] = L.generate_comments(3000, 11)
    raw = W.write_parquet(L.parquet_columns(data), 1024,
                          dict_page_bytes=1024, page_row_limit=500)
    table = device_scan.scan_table(raw, device="cpu")
    batch = pt.convert_to_rows(table)[0]
    want, offs = jcudf.encode(L.reference_columns(data))
    assert np.array_equal(batch.host_bytes(), want)
    assert np.array_equal(batch.offsets.numpy(), offs)


def test_lineitem_file_against_pyarrow():
    pq = pytest.importorskip("pyarrow.parquet")
    data = L.generate_lineitem(5000, 3)
    data["l_comment"] = L.generate_comments(5000, 3)
    raw = W.write_parquet(L.parquet_columns(data), 2048,
                          dict_page_bytes=2048, page_row_limit=1000)
    t = pq.read_table(io.BytesIO(raw))
    assert t.num_rows == 5000 and t.num_columns == 16
    assert np.array_equal(t["l_orderkey"].to_numpy(), data["l_orderkey"])
    assert np.array_equal(t["l_quantity"].to_numpy(), data["l_quantity"])
    assert t["l_shipmode"].to_pylist()[:50] == [
        L.VOCAB["l_shipmode"][c].decode() for c in data["l_shipmode"][:50]]
    chars, offs = data["l_comment"]
    assert t["l_comment"].to_pylist()[4999] == \
        chars[offs[4999]:offs[5000]].tobytes().decode()


def test_tpcds_files_against_pyarrow():
    pq = pytest.importorskip("pyarrow.parquet")
    arrays = _star(4000, 100, 5)
    for name in D.SCHEMA:
        raw = W.write_parquet(D.table_columns(name, arrays[name]), 1500)
        t = pq.read_table(io.BytesIO(raw))
        for col in D.SCHEMA[name]:
            got = t[col].to_pylist()
            want = arrays[name][col]
            if col == "i_current_price":
                assert [int(v * 100) for v in got] == want.tolist()
            elif col == "ws_ext_sales_price":
                valid = arrays[name]["ws_ext_sales_price_valid"]
                assert [g is not None for g in got] == valid.tolist()
                assert np.array_equal(np.array(got, object)[valid],
                                      want[valid])
            else:
                assert got == want.tolist(), (name, col)


def test_date_dim_is_the_calendar():
    """d_date_sk 1 is 1900-01-02, as TPC-DS's 2415022; the sales span is
    dsdgen's 2450816-2452642 (1998-01-02 to 2003-01-02)."""
    a = _star(3000, 50, 4)
    dd, ss = a["date_dim"], a["store_sales"]
    assert dd["d_date_sk"].shape[0] == 73049
    first, days = SPAN
    assert (first + 2415021, first + days - 1 + 2415021) == (2450816,
                                                              2452642)
    assert (dd["d_year"][0], dd["d_moy"][0]) == (1900, 1)
    assert (dd["d_year"][first - 1], dd["d_moy"][first - 1]) == (1998, 1)
    assert (dd["d_year"][-1], dd["d_moy"][-1]) == (2100, 1)
    assert np.count_nonzero(dd["d_moy"][dd["d_year"] == 2000] == 2) == 29
    sold = ss["ss_sold_date_sk"]
    assert sold.min() >= first and sold.max() < first + days
    years = set(dd["d_year"][sold - 1].tolist())
    assert years == {1998, 1999, 2000, 2001, 2002, 2003}


def test_least_bytes_of_dictionary_columns():
    """A dictionary column is read as int32 codes plus its entries."""
    from portbench import yardstick
    cols = [("int32", np.arange(4, dtype=np.int32)),
            ("string", _strings([b"ab", b"cde", b"ab", b"ab"]))]
    row = yardstick.row_bytes(cols)
    plain = yardstick.rows_least_bytes(cols)
    assert plain == 16 + (9 + 4 * 5) + row + 4 * 5
    coded = yardstick.rows_least_bytes(cols, {1: np.array([2, 3])})
    assert coded == 16 + (4 * 4 + 5 + 4 * 3) + row + 4 * 5


def test_oracle_copy_answers_as_the_tools_oracle():
    import importlib.util
    import os
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "tools", "torch_tpcds_oracle.py")
    spec = importlib.util.spec_from_file_location("tools_oracle", path)
    tools = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tools)
    arrays = _star(5000, 200, 9)
    assert O.query_params(arrays) == tools.query_params(arrays)
    params = O.query_params(arrays)
    for q in ("q3", "q65", "q27_cube", "q_running_share", "q29_minmax"):
        a = O.answer(q, arrays, params[q])
        b = tools.answer(q, arrays, params[q])
        assert all(np.array_equal(x, y) for x, y in zip(a.cols, b.cols))
        valid = [np.ones(a.num_rows, bool) if v is None else v
                 for v in a.valid]
        assert O.readings(a.cols, valid, a) == (0, 0.0)


def test_readings_count_what_differs():
    arrays = _star(5000, 200, 9)
    params = O.query_params(arrays)
    want = O.answer("q3", arrays, params["q3"])
    valid = [np.ones(want.num_rows, bool)] * len(want.cols)
    cols = [c.copy() for c in want.cols]
    cols[0][0] += 1
    assert O.readings(cols, valid, want)[0] == 1
    lower = O.float32_answer(want)
    assert O.readings(lower.cols, valid, want)[1] > 1e-9


@pytest.mark.parametrize("cell", ["rows_lineitem_sf1", "rows_store_sales_sf10",
                                  "tpcds_serve_sf1"])
def test_control_fails_the_check(cell):
    """The reference one precision below fails a number of the cell."""
    c = tiny_cell(cell)
    got = control.readings(c, 2**31 + 3)
    limits = c["workload"]["limits"]
    assert any(v > limits[k] for k, v in got.items()), got
