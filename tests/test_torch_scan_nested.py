"""The port's scan of nested and newly read columns against the JAX
package's and pyarrow, on the CPU.

Every LIST case of ``tests/test_parquet_decode_ext.py`` (ints, null
elements, strings, several row groups, column selection, and
``NestedDecodeUnsupported`` naming the path for a list of lists and a
MAP) is written with pyarrow and read by the port's ``scan_table`` and
by the JAX package's ``read_table`` and ``scan_table``: the columns are
equal (dtype tree, offsets, validity, chars, values).  The same holds
for dictionary-encoded and PLAIN lists, struct leaves (dotted names),
an all-pruned scan, fixed-size binary (FIXED_LEN_BYTE_ARRAY(16), a
STRING of 16 bytes a value) and BOOLEAN dictionaries, which pyarrow
cannot write: ``tools/torch_nested_parquet.py`` writes those.  That
writer's 20,000-row event table is read equal to its generator's lists
by pyarrow (every column but the BOOLEAN dictionary, which pyarrow does
not decode), the JAX package and the port.
"""

import torch_one_thread  # noqa: F401  (first: one intra-op thread)

import io
import os
import sys

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from spark_rapids_jni_tpu.parquet import decode as JD
from spark_rapids_jni_tpu.parquet import device_scan as jscan

import spark_rapids_jni_tpu_torch as pt
from spark_rapids_jni_tpu_torch.parquet import decode as PD
from spark_rapids_jni_tpu_torch.parquet import device_scan as pscan

from torch_jax_columns import assert_same_nested

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))
import torch_nested_parquet as N  # noqa: E402

CPU = "cpu"


def write(table: pa.Table, **kw) -> bytes:
    buf = io.BytesIO()
    pq.write_table(table, buf, **kw)
    return buf.getvalue()


def three_ways(raw: bytes, **kw):
    """(port, JAX read_table, JAX scan_table) of one file."""
    return (pscan.scan_table(raw, device=CPU, **kw),
            JD.read_table(raw, **kw), jscan.scan_table(raw, **kw))


def assert_three_equal(raw: bytes, **kw):
    p, j1, j2 = three_ways(raw, **kw)
    assert p.num_columns == j1.num_columns == j2.num_columns
    for i, pc in enumerate(p.columns):
        assert_same_nested(pc, j1[i], f"column {i} vs read_table")
        assert_same_nested(pc, j2[i], f"column {i} vs scan_table")
    return p


def _rand_lists(n, seed, null=0.1, hi=6):
    rng = np.random.default_rng(seed)
    return [None if rng.random() < null else
            rng.integers(0, 100, rng.integers(0, hi)).tolist()
            for _ in range(n)]


# the LIST cases of tests/test_parquet_decode_ext.py
LIST_CASES = {
    "int": (pa.array([[1, 2], [], None, [5], None, [6, 7, 8]],
                     pa.list_(pa.int32())), {}),
    "null_elements": (pa.array([[1, None, 3], None, [], [None]],
                               pa.list_(pa.int64())), {}),
    "strings": (pa.array([["ab", "c"], [], None, ["defg", None]],
                         pa.list_(pa.string())), {}),
    "many_rows_multi_group": (pa.array(_rand_lists(5000, 1),
                                       pa.list_(pa.int32())),
                              {"row_group_size": 700}),
    "doubles": (pa.array([[1.5, None], None, [-0.0, 2.25e300]],
                         pa.list_(pa.float64())), {}),
    "dates": (pa.array([[0, 18000], None, [None]], pa.list_(pa.date32())),
              {}),
}


@pytest.mark.parametrize("dictionary", [True, False])
@pytest.mark.parametrize("case", list(LIST_CASES))
def test_list_column(case, dictionary):
    arr, kw = LIST_CASES[case]
    raw = write(pa.table({"l": arr}), use_dictionary=dictionary, **kw)
    p = assert_three_equal(raw)
    if pa.types.is_date32(arr.type.value_type):   # days since the epoch
        arr = arr.cast(pa.list_(pa.int32()))
    assert p[0].to_pylist() == arr.to_pylist()
    if case == "strings" and dictionary:
        assert isinstance(p[0].children[0], pt.DictColumn)


def test_list_strings_v2_pages_and_small_pages():
    vals = [[f"s{i % 7}" * (i % 3), None][:i % 3] for i in range(3000)]
    raw = write(pa.table({"l": pa.array(vals, pa.list_(pa.string()))}),
                data_page_version="2.0", data_page_size=512,
                use_dictionary=False, compression="SNAPPY")
    p = assert_three_equal(raw)
    assert p[0].to_pylist() == vals


def test_mixed_flat_and_list_with_selection():
    tbl = pa.table({
        "a": pa.array([1, 2, 3], pa.int64()),
        "l": pa.array([[1], [], [2, 3]], pa.list_(pa.int32())),
        "s": pa.array(["x", "y", "z"]),
    })
    p = assert_three_equal(write(tbl), columns=["s", "l"])
    assert p[0].to_pylist() == ["x", "y", "z"]
    assert p[1].to_pylist() == [[1], [], [2, 3]]


def test_all_row_groups_pruned_gives_empty_list_column():
    tbl = pa.table({"id": pa.array(np.arange(10, dtype=np.int64)),
                    "l": pa.array([[str(i)] for i in range(10)],
                                  pa.list_(pa.string()))})
    raw = write(tbl, row_group_size=4)
    p = pscan.scan_table(raw, device=CPU,
                         rowgroup_predicate=[("id", "gt", 100)])
    j = jscan.scan_table(raw, rowgroup_predicate=[("id", "gt", 100)])
    assert p.num_rows == j.num_rows == 0
    assert p[1].dtype.id == pt.TypeId.LIST
    assert p[1].offsets.tolist() == [0] and p[1].to_pylist() == []
    # a list leaf's statistics never prune
    got = pscan.scan_table(raw, device=CPU,
                           rowgroup_predicate=[("l", "eq", b"zz")])
    assert got.num_rows == 10


def test_row_predicate_with_a_list_column_filters_after():
    tbl = pa.table({"id": pa.array(np.arange(50, dtype=np.int64)),
                    "l": pa.array([[i, i] for i in range(50)],
                                  pa.list_(pa.int64()))})
    got = pscan.scan_table(write(tbl), device=CPU,
                           row_predicate=[("id", "lt", 5)])
    assert got.num_rows == 50 and not got.fused_filter_complete


@pytest.mark.parametrize("name,vals", [
    ("deep", [[[1]], [[2, 3]]]),
    ("m", None),
])
def test_nested_decode_unsupported_names_path(name, vals):
    if vals is None:
        arr = pa.array([[("k", 1)], [("j", 2)]],
                       pa.map_(pa.string(), pa.int64()))
        match = "m.*MAP"
    else:
        arr = pa.array(vals, pa.list_(pa.list_(pa.int32())))
        match = name
    raw = write(pa.table({name: arr}))
    with pytest.raises(PD.NestedDecodeUnsupported, match=match):
        pscan.scan_table(raw, device=CPU)
    with pytest.raises(JD.NestedDecodeUnsupported, match=match):
        JD.read_table(raw)


def test_struct_leaves_keep_dotted_names():
    tbl = pa.table({"geo": pa.array(
        [{"lat": 1.0, "lon": None}, None, {"lat": -2.5, "lon": 4.0}],
        pa.struct([("lat", pa.float64()), ("lon", pa.float64())]))})
    raw = write(tbl)
    p = assert_three_equal(raw, columns=["geo.lon"])
    assert p[0].to_pylist() == [None, None, 4.0]
    assert [c.to_pylist() for c in assert_three_equal(raw)] == \
        [[1.0, None, -2.5], [None, None, 4.0]]


@pytest.mark.parametrize("dictionary", [True, False])
def test_fixed_size_binary(dictionary):
    rng = np.random.default_rng(7)
    vals = [bytes(rng.integers(0, 256, 16).astype(np.uint8))
            for _ in range(40)]
    vals = [None if i % 9 == 4 else vals[i % (5 if dictionary else 40)]
            for i in range(200)]
    raw = write(pa.table({"u": pa.array(vals, pa.binary(16))}),
                use_dictionary=dictionary, row_group_size=64)
    p = assert_three_equal(raw)
    col = p[0]
    assert col.dtype.id == pt.TypeId.STRING
    chars = bytes(col.data.numpy())
    offs = col.offsets.numpy()
    assert [chars[offs[i]:offs[i + 1]] if v else None
            for i, v in enumerate(col.validity_or_true().tolist())] == vals


def _bool_dict_file(n, seed, row_group_rows):
    arrays = N.nested_arrays(n, seed)
    return N.write_nested(arrays, row_group_rows), arrays


@pytest.mark.parametrize("rows,group", [(1000, 1000), (3000, 700)])
def test_boolean_dictionary(rows, group):
    raw, arrays = _bool_dict_file(rows, rows, group)
    p = assert_three_equal(raw, columns=["flag"])
    assert p[0].data.numpy().tolist() == arrays["flag"].tolist()


def test_boolean_dictionary_rows_pruned_by_the_row_filter():
    raw, arrays = _bool_dict_file(2000, 5, 700)
    want = arrays["id"] < 900
    p = pscan.scan_table(raw, columns=["id", "flag"], device=CPU,
                         row_predicate=[("id", "lt", 900)])
    assert p.num_rows == int(want.sum()) and p.fused_filter_complete
    assert p[1].data.numpy().tolist() == arrays["flag"][want].tolist()


def _bool_mixed_file(groups) -> tuple[bytes, list]:
    """An OPTIONAL BOOLEAN column whose chunks mix pages: each row group
    is a list of pages ``(encoding, values)``, "dict" or "plain", with
    None for a null.  Each chunk starts with a dictionary page of
    [True, False]; a dictionary page of nulls only holds no codes."""
    W = N.W
    out = bytearray(W.MAGIC)
    row_groups, expect = [], []
    for pages in groups:
        start = len(out)
        page, usize = W._page(W.PAGE_DICTIONARY, b"\x01", (
            7, N.TType.STRUCT, N._struct(N._i32(1, 2),
                                         N._i32(2, W.ENC_PLAIN))))
        out += page
        data_off, n = len(out), 0
        for enc, vals in pages:
            valid = np.array([v is not None for v in vals], bool)
            present = np.array([bool(v) for v in vals if v is not None],
                               bool)
            levels = W.bit_packed_runs(valid.astype(np.uint8), 1)
            body = N.struct.pack("<I", len(levels)) + levels
            if enc == "dict":
                # entry 0 is True, entry 1 False
                body += b"\x01" + W.bit_packed_runs(
                    (~present).astype(np.uint8), 1)
                code = W.ENC_RLE_DICTIONARY
            else:
                body += np.packbits(present.astype(np.uint8),
                                    bitorder="little").tobytes()
                code = W.ENC_PLAIN
            page, size = W._page(W.PAGE_DATA, body, (
                5, N.TType.STRUCT, N._struct(
                    N._i32(1, len(vals)), N._i32(2, code),
                    N._i32(3, W.ENC_RLE), N._i32(4, W.ENC_RLE))))
            out += page
            usize += size
            n += len(vals)
            expect += vals
        md = N._struct(
            N._i32(1, 0),
            (2, N.TType.LIST, N.ListValue(N.TType.I32, sorted(
                {W.ENC_PLAIN, W.ENC_RLE, W.ENC_RLE_DICTIONARY}))),
            (3, N.TType.LIST, N.ListValue(N.TType.BINARY, [b"flag"])),
            N._i32(4, 0), N._i64(5, n), N._i64(6, usize),
            N._i64(7, len(out) - start), N._i64(9, data_off),
            N._i64(11, start))
        chunk = N._struct(N._i64(2, start), (3, N.TType.STRUCT, md))
        size = len(out) - start
        row_groups.append(N._struct(
            (1, N.TType.LIST, N.ListValue(N.TType.STRUCT, [chunk])),
            N._i64(2, size), N._i64(3, n), N._i64(5, start),
            N._i64(6, size)))
    schema = [N._struct(N._i32(3, N.REQUIRED),
                        (4, N.TType.BINARY, b"schema"), N._i32(5, 1)),
              N._struct(N._i32(1, 0), N._i32(3, N.OPTIONAL),
                        (4, N.TType.BINARY, b"flag"))]
    footer = N._thrift(N._struct(
        N._i32(1, 1), (2, N.TType.LIST, N.ListValue(N.TType.STRUCT, schema)),
        N._i64(3, len(expect)),
        (4, N.TType.LIST, N.ListValue(N.TType.STRUCT, row_groups))))
    out += footer + N.struct.pack("<I", len(footer)) + W.MAGIC
    return bytes(out), expect


def _bools(rng, n, null):
    v = rng.integers(0, 2, n).astype(bool).tolist()
    return [None if rng.random() < null else x for x in v]


@pytest.mark.parametrize("layout", [
    [[("dict", 1.0), ("plain", 0.3), ("dict", 0.2)]],
    [[("dict", 1.0), ("plain", 0.0)], [("plain", 0.5), ("dict", 1.0)]],
    [[("plain", 0.2), ("dict", 1.0), ("dict", 0.1), ("plain", 1.0)]],
])
def test_boolean_pages_of_both_kinds_with_a_page_of_nulls(layout):
    """A dictionary page of nulls holds no codes: the PLAIN pages after
    it keep their bits (port, JAX ``read_table`` and ``scan_table``)."""
    rng = np.random.default_rng(len(layout))
    groups = [[(enc, _bools(rng, int(rng.integers(20, 90)), null))
               for enc, null in pages] for pages in layout]
    raw, expect = _bool_mixed_file(groups)
    p = assert_three_equal(raw)
    assert [None if v is None else bool(v)
            for v in p[0].to_pylist()] == expect


@pytest.fixture(scope="module")
def event_file():
    raw, arrays = N.nested_parquet(20_000, 18, row_group_rows=6_000)
    return raw, arrays, N.expected_pylists(arrays)


def test_event_table_writer_read_back_by_pyarrow(event_file):
    raw, _, expect = event_file
    tbl = pq.read_table(io.BytesIO(raw),
                        columns=["id", "items", "tags", "notes", "geo",
                                 "uuid"])
    for name in ("id", "items", "tags", "notes", "uuid"):
        assert tbl.column(name).to_pylist() == expect[name], name
    geo = tbl.column("geo").to_pylist()
    assert [None if g is None else g["lat"] for g in geo] == expect["geo.lat"]
    assert [None if g is None else g["lon"] for g in geo] == expect["geo.lon"]
    meta = pq.ParquetFile(io.BytesIO(raw)).metadata
    assert meta.num_row_groups == 4
    assert meta.row_group(0).column(1).compression == "SNAPPY"


def test_event_table_port_equals_jax_and_generator(event_file):
    raw, _, expect = event_file
    p = assert_three_equal(raw)
    assert [f"{c}" for c in N.COLUMNS] == [
        "id", "items", "tags", "notes", "geo.lat", "geo.lon", "flag", "uuid"]
    for name, col in zip(N.COLUMNS, p.columns):
        if name == "uuid":
            got = [bytes(col.data.numpy()[16 * i:16 * i + 16])
                   for i in range(col.num_rows)]
        elif name == "flag":
            got = [bool(v) for v in col.to_pylist()]
        else:
            got = col.to_pylist()
        assert got == expect[name], name
    assert isinstance(p[2].children[0], pt.DictColumn)
    assert not isinstance(p[3].children[0], pt.DictColumn)


@pytest.mark.parametrize("bw", [1, 2, 3, 4, 8, 10])
@pytest.mark.parametrize("n", [1, 8, 505, 5000])
def test_level_counts_equal_the_expanded_levels(bw, n):
    """``rle_device.level_counts`` against a histogram of the host
    expansion, an RLE run before the bit-packed ones and the last run cut
    short."""
    from spark_rapids_jni_tpu_torch.parquet import rle_device as R
    W = N.W
    v = np.random.default_rng(n * bw).integers(0, 1 << bw, n)
    rle = W._uleb(5 << 1) + (1).to_bytes((bw + 7) // 8, "little")
    plan = R.parse_runs(rle + W.bit_packed_runs(v, bw), bw, n + 5)
    for size in (1, 2, 1 << bw):
        want = np.bincount(R.expand_np(plan), minlength=1 << bw)[:size]
        np.testing.assert_array_equal(R.level_counts(plan, size), want)


# a bit-packed run of 2**62 groups: a 10-byte varint header
_HUGE_BP = N.W._uleb(((1 << 62) << 1) | 1)


@pytest.mark.parametrize("buf,bw,msg", [(b"\x80", 3, "header"),
                                        (b"\x03", 3, "past its stream"),
                                        (b"\x00", 3, "malformed"),
                                        (b"\x02", 3, "malformed"),
                                        (_HUGE_BP + b"\x00", 2,
                                         "past its stream"),
                                        (_HUGE_BP + b"\x00", 32,
                                         "past its stream")])
def test_parse_runs_rejects_malformed_streams(buf, bw, msg):
    from spark_rapids_jni_tpu_torch.parquet import rle_device as R
    assert len(_HUGE_BP) == 10
    with pytest.raises(ValueError, match=msg):
        R.parse_runs(buf, bw, 4)
