"""The port's device Parquet scan, DictColumn, Q6 and rows of a scanned
table against the JAX package and pyarrow, on the CPU.

Each file is written from numpy-seeded data (by pyarrow, or by the lineitem
writer of ``tools/torch_lineitem_parquet.py``) and scanned by both packages:
``spark_rapids_jni_tpu_torch.parquet.device_scan.scan_table`` on CPU
tensors and ``spark_rapids_jni_tpu.parquet.device_scan.scan_table``.  Values,
validity, dictionary codes, dictionaries and materialized chars must be
equal (exact); pyarrow's reading is the independent oracle, which also
covers the dictionary-string cases the JAX suite is known to fail in some
runs.  FLOAT64 compares as values: the JAX package stores it as uint32
bit pairs, the port as native float64.
"""

import torch_one_thread  # noqa: F401  (first: one intra-op thread)
import decimal
import io
import pathlib
import sys

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

import jax.numpy as jnp  # noqa: F401  (JAX on the CPU, set by conftest)
import spark_rapids_jni_tpu as sr
from spark_rapids_jni_tpu.column import DictColumn as JDictColumn
from spark_rapids_jni_tpu.models import q6 as jq6
from spark_rapids_jni_tpu.parquet import device_scan as jscan

import spark_rapids_jni_tpu_torch as pt
from spark_rapids_jni_tpu_torch.models import q6 as pq6
from spark_rapids_jni_tpu_torch.parquet import device_scan as pscan
from spark_rapids_jni_tpu_torch.parquet import rle_device
from spark_rapids_jni_tpu_torch.rowconv import bytepath

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent / "tools"))
import torch_lineitem_parquet as W  # noqa: E402
from torch_jni_env import load_jax_native  # noqa: E402

CPU = "cpu"
N = 3000


# At import: a test worker imports every test file before it runs any test,
# so a worker that lost the build race at an earlier import holds a loaded
# library before any JAX test reaches for it lazily.  A failure is reported
# by the fixture below, not here, so that every worker collects the same
# tests.
JAX_NATIVE_LOADED = load_jax_native()


@pytest.fixture(scope="module", autouse=True)
def _jax_native_library():
    if not JAX_NATIVE_LOADED:
        pytest.fail("the JAX package's native library does not load")


@pytest.fixture(autouse=True)
def _jax_quick_paths(monkeypatch):
    # per-column JAX decode programs (cached across files of one shape)
    # instead of one fused program a file, and the DMA row engine instead
    # of xpack: the JAX package's own tests hold these paths bit-identical
    # to its defaults (tests/test_bytepath.py); they compile far faster
    monkeypatch.setenv("SRJT_FUSED_SCAN", "0")
    monkeypatch.setenv("SRJT_XPACK", "0")


def _write(table: pa.Table, **kw) -> bytes:
    buf = io.BytesIO()
    pq.write_table(table, buf, **kw)
    return buf.getvalue()


# one column of each kind is OPTIONAL too: every OPTIONAL column costs the
# JAX scan a few more compiles on the CPU
OPTIONAL_KINDS = ("s_wide", "i_dict", "l_plain")


def _table(rng, n, null_share=0.15):
    """Dictionary strings, dictionary numerics and PLAIN numerics, all
    REQUIRED (``req_*``), and ``OPTIONAL_KINDS`` again OPTIONAL with nulls
    (``opt_*``)."""
    def values():
        return {
            "s_dict": [f"val{v}" for v in rng.integers(0, 30, n)],
            "s_wide": [f"{'x' * int(v)}|{v}" for v in rng.integers(0, 40, n)],
            "i_dict": rng.integers(0, 9, n).astype(np.int32).tolist(),
            "f_dict": (rng.integers(0, 11, n) / 100.0).tolist(),
            "l_plain": rng.integers(-2**40, 2**40, n).tolist(),
            "d_plain": rng.standard_normal(n).tolist(),
            "date": rng.integers(8000, 10000, n).astype(np.int32).tolist(),
        }
    types = {"s_dict": pa.string(), "s_wide": pa.string(),
             "i_dict": pa.int32(), "f_dict": pa.float64(),
             "l_plain": pa.int64(), "d_plain": pa.float64(),
             "date": pa.date32()}
    arrays, fields = [], []
    for prefix, optional in (("req_", False), ("opt_", True)):
        for k, v in values().items():
            if optional and k not in OPTIONAL_KINDS:
                continue
            if optional:
                v = [None if m else x for x, m in
                     zip(v, rng.random(n) < null_share)]
            arrays.append(pa.array(v, types[k]))
            fields.append(pa.field(prefix + k, types[k], nullable=optional))
    return pa.Table.from_arrays(arrays, schema=pa.schema(fields))


DICT_COLS = [p + k for p in ("req_", "opt_")
             for k in ("s_dict", "s_wide", "i_dict", "f_dict", "date")]


def _file(row_groups, multi_page, compression="NONE", **kw):
    """N rows in ``row_groups`` row groups; with ``multi_page`` every
    chunk cuts into pages of 500 rows (pages end at pyarrow's write
    batches), which keeps the JAX scan's compiled shapes few."""
    rng = np.random.default_rng(row_groups + 10 * int(multi_page))
    t = _table(rng, N)
    raw = _write(t, compression=compression, use_dictionary=DICT_COLS,
                 row_group_size=N // row_groups,
                 data_page_size=1 if multi_page else 1 << 20,
                 write_batch_size=500 if multi_page else N, **kw)
    return t, raw


def _names(t: pa.Table, optional: bool) -> list[str]:
    prefix = "opt_" if optional else "req_"
    return [c for c in t.column_names if c.startswith(prefix)]


_JAX_SCANS = {}


def _jax_scan(raw: bytes, **kw):
    key = (raw, repr(sorted(kw.items())))
    if key not in _JAX_SCANS:
        _JAX_SCANS[key] = jscan.scan_table(raw, **kw)
    return _JAX_SCANS[key]


# ---------------------------------------------------------------------------
# comparison helpers
# ---------------------------------------------------------------------------

def _valid(col) -> np.ndarray:
    v = col.validity_or_true()
    return v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def assert_column_equal(p, j):
    """A port column equals a JAX column: dtype, validity, bytes."""
    assert int(p.dtype.id) == int(j.dtype.id) and p.dtype.scale == j.dtype.scale
    assert p.num_rows == j.num_rows
    np.testing.assert_array_equal(_valid(p), _valid(j))
    if isinstance(j, JDictColumn) or j.dtype.id == sr.TypeId.STRING:
        np.testing.assert_array_equal(p.offsets.numpy(), np.asarray(j.offsets))
        np.testing.assert_array_equal(p.data.numpy(), np.asarray(j.data))
    else:
        np.testing.assert_array_equal(p.data.numpy(), j.to_numpy())


def assert_dict_equal(p, j):
    """A port DictColumn equals a JAX DictColumn: codes and dictionary."""
    assert isinstance(p, pt.DictColumn) and isinstance(j, JDictColumn)
    np.testing.assert_array_equal(p.codes.numpy(), np.asarray(j.codes))
    np.testing.assert_array_equal(p.dictionary.data.numpy(),
                                  np.asarray(j.dictionary.data))
    np.testing.assert_array_equal(p.dictionary.offsets.numpy(),
                                  np.asarray(j.dictionary.offsets))


def assert_matches_arrow(p, arrow_col):
    want = arrow_col.to_pylist()
    got = p.to_pylist()
    if pa.types.is_date32(arrow_col.type):
        epoch = np.datetime64("1970-01-01", "D")
        want = [None if w is None else int((np.datetime64(w, "D") - epoch)
                                          .astype(int)) for w in want]
    assert got == want


# ---------------------------------------------------------------------------
# the scan matrix
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dict_strings", [True, False], ids=["dict", "mat"])
@pytest.mark.parametrize("multi_page", [False, True], ids=["1page", "pages"])
@pytest.mark.parametrize("row_groups", [1, 3], ids=["1rg", "3rg"])
@pytest.mark.parametrize("optional", [False, True], ids=["req", "opt"])
def test_scan_matches_jax_and_arrow(optional, row_groups, multi_page,
                                    dict_strings):
    t, raw = _file(row_groups, multi_page)
    names = _names(t, optional)
    got = pscan.scan_table(raw, columns=names, dict_strings=dict_strings,
                           device=CPU)
    want = _jax_scan(raw)
    assert got.num_columns == len(names)
    for name, p in zip(names, got.columns):
        j = want[t.column_names.index(name)]
        if name[4:].startswith("s_"):
            assert isinstance(p, pt.DictColumn) == dict_strings
            if dict_strings:
                assert_dict_equal(p, j)
        assert_column_equal(p, j)
        assert_matches_arrow(p, t[name])


@pytest.mark.parametrize("compression", ["SNAPPY", "NONE"])
@pytest.mark.parametrize("page_version", ["1.0", "2.0"])
def test_scan_codecs_and_page_versions(compression, page_version):
    t, raw = _file(3, True, compression=compression,
                   data_page_version=page_version)
    got = pscan.scan_table(raw, device=CPU)
    for name, p in zip(t.column_names, got.columns):
        assert_matches_arrow(p, t[name])


def test_scan_selects_columns_and_row_groups():
    t, raw = _file(3, False)
    cols = ["req_date", "req_s_dict", "opt_s_wide", "opt_l_plain"]
    got = pscan.scan_table(raw, columns=cols, row_groups=[2, 0], device=CPU)
    rg = N // 3
    keep = np.r_[0:rg, 2 * rg:N]
    for name, p in zip(cols, got.columns):
        assert_matches_arrow(p, t[name].take(keep))


def test_scan_zero_rows():
    t, raw = _file(3, False)
    got = pscan.scan_table(raw, row_groups=[], device=CPU)
    want = jscan.scan_table(raw, row_groups=[])
    assert got.num_rows == 0 and got.num_columns == t.num_columns
    for p, j in zip(got.columns, want.columns):
        assert_column_equal(p, j)
    # a file of zero rows, written with its one empty row group
    empty = W.write_parquet(
        [W.ParquetColumn("a", "INT64", np.zeros(0, np.int64)),
         W.strings_column("s", []),
         W.ParquetColumn("d", "DOUBLE", np.zeros(0), "dict")], 100)
    got = pscan.scan_table(empty, device=CPU)
    assert got.num_rows == 0
    assert got[1].materialize().data.numel() == 0


def test_scan_all_null_columns():
    n = 3000
    none = np.zeros(n, bool)
    some = np.random.default_rng(5).random(n) < 0.5
    cols = [W.ParquetColumn("a", "INT64", np.arange(n), validity=none),
            W.ParquetColumn("b", "DOUBLE", np.arange(n) % 4.0, "dict", None,
                            None, none),
            W.strings_column("s", ["x"] * n, validity=none),
            W.strings_column("t", [f"v{i % 3}" for i in range(n)], some)]
    raw = W.write_parquet(cols, 1000)
    t = pq.read_table(io.BytesIO(raw))
    got = pscan.scan_table(raw, device=CPU)
    want = jscan.scan_table(raw)
    for name, p, j in zip(t.column_names, got.columns, want.columns):
        assert_column_equal(p, j)
        assert_matches_arrow(p, t[name])
    assert not _valid(got[2]).any()
    assert got[2].materialize().data.numel() == 0
    assert got[2].dictionary.num_rows == 0


def test_merged_dictionaries_rebase_codes():
    """Row groups write their dictionaries in first-occurrence order, so
    they differ: the dictionaries concatenate and the codes rebase, as the
    JAX scan's merge does."""
    raw, data, _ = W.lineitem_parquet(6000, 11, row_group_rows=2000)
    got = pscan.scan_table(raw, columns=["l_shipmode", "l_shipdate"],
                           device=CPU)
    want = _jax_scan(raw, columns=["l_shipmode", "l_shipdate"])
    assert got[0].dictionary.num_rows == 3 * 7
    assert_dict_equal(got[0], want[0])
    assert_column_equal(got[0], want[0])
    assert_column_equal(got[1], want[1])
    np.testing.assert_array_equal(got[1].data.numpy(), data["l_shipdate"])


def test_scanned_columns_own_their_storage():
    """PLAIN words come out of B7 as new tensors, the dictionary chars are
    copied: nothing the scan returns keeps the slab alive."""
    _, raw = _file(3, True)
    got = pscan.scan_table(raw, device=CPU)
    for c in got.columns:
        tensors = ([c.codes, c.dictionary.data, c.dictionary.offsets]
                   if isinstance(c, pt.DictColumn) else [c.data])
        for x in tensors:
            assert x.untyped_storage().nbytes() == x.numel() * x.element_size()


# ---------------------------------------------------------------------------
# DictColumn
# ---------------------------------------------------------------------------

def test_dict_column_materialize_matches_jax():
    t, raw = _file(3, True)
    names = ["opt_s_wide", "req_s_dict"]
    got = pscan.scan_table(raw, columns=names, device=CPU)
    want = [_jax_scan(raw)[t.column_names.index(c)] for c in names]
    for p, j in zip(got.columns, want):
        m, jm = p.materialize(), j.materialize()
        assert p.materialize() is m                   # memoized
        np.testing.assert_array_equal(m.data.numpy(), np.asarray(jm.data))
        np.testing.assert_array_equal(m.offsets.numpy(),
                                      np.asarray(jm.offsets))
        assert m.offsets.dtype == torch.int32
        assert p.to_pylist() == m.to_pylist()


def test_dict_column_rejects_bad_codes():
    dictionary = pt.Column.strings_from_list(["a", "bc"], device=CPU)
    col = pt.DictColumn(torch.tensor([0, 2], dtype=torch.int32), dictionary)
    with pytest.raises(IndexError):
        col.materialize()
    with pytest.raises(TypeError):
        pt.DictColumn(torch.tensor([0], dtype=torch.int64), dictionary)
    empty = pt.DictColumn(torch.zeros(2, dtype=torch.int32),
                          pt.Column.strings_from_list([], device=CPU),
                          torch.zeros(2, dtype=torch.bool))
    assert empty.materialize().offsets.tolist() == [0, 0, 0]


def test_scan_checks_dictionary_codes(monkeypatch):
    _, raw = _file(1, False)
    expand = rle_device.expand

    def bad(slab, runs, n):
        return expand(slab, runs, n) + 1000
    monkeypatch.setattr(rle_device, "expand", bad)
    with pytest.raises(ValueError, match="dictionary code"):
        pscan.scan_table(raw, columns=["req_i_dict"], device=CPU)


# ---------------------------------------------------------------------------
# Q6 and rows
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("null_fraction", [0.0, 0.1])
def test_q6_matches_jax(null_fraction):
    raw, data, valid = W.lineitem_parquet(12000, 3, row_group_rows=5000,
                                          null_fraction=null_fraction)
    lo, hi = 8766, 9131                        # [1994-01-01, 1995-01-01)
    revenue, matched = pq6.run(raw, lo, hi, device=CPU)
    j_revenue, j_matched = jq6.run(raw, lo, hi)
    assert matched == j_matched
    # both sum the same float64 products in different orders: they agree
    # to a few ulps of the total, far inside a relative 1e-12
    assert revenue == pytest.approx(j_revenue, rel=1e-12, abs=0)
    # and against numpy over the generator's arrays (nulls scan as 0)
    cols = {k: np.where(valid[k], data[k], 0) if k in valid else data[k]
            for k in pq6.COLUMNS}
    mask = ((cols["l_shipdate"] >= lo) & (cols["l_shipdate"] < hi)
            & (cols["l_discount"] >= 0.05 - 1e-9)
            & (cols["l_discount"] <= 0.07 + 1e-9) & (cols["l_quantity"] < 24))
    assert matched == int(mask.sum()) > 0
    want = float(np.sum(cols["l_extendedprice"][mask]
                        * cols["l_discount"][mask]))
    assert revenue == pytest.approx(want, rel=1e-12, abs=0)


ROW_COLUMNS = ["l_orderkey", "l_quantity", "l_returnflag", "l_shipdate",
               "l_shipinstruct", "l_shipmode", "l_linenumber"]


@pytest.mark.parametrize("null_fraction", [0.0, 0.1])
def test_rows_of_scanned_table_match_jax(null_fraction):
    raw, _, _ = W.lineitem_parquet(3000, 5, row_group_rows=1000,
                                   null_fraction=null_fraction)
    got = pscan.scan_table(raw, columns=ROW_COLUMNS, device=CPU)
    assert sum(isinstance(c, pt.DictColumn) for c in got.columns) == 3
    before = bytepath.launch_counts()
    rows = pt.convert_to_rows(got)
    assert bytepath.launch_counts() == before           # CPU: plain versions
    want = sr.convert_to_rows(_jax_scan(raw, columns=ROW_COLUMNS))
    assert len(rows) == len(want) == 1
    np.testing.assert_array_equal(rows[0].host_bytes(), want[0].host_bytes())
    np.testing.assert_array_equal(rows[0].offsets.numpy(),
                                  np.asarray(want[0].offsets))
    back = pt.convert_from_rows(rows[0], got.schema)
    for a, b in zip(got.columns, back.columns):
        np.testing.assert_array_equal(_valid(a), _valid(b))
        np.testing.assert_array_equal(a.data.numpy(), b.data.numpy())


def test_lineitem_scan_equals_generator():
    raw, data, valid = W.lineitem_parquet(9000, 2, row_group_rows=4096,
                                          null_fraction=0.1,
                                          pages_per_chunk=2)
    got = pscan.scan_table(raw, device=CPU)
    assert got.num_columns == len(W.LINEITEM) == 16
    for (name, *_), c in zip(W.LINEITEM, got.columns):
        v = valid[name]
        np.testing.assert_array_equal(_valid(c), v)
        if name == "l_comment":
            chars, offs = data[name]
            assert not isinstance(c, pt.DictColumn)
            assert c.to_pylist() == [chars[a:b].tobytes().decode() if m
                                     else None for a, b, m in
                                     zip(offs[:-1], offs[1:], v)]
        elif name in W.VOCAB:
            vocab = [e.decode() for e in W.VOCAB[name]]
            assert c.to_pylist() == [vocab[k] if m else None
                                     for k, m in zip(data[name], v)]
        else:
            np.testing.assert_array_equal(c.data.numpy(),
                                          np.where(v, data[name], 0))


# ---------------------------------------------------------------------------
# PLAIN strings
# ---------------------------------------------------------------------------

def _plain_string_file(row_groups, compression, page_version):
    """PLAIN strings REQUIRED and OPTIONAL (with empty strings and 20%
    nulls) beside a dictionary string and an int64, in pages of 500
    rows."""
    rng = np.random.default_rng(row_groups)
    lens = rng.integers(0, 40, N)
    text = [f"{'ab' * int(k)}{i}"[:int(k)] for i, k in enumerate(lens)]
    t = pa.table({
        "req_p": pa.array(text, pa.string()),
        "opt_p": pa.array([None if m else x for x, m in
                           zip(text[::-1], rng.random(N) < 0.2)], pa.string()),
        "d": pa.array([f"d{k % 5}" for k in lens], pa.string()),
        "i": pa.array(rng.integers(-9, 9, N), pa.int64()),
    })
    raw = _write(t, compression=compression, data_page_version=page_version,
                 use_dictionary=["d"], row_group_size=N // row_groups,
                 data_page_size=1, write_batch_size=500)
    return t, raw


@pytest.mark.parametrize("compression", ["NONE", "SNAPPY"])
@pytest.mark.parametrize("page_version", ["1.0", "2.0"])
@pytest.mark.parametrize("row_groups", [1, 3])
def test_plain_strings_match_jax_and_arrow(row_groups, compression,
                                           page_version):
    t, raw = _plain_string_file(row_groups, compression, page_version)
    got = pscan.scan_table(raw, device=CPU)
    want = _jax_scan(raw)
    for name, p, j in zip(t.column_names, got.columns, want.columns):
        if name.endswith("_p"):
            assert not isinstance(p, pt.DictColumn)
            assert p.offsets.dtype == torch.int32
        assert_column_equal(p, j)
        assert_matches_arrow(p, t[name])


def test_plain_strings_all_null_and_empty():
    n = 2000
    none = np.zeros(n, bool)
    empty = (np.zeros(0, np.uint8), np.zeros(n + 1, np.int64))
    cols = [W.plain_strings_column("nulls", *empty, validity=none),
            W.plain_strings_column("empties", *empty),
            W.plain_strings_column("one", np.frombuffer(b"xyz", np.uint8),
                                   np.r_[np.zeros(n, np.int64), 3])]
    raw = W.write_parquet(cols, 700)
    t = pq.read_table(io.BytesIO(raw))
    got = pscan.scan_table(raw, device=CPU)
    for name, p in zip(t.column_names, got.columns):
        assert_matches_arrow(p, t[name])
    assert got[0].data.numel() == 0 and got[0].offsets.tolist() == [0] * (n + 1)
    assert got[2].to_pylist()[-1] == "xyz"


def test_plain_strings_select_and_own_their_storage():
    """Row groups and columns selected; the chars are B4's own tensor, not
    a view of the slab."""
    t, raw = _plain_string_file(3, "NONE", "1.0")
    got = pscan.scan_table(raw, columns=["opt_p", "i"], row_groups=[2, 0],
                           device=CPU)
    rg = N // 3
    keep = np.r_[0:rg, 2 * rg:N]
    assert_matches_arrow(got[0], t["opt_p"].take(keep))
    for x in (got[0].data, got[0].offsets):
        assert x.untyped_storage().nbytes() == x.numel() * x.element_size()


def test_plain_strings_truncated_page_raises():
    cols = [W.plain_strings_column("s", np.frombuffer(b"abcdef", np.uint8),
                                   np.array([0, 2, 6], np.int64))]
    raw = bytearray(W.write_parquet(cols, 10))
    at = bytes(raw).index(b"\x04\x00\x00\x00cdef")
    raw[at] = 9                        # the second value now runs past
    with pytest.raises(ValueError, match="column s: PLAIN string page"):
        pscan.scan_table(bytes(raw), device=CPU)


def test_full_lineitem_to_rows_matches_jax(monkeypatch):
    """The slice as a whole: a 16-column lineitem file (PLAIN l_comment,
    nulls, several row groups) scanned and turned into rows by the port
    gives the JAX package's rows of the same file, byte for byte, through
    its default xpack engine; and back."""
    monkeypatch.setenv("SRJT_XPACK", "1")
    raw, _, _ = W.lineitem_parquet(1500, 8, row_group_rows=500,
                                   null_fraction=0.1)
    got = pscan.scan_table(raw, device=CPU)
    assert got.num_columns == 16 and not isinstance(got[15], pt.DictColumn)
    rows = pt.convert_to_rows(got)
    want = sr.convert_to_rows(_jax_scan(raw))
    assert len(rows) == len(want) == 1
    np.testing.assert_array_equal(rows[0].host_bytes(), want[0].host_bytes())
    np.testing.assert_array_equal(rows[0].offsets.numpy(),
                                  np.asarray(want[0].offsets))
    back = pt.convert_from_rows(rows[0], got.schema)
    for a, b in zip(got.columns, back.columns):
        np.testing.assert_array_equal(_valid(a), _valid(b))
        np.testing.assert_array_equal(a.data.numpy(), b.data.numpy())


# ---------------------------------------------------------------------------
# TPC-H Q1's scan types: FLBA and BYTE_ARRAY decimals, BOOLEAN
# ---------------------------------------------------------------------------

_CTX = decimal.Context(prec=60)
# (precision, the FLBA width pyarrow gives it, the port's type)
FLBA_CASES = ((4, 2, pt.decimal32(-2)), (12, 6, pt.decimal64(-2)),
              (38, 16, pt.decimal128(-2)))


def _unscaled(values, scale: int = 2) -> list:
    return [None if v is None else int(v.scaleb(scale, _CTX)) for v in values]


def _decimal_values(rng, precision: int, n: int, nulls: bool) -> list:
    top = 10 ** precision - 1
    vals = [int(v) for v in rng.integers(-min(top, 2**62), min(top, 2**62),
                                         n)]
    vals[:4] = [top, -top, -1, 0]
    if precision > 18:
        vals[4:n // 2] = [v * 10 ** (precision - 19) for v in vals[4:n // 2]]
    if nulls:
        vals = [None if m else v for v, m in zip(vals, rng.random(n) < 0.2)]
    return vals


def _scan_types_check(raw: bytes, arrow: pa.Table, dtypes) -> None:
    """The port's scan of every column equals the JAX scan and pyarrow's
    reading, and has the given types."""
    got = pscan.scan_table(raw, device=CPU)
    want = _jax_scan(raw)
    for i, name in enumerate(arrow.column_names):
        p = got[i]
        assert p.dtype == dtypes[i], name
        assert_column_equal(p, want[i])
        a = arrow[name].to_pylist()
        if pa.types.is_decimal(arrow[name].type):
            a = _unscaled(a, arrow[name].type.scale)
        if p.dtype == pt.bool8:
            a = [None if v is None else int(v) for v in a]
        if pa.types.is_date32(arrow[name].type):
            assert_matches_arrow(p, arrow[name])
            continue
        assert p.to_pylist() == a, name


@pytest.mark.parametrize("nulls", [False, True], ids=["req", "opt"])
@pytest.mark.parametrize("use_dictionary", [True, False], ids=["dict", "plain"])
def test_scan_flba_decimals_match_jax_and_arrow(use_dictionary, nulls):
    """FLBA decimals of 2, 6 and 16 bytes (decimal32, decimal64,
    decimal128 by precision), PLAIN and dictionary-encoded, over two row
    groups and several pages, with and without nulls."""
    rng = np.random.default_rng(31)
    n = 2000
    cols = {f"d{p}": pa.array([None if v is None else decimal.Decimal(v)
                               .scaleb(-2, _CTX)
                               for v in _decimal_values(rng, p, n, nulls)],
                              pa.decimal128(p, 2))
            for p, _, _ in FLBA_CASES}
    t = pa.table(cols)
    raw = _write(t, use_dictionary=use_dictionary, row_group_size=1200,
                 data_page_size=2048)
    md = pq.ParquetFile(io.BytesIO(raw)).metadata
    widths = [md.schema.column(i).length for i in range(len(FLBA_CASES))]
    assert widths == [w for _, w, _ in FLBA_CASES]
    _scan_types_check(raw, t, [dt for _, _, dt in FLBA_CASES])


@pytest.mark.parametrize("nulls", [False, True], ids=["req", "opt"])
@pytest.mark.parametrize("multi_page", [False, True], ids=["1page", "pages"])
def test_scan_boolean_matches_jax_and_arrow(multi_page, nulls):
    """PLAIN BOOLEAN, in one page a chunk or in pages whose value counts
    are not multiples of 8.  RLE booleans (data page v2), which the JAX
    package decodes on neither path, are refused."""
    rng = np.random.default_rng(32)
    n = 3001
    vals = [bool(v) for v in rng.integers(0, 2, n)]
    if nulls:
        vals = [None if m else v for v, m in zip(vals, rng.random(n) < 0.2)]
    t = pa.table({"b": pa.array(vals, pa.bool_()),
                  "i": pa.array(np.arange(n, dtype=np.int32))})
    kw = dict(data_page_size=64, write_batch_size=333) if multi_page else {}
    raw = _write(t, row_group_size=2000, **kw)
    _scan_types_check(raw, t, [pt.bool8, pt.int32])
    _refused(t, "RLE of BOOLEAN", data_page_version="2.0")


@pytest.mark.parametrize("nulls", [False, True], ids=["req", "opt"])
@pytest.mark.parametrize("encoding", ["plain", "dict"])
def test_scan_byte_array_decimals_match_jax_and_arrow(encoding, nulls):
    """BYTE_ARRAY decimals (each value in its fewest bytes, from the numpy
    writer) of precisions 9, 18 and 38, decoded on the device from their
    chars, against the JAX package's host decode and pyarrow."""
    rng = np.random.default_rng(33)
    n = 1500
    valid = rng.random(n) >= 0.2 if nulls else None
    cols, dtypes = [], []
    for precision, dt in ((9, pt.decimal32(-3)), (18, pt.decimal64(-3)),
                          (38, pt.decimal128(-3))):
        vals = _decimal_values(rng, precision, n, False)
        if precision == 38:
            vals[4:8] = [(1 << 127) - 1, -(1 << 127), 1 << 64, -(1 << 63)]
        cols.append(W.decimal_column(f"d{precision}", vals, precision, 3,
                                     encoding, valid, byte_array=True))
        dtypes.append(dt)
    raw = W.write_parquet(cols, 1000, pages_per_chunk=2)
    _scan_types_check(raw, pq.read_table(io.BytesIO(raw)), dtypes)


@pytest.mark.parametrize("null_fraction", [0.0, 0.1])
def test_q1_layout_file_matches_jax_arrow_and_generator(null_fraction):
    """The numpy writer's Q1 layout (FLBA DECIMAL(12,2) PLAIN, FLBA
    DECIMAL(4,2) dictionaries, INT64, DATE, dictionary strings) reads the
    same through the port, the JAX scan and pyarrow, and its decimals are
    the generator's cents."""
    raw, data, valid = W.lineitem_parquet(
        4000, 6, row_group_rows=1500, null_fraction=null_fraction,
        pages_per_chunk=2, columns=W.LINEITEM_Q1)
    _scan_types_check(raw, pq.read_table(io.BytesIO(raw)),
                      [pt.string, pt.string, pt.int64, pt.decimal64(-2),
                       pt.decimal32(-2), pt.decimal32(-2),
                       pt.timestamp_days])
    got = pscan.scan_table(raw, device=CPU)
    for name in W.Q1_DECIMALS:
        col = got[[n for n, *_ in W.LINEITEM_Q1].index(name)]
        want = data[name + "_unscaled"]
        if name in valid:
            want = np.where(valid[name], want, 0)
        np.testing.assert_array_equal(col.data.numpy(), want)


def test_byte_array_decimal_past_16_bytes_raises():
    for encoding in ("plain", "dict"):
        raw = W.write_parquet([W.decimal_column(
            "d", [1, 1 << 130], 38, 0, encoding, byte_array=True)], 10)
        with pytest.raises(ValueError, match="wider than 16 bytes"):
            pscan.scan_table(raw, device=CPU)


# ---------------------------------------------------------------------------
# what the scan refuses
# ---------------------------------------------------------------------------

def _refused(table: pa.Table, match: str, **kw):
    raw = _write(table, **kw)
    with pytest.raises(NotImplementedError, match=match):
        pscan.scan_table(raw, device=CPU)


def test_refuses_plain_strings():
    """A chunk whose dictionary filled up and went on in PLAIN pages used
    to be refused; it scans now (the JAX scan sends it to its host path),
    materialized, equal to the JAX scan and to pyarrow."""
    t = pa.table({"s": [f"value-{i}" for i in range(5000)]})
    raw = _write(t, dictionary_pagesize_limit=2000, data_page_size=1000,
                 write_batch_size=100)
    got = pscan.scan_table(raw, device=CPU)
    assert not isinstance(got[0], pt.DictColumn)
    assert_column_equal(got[0], jscan.scan_table(raw)[0])
    assert_matches_arrow(got[0], t["s"])


def test_refuses_boolean_and_delta():
    """BOOLEAN scans now (``test_scan_boolean_*``), and so does
    DELTA_BINARY_PACKED (decoded on the host, equal to the JAX scan);
    so does fixed-size binary that is no decimal, as a STRING of its
    width, equal to the JAX scan."""
    raw = _write(pa.table({"b": pa.array([b"ab", b"cd"], pa.binary(2))}))
    got = pscan.scan_table(raw, device=CPU)
    assert_column_equal(got[0], jscan.scan_table(raw)[0])
    assert bytes(got[0].data.numpy()) == b"abcd"
    t = pa.table({"i": np.arange(100, dtype=np.int64) * -7})
    raw = _write(t, use_dictionary=False,
                 column_encoding={"i": "DELTA_BINARY_PACKED"})
    got = pscan.scan_table(raw, device=CPU)
    assert got.host_decoded_cols == 1
    assert_column_equal(got[0], jscan.scan_table(raw)[0])
    assert_matches_arrow(got[0], t["i"])


def test_refuses_gzip_and_decimal_bytes():
    """GZIP pages scan now, equal to the JAX scan; FLBA decimals of up to
    16 bytes scan (``test_scan_flba_*``); a wider one, past DECIMAL128's
    lanes, is refused."""
    t = pa.table({"i": np.arange(10, dtype=np.int64)})
    raw = _write(t, compression="GZIP")
    got = pscan.scan_table(raw, device=CPU)
    assert_column_equal(got[0], jscan.scan_table(raw)[0])
    assert_matches_arrow(got[0], t["i"])
    import decimal
    _refused(pa.table({"x": pa.array([decimal.Decimal("1.25")],
                                     pa.decimal256(40, 2))}), "DECIMAL")


def test_list_columns_refused_only_when_selected():
    """LIST columns scan now (``tests/test_torch_scan_nested.py``): the
    whole file equals the JAX scan, and a selection without the list
    still reads only its columns."""
    raw = _write(pa.table({"id": np.arange(5, dtype=np.int64),
                           "l": pa.array([[i] for i in range(5)],
                                         pa.list_(pa.int32()))}))
    got = pscan.scan_table(raw, device=CPU)
    assert got[1].to_pylist() == [[i] for i in range(5)]
    assert got[1].to_pylist() == jscan.scan_table(raw)[1].to_pylist()
    got = pscan.scan_table(raw, columns=["id"], device=CPU)
    assert got[0].data.tolist() == list(range(5))


def test_bad_arguments():
    _, raw = _file(1, False)
    with pytest.raises(KeyError, match="nope"):
        pscan.scan_table(raw, columns=["nope"], device=CPU)
    with pytest.raises(IndexError):
        pscan.scan_table(raw, row_groups=[3], device=CPU)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            pscan.scan_table(raw)
    assert pscan.read_table is pscan.scan_table
