"""The port's scan of Parquet files as Spark and pyarrow write them, against
the JAX package's, on the CPU.

Each file goes through ``spark_rapids_jni_tpu_torch.parquet.device_scan.
scan_table`` (``device="cpu"``) and ``spark_rapids_jni_tpu.parquet.
device_scan.scan_table``, and every column must be the same value for value
(``tests/torch_jax_columns.py``; FLOAT64 as bits): SNAPPY and GZIP, data
pages v1 and v2, chunks whose dictionary fell back to PLAIN or DELTA pages,
INT96 timestamps (PLAIN and dictionary), each DELTA encoding, with and
without nulls.  ``rowgroup_predicate`` must keep the row groups the JAX
package's ``_prune_row_groups`` keeps.  The C decompressor is held against
both packages' Python decoders and pyarrow's compressor; broken pages must
raise ``ValueError``.  The lineitem writer's new options
(``tools/torch_lineitem_parquet.py``) are read back by pyarrow.
"""

import torch_one_thread  # noqa: F401  (first: one intra-op thread)
import decimal
import io
import pathlib
import sys
import zlib

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from spark_rapids_jni_tpu.parquet import decode as JD
from spark_rapids_jni_tpu.parquet import device_scan as jscan
from spark_rapids_jni_tpu.parquet import snappy as JS
from spark_rapids_jni_tpu.parquet.footer import extract_footer_bytes
from spark_rapids_jni_tpu.parquet.thrift import parse_struct

import spark_rapids_jni_tpu_torch as pt
from spark_rapids_jni_tpu_torch.parquet import decode as PD
from spark_rapids_jni_tpu_torch.parquet import device_scan as pscan
from spark_rapids_jni_tpu_torch.parquet import snappy as PS

from test_torch_scan import JAX_NATIVE_LOADED
from torch_jax_columns import assert_same

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent / "tools"))
import torch_lineitem_parquet as W  # noqa: E402

CPU = "cpu"
N = 3000


@pytest.fixture(scope="module", autouse=True)
def _jax_native_library():
    if not JAX_NATIVE_LOADED:
        pytest.fail("the JAX package's native library does not load")


@pytest.fixture(autouse=True)
def _jax_quick_paths(monkeypatch):
    # per-column JAX decode programs, cached across files of one shape
    # (held bit-identical to the fused scan by tests/test_bytepath.py)
    monkeypatch.setenv("SRJT_FUSED_SCAN", "0")


@pytest.fixture(autouse=True)
def _no_python_snappy(monkeypatch):
    """The scan never drops back to the Python decompressor."""
    def refuse(*args, **kw):
        raise AssertionError("the scan called parquet/snappy.py")
    monkeypatch.setattr(PS, "decompress", refuse)


def _write(table: pa.Table, **kw) -> bytes:
    buf = io.BytesIO()
    pq.write_table(table, buf, **kw)
    return buf.getvalue()


def _same_as_jax(raw: bytes, **kw) -> pt.Table:
    """Scan ``raw`` with both packages: every column the same, strings
    materialized on the port's side."""
    got = pscan.scan_table(raw, device=CPU, dict_strings=False, **kw)
    want = jscan.scan_table(raw, **kw)
    assert got.num_columns == want.num_columns
    assert got.num_rows == want.num_rows
    for i, (p, j) in enumerate(zip(got.columns, want.columns)):
        assert_same(p, j, what=f"column {i}")
    return got


def _run_kinds(raw: bytes) -> dict:
    """Each column's kinds of page runs, over its row groups, as the
    port's page walk finds them: "dict" and "plain" (PLAIN or DELTA)."""
    mv = memoryview(raw)
    meta = parse_struct(extract_footer_bytes(raw))
    leaves = PD.leaf_schema_elements(meta)
    out = {}
    for g in meta.get(PD.FMD.ROW_GROUPS).values:
        for leaf, chunk in zip(leaves, g.get(PD.RG.COLUMNS).values):
            walk = pscan._walk_chunk(mv, chunk, leaf)
            out.setdefault(leaf.name, set()).update(k for k, _ in walk.runs)
    return out


def _encodings(raw: bytes) -> dict:
    """Each column's encodings, over its row groups."""
    md = pq.ParquetFile(io.BytesIO(raw)).metadata
    out = {}
    for g in range(md.num_row_groups):
        for c in range(md.num_columns):
            col = md.row_group(g).column(c)
            out.setdefault(col.path_in_schema, set()).update(col.encodings)
    return out


def _maybe_null(rng, values, nulls: bool):
    if not nulls:
        return values
    return [None if m else v for v, m in zip(values, rng.random(len(values))
                                             < 0.1)]


def _fallback_table(rng, nulls: bool) -> pa.Table:
    """INT64, DOUBLE, FLBA DECIMAL and string columns with more distinct
    values than a small dictionary page holds."""
    cents = rng.integers(-10**12, 10**12, N)
    return pa.table({
        "i64": pa.array(_maybe_null(rng, rng.integers(0, 10**9, N).tolist(),
                                    nulls), pa.int64()),
        "f64": pa.array(_maybe_null(rng, rng.standard_normal(N).tolist(),
                                    nulls), pa.float64()),
        "dec": pa.array(_maybe_null(rng, [decimal.Decimal(int(c)).scaleb(-2)
                                          for c in cents], nulls),
                        pa.decimal128(18, 2)),
        "s": pa.array(_maybe_null(rng, [f"v{x}" for x in
                                        rng.integers(0, 2000, N)], nulls)),
        "k": pa.array(_maybe_null(rng, rng.integers(0, 7, N).tolist(),
                                  nulls), pa.int32()),
    })


# ---------------------------------------------------------------------------
# codecs, page versions, dictionary fallback
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nulls", [False, True], ids=["req", "nulls"])
@pytest.mark.parametrize("page_version", ["1.0", "2.0"])
@pytest.mark.parametrize("codec", ["SNAPPY", "GZIP"])
def test_fallback_chunks_match_jax(codec, page_version, nulls):
    """A dictionary that passes its page size falls back to PLAIN for the
    rest of the chunk: INT64, DOUBLE, FLBA decimal and string columns
    come out mixed, a small-domain column stays pure dictionary."""
    t = _fallback_table(np.random.default_rng(len(codec) + 3 * nulls), nulls)
    raw = _write(t, compression=codec, data_page_version=page_version,
                 dictionary_pagesize_limit=2000, data_page_size=1000,
                 write_batch_size=100, row_group_size=1000)
    kinds = _run_kinds(raw)
    for name in ("i64", "f64", "dec", "s"):
        assert kinds[name] == {"dict", "plain"}, name
    assert kinds["k"] == {"dict"}
    got = _same_as_jax(raw)
    assert got.host_decoded_cols == 0
    # a mixed string column comes back materialized even with dict_strings
    s = pscan.scan_table(raw, columns=["s"], device=CPU)[0]
    assert not isinstance(s, pt.DictColumn)
    assert s.to_pylist() == t["s"].to_pylist()


def test_row_groups_pure_and_mixed_are_mixed_as_a_whole():
    """One row group's chunk is pure dictionary, the next one's falls back:
    the column is mixed as a whole; codes of each group's dictionary stay
    its own on either side of a PLAIN run."""
    rng = np.random.default_rng(7)
    few = [f"a{x}" for x in rng.integers(0, 5, 1000)]
    many = [f"b{x}" for x in rng.integers(0, 3000, 1000)]
    again = [f"c{x}" for x in rng.integers(0, 9, 1000)]
    t = pa.table({"s": few + many + again,
                  "i": pa.array(rng.integers(0, 5, 1000).tolist()
                                + rng.integers(0, 10**9, 1000).tolist()
                                + rng.integers(7, 9, 1000).tolist(),
                                pa.int64())})
    raw = _write(t, compression="SNAPPY", dictionary_pagesize_limit=2000,
                 data_page_size=1000, write_batch_size=100,
                 row_group_size=1000)
    meta = parse_struct(extract_footer_bytes(raw))
    leaf = PD.leaf_schema_elements(meta)[0]
    groups = meta.get(PD.FMD.ROW_GROUPS).values
    assert [{k for k, _ in pscan._walk_chunk(
        memoryview(raw), g.get(PD.RG.COLUMNS).values[0], leaf).runs}
        for g in groups] == [{"dict"}, {"dict", "plain"}, {"dict"}]
    got = _same_as_jax(raw)
    assert got[0].to_pylist() == t["s"].to_pylist()
    assert got[1].data.tolist() == t["i"].to_pylist()


@pytest.mark.parametrize("page_version", [1, 2])
def test_byte_array_decimal_fallback_matches_jax(page_version):
    """BYTE_ARRAY decimals whose dictionary falls back to PLAIN (or, for
    the v2 writer, DELTA_BYTE_ARRAY) pages, with nulls: the dictionary
    runs and the PLAIN runs both decode from their chars."""
    rng = np.random.default_rng(page_version)
    vals = [int(v) for v in rng.integers(-10**17, 10**17, N)]
    vals[:5] = [0, -1, 1, (1 << 63) - 1, -(1 << 63)]
    cols = [W.decimal_column("d", vals, 38, 2, "dict",
                             rng.random(N) >= 0.1, byte_array=True),
            W.decimal_column("e", [v % 50 - 25 for v in vals], 9, 1, "dict",
                             byte_array=True)]
    raw = W.write_parquet(cols, 1000, dict_page_bytes=2000,
                          page_row_limit=100, page_version=page_version,
                          codec="SNAPPY")
    kinds = _run_kinds(raw)
    assert kinds == {"d": {"dict", "plain"}, "e": {"dict"}}
    got = _same_as_jax(raw)
    assert got[0].dtype == pt.decimal128(-2)
    assert got.host_decoded_cols == page_version - 1


# ---------------------------------------------------------------------------
# INT96 and the DELTA encodings
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dictionary", [False, True], ids=["plain", "dict"])
@pytest.mark.parametrize("nulls", [False, True], ids=["req", "nulls"])
def test_int96_matches_jax(dictionary, nulls):
    rng = np.random.default_rng(11 + nulls)
    ns = (rng.integers(-3 * 10**17, 3 * 10**17, N // 10).repeat(10)
          + rng.integers(0, 10**9, N))
    t = pa.table({"ts": pa.array(_maybe_null(rng, ns.tolist(), nulls),
                                 pa.timestamp("ns"))})
    raw = _write(t, use_deprecated_int96_timestamps=True,
                 use_dictionary=dictionary, compression="SNAPPY",
                 row_group_size=1000)
    assert pq.ParquetFile(io.BytesIO(raw)).schema.column(0).physical_type \
        == "INT96"
    assert _run_kinds(raw)["ts"] == ({"dict"} if dictionary else {"plain"})
    got = _same_as_jax(raw)
    assert got[0].dtype == pt.timestamp_ns
    assert got[0].to_pylist() == t["ts"].cast(pa.int64()).to_pylist()


def test_int96_wraps_as_the_jax_package():
    """Julian days at the ends of int32 and nanoseconds past a day: the
    port's int64 arithmetic wraps where the JAX package's does."""
    days = np.array([0, 1, -1, 2**31 - 1, -2**31, 2440588, 2440587],
                    np.int64) - W.JULIAN_UNIX_EPOCH
    nanos = np.array([0, 1, W.NS_PER_DAY - 1, 2**63 - 1, 12345,
                      W.NS_PER_DAY * 3, 7], np.int64)
    rec = np.empty((days.shape[0], 12), np.uint8)
    rec[:, :8] = nanos.astype("<i8").view(np.uint8).reshape(-1, 8)
    rec[:, 8:] = (days + W.JULIAN_UNIX_EPOCH).astype("<i4").view(
        np.uint8).reshape(-1, 4)
    col_bytes = rec.tobytes()
    raw = W.write_parquet([W.ParquetColumn("ts", "INT96", rec),
                           W.ParquetColumn("d", "INT96", rec, "dict")], 100)
    got = _same_as_jax(raw)
    want = JD._decode_int96(col_bytes, days.shape[0])
    np.testing.assert_array_equal(got[0].data.numpy(), want)
    np.testing.assert_array_equal(got[1].data.numpy(), want)


DELTA_CASES = {
    "binary_packed": {"i64": "DELTA_BINARY_PACKED",
                      "i32": "DELTA_BINARY_PACKED"},
    "length_byte_array": {"s": "DELTA_LENGTH_BYTE_ARRAY"},
    "byte_array": {"s": "DELTA_BYTE_ARRAY", "dec": "DELTA_BYTE_ARRAY"},
}


@pytest.mark.parametrize("nulls", [False, True], ids=["req", "nulls"])
@pytest.mark.parametrize("page_version", ["1.0", "2.0"])
@pytest.mark.parametrize("case", list(DELTA_CASES))
def test_delta_encodings_match_jax(case, page_version, nulls):
    rng = np.random.default_rng(len(case) + nulls)
    cents = rng.integers(-10**15, 10**15, N)
    t = pa.table({
        "i64": pa.array(_maybe_null(rng, rng.integers(-2**62, 2**62, N)
                                    .tolist(), nulls), pa.int64()),
        "i32": pa.array(_maybe_null(rng, np.sort(rng.integers(
            -2**31, 2**31, N)).tolist(), nulls), pa.int32()),
        "s": pa.array(_maybe_null(rng, sorted(
            f"prefix/{x:07d}" * int(x % 3) for x in
            rng.integers(0, 10**6, N)), nulls)),
        "dec": pa.array(_maybe_null(rng, [decimal.Decimal(int(c)).scaleb(-3)
                                          for c in cents], nulls),
                        pa.decimal128(18, 3)),
    })
    enc = DELTA_CASES[case]
    t = t.select(list(enc))
    raw = _write(t, use_dictionary=False, column_encoding=enc,
                 compression="SNAPPY", data_page_version=page_version,
                 data_page_size=2000, row_group_size=1000)
    for name, e in enc.items():
        assert e in _encodings(raw)[name]
    got = _same_as_jax(raw)
    assert got.host_decoded_cols == len(enc)
    for name, col in zip(t.column_names, got.columns):
        if name.startswith("i"):
            assert col.to_pylist() == t[name].to_pylist()


@settings(max_examples=40, deadline=None)
@given(st.lists(st.integers(-2**63, 2**63 - 1), min_size=1, max_size=400))
def test_delta_binary_packed_decoder_matches_jax(values):
    page = W.delta_binary_packed(np.array(values, np.int64))
    got, end = PD.decode_delta_binary_packed(page)
    want, jend = JD.decode_delta_binary_packed(page)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, values)
    assert end == jend == len(page)


@settings(max_examples=40, deadline=None)
@given(st.lists(st.binary(max_size=12), max_size=60))
def test_delta_byte_array_rebuild_matches_plain_and_jax(values):
    offs = np.zeros(len(values) + 1, np.int64)
    np.cumsum([len(v) for v in values], out=offs[1:])
    chars = np.frombuffer(b"".join(values), np.uint8)
    page = W.delta_byte_array(chars, offs)
    got, lens = PD.decode_delta_byte_array(page, len(values))
    jchars, jlens = JD._decode_delta_byte_array(page, len(values))
    assert got.tobytes() == jchars.tobytes() == b"".join(values)
    np.testing.assert_array_equal(lens, jlens)
    prefix, pos = PD.decode_delta_binary_packed(page)
    suffix, pos = PD.decode_delta_binary_packed(page, pos)
    plain = PD.delta_byte_array_plain(prefix, suffix, page[pos:])
    assert plain.tobytes() == got.tobytes()


def test_broken_delta_pages_raise():
    page = W.delta_byte_array(np.frombuffer(b"abcabd", np.uint8),
                              np.array([0, 3, 6], np.int64))
    for bad in (page[:3], page[:-2]):
        with pytest.raises(ValueError):
            PD.decode_delta_byte_array(bad, 2)
    # a prefix longer than the value before it
    broken = (W.delta_binary_packed(np.array([0, 9]))
              + W.delta_binary_packed(np.array([3, 1])) + b"abcd")
    with pytest.raises(ValueError, match="rebuild"):
        PD.decode_delta_byte_array(broken, 2)


# ---------------------------------------------------------------------------
# row-group pruning
# ---------------------------------------------------------------------------

def _pruning_file() -> tuple[pa.Table, bytes]:
    """Sorted keys, so that row groups hold disjoint ranges; ``nostat`` has
    no statistics."""
    n = 4000
    key = np.arange(n, dtype=np.int64) * 3
    t = pa.table({"key": key, "k32": (key // 3).astype(np.int32),
                  "name": [f"n{i:05d}" for i in range(n)],
                  "nostat": key + 1, "f": key / 7.0})
    raw = _write(t, row_group_size=1000, compression="SNAPPY",
                 write_statistics=["key", "k32", "name", "f"])
    return t, raw


def _jax_kept(raw: bytes, conds) -> list[int]:
    meta = parse_struct(extract_footer_bytes(raw))
    leaves = JD._leaf_schema_elements(meta)
    names = [leaf.name for leaf in leaves]
    return jscan._prune_row_groups(list(meta.get(JD.FMD.ROW_GROUPS).values),
                                   leaves, names, conds)


PREDICATES = {
    "eq_int": [("key", "eq", 3 * 1500)],
    "lt_int": [("key", "lt", 3 * 1000)],
    "le_int": [("key", "le", 3 * 1000)],
    "gt_int": [("k32", "gt", 2999)],
    "ge_int": [("k32", "ge", 2999)],
    "eq_bytes": [("name", "eq", b"n02500")],
    "lt_bytes": [("name", "lt", b"n01000")],
    "le_bytes": [("name", "le", b"n01000")],
    "gt_bytes": [("name", "gt", b"n02999")],
    "ge_bytes": [("name", "ge", b"n02999")],
    "pair": [("key", "ge", 3 * 900), ("key", "lt", 3 * 2100)],
    "type_mismatch": [("key", "eq", b"x"), ("name", "lt", 5)],
    "no_statistics": [("nostat", "lt", 0)],
    "float_kept": [("f", "lt", -1)],
    "no_such_column": [("nope", "eq", 1)],
    "all_pruned": [("key", "gt", 10**9)],
}


@pytest.mark.parametrize("case", list(PREDICATES))
def test_rowgroup_predicate_keeps_the_jax_groups(case):
    t, raw = _pruning_file()
    conds = PREDICATES[case]
    kept = _jax_kept(raw, conds)
    assert pscan._prune_row_groups(
        list(parse_struct(extract_footer_bytes(raw)).get(PD.FMD.ROW_GROUPS)
             .values),
        PD.leaf_schema_elements(parse_struct(extract_footer_bytes(raw))),
        conds) == kept
    got = pscan.scan_table(raw, rowgroup_predicate=conds, device=CPU,
                           columns=["key", "name"])
    rows = np.concatenate([np.arange(g * 1000, (g + 1) * 1000)
                           for g in kept] or [np.zeros(0, np.int64)])
    assert got[0].data.tolist() == t["key"].take(rows).to_pylist()
    assert got[1].to_pylist() == t["name"].take(rows).to_pylist()
    if case in ("no_statistics", "float_kept", "type_mismatch",
                "no_such_column"):
        assert kept == [0, 1, 2, 3]
    if case == "pair":
        assert kept == [0, 1, 2]


def test_rowgroup_predicate_intersects_row_groups():
    _, raw = _pruning_file()
    conds = PREDICATES["pair"]
    got = pscan.scan_table(raw, row_groups=[2, 3], rowgroup_predicate=conds,
                           device=CPU, columns=["key"])
    assert got[0].data.tolist() == list(range(6000, 9000, 3))


def test_all_pruned_returns_zero_rows_like_jax():
    t, raw = _pruning_file()
    conds = PREDICATES["all_pruned"]
    got = pscan.scan_table(raw, rowgroup_predicate=conds, device=CPU,
                           dict_strings=False)
    want = jscan.scan_table(raw, rowgroup_predicate=conds)
    assert got.num_rows == 0 and got.num_columns == t.num_columns
    for p, j in zip(got.columns, want.columns):
        assert_same(p, j)


# ---------------------------------------------------------------------------
# the C decompressor
# ---------------------------------------------------------------------------

@settings(max_examples=60, deadline=None)
@given(st.binary(max_size=3000), st.integers(0, 40))
def test_native_snappy_matches_python_and_pyarrow(data, repeat):
    data = data + data[:repeat] * repeat          # copies, overlapping too
    for block in (pa.compress(data, "snappy", asbytes=True),
                  W.snappy_compress(data)):
        got = PD.decompress(block, PD.CODEC_SNAPPY, len(data))
        assert bytes(got) == data
        assert JS.decompress(block, expected_size=len(data)) == data
    gz = zlib.compressobj(6, zlib.DEFLATED, 31)
    assert bytes(PD.decompress(gz.compress(data) + gz.flush(),
                               PD.CODEC_GZIP, len(data))) == data


def test_writer_snappy_uses_every_copy_element():
    """The greedy compressor's output holds literals and 1-, 2- and
    4-byte-offset copies, overlapping ones among them."""
    rng = np.random.default_rng(3)
    far = rng.integers(0, 256, 70000, dtype=np.uint8).tobytes()
    data = (b"hello, hello! " + b"ab" * 50 + b"xyzw0123" + far + b"xyzw0123"
            + far[:300] + far[:64])
    block = W.snappy_compress(data)
    assert len(block) < len(data)
    assert bytes(PD.decompress(block, PD.CODEC_SNAPPY, len(data))) == data
    kinds, pos = set(), 0
    while block[pos] & 0x80:
        pos += 1
    pos += 1
    while pos < len(block):
        tag = block[pos]
        kind = tag & 3
        kinds.add(kind)
        if kind == 0:
            ln = (tag >> 2) + 1
            extra = max(0, ln - 60)
            if extra:
                ln = int.from_bytes(block[pos + 1:pos + 1 + extra],
                                    "little") + 1
            pos += 1 + extra + ln
        else:
            pos += 1 + kind
    assert kinds == {0, 1, 2, 3}


@pytest.mark.parametrize("codec", ["SNAPPY", "GZIP"])
def test_broken_pages_raise_value_error(codec):
    data = bytes(range(256)) * 20
    code = {"SNAPPY": PD.CODEC_SNAPPY, "GZIP": PD.CODEC_GZIP}[codec]
    block = W.compress(data, codec)
    garbled = bytearray(block)
    garbled[len(garbled) // 2] ^= 0xFF
    garbled[-1] ^= 0xFF
    for bad, size in ((block[:len(block) // 2], len(data)),
                      (bytes(garbled), len(data)),
                      (block, len(data) + 1), (block, len(data) - 1),
                      (b"", len(data))):
        with pytest.raises(ValueError, match="column c"):
            PD.decompress(bad, code, size, "c")


def test_broken_snappy_page_in_a_file_raises():
    """A SNAPPY page the C decompressor rejects fails the scan with
    ``ValueError``; the Python decoder is never tried (the autouse
    fixture fails any call to it)."""
    t = pa.table({"i": np.arange(2000, dtype=np.int64)})
    raw = bytearray(_write(t, compression="SNAPPY", use_dictionary=False))
    md = pq.ParquetFile(io.BytesIO(bytes(raw))).metadata.row_group(0)
    start = md.column(0).data_page_offset
    stream = PD.PageStream(memoryview(bytes(raw))[start:])
    header, _ = stream.next_page()
    body = start + stream.pos - header.get(PD.PH.COMPRESSED_SIZE)
    # the Snappy block's length varint no longer matches the page header
    raw[body] ^= 0x01
    with pytest.raises(ValueError, match="SNAPPY page rejected"):
        pscan.scan_table(bytes(raw), device=CPU)


def test_unsupported_codec_still_refused():
    t = pa.table({"i": np.arange(10, dtype=np.int64)})
    raw = _write(t, compression="ZSTD")
    with pytest.raises(NotImplementedError, match="ZSTD"):
        pscan.scan_table(raw, device=CPU)


# ---------------------------------------------------------------------------
# the lineitem writer's options, read back by pyarrow
# ---------------------------------------------------------------------------

WRITER_OPTIONS = {
    "snappy": dict(codec="SNAPPY"),
    "gzip": dict(codec="GZIP"),
    "spark": dict(W.SPARK_DEFAULTS, dict_page_bytes=2048, page_row_limit=50),
    "spark_v2_int96": dict(W.SPARK_DEFAULTS, codec="GZIP",
                           dict_page_bytes=2048, page_row_limit=50,
                           page_version=2, int96_dates=True),
}


@pytest.mark.parametrize("nulls", [0.0, 0.1], ids=["req", "nulls"])
@pytest.mark.parametrize("option", list(WRITER_OPTIONS))
def test_writer_options_read_back_by_pyarrow(option, nulls):
    kw = WRITER_OPTIONS[option]
    raw, data, valid = W.lineitem_parquet(3000, 4, row_group_rows=1500,
                                          null_fraction=nulls, **kw)
    t = pq.read_table(io.BytesIO(raw))
    md = pq.ParquetFile(io.BytesIO(raw)).metadata
    codec = kw.get("codec", "UNCOMPRESSED")
    assert md.row_group(0).column(0).compression == codec
    enc = _encodings(raw)
    if "dict_page_bytes" in kw:
        fallback = ("DELTA_BINARY_PACKED" if kw.get("page_version") == 2
                    else "PLAIN")
        assert {"RLE_DICTIONARY", fallback} <= enc["l_orderkey"]
        assert ("DELTA_BYTE_ARRAY" in enc["l_comment"]) == (
            kw.get("page_version") == 2)
        kinds = _run_kinds(raw)
        for name in ("l_orderkey", "l_extendedprice", "l_comment",
                     "l_shipdate"):
            assert kinds[name] == {"dict", "plain"}, name
        assert kinds["l_shipmode"] == {"dict"}
    for name, *_ in W.LINEITEM:
        v = valid.get(name)
        got = t[name].to_pylist()
        if name == "l_comment":
            chars, offs = data[name]
            want = [chars[offs[i]:offs[i + 1]].tobytes().decode()
                    for i in range(3000)]
        elif name in W.VOCAB:
            want = [W.VOCAB[name][c].decode() for c in data[name]]
        elif name in ("l_shipdate", "l_commitdate", "l_receiptdate"):
            # days, read from DATE or from INT96 midnights
            unit = W.NS_PER_DAY if kw.get("int96_dates") else 1
            got = [None if g is None else g // unit
                   for g in t[name].cast(pa.int64()
                                         if unit > 1 else pa.int32())
                   .to_pylist()]
            want = data[name].tolist()
        else:
            want = data[name].tolist()
        if v is not None:
            want = [w if ok else None for w, ok in zip(want, v)]
            got = [g if ok else None for g, ok in zip(got, v)]
            assert t[name].null_count == int((~v).sum())
        assert got == want, name


@pytest.mark.parametrize("option", ["spark", "spark_v2_int96"])
def test_writer_spark_files_match_jax(option):
    """The writer's Spark-default files, v1 and v2 (INT96 dates, DELTA
    fallbacks, 10% nulls), scan the same through both packages."""
    kw = WRITER_OPTIONS[option]
    raw, _, _ = W.lineitem_parquet(3000, 5, row_group_rows=1500,
                                   null_fraction=0.1, **kw)
    got = _same_as_jax(raw)
    delta = [name for name, enc in _encodings(raw).items()
             if any(e.startswith("DELTA") for e in enc)]
    assert got.host_decoded_cols == len(delta)
    assert ("l_comment" in delta) == (option == "spark_v2_int96")
