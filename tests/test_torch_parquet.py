"""The port's host Parquet modules against the JAX package's, on the CPU.

``thrift``, ``footer``, ``snappy``, the RLE/bit-packed hybrid decoder, the
run-header walk and its device expansion (on CPU tensors) run on the same
pyarrow-written files and the same random streams as the JAX package's
modules, and must give the same trees, bytes and values.  The lineitem
writer that ``chip_smoke.py`` uses is read back by pyarrow, which checks it
apart from both scanners.
"""

import torch_one_thread  # noqa: F401  (first: one intra-op thread)
import datetime
import io
import pathlib
import sys
import zlib

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

from spark_rapids_jni_tpu.parquet import decode as JD
from spark_rapids_jni_tpu.parquet import footer as JF
from spark_rapids_jni_tpu.parquet import rle_device as JR
from spark_rapids_jni_tpu.parquet import snappy as JS
from spark_rapids_jni_tpu.parquet import thrift as JT

from spark_rapids_jni_tpu_torch.parquet import decode as PD
from spark_rapids_jni_tpu_torch.parquet import footer as PF
from spark_rapids_jni_tpu_torch.parquet import rle_device as PR
from spark_rapids_jni_tpu_torch.parquet import snappy as PS
from spark_rapids_jni_tpu_torch.parquet import thrift as PT

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent / "tools"))
import torch_lineitem_parquet as W  # noqa: E402


def _write(table: pa.Table, **kw) -> bytes:
    buf = io.BytesIO()
    pq.write_table(table, buf, **kw)
    return buf.getvalue()


def simple_file(n=100, row_group_size=None, compression="NONE") -> bytes:
    t = pa.table({
        "a": pa.array(np.arange(n, dtype=np.int64)),
        "B": pa.array(np.arange(n, dtype=np.int32)),
        "c": pa.array([f"s{i}" for i in range(n)]),
        "d": pa.array(np.arange(n, dtype=np.float64)),
    })
    return _write(t, row_group_size=row_group_size or n,
                  compression=compression)


def nested_file(n=10) -> bytes:
    t = pa.table({
        "id": pa.array(np.arange(n, dtype=np.int64)),
        "s": pa.array([{"x": i, "y": float(i)} for i in range(n)],
                      type=pa.struct([("x", pa.int32()), ("y", pa.float64())])),
        "l": pa.array([[i, i + 1] for i in range(n)],
                      type=pa.list_(pa.int32())),
        "m": pa.array([[(str(i), i)] for i in range(n)],
                      type=pa.map_(pa.string(), pa.int64())),
    })
    return _write(t)


def _tree(v):
    """A thrift value as plain Python, comparable across the packages."""
    if hasattr(v, "fields"):
        return [(f.fid, f.ttype, _tree(f.value)) for f in v.fields]
    if hasattr(v, "elem_type"):
        return (v.elem_type, [_tree(x) for x in v.values])
    if isinstance(v, (bytes, bytearray, memoryview)):
        return bytes(v)
    return v


# ---------------------------------------------------------------------------
# thrift
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("compression", ["NONE", "SNAPPY"])
@pytest.mark.parametrize("maker", ["simple", "nested"])
def test_thrift_parse_and_serialize_match_jax(compression, maker):
    raw = (simple_file(compression=compression, row_group_size=30)
           if maker == "simple" else nested_file())
    footer = PF.extract_footer_bytes(raw)
    assert footer == JF.extract_footer_bytes(raw)
    p, j = PT.parse_struct(footer), JT.parse_struct(footer)
    assert _tree(p) == _tree(j)
    assert PT.serialize_struct(p) == JT.serialize_struct(j) == footer


def test_thrift_errors_match_jax():
    for blob in (b"\x15", b"\x18\xff\xff\xff\xff\x0f", b"\x19\xfc"):
        with pytest.raises(JT.ThriftError):
            JT.parse_struct(blob)
        with pytest.raises(PT.ThriftError):
            PT.parse_struct(blob)


# ---------------------------------------------------------------------------
# footer pruning (the cases of tests/test_parquet_footer.py)
# ---------------------------------------------------------------------------

def _schemas(mod):
    S, V, L, M = (mod.StructElement, mod.ValueElement, mod.ListElement,
                  mod.MapElement)
    return {
        "subset": (S("root", V("a"), V("c")), False),
        "case_sensitive_miss": (S("root", V("b")), False),
        "case_insensitive": (S("root", V("b")), True),
        "missing_column": (S("root", V("a"), V("zz")), False),
        "upper_fold": (S("root", V("A"), V("D")), True),
        "full": (S("root", V("a"), V("B"), V("c"), V("d")), False),
        "nested_struct": (S("root", S("s", V("x")), V("id")), False),
        "list_and_map": (S("root", L("l", V("element")),
                           M("m", V("key"), V("value"))), False),
    }


@pytest.mark.parametrize("case", list(_schemas(PF)))
@pytest.mark.parametrize("split", ["all", "head", "none"])
def test_prune_matches_jax(case, split):
    raw_file = nested_file() if case in ("nested_struct", "list_and_map") \
        else simple_file(n=300, row_group_size=100)
    raw = PF.extract_footer_bytes(raw_file)
    part = {"all": (0, -1), "head": (0, len(raw_file) // 3),
            "none": (len(raw_file) + 100, 50)}[split]
    p_schema, fold = _schemas(PF)[case]
    j_schema, _ = _schemas(JF)[case]
    got = PF.read_and_filter(raw, *part, p_schema, ignore_case=fold)
    want = JF.read_and_filter(raw, *part, j_schema, ignore_case=fold)
    assert got.num_rows == want.num_rows
    assert got.num_columns == want.num_columns
    blob = got.serialize_thrift_file()
    assert blob == want.serialize_thrift_file()
    pq.read_metadata(io.BytesIO(blob))       # pyarrow accepts the footer


def test_prune_errors_match_jax():
    raw = PF.extract_footer_bytes(simple_file())
    for mod in (PF, JF):
        with pytest.raises(mod.PruneError):
            mod.read_and_filter(raw, 0, -1, mod.StructElement(
                "root", mod.StructElement("a", mod.ValueElement("x"))))
    with pytest.raises(ValueError, match="PAR1"):
        PF.extract_footer_bytes(b"nope" + raw)


# ---------------------------------------------------------------------------
# snappy
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["random", "repetitive", "text", "empty"])
def test_snappy_matches_jax(kind):
    rng = np.random.default_rng(len(kind))
    data = {"random": rng.integers(0, 256, 70000, dtype=np.uint8).tobytes(),
            "repetitive": b"abcabcabd" * 9000 + b"x" * 5000,
            "text": " ".join(f"word{i % 97}" for i in range(20000)).encode(),
            "empty": b""}[kind]
    comp = pa.compress(data, codec="snappy", asbytes=True)
    got = PS.decompress(comp, expected_size=len(data))
    assert got == data == JS.decompress(comp, expected_size=len(data))
    # the scan's C decompressor, which the Python one is the plain twin of
    assert bytes(PD.decompress(comp, PD.CODEC_SNAPPY, len(data))) == data
    with pytest.raises(PS.SnappyError):
        PS.decompress(comp, expected_size=len(data) + 1)


# ---------------------------------------------------------------------------
# RLE / bit-packed hybrid
# ---------------------------------------------------------------------------

def _hybrid_stream(rng, n, bw):
    """A hybrid stream mixing RLE runs and bit-packed runs of n values."""
    out = bytearray()
    vals = []
    while len(vals) < n:
        k = int(rng.integers(1, 60))
        if rng.random() < 0.5:
            v = int(rng.integers(0, 1 << bw))
            out += W._uleb(k << 1) + v.to_bytes((bw + 7) // 8, "little")
            vals += [v] * k
        else:
            groups = -(-k // 8)
            vs = rng.integers(0, 1 << bw, groups * 8)
            out += W.bit_packed_runs(vs, bw)
            vals += vs.tolist()
    return bytes(out), np.asarray(vals[:n], np.uint32)


@pytest.mark.parametrize("bw", [1, 2, 3, 7, 8, 12, 17, 24])
def test_rle_decode_parse_and_expand_match_jax(bw):
    rng = np.random.default_rng(bw)
    n = 3001
    buf, want = _hybrid_stream(rng, n, bw)
    np.testing.assert_array_equal(PD.decode_rle_bitpacked_hybrid(buf, bw, n),
                                  want)
    np.testing.assert_array_equal(JD.decode_rle_bitpacked_hybrid(buf, bw, n),
                                  want)
    p, j = PR.parse_runs(buf, bw, n), JR.parse_runs(buf, bw, n)
    for field in ("counts", "is_bp", "rle_vals", "bp_bit_base"):
        np.testing.assert_array_equal(getattr(p, field), getattr(j, field))
    assert p.payload == j.payload
    np.testing.assert_array_equal(PR.expand_np(p), JR.expand_np(j))
    for target in (0, int(want[0])):
        assert PR.present_count(p, target) == JR.present_count(j, target) \
            == int((want == target).sum())
    # the device expansion, on CPU tensors, from a slab with other bytes
    # around the payload and a rebase addend
    pre = b"\x07" * 5
    slab = torch.frombuffer(bytearray(pre + p.payload + b"\xff" * 3),
                            dtype=torch.uint8)
    runs = torch.from_numpy(PR.run_table(p, len(pre), addend=11))
    got = PR.expand(slab, runs, n).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64) + 11)


def test_rle_bw32_and_malformed_streams():
    rng = np.random.default_rng(32)
    vs = rng.integers(0, 1 << 32, 16, dtype=np.uint64)
    buf = W.bit_packed_runs(vs, 32)
    plan = PR.parse_runs(buf, 32, 16)
    slab = torch.frombuffer(bytearray(plan.payload), dtype=torch.uint8)
    got = PR.expand(slab, torch.from_numpy(PR.run_table(plan, 0)), 16)
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  vs.astype(np.uint32))
    with pytest.raises(ValueError):
        PR.parse_runs(buf[:5], 32, 16)          # payload cut short
    with pytest.raises(ValueError):
        PR.parse_runs(b"\x04\x01", 1, 10)       # 2 values, 10 expected
    with pytest.raises(ValueError):
        PR.parse_runs(buf, 33, 16)
    assert PR.expand(slab, torch.zeros((0, 5), dtype=torch.int64), 0).numel() == 0


# ---------------------------------------------------------------------------
# schema walk and page helpers
# ---------------------------------------------------------------------------

def test_leaf_schema_matches_jax():
    meta = PT.parse_struct(PF.extract_footer_bytes(nested_file()))
    jmeta = JT.parse_struct(JF.extract_footer_bytes(nested_file()))
    with pytest.raises(PD.NestedDecodeUnsupported, match="MAP"):
        PD.leaf_schema_elements(meta)
    with pytest.raises(JD.NestedDecodeUnsupported, match="MAP"):
        JD._leaf_schema_elements(jmeta)
    raw = _write(pa.table({
        "id": pa.array(np.arange(5, dtype=np.int64)),
        "s": pa.array([{"x": i} for i in range(5)],
                      type=pa.struct([("x", pa.int32())])),
        "l": pa.array([[i] for i in range(5)], type=pa.list_(pa.int32())),
        "dt": pa.array(np.arange(5, dtype=np.int32), type=pa.date32())}))
    p = PD.leaf_schema_elements(PT.parse_struct(PF.extract_footer_bytes(raw)))
    j = JD._leaf_schema_elements(JT.parse_struct(JF.extract_footer_bytes(raw)))
    assert [(a.name, a.path, a.max_def, a.max_rep) for a in p] == \
        [(b.name, b.path, b.max_def, b.max_rep) for b in j]
    assert [a.logical_dtype().id.name for a in p if a.max_rep == 0] == \
        [b.logical_dtype().id.name for b in j if b.max_rep == 0]


def test_plain_dictionary_page_decoders():
    vocab = [b"", b"a", b"hello", b"\xff\x00z"]
    page = b"".join(len(v).to_bytes(4, "little") + v for v in vocab)
    chars, offs = PD.decode_plain_strings(page, len(vocab))
    assert chars.tobytes() == b"".join(vocab)
    np.testing.assert_array_equal(offs, [0, 0, 1, 6, 9])
    with pytest.raises(ValueError):
        PD.decode_plain_strings(page[:-1], len(vocab))
    with pytest.raises(ValueError):
        PD.decode_plain_strings(page[:2], 1)
    chars, offs = PD.decode_plain_strings(b"", 0)
    assert chars.size == 0 and offs.tolist() == [0]
    # GZIP pages decompress now (zlib, gzip framing), as in the JAX package
    page = b"".join(len(v).to_bytes(4, "little") + v for v in vocab)
    gz = zlib.compressobj(6, zlib.DEFLATED, 31)
    packed = gz.compress(page) + gz.flush()
    assert bytes(PD.decompress(packed, PD.CODEC_GZIP, len(page))) == page
    assert JD._decompress(packed, JD.CODEC_GZIP, len(page)) == page


# ---------------------------------------------------------------------------
# the PLAIN string walker
# ---------------------------------------------------------------------------

def _records(lens, rng, tail=0):
    """A PLAIN BYTE_ARRAY page of random values of ``lens`` bytes, and
    ``tail`` more bytes after its records."""
    vals = [rng.integers(0, 256, int(k)).astype(np.uint8).tobytes()
            for k in lens]
    page = b"".join(len(v).to_bytes(4, "little") + v for v in vals)
    return page + bytes(tail)


# (lengths, trailing bytes): short and empty values, long values, one
# value, no value, bytes after the records (a page's other data)
WALK_CASES = {
    "short": (np.arange(300) % 7, 0),
    "empty_values": (np.zeros(50, np.int64), 0),
    "long": (np.array([5000, 0, 70000, 3]), 0),
    "one": (np.array([11]), 0),
    "none": (np.zeros(0, np.int64), 0),
    "tail": (np.arange(40) % 5 + 1, 13),
}


@pytest.mark.parametrize("case", list(WALK_CASES))
def test_byte_array_offsets_match_twin_and_jax(case):
    lens, tail = WALK_CASES[case]
    page = _records(lens, np.random.default_rng(len(case)), tail)
    n = lens.shape[0]
    want = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    got = PD.byte_array_offsets(page, n, "c")
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(PD.byte_array_offsets_plain(page, n), want)
    # a memoryview slice of a larger buffer walks the same
    view = memoryview(b"xy" + page)[2:]
    np.testing.assert_array_equal(PD.byte_array_offsets(view, n), want)
    # the JAX package's native walker, when its library loaded in this
    # process (it returns None otherwise)
    jax_offs = JD.byte_array_offsets(page, n)
    if jax_offs is not None:
        np.testing.assert_array_equal(got, jax_offs)


# (values, bytes cut from the end, values asked for)
TRUNCATED = [(3, 1, 3), (3, 9, 3), (3, 0, 4), (1, 2, 1), (0, 0, 1)]


@pytest.mark.parametrize("k,cut,n", TRUNCATED)
def test_byte_array_offsets_refuse_truncated_pages(k, cut, n):
    page = _records(np.full(k, 6), np.random.default_rng(k))
    page = page[:len(page) - cut]
    for walk in (PD.byte_array_offsets, PD.byte_array_offsets_plain):
        with pytest.raises(ValueError, match="column l_comment: PLAIN"):
            walk(page, n, "l_comment")
    if n:
        assert JD.byte_array_offsets(page, n) is None


# ---------------------------------------------------------------------------
# the lineitem writer, read back by pyarrow
# ---------------------------------------------------------------------------

def _expected(name, data, valid):
    v = data[name]
    if name == "l_comment":
        chars, offs = v
        out = [chars[a:b].tobytes().decode()
               for a, b in zip(offs[:-1], offs[1:])]
    elif name in W.VOCAB:
        out = [W.VOCAB[name][c].decode() for c in v]
    elif name in ("l_shipdate", "l_commitdate", "l_receiptdate"):
        out = [datetime.date(1970, 1, 1) + datetime.timedelta(days=int(d))
               for d in v]
    else:
        out = v.tolist()
    if name in valid:
        out = [x if m else None for x, m in zip(out, valid[name])]
    return out


@pytest.mark.parametrize("null_fraction,pages,rg", [(0.0, None, 4000),
                                                    (0.1, 2, 2500),
                                                    (0.5, 3, 10000)])
def test_writer_read_back_by_pyarrow(null_fraction, pages, rg):
    n = 10000
    raw, data, valid = W.lineitem_parquet(n, 7, row_group_rows=rg,
                                          null_fraction=null_fraction,
                                          pages_per_chunk=pages,
                                          data_page_bytes=8192)
    f = pq.ParquetFile(io.BytesIO(raw))
    assert f.metadata.num_rows == n
    assert f.metadata.num_row_groups == -(-n // rg)
    t = f.read()
    for name, phys, conv, enc in W.LINEITEM:
        assert t[name].to_pylist() == _expected(name, data, valid), name
    # statistics: pyarrow decodes the writer's min/max
    st = f.metadata.row_group(0).column(0).statistics
    head = data["l_orderkey"][:rg]
    if "l_orderkey" in valid:
        head = head[valid["l_orderkey"][:rg]]
    assert st.min == head.min() and st.max == head.max()


def test_lineitem_distributions():
    data = W.generate_lineitem(20000, 1)
    assert len(data["l_orderkey"]) == 20000
    assert set(np.unique(data["l_linenumber"])) <= set(range(1, 8))
    assert data["l_quantity"].min() >= 1 and data["l_quantity"].max() <= 50
    assert data["l_discount"].max() <= 0.10 and data["l_tax"].max() <= 0.08
    ship, commit, receipt = (data[k] for k in ("l_shipdate", "l_commitdate",
                                               "l_receiptdate"))
    assert ((receipt - ship >= 1) & (receipt - ship <= 30)).all()
    assert (data["l_linestatus"] == (ship > W.CURRENT_DATE)).all()
    flag = data["l_returnflag"]
    assert (flag[receipt > W.CURRENT_DATE] == 1).all()       # 'N'
    assert set(np.unique(flag[receipt <= W.CURRENT_DATE])) == {0, 2}
    assert (np.diff(data["l_orderkey"]) >= 0).all()


def test_lineitem_comments():
    """l_comment: 10-43 chars of the grammar's words, from a generator of
    its own, so the other 15 columns are the same with or without it."""
    chars, offs = W.generate_comments(20000, 1)
    lens = np.diff(offs)
    assert lens.min() == W.COMMENT_LEN[0] and lens.max() == W.COMMENT_LEN[1]
    comments = [chars[a:b].tobytes().decode("ascii")
                for a, b in zip(offs[:2000], offs[1:2001])]
    tokens = {t for c in comments for t in c.split()}
    assert len(tokens) > 100
    # a comment may start or end inside a word
    assert tokens <= {w for c in W.COMMENT_WORDS for w in _cuts(c)}
    again = W.generate_comments(20000, 1)
    np.testing.assert_array_equal(again[0], chars)
    raw16, data16, _ = W.lineitem_parquet(3000, 4, row_group_rows=1000)
    raw15, data15, _ = W.lineitem_parquet(3000, 4, row_group_rows=1000,
                                          columns=W.LINEITEM_NO_COMMENT)
    t16 = pq.read_table(io.BytesIO(raw16))
    t15 = pq.read_table(io.BytesIO(raw15))
    assert t16.column_names == [c[0] for c in W.LINEITEM]
    assert t15.column_names == t16.column_names[:15]
    assert t16.select(t15.column_names).equals(t15)
    assert "l_comment" not in data15
    md = pq.ParquetFile(io.BytesIO(raw16)).metadata.row_group(0).column(15)
    assert md.encodings == ("PLAIN", "RLE")


def _cuts(word):
    """A word and every piece of it a comment may start or end with."""
    return {word[i:j] for i in range(len(word)) for j in range(i + 1,
                                                               len(word) + 1)}
