"""JCUDF row conversion: the PyTorch port against the JAX package, on the CPU.

Each case makes one table with numpy from a seed and hands it to both
packages.  The port's ``convert_to_rows`` must give the JAX package's bytes
and offsets, batch for batch, and the numpy oracle's; rows cross between the
packages in both directions and come back column for column.  Exact byte
equality throughout.

The JAX side runs with ``SRJT_XPACK=0``: off a TPU that takes its XLA
gather formulation, which the JAX package holds bit-identical to its
default xpack engine and which compiles far faster on the CPU.  The port
packs its rows through kernel B1, the xpack contract, either way;
``tests/test_torch_xpack.py`` holds it against the JAX package's xpack
engine itself.
"""

import torch_one_thread  # noqa: F401  (first: one intra-op thread)
import numpy as np
import pytest
import torch

import jax.numpy as jnp
import spark_rapids_jni_tpu as sr
from spark_rapids_jni_tpu.rowconv import convert as jconvert
from spark_rapids_jni_tpu.rowconv import reference as jref

import spark_rapids_jni_tpu_torch as pt
from spark_rapids_jni_tpu_torch import interop
from spark_rapids_jni_tpu_torch.rowconv import convert as pconvert
from spark_rapids_jni_tpu_torch.rowconv import reference as pref

CPU = "cpu"
STRING = int(pt.TypeId.STRING)


@pytest.fixture(autouse=True)
def _jax_without_xpack(monkeypatch):
    monkeypatch.setenv("SRJT_XPACK", "0")


# ---------------------------------------------------------------------------
# tables as numpy column tuples (type_id, scale, data, offsets, validity)
# ---------------------------------------------------------------------------

def _validity(rng, n, pattern):
    if pattern == "all":
        return None
    if pattern == "none":
        return np.zeros(n, dtype=bool)
    return rng.random(n) < (0.9 if pattern == "most" else 0.1)


def make_column(rng, name, n, pattern="all", max_len=12, scale=0):
    tid = pt.TypeId[name]
    valid = _validity(rng, n, pattern)
    if tid == pt.TypeId.STRING:
        lens = rng.integers(0, max_len + 1, n)
        offs = np.zeros(n + 1, dtype=np.int32)
        np.cumsum(lens, out=offs[1:])
        chars = rng.integers(32, 127, int(offs[-1])).astype(np.uint8)
        return (int(tid), 0, chars, offs, valid)
    if tid == pt.TypeId.DECIMAL128:
        data = rng.integers(-2**62, 2**62, (n, 2), dtype=np.int64)
    elif tid == pt.TypeId.BOOL8:
        data = rng.integers(0, 2, n).astype(np.uint8)
    else:
        st = pt.DType(tid).storage
        if st.kind == "f":
            data = rng.standard_normal(n).astype(st)
        else:
            info = np.iinfo(st)
            data = rng.integers(info.min // 2, info.max // 2, n, dtype=st)
    return (int(tid), scale, data, None, valid)


def to_jax_table(cols):
    out = []
    for tid, scale, data, offs, valid in cols:
        dt = sr.DType(sr.TypeId(tid), scale)
        v = None if valid is None else jnp.asarray(valid)
        if tid == STRING:
            out.append(sr.Column(dt, jnp.asarray(data), jnp.asarray(offs), v))
        elif dt.id == sr.TypeId.DECIMAL128:
            out.append(sr.Column(dt, jnp.asarray(data), validity=v))
        else:
            out.append(sr.Column.from_numpy(data, dt, valid))
    return sr.Table(out)


def from_jax_table(table):
    out = []
    for c in table.columns:
        valid = None if c.validity is None else np.asarray(c.validity)
        if c.dtype.is_variable_width:
            out.append((int(c.dtype.id), 0, np.asarray(c.data),
                        np.asarray(c.offsets), valid))
        else:
            out.append((int(c.dtype.id), c.dtype.scale,
                        np.asarray(c.to_numpy()), None, valid))
    return out


def assert_columns_equal(want, got):
    assert len(want) == len(got)
    for ci, (a, b) in enumerate(zip(want, got)):
        assert a[:2] == b[:2], f"column {ci} type"
        n = (a[3].shape[0] - 1) if a[3] is not None else a[2].shape[0]
        va = np.ones(n, bool) if a[4] is None else np.asarray(a[4])
        vb = np.ones(n, bool) if b[4] is None else np.asarray(b[4])
        np.testing.assert_array_equal(va, vb, err_msg=f"column {ci} validity")
        np.testing.assert_array_equal(
            np.ascontiguousarray(a[2]).view(np.uint8),
            np.ascontiguousarray(b[2]).view(np.uint8),
            err_msg=f"column {ci} data")
        if a[3] is not None:
            np.testing.assert_array_equal(a[3], b[3],
                                          err_msg=f"column {ci} offsets")


def check_table(cols, max_batch_bytes=None, cross_feed=True):
    """Port bytes == JAX bytes == oracle bytes; both round trips; rows
    cross between the packages.  Returns the port's batches."""
    ptable = interop.table_from_numpy(cols, device=CPU)
    jtable = to_jax_table(cols)
    pb = pt.convert_to_rows(ptable, max_batch_bytes)
    jb = sr.convert_to_rows(jtable, max_batch_bytes)
    assert len(pb) == len(jb)
    for p, j in zip(pb, jb):
        assert p.data.dtype == torch.uint8 and p.offsets.dtype == torch.int32
        np.testing.assert_array_equal(p.host_bytes(), j.host_bytes())
        np.testing.assert_array_equal(p.offsets.numpy(), np.asarray(j.offsets))

    want_bytes, want_offs = pref.to_rows_np(ptable)
    np.testing.assert_array_equal(
        np.concatenate([p.host_bytes() for p in pb]), want_bytes)
    if len(pb) == 1:
        np.testing.assert_array_equal(pb[0].offsets.numpy(), want_offs)
        jbytes, _ = jref.to_rows_np(jtable)
        np.testing.assert_array_equal(want_bytes, jbytes)
        # the oracle reads its own rows back
        assert_columns_equal(cols, interop.table_to_numpy(
            pref.from_rows_np(want_bytes, want_offs, ptable.schema, CPU)))

    schema = ptable.schema
    jschema = jtable.schema
    lo = 0
    for p, j in zip(pb, jb):
        hi = lo + p.num_rows
        part = _slice_cols(cols, lo, hi)
        back = interop.table_to_numpy(pt.convert_from_rows(p, schema))
        assert_columns_equal(part, back)
        if cross_feed:
            # JAX rows into the port, port rows into JAX
            jrows = interop.batch_from_numpy(j.host_bytes(),
                                             np.asarray(j.offsets), CPU)
            assert_columns_equal(part, interop.table_to_numpy(
                pt.convert_from_rows(jrows, schema)))
            prows = jconvert.RowBatch(jnp.asarray(p.host_bytes()),
                                      jnp.asarray(p.offsets.numpy()))
            assert_columns_equal(part, from_jax_table(
                sr.convert_from_rows(prows, jschema)))
        lo = hi
    return pb


def _slice_cols(cols, lo, hi):
    out = []
    for tid, scale, data, offs, valid in cols:
        v = None if valid is None else valid[lo:hi]
        if offs is not None:
            o = offs[lo:hi + 1]
            out.append((tid, scale, data[o[0]:o[-1]], o - o[0], v))
        else:
            out.append((tid, scale, data[lo:hi], None, v))
    return out


# ---------------------------------------------------------------------------
# fixed width
# ---------------------------------------------------------------------------

TYPE_MATRIX = ["INT8", "INT16", "INT32", "INT64", "UINT8", "UINT16",
               "UINT32", "UINT64", "FLOAT32", "FLOAT64", "BOOL8",
               "TIMESTAMP_MILLISECONDS", "TIMESTAMP_DAYS", "DURATION_SECONDS",
               "DECIMAL32", "DECIMAL64", "DECIMAL128"]


@pytest.mark.parametrize("pattern", ["all", "none", "most", "few"])
def test_type_matrix_with_validity(pattern):
    rng = np.random.default_rng(len(pattern))
    cols = [make_column(rng, name, 97, pattern,
                        scale=-2 if name.startswith("DECIMAL") else 0)
            for name in TYPE_MATRIX]
    check_table(cols)


def test_single_int64_column():
    check_table([make_column(np.random.default_rng(1), "INT64", 17)])


def test_non_power_of_two_shape():
    rng = np.random.default_rng(557)
    kinds = ["INT8", "INT16", "INT32", "INT64", "FLOAT32"]
    check_table([make_column(rng, kinds[i % 5], 557, "most")
                 for i in range(131)], cross_feed=False)


def test_float64_and_decimal128_special_values():
    f = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 5e-324,
                  np.finfo(np.float64).max, -1.5], dtype=np.float64)
    d = np.array([[0, 0], [-1, -1], [-1, 0], [0, -2**63], [2**63 - 1, 2**63 - 1],
                  [1, 0], [0, 1], [-2**63, -1]], dtype=np.int64)
    cols = [(int(pt.TypeId.FLOAT64), 0, f, None, None),
            (int(pt.TypeId.INT8), 0, np.arange(8, dtype=np.int8), None, None),
            (int(pt.TypeId.DECIMAL128), -4, d, None,
             np.array([1, 0, 1, 1, 1, 0, 1, 1], bool))]
    check_table(cols)


def test_multi_batch_fixed():
    rng = np.random.default_rng(200)
    pb = check_table([make_column(rng, "INT64", 200, "most"),
                      make_column(rng, "INT16", 200)], max_batch_bytes=1024)
    assert len(pb) > 1


def test_zero_rows_fixed():
    check_table([make_column(np.random.default_rng(0), "INT32", 0),
                 make_column(np.random.default_rng(0), "INT64", 0)])


def test_fixed_width_optimized_parity():
    rng = np.random.default_rng(64)
    cols = [make_column(rng, "INT32", 64), make_column(rng, "INT64", 64)]
    t = interop.table_from_numpy(cols, device=CPU)
    a = pt.convert_to_rows(t)[0]
    b = pconvert.convert_to_rows_fixed_width_optimized(t)[0]
    assert torch.equal(a.data, b.data)
    back = pconvert.convert_from_rows_fixed_width_optimized(b, t.schema)
    assert_columns_equal(cols, interop.table_to_numpy(back))
    s = interop.table_from_numpy([make_column(rng, "STRING", 4)], device=CPU)
    with pytest.raises(ValueError, match="fixed-width"):
        pconvert.convert_to_rows_fixed_width_optimized(s)
    with pytest.raises(ValueError, match="fixed-width"):
        pconvert.convert_from_rows_fixed_width_optimized(a, s.schema)


def test_from_rows_rejects_wrong_byte_count():
    rng = np.random.default_rng(5)
    t = interop.table_from_numpy([make_column(rng, "INT32", 10)], device=CPU)
    b = pt.convert_to_rows(t)[0]
    short = pt.RowBatch(b.data[:-8], b.offsets)
    with pytest.raises(ValueError, match="bytes"):
        pt.convert_from_rows(short, t.schema)


# ---------------------------------------------------------------------------
# strings
# ---------------------------------------------------------------------------

def _string_table(rng, n, nvar, pattern, max_len=12):
    """nvar string columns, each followed by a fixed-width one."""
    kinds = ["INT32", "INT64", "INT8", "FLOAT32", "INT16", "BOOL8"]
    cols = []
    for i in range(nvar):
        cols.append(make_column(rng, "STRING", n, pattern, max_len))
        cols.append(make_column(rng, kinds[i % len(kinds)], n, pattern))
    return cols


@pytest.mark.parametrize("nvar", [1, 2, 16])
@pytest.mark.parametrize("pattern", ["all", "most", "few"])
def test_string_columns(nvar, pattern):
    rng = np.random.default_rng(nvar * 10 + len(pattern))
    check_table(_string_table(rng, 61, nvar, pattern))


def test_spark_shaped_strings():
    """The 12-column schema with two 0-39 char strings of the reference's
    Spark-shaped benchmark."""
    rng = np.random.default_rng(12)
    kinds = ["INT64", "INT32", "INT16", "INT8", "FLOAT32", "BOOL8"]
    cols = [make_column(rng, "STRING", 150, "most", 39) if i % 6 == 0
            else make_column(rng, kinds[i % 6], 150, "most")
            for i in range(12)]
    check_table(cols)


def test_strings_only_table():
    rng = np.random.default_rng(2)
    check_table([make_column(rng, "STRING", 40, "few", 30)])


def test_long_strings_near_row_limit():
    rng = np.random.default_rng(3)
    cols = [make_column(rng, "STRING", 20, "all", 450),
            make_column(rng, "INT64", 20),
            make_column(rng, "STRING", 20, "all", 450)]
    check_table(cols)


def test_row_over_limit_raises():
    cols = [(STRING, 0, np.zeros(1100, np.uint8),
             np.array([0, 1100], np.int32), None)]
    with pytest.raises(ValueError, match="exceeds JCUDF limit"):
        pt.convert_to_rows(interop.table_from_numpy(cols, device=CPU))


def test_empty_strings_only():
    cols = [(STRING, 0, np.zeros(0, np.uint8), np.zeros(4, np.int32), None),
            make_column(np.random.default_rng(4), "INT8", 3)]
    check_table(cols)


def test_all_null_columns():
    rng = np.random.default_rng(6)
    cols = [make_column(rng, "STRING", 33, "none"),
            make_column(rng, "INT32", 33, "none"),
            make_column(rng, "STRING", 33, "none")]
    check_table(cols)


def test_zero_rows_strings():
    cols = [(STRING, 0, np.zeros(0, np.uint8), np.zeros(1, np.int32), None),
            (int(pt.TypeId.INT16), 0, np.zeros(0, np.int16), None, None)]
    pb = check_table(cols)
    assert pb[0].num_rows == 0 and pb[0].num_bytes == 0


def test_multi_batch_strings():
    rng = np.random.default_rng(9)
    pb = check_table(_string_table(rng, 300, 2, "most", 20),
                     max_batch_bytes=4096)
    assert len(pb) > 2


def test_strings_with_offset_base():
    """A string column whose offsets do not start at zero (a view into a
    larger chars buffer) gives the same rows as its rebased copy."""
    rng = np.random.default_rng(10)
    base = make_column(rng, "STRING", 50, "most", 9)
    pad = rng.integers(32, 127, 17).astype(np.uint8)
    shifted = (STRING, 0, np.concatenate([pad, base[2]]), base[3] + 17,
               base[4])
    other = make_column(rng, "INT32", 50)
    for nvar_cols in ([base, other], [base, other, base]):
        want = pt.convert_to_rows(interop.table_from_numpy(nvar_cols, CPU))
        moved = [shifted if c is base else c for c in nvar_cols]
        got = pt.convert_to_rows(interop.table_from_numpy(moved, CPU))
        assert torch.equal(got[0].data, want[0].data)


# ---------------------------------------------------------------------------
# the row matrix of a batch with strings, built in place
# ---------------------------------------------------------------------------

# (schema, rows, null pattern, longest string, max_batch_bytes, the
# fixed_plus_validity it must have or None): one string column (one B4
# segment a row) alone and beside fixed columns, the chars starting at
# fixed_plus_validity % 8 = 2, 4 and 6, no chars at all (empty or null
# strings), the widest rows the layout allows, one row, and batches split
# by a small cap
INPLACE_CASES = {
    "one_string_column": (["STRING"], 90, "most", 39, None, 9),
    "one_string_beside_fixed": (["INT64", "STRING", "INT32"], 70, "most", 39,
                                None, None),
    "fpv_mod8_2": (["STRING", "INT8"], 60, "most", 21, None, 10),
    "fpv_mod8_4": (["STRING", "INT16", "INT8"], 60, "few", 21, None, 12),
    "fpv_mod8_6": (["STRING", "INT32", "INT8"], 60, "most", 21, None, 14),
    "fpv_mod8_6_two_strings": (["STRING", "INT32", "STRING", "INT8"], 60,
                               "all", 13, None, 22),
    "all_chars_empty": (["STRING", "INT64", "STRING"], 40, "all", 0, None,
                        None),
    "every_string_null": (["STRING", "INT16", "STRING"], 40, "none", 20,
                          None, None),
    "one_row": (["STRING", "INT64"], 1, "all", 30, None, None),
    "three_strings_mixed": (["STRING", "STRING", "FLOAT64", "STRING"], 80,
                            "few", 17, None, None),
    "split_batches": (["STRING", "INT32", "STRING"], 300, "most", 20, 2048,
                      None),
    "split_batches_one_string": (["INT8", "STRING"], 300, "most", 30, 1500,
                                 None),
}


def _spy(monkeypatch, module, name, calls):
    fn = getattr(module, name)

    def wrapper(*args):
        calls[name] += 1
        return fn(*args)
    monkeypatch.setattr(module, name, wrapper)


def _to_rows_calls(monkeypatch) -> dict:
    """Count the calls of the ragged kernels' and B1's wrappers."""
    from spark_rapids_jni_tpu_torch.rowconv import ragged, xpack
    calls = {"segmented_copy": 0, "unpack_rows": 0, "pack_windows": 0}
    _spy(monkeypatch, ragged, "segmented_copy", calls)
    _spy(monkeypatch, ragged, "unpack_rows", calls)
    _spy(monkeypatch, xpack, "pack_windows", calls)
    return calls


@pytest.mark.parametrize("case", list(INPLACE_CASES))
def test_to_rows_row_matrix_in_place(case, monkeypatch):
    """Each batch's chars go into its row matrix by one B4 call (no B3
    tile, no concatenate), then B1 packs it: the bytes equal the JAX
    package's and the oracle's, batch for batch."""
    kinds, n, pattern, max_len, cap, fpv = INPLACE_CASES[case]
    rng = np.random.default_rng(len(case) * 7 + n)
    cols = [make_column(rng, k, n, pattern if k == "STRING" else "most",
                        max_len) for k in kinds]
    layout = pt.compute_row_layout(
        interop.table_from_numpy(cols, device=CPU).schema)
    if fpv is not None:
        assert layout.fixed_plus_validity == fpv
    calls = _to_rows_calls(monkeypatch)
    pb = check_table(cols, cap, cross_feed=False)
    chars = sum(int(np.asarray(c[3])[-1]) for c in cols if c[3] is not None)
    assert calls["pack_windows"] == len(pb)
    assert calls["unpack_rows"] == len(pb)          # from_rows' fixed region
    with_chars = len(pb) if chars else 0
    # to_rows: one B4 a batch with chars; from_rows: one B4 a batch
    assert calls["segmented_copy"] == with_chars + len(pb)
    if cap is not None:
        assert len(pb) > 2


def test_to_rows_widest_rows_in_place():
    """Rows of 1,024 bytes, the most the layout allows: a row matrix of
    M = 1024 whose chars run to its last byte."""
    rng = np.random.default_rng(1024)
    n = 12
    lens = rng.integers(990, 1008, n)
    lens[3] = 1007                        # 17 fixed bytes + 1007 chars
    offs = np.zeros(n + 1, np.int32)
    np.cumsum(lens, out=offs[1:])
    cols = [(STRING, 0, rng.integers(32, 127, int(offs[-1])).astype(np.uint8),
             offs, None), make_column(rng, "INT64", n, "most")]
    pb = check_table(cols)
    sizes = np.diff(pb[0].offsets.numpy())
    assert sizes.max() == 1024


@pytest.mark.parametrize("field,value", [("offset", 3), ("offset", 4000),
                                         ("length", 1 << 20)])
def test_corrupt_slot_raises(field, value):
    """Rows from a shuffle with a string slot outside its row raise, as in
    the JAX package (convert.py:1157-1160, 1194-1196)."""
    n = 64
    cols = [(int(pt.TypeId.INT32), 0, np.arange(n, dtype=np.int32), None,
             None),
            (STRING, 0, np.frombuffer(b"abcd" * n, np.uint8),
             np.arange(n + 1, dtype=np.int32) * 4, None)]
    t = interop.table_from_numpy(cols, device=CPU)
    b = pt.convert_to_rows(t)[0]
    raw = b.host_bytes().copy()
    lay = pt.compute_row_layout(t.schema)
    at = lay.column_starts[1] + (0 if field == "offset" else 4)
    raw[at:at + 4] = np.frombuffer(np.uint32(value).tobytes(), np.uint8)
    bad = interop.batch_from_numpy(raw, b.offsets.numpy(), CPU)
    with pytest.raises(ValueError, match="corrupt row"):
        pt.convert_from_rows(bad, t.schema)
