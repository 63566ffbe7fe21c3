"""The port's op library against the JAX package's, on the CPU.

``ops/{filter,sort,strings,groupby,reductions,copying,hashing}.py`` of
``spark_rapids_jni_tpu_torch`` take the same numpy-seeded columns, nulls
among them, as their JAX counterparts; outputs must be equal: keys,
counts, integer and decimal results and selected values exactly (FLOAT64
as bits), float sums, means, variances and deviations to a relative
1e-12 (the same values summed in another order).  The murmur3 hashes are
also held against a scalar implementation of the public algorithm.  The
grouping sets (rollup, cube, explicit sets, ``nunique``) and the string
matchers (``contains``, ``starts_with``, ``ends_with``, ``like``; plain
and dictionary columns, patterns longer than every row, empty, all-%
and with ``_``) are held against the JAX package the same way.
"""

import torch_one_thread  # noqa: F401  (first: one intra-op thread)
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from spark_rapids_jni_tpu import ops as jops
from spark_rapids_jni_tpu.ops import groupby as jgroupby
from spark_rapids_jni_tpu.ops import hashing as jhashing
from spark_rapids_jni_tpu.ops import strings as jstrings

import spark_rapids_jni_tpu_torch as pt
from spark_rapids_jni_tpu_torch import ops
from spark_rapids_jni_tpu_torch.ops import decimal128 as d128
from spark_rapids_jni_tpu_torch.ops import groupby, hashing, strings

from test_hashing import _scalar_murmur3_bytes
from torch_jax_columns import assert_same, assert_same_table, to_jax

CPU = "cpu"
N = 600
RTOL = 1e-12
WORDS = ["", "a", "ab", "a\x00", "b", "zz", "abcdefgh", "abcdefghi"]
FLOATS = [-0.0, 0.0, np.nan, -np.nan, 1.5, -2.5, np.inf, -np.inf, 1e-300]


def _valid(rng, n, share=0.2):
    return rng.random(n) >= share


def make_column(kind: str, rng, n: int = N, nulls: bool = True):
    """A port column of ``kind`` on the CPU, from the generator."""
    valid = _valid(rng, n) if nulls else None
    if kind == "int":
        return pt.Column.from_numpy(rng.integers(0, 9, n).astype(np.int32),
                                    validity=valid, device=CPU)
    if kind == "int64":
        return pt.Column.from_numpy(rng.integers(-2**62, 2**62, n),
                                    validity=valid, device=CPU)
    if kind == "uint8":
        return pt.Column.from_numpy(rng.integers(0, 256, n).astype(np.uint8),
                                    validity=valid, device=CPU)
    if kind == "bool":
        return pt.Column.from_numpy(rng.integers(0, 2, n).astype(np.uint8),
                                    pt.bool8, valid, device=CPU)
    if kind == "float":
        return pt.Column.from_numpy(rng.choice(np.array(FLOATS), n),
                                    validity=valid, device=CPU)
    if kind == "float32":
        return pt.Column.from_numpy(
            rng.choice(np.array(FLOATS, np.float32), n), validity=valid,
            device=CPU)
    if kind == "decimal64":
        return pt.Column.from_numpy(rng.integers(-10**6, 10**6, n),
                                    pt.decimal64(-2), valid, device=CPU)
    if kind == "decimal128":
        pool = [(1 << 127) - 1, -(1 << 127), -1, 0, 10**30, 7, -10**20]
        vals = [pool[i] for i in rng.integers(0, len(pool), n)]
        if nulls:
            vals = [v if ok else None for v, ok in zip(vals, valid)]
        return d128.from_pyints(vals, -4, device=CPU)
    if kind == "string":
        vals = [WORDS[i] for i in rng.integers(0, len(WORDS), n)]
        if nulls:
            vals = [v if ok else None for v, ok in zip(vals, valid)]
        return pt.Column.strings_from_list(vals, device=CPU)
    if kind == "dict":
        # merged dictionaries hold duplicate entries
        dictionary = pt.Column.strings_from_list(["b", "a", "zz", "a", ""],
                                                 device=CPU)
        codes = rng.integers(0, 5, n).astype(np.int32)
        if nulls:
            codes[~valid] = 0
        return pt.DictColumn(torch.from_numpy(codes), dictionary,
                             None if valid is None else torch.from_numpy(valid))
    raise ValueError(kind)


def _table(kinds, seed, n=N, nulls=True):
    rng = np.random.default_rng(seed)
    return pt.Table([make_column(k, rng, n, nulls) for k in kinds])


# ---------------------------------------------------------------------------
# groupby
# ---------------------------------------------------------------------------

VALUE_KINDS = ("int", "float", "decimal64")
KEY_CASES = {
    "int": ["int"], "float": ["float"], "decimal64": ["decimal64"],
    "decimal128": ["decimal128"], "string": ["string"], "dict": ["dict"],
    "multi": ["string", "int", "float"], "dict_int": ["dict", "bool"],
}
FLOAT_RESULTS = ("sum", "mean", "var", "std")


def _all_aggs(n_keys: int):
    aggs = []
    for vi in range(len(VALUE_KINDS)):
        aggs += [(n_keys + vi, a) for a in groupby._AGGS]
    aggs += [(n_keys + len(VALUE_KINDS), "sum"),
             (n_keys + len(VALUE_KINDS), "count")]
    return aggs


def _assert_aggs(out, jout, n_keys, aggs):
    for ci in range(n_keys):
        assert_same(out[ci], jout[ci], what=f"key {ci}")
    for k, (vi, agg) in enumerate(aggs):
        ci = n_keys + k
        float_res = agg in FLOAT_RESULTS and out[ci].dtype == pt.float64
        assert_same(out[ci], jout[ci], RTOL if float_res else None,
                    what=f"{agg} of column {vi}")


@pytest.mark.parametrize("nulls", [False, True], ids=["valid", "nulls"])
@pytest.mark.parametrize("keys", list(KEY_CASES))
def test_groupby_aggregate_matches_jax(keys, nulls):
    kinds = KEY_CASES[keys]
    t = _table(kinds + list(VALUE_KINDS) + ["decimal128"], 7, nulls=nulls)
    key_idx = list(range(len(kinds)))
    aggs = _all_aggs(len(kinds))
    out = ops.groupby_aggregate(t, key_idx, aggs)
    jout = jops.groupby_aggregate(to_jax(t), key_idx, aggs)
    assert out.num_rows == jout.num_rows > 1
    _assert_aggs(out, jout, len(kinds), aggs)


def test_groupby_sums_by_parts_match_jax():
    """Groups of thousands of rows: the sums go by parts of 1,024 rows
    (``groupby._parts``), the decimal128 limb sums too; against JAX."""
    rng = np.random.default_rng(28)
    n = 6000
    t = pt.Table([pt.Column.from_numpy(rng.integers(0, 3, n).astype(np.int32),
                                       validity=_valid(rng, n), device=CPU)]
                 + [make_column(k, rng, n) for k in VALUE_KINDS]
                 + [make_column("decimal128", rng, n)])
    seg = torch.from_numpy(np.sort(rng.integers(0, 3, n)))
    assert groupby._parts(seg, 3) is not None
    aggs = _all_aggs(1)
    out = ops.groupby_aggregate(t, [0], aggs)
    _assert_aggs(out, jops.groupby_aggregate(to_jax(t), [0], aggs), 1, aggs)


def test_sorted_segment_sum_is_exact_for_ints_and_close_for_floats():
    """By parts, a million equal float addends on a few segments stay
    within 1e-14 of the exact sums (one run of ``index_add_`` a segment
    drifts to about 1e-12); int64 sums are exact."""
    rng = np.random.default_rng(29)
    n = 1 << 20
    cents = rng.integers(0, 11, n)
    seg = np.sort(rng.integers(0, 4, n))
    s = torch.from_numpy(seg)
    exact = np.array([int(cents[seg == g].sum()) for g in range(4)])
    floats = groupby._sorted_segment_sum(torch.from_numpy(cents / 100.0), s, 4)
    np.testing.assert_allclose(floats.numpy(), exact / 100.0, rtol=1e-14)
    ints = groupby._sorted_segment_sum(torch.from_numpy(cents), s, 4)
    np.testing.assert_array_equal(ints.numpy(), exact)


def test_groupby_float_keys_follow_spark_equality():
    vals = np.array([-0.0, 0.0, np.nan, -np.nan, 2.0, 0.0], np.float64)
    t = pt.Table([pt.Column.from_numpy(vals, device=CPU),
                  pt.Column.from_numpy(np.arange(6), device=CPU)])
    out = ops.groupby_aggregate(t, [0], [(1, "count"), (1, "min")])
    # -0.0 and 0.0 one group, the NaNs one group, ordered NaN last
    assert out[1].to_pylist() == [3, 1, 2]
    assert out[2].to_pylist() == [0, 4, 2]
    assert_same_table(out, jops.groupby_aggregate(to_jax(t), [0],
                                                  [(1, "count"),
                                                   (1, "min")]))


@pytest.mark.parametrize("nulls", [False, True], ids=["valid", "nulls"])
def test_grand_total_and_distinct_match_jax(nulls):
    t = _table(list(VALUE_KINDS) + ["decimal128"], 8, nulls=nulls)
    aggs = _all_aggs(0)
    out = ops.groupby_aggregate(t, [], aggs)
    jout = jops.groupby_aggregate(to_jax(t), [], aggs)
    assert out.num_rows == 1
    _assert_aggs(out, jout, 0, aggs)
    d = _table(["string", "int", "dict", "float"], 9, n=200, nulls=nulls)
    assert_same_table(ops.distinct(d), jops.distinct(to_jax(d)))


@pytest.mark.parametrize("keys", [[0, 1], []], ids=["keyed", "grand_total"])
def test_groupby_of_no_rows_matches_jax(keys):
    t = _table(["string", "int"] + list(VALUE_KINDS) + ["decimal128"], 10,
               n=0)
    aggs = _all_aggs(2)
    out = ops.groupby_aggregate(t, keys, aggs)
    jout = jops.groupby_aggregate(to_jax(t), keys, aggs)
    assert out.num_rows == jout.num_rows == (0 if keys else 1)
    assert out.schema == [c.dtype for c in out.columns]
    for p, j in zip(out.columns, jout.columns):
        assert (int(p.dtype.id), p.dtype.scale) == (int(j.dtype.id),
                                                    j.dtype.scale)
        assert tuple(p.data.shape) == tuple(np.asarray(j.data).shape[:len(
            p.data.shape)])
        np.testing.assert_array_equal(p.validity_or_true().numpy(),
                                      np.asarray(j.validity_or_true()))


GROUPING_KEYS = {"string_int": ["string", "int"],
                 "dict_float": ["dict", "float"],
                 "decimal128_int_bool": ["decimal128", "int", "bool"]}
# (value column of VALUE_KINDS, aggregate)
GROUPING_AGGS = ((0, "sum"), (0, "min"), (1, "mean"), (1, "max"),
                 (2, "sum"), (2, "count"))


def _grouping_case(keys, seed, n=N):
    kinds = GROUPING_KEYS[keys]
    t = _table(kinds + list(VALUE_KINDS), seed, n=n)
    aggs = [(len(kinds) + vi, a) for vi, a in GROUPING_AGGS]
    return t, list(range(len(kinds))), aggs


def _assert_grouping(out, jout, nk, aggs):
    assert out.num_rows == jout.num_rows
    _assert_aggs(out, jout, nk, aggs)
    assert_same(out[nk + len(aggs)], jout[nk + len(aggs)],
                what="grouping_id")


@pytest.mark.parametrize("fn", ["rollup", "cube", "sets"])
@pytest.mark.parametrize("keys", list(GROUPING_KEYS))
def test_grouping_sets_match_jax(keys, fn):
    """ROLLUP, CUBE and explicit GROUPING SETS: keys null where a set
    drops them, the aggregates, Spark's grouping_id; the sets in order."""
    t, key_idx, aggs = _grouping_case(keys, 40 + len(keys))
    jt = to_jax(t)
    if fn == "sets":
        nk = len(key_idx)
        sets = [[nk - 1], [], [0, nk - 1], [0]]
        out = ops.groupby_grouping_sets(t, key_idx, sets, aggs)
        jout = jops.groupby_grouping_sets(jt, key_idx, sets, aggs)
    else:
        out = getattr(ops, f"groupby_{fn}")(t, key_idx, aggs)
        jout = getattr(jops, f"groupby_{fn}")(jt, key_idx, aggs)
    _assert_grouping(out, jout, len(key_idx), aggs)
    gid = out[len(key_idx) + len(aggs)].data
    assert int(gid.max()) == (1 << len(key_idx)) - 1


def test_grouping_sets_of_no_rows_match_jax():
    t, key_idx, aggs = _grouping_case("string_int", 44, n=0)
    out = ops.groupby_rollup(t, key_idx, aggs)
    jout = jops.groupby_rollup(to_jax(t), key_idx, aggs)
    # the grand total's one row: counts 0, the rest null
    assert out.num_rows == 1
    _assert_grouping(out, jout, len(key_idx), aggs)


@pytest.mark.parametrize("value,keys,nulls", [
    ("int", [0, 1], True), ("string", [0, 1], True), ("float", [1], True),
    ("dict", [0], True), ("int", [], False)])
def test_groupby_nunique_matches_jax(value, keys, nulls):
    """COUNT(DISTINCT value): null values not counted, null keys one
    group."""
    t = _table(["string", "int", value], 46, n=200, nulls=nulls)
    out = ops.groupby_nunique(t, keys, 2)
    assert_same_table(out, jops.groupby_nunique(to_jax(t), keys, 2))


def test_groupby_rejects_what_jax_rejects():
    t = _table(["int", "decimal128", "string"], 11)
    with pytest.raises(NotImplementedError):
        ops.groupby_aggregate(t, [0], [(1, "mean")])
    with pytest.raises(NotImplementedError):
        ops.groupby_aggregate(t, [0], [(2, "sum")])
    with pytest.raises(ValueError):
        groupby._agg_segment(t[0].data, None, torch.zeros(N, dtype=torch.int64),
                             "median", 1, np.dtype(np.int32))


# ---------------------------------------------------------------------------
# order_by
# ---------------------------------------------------------------------------

SORT_KINDS = ("int", "int64", "uint8", "bool", "float", "float32",
              "decimal128", "string", "dict")


@pytest.mark.parametrize("nulls_first", [True, False], ids=["nf", "nl"])
@pytest.mark.parametrize("ascending", [True, False], ids=["asc", "desc"])
@pytest.mark.parametrize("kind", SORT_KINDS)
def test_order_by_matches_jax(kind, ascending, nulls_first):
    t = _table([kind, "int"], 12)
    for keys in ([0], [0, 1]):
        asc = [ascending, not ascending][:len(keys)]
        nf = [nulls_first, True][:len(keys)]
        got = ops.order_by(t, keys, asc, nf)
        want = jops.order_by(to_jax(t), keys, asc, nf)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    sorted_t = ops.sort_table(t, [0], [ascending], [nulls_first])
    assert_same_table(sorted_t, jops.sort_table(to_jax(t), [0], [ascending],
                                                [nulls_first]))


# ---------------------------------------------------------------------------
# filter
# ---------------------------------------------------------------------------

FILTER_KINDS = ["int", "float", "string", "dict", "decimal128", "decimal64"]


def test_apply_boolean_mask_and_gather_match_jax():
    t = _table(FILTER_KINDS, 13)
    mask = np.random.default_rng(14).random(N) < 0.4
    got = ops.apply_boolean_mask(t, torch.from_numpy(mask))
    assert got.num_rows == int(mask.sum())
    assert_same_table(got, jops.apply_boolean_mask(to_jax(t),
                                                   jnp.asarray(mask)))
    idx = np.random.default_rng(15).integers(0, N, 900)
    assert_same_table(ops.gather(t, torch.from_numpy(idx)),
                      jops.gather(to_jax(t), jnp.asarray(idx)))
    empty = ops.apply_boolean_mask(t, torch.zeros(N, dtype=torch.bool))
    assert empty.num_rows == 0 and empty.schema == t.schema


def test_mask_table_and_fill_null_match_jax():
    t = _table(FILTER_KINDS, 16)
    mask = np.random.default_rng(17).random(N) < 0.5
    assert_same_table(ops.mask_table(t, torch.from_numpy(mask)),
                      jops.mask_table(to_jax(t), jnp.asarray(mask)))
    for ci, value in ((0, 7), (1, -1.25), (5, 99)):
        assert_same(ops.fill_null(t[ci], value),
                    jops.fill_null(to_jax(t[ci]), value))
    with pytest.raises(TypeError):
        ops.fill_null(t[2], "x")
    with pytest.raises(TypeError):
        ops.fill_null(t[4], 0)


@pytest.mark.parametrize("kind,probes", [
    ("int", [1, 3.5, 2**40, None, 7, 3]),
    ("float", [np.nan, -0.0, 1.5, None, "x", 2**80]),
    ("float32", [1.5, np.nan, -2.5, 0.1]),
    ("string", ["a", "zz", None, "nope", "abcdefghi", ""]),
    ("dict", ["a", "", "q"]),
    ("decimal64", [-5, 12]),
])
def test_isin_matches_jax(kind, probes):
    col = make_column(kind, np.random.default_rng(18))
    got = ops.isin(col, probes)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jops.isin(to_jax(col), probes)))


# ---------------------------------------------------------------------------
# the strings key subset
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["string", "dict"])
@pytest.mark.parametrize("width", [None, 13])
def test_byte_matrix_and_sort_lanes_match_jax(kind, width):
    col = make_column(kind, np.random.default_rng(19))
    mat, lens = strings.byte_matrix(col, width)
    jmat, jlens = jstrings.byte_matrix(to_jax(col), width)
    np.testing.assert_array_equal(mat.numpy(), np.asarray(jmat))
    np.testing.assert_array_equal(lens.numpy(), np.asarray(jlens))
    for desc in (False, True):
        for got, want in zip(strings.sort_key_lanes(col, desc),
                             jstrings.sort_key_lanes(to_jax(col), desc)):
            np.testing.assert_array_equal(got.numpy(),
                                          np.asarray(want).astype(np.int64))


@pytest.mark.parametrize("kind", ["string", "dict"])
@pytest.mark.parametrize("nulls", [False, True], ids=["valid", "nulls"])
def test_dictionary_encode_matches_jax(kind, nulls):
    col = make_column(kind, np.random.default_rng(20), nulls=nulls)
    codes, uniq = strings.dictionary_encode(col)
    jcodes, juniq = jstrings.dictionary_encode(to_jax(col))
    assert_same(codes, jcodes)
    assert_same(uniq, juniq)
    if kind == "dict":
        rank, sdict = strings.dict_rank_codes(col)
        jrank, jsdict = jstrings.dict_rank_codes(to_jax(col))
        np.testing.assert_array_equal(rank.numpy(), np.asarray(jrank))
        assert_same(sdict, jsdict)


# ---------------------------------------------------------------------------
# reductions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nulls", [False, True], ids=["valid", "nulls"])
@pytest.mark.parametrize("kind", ["int", "int64", "uint8", "float",
                                  "float32", "decimal64"])
def test_reductions_match_jax(kind, nulls):
    col = make_column(kind, np.random.default_rng(21), nulls=nulls)
    jcol = to_jax(col)
    for name in ("sum_", "mean", "min_", "max_", "valid_count"):
        got = getattr(ops, name)(col)
        want = np.asarray(getattr(jops, name)(jcol))
        assert got.dim() == 0
        if got.is_floating_point() and name in ("sum_", "mean"):
            np.testing.assert_allclose(got.item(), want, rtol=RTOL, atol=0)
        else:                            # NaN equals NaN here
            np.testing.assert_array_equal(got.numpy(), want, name)


# ---------------------------------------------------------------------------
# copying
# ---------------------------------------------------------------------------

def test_concat_tables_matches_jax():
    kinds = ["int", "float", "string", "dict", "decimal128"]
    parts = [_table(kinds, 22 + i, n=n, nulls=i != 1)
             for i, n in enumerate((50, 0, 120))]
    got = ops.concat_tables(parts)
    assert got.num_rows == 170
    assert_same_table(got, jops.concat_tables([to_jax(t) for t in parts]))
    with pytest.raises(ValueError):
        ops.concat_tables([])
    with pytest.raises(TypeError):
        ops.concat_tables([_table(["int"], 1, 5), _table(["float"], 1, 5)])


@pytest.mark.parametrize("start,length", [(0, None), (17, 40), (590, 100),
                                          (700, 5), (-3, 2), (5, 0)])
def test_slice_table_matches_jax(start, length):
    t = _table(["int", "string", "dict", "decimal128"], 25)
    assert_same_table(ops.slice_table(t, start, length),
                      jops.slice_table(to_jax(t), start, length))


# ---------------------------------------------------------------------------
# hashing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.int8, np.int16, np.int32, np.int64,
                                   np.uint8, np.uint16, np.uint64, np.bool_,
                                   np.float32])
def test_murmur3_matches_jax(dtype):
    rng = np.random.default_rng(26)
    if dtype == np.float32:
        vals = np.concatenate([np.array(FLOATS, np.float32),
                               rng.standard_normal(500).astype(np.float32)])
    elif dtype == np.bool_:
        vals = rng.integers(0, 2, 500).astype(bool)
    else:
        info = np.iinfo(dtype)
        vals = rng.integers(info.min, info.max, 500, dtype=dtype,
                            endpoint=True)
        vals[:2] = [info.min, info.max]
    got = hashing.murmur3_32(torch.from_numpy(vals))
    want = np.asarray(jhashing.murmur3_32(jnp.asarray(vals)))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    seeds = rng.integers(0, 2**32, vals.shape[0])
    np.testing.assert_array_equal(
        hashing.murmur3_32(torch.from_numpy(vals),
                           torch.from_numpy(seeds)).numpy(),
        np.asarray(jhashing.murmur3_32(jnp.asarray(vals),
                                       jnp.asarray(seeds.astype(np.uint32)))))


def test_murmur3_matches_the_scalar_spec():
    for dtype, width in ((np.int32, 4), (np.int64, 8)):
        vals = np.asarray([0, 1, -1, 42, 2**31 - 1, -2**31], dtype=dtype)
        got = hashing.murmur3_32(torch.from_numpy(vals)).tolist()
        assert got == [_scalar_murmur3_bytes(
            int(v).to_bytes(width, "little", signed=True), 42) for v in vals]
    with pytest.raises(TypeError, match="float64"):
        hashing.murmur3_32(torch.ones(3, dtype=torch.float64))


def test_fingerprint_and_partition_match_jax():
    rng = np.random.default_rng(27)
    lanes = [rng.integers(-2**62, 2**62, 400),
             rng.integers(0, 9, 400).astype(np.int32)]
    got = hashing.fingerprint64([torch.from_numpy(x) for x in lanes])
    want = jhashing.fingerprint64([jnp.asarray(x) for x in lanes])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    h = hashing.murmur3_32(torch.from_numpy(lanes[0]))
    jh = jhashing.murmur3_32(jnp.asarray(lanes[0]))
    for parts in (1, 8, 200):
        p = hashing.hash_partition(h, parts)
        assert p.dtype == torch.int32
        np.testing.assert_array_equal(
            p.numpy(), np.asarray(jhashing.hash_partition(jh, parts)))


# ---------------------------------------------------------------------------
# lazy columns, string equality and shared codes
# ---------------------------------------------------------------------------

def test_lazy_column_forces_once_and_counts_rows_without_forcing():
    calls = []
    inner = pt.Column.from_numpy(np.arange(5, dtype=np.int32), device=CPU)

    def thunk():
        calls.append(1)
        return inner

    lazy = pt.LazyColumn(pt.int32, 5, CPU, thunk)
    t = pt.Table([lazy])
    assert (lazy.num_rows, len(lazy), t.num_rows, t.device.type) == \
        (5, 5, 5, "cpu")
    assert calls == [] and not lazy.forced
    assert lazy.data is inner.data and lazy.validity is None
    assert lazy.to_pylist() == [0, 1, 2, 3, 4]
    assert calls == [1] and lazy.forced
    assert pt.force_column(lazy) is inner and pt.force_column(inner) is inner


def test_gather_is_lazy_and_unread_columns_are_never_gathered():
    t = _table(["int", "string", "float"], 30)
    idx = torch.from_numpy(np.random.default_rng(31).integers(0, N, 200))
    got = ops.gather(t, idx)
    assert all(isinstance(c, pt.LazyColumn) and not c.forced
               for c in got.columns)
    # a groupby on one column forces only what it reads
    ops.groupby_aggregate(got, [0], [(0, "count")])
    assert got[0].forced and not got[1].forced and not got[2].forced
    # filters, joins and concatenations of lazy tables stay lazy
    both = ops.concat_tables([got, got])
    assert not any(c.forced for c in both.columns[1:])
    assert_same_table(both, jops.concat_tables([to_jax(got), to_jax(got)]))
    assert got[1].forced and got[2].forced


def test_lazy_dict_column_is_seen_through():
    t = _table(["dict", "int"], 32)
    mask = torch.from_numpy(np.random.default_rng(33).random(N) < 0.5)
    masked = ops.mask_table(t, mask)
    assert isinstance(masked[0], pt.DictColumn)
    lazy = pt.LazyColumn(pt.string, N, CPU, lambda: t[0])
    assert pt.column.as_dict_column(lazy) is t[0]
    assert pt.column.as_dict_column(t[1]) is None
    # dictionary-aware ops take the codes through the wrapper
    got = ops.gather(pt.Table([lazy, t[1]]), torch.arange(N - 1, -1, -1))
    assert isinstance(pt.force_column(got[0]), pt.DictColumn)
    probe = ["a", "zz"]
    np.testing.assert_array_equal(ops.isin(lazy, probe).numpy(),
                                  np.asarray(jops.isin(to_jax(t[0]), probe)))
    codes, _ = strings.dictionary_encode(lazy)
    jcodes, _ = jstrings.dictionary_encode(to_jax(t[0]))
    assert_same(codes, jcodes)
    order = ops.order_by(pt.Table([lazy]), [0])
    np.testing.assert_array_equal(
        order.numpy(), np.asarray(jops.order_by(to_jax(pt.Table([t[0]])),
                                                [0])))


def test_rows_of_a_lazy_table_equal_the_eager_table():
    from spark_rapids_jni_tpu_torch.rowconv import convert
    t = _table(["int", "string", "dict", "float"], 34)
    idx = torch.from_numpy(np.random.default_rng(35).integers(0, N, 300))
    lazy = ops.gather(t, idx)
    eager = pt.Table([ops.filter._gather_column(c, idx) for c in t.columns])
    eager = pt.Table([c.materialize() if isinstance(c, pt.DictColumn) else c
                      for c in eager.columns])
    a = convert.convert_to_rows(lazy)
    b = convert.convert_to_rows(eager)
    assert len(a) == len(b) == 1
    assert torch.equal(a[0].data, b[0].data)
    assert torch.equal(a[0].offsets, b[0].offsets)


@pytest.mark.parametrize("n_keep", [0, 37, 120, 400])
def test_sized_nonzero_matches_jax(n_keep):
    from spark_rapids_jni_tpu.ops.filter import sized_nonzero as jsized
    mask = np.random.default_rng(36).random(300) < 0.4
    got = ops.filter.sized_nonzero(torch.from_numpy(mask), n_keep)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jsized(jnp.asarray(mask),
                                                    n_keep)))


@pytest.mark.parametrize("kind", ["string", "dict"])
def test_equal_to_scalar_matches_jax(kind):
    col = make_column(kind, np.random.default_rng(37))
    for value in ["a", "", "zz", "abcdefghi", "nope", b"ab"]:
        assert_same(strings.equal_to_scalar(col, value),
                    jstrings.equal_to_scalar(to_jax(col), value),
                    what=repr(value))


def test_equal_to_matches_jax():
    rng = np.random.default_rng(38)
    a, b = make_column("string", rng), make_column("string", rng)
    assert_same(strings.equal_to(a, b),
                jstrings.equal_to(to_jax(a), to_jax(b)))


@pytest.mark.parametrize("kinds", [("string", "string"), ("dict", "string"),
                                   ("dict", "dict")])
def test_encode_shared_matches_jax(kinds):
    rng = np.random.default_rng(39)
    cols = [make_column(k, rng, n) for k, n in zip(kinds, (N, 250))]
    got = strings.encode_shared(cols)
    want = jstrings.encode_shared([to_jax(c) for c in cols])
    for g, w in zip(got, want):
        assert_same(g, w)


# ---------------------------------------------------------------------------
# the matchers: contains, starts_with, ends_with, LIKE
# ---------------------------------------------------------------------------

# "abcdefghijklmnop" is longer than every row; "" and "%..." match all
PATTERNS = ["a", "ab", "b", "zz", "gh", "abcdefghi", "abcdefghijklmnop", "",
            "a\x00"]
LIKE_PATTERNS = ["a", "ab", "", "%", "%%", "_", "__", "a_", "_b", "a%", "%a",
                 "%b%", "a%h", "%c%e%", "a%c%", "ab%_%i", "_%_", "%zz",
                 "abcdefghijklmnop%", "%abcdefghijklmnop", "a\x00",
                 "%\x00", "abcdefgh_"]


@pytest.mark.parametrize("kind", ["string", "dict"])
@pytest.mark.parametrize("fn", ["contains", "starts_with", "ends_with"])
def test_matchers_match_jax(fn, kind):
    col = make_column(kind, np.random.default_rng(47))
    jcol = to_jax(col)
    for pat in PATTERNS + [b"ab", b"zz"]:
        assert_same(getattr(strings, fn)(col, pat),
                    getattr(jstrings, fn)(jcol, pat), what=repr(pat))


@pytest.mark.parametrize("kind", ["string", "dict"])
def test_like_matches_jax(kind):
    col = make_column(kind, np.random.default_rng(48))
    jcol = to_jax(col)
    for pat in LIKE_PATTERNS:
        assert_same(strings.like(col, pat), jstrings.like(jcol, pat),
                    what=repr(pat))


def test_like_matches_python_on_brand_like_words():
    """LIKE against a regex of the same pattern, on TPC-DS-like words
    with repeats, so that a floating piece must take its earliest
    match."""
    import re
    rng = np.random.default_rng(49)
    words = [f"brand#{int(b)}" for b in rng.integers(1, 130, 300)]
    words += ["#1#1", "##11", "brand#", "", "1#1brand#1"]
    col = pt.Column.strings_from_list(words, device=CPU)
    for pat in ["%#1%", "brand#1_", "%#1", "b%#%1", "%1%1%", "_r%d#_",
                "brand#1%1", "%#1#%", "#1%"]:
        rx = re.compile("^" + "".join(
            ".*" if ch == "%" else "." if ch == "_" else re.escape(ch)
            for ch in pat) + "$", re.S)
        want = [bool(rx.match(w)) for w in words]
        assert strings.like(col, pat).to_pylist() == want, pat
