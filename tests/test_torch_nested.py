"""Nested (LIST and STRUCT) columns of the port against the JAX package's,
on the CPU.

Every case of ``tests/test_nested.py`` runs through both packages on the
same host lists: construction, ``to_pylist``, gather, boolean mask and
``mask_table`` through any nesting, the dtype validation and the row
layout's rejection; the port's column equals the JAX package's (dtype
tree, validity, offsets, chars, values).  Beyond them: concatenation and
slices through LIST-of-LIST and STRUCT-of-LIST (the JAX package's
``ops/copying.py``), ``from_pylist`` with a LIST dtype, a lazy column's
children, the Arrow exchange of LIST columns (buffers and pyarrow), and
the dictionary-codes row passthrough (``dict_encode_for_rows`` → rows →
``restore_dict_columns``), all equal to the JAX package's.
"""

import torch_one_thread  # noqa: F401  (first: one intra-op thread)

import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_jni_tpu import types as JT
from spark_rapids_jni_tpu.column import Column as JColumn
from spark_rapids_jni_tpu.column import DictColumn as JDictColumn
from spark_rapids_jni_tpu.column import Table as JTable
from spark_rapids_jni_tpu.ops import copying as JC
from spark_rapids_jni_tpu.ops import filter as JF
from spark_rapids_jni_tpu.rowconv import convert as JRC
from spark_rapids_jni_tpu.utils import arrow as JA

from spark_rapids_jni_tpu_torch import types as T
from spark_rapids_jni_tpu_torch.column import (Column, DictColumn,
                                               LazyColumn, Table)
from spark_rapids_jni_tpu_torch.ops import copying as C
from spark_rapids_jni_tpu_torch.ops import filter as F
from spark_rapids_jni_tpu_torch.rowconv import convert as RC
from spark_rapids_jni_tpu_torch.rowconv.layout import compute_row_layout
from spark_rapids_jni_tpu_torch.utils import arrow as A

from torch_jax_columns import assert_same_nested, dtype_tree

CPU = "cpu"

# host lists of tests/test_nested.py, and deeper ones
LISTS = {
    "int": [[1, 2, 3], [], None, [7], [8, 9]],
    "strings": [["ab", "c"], None, [], ["xyz"]],
    "list_of_list": [[[1], [2, 3]], [], None, [[4, 5, 6]]],
    "gather_src": [[1, 2], [3], [], [4, 5, 6], None],
    "nested_strings": [[["a", "bb"]], [["c"], []], None],
    "mask_src": [[1], [2, 2], [3], [4, 4]],
    "null_elements": [[1, None, 3], None, [], [None], [5]],
    "deep": [[[["a"]], []], None, [[["b", None], None]], [], [[[]]]],
}


def both_lists(vals):
    return (Column.list_from_pylist(vals, device=CPU),
            JColumn.list_from_pylist(vals))


def both_struct():
    """The struct of tests/test_nested.py ``_make``."""
    a = np.asarray([1, 2, 3], np.int32)
    s = ["x", None, "zz"]
    valid = np.asarray([True, True, False])
    p = Column.struct_from_columns(
        [Column.from_numpy(a, device=CPU),
         Column.strings_from_list(s, device=CPU)], validity=valid)
    j = JColumn.struct_from_columns(
        [JColumn.from_numpy(a), JColumn.strings_from_list(s)],
        validity=valid)
    return p, j


def both_struct_of_list(vals=((1, 2), (), (3,), None, (4, 5))):
    vals = [None if v is None else list(v) for v in vals]
    ids = np.arange(len(vals), dtype=np.int64)
    p = Column.struct_from_columns(
        [Column.list_from_pylist(vals, device=CPU),
         Column.from_numpy(ids, device=CPU)],
        validity=np.asarray([i % 4 != 2 for i in range(len(vals))]))
    j = JColumn.struct_from_columns(
        [JColumn.list_from_pylist(vals), JColumn.from_numpy(ids)],
        validity=np.asarray([i % 4 != 2 for i in range(len(vals))]))
    return p, j


def forced(col):
    """A port column with every lazy level forced (for comparison)."""
    return col._force() if isinstance(col, LazyColumn) else col


# --- construction and host round trip ---------------------------------------

@pytest.mark.parametrize("case", list(LISTS))
def test_list_roundtrip(case):
    p, j = both_lists(LISTS[case])
    assert p.dtype.id == T.TypeId.LIST and p.num_rows == len(LISTS[case])
    assert p.to_pylist() == LISTS[case]
    assert_same_nested(p, j, case)


def test_struct_roundtrip():
    p, j = both_struct()
    assert p.dtype.id == T.TypeId.STRUCT and p.num_rows == 3
    assert p.to_pylist() == [(1, "x"), (2, None), None]
    assert_same_nested(p, j)


def test_from_pylist_with_list_dtype():
    vals = [[1, 2], None, []]
    p = Column.from_pylist(vals, T.list_(T.int16), device=CPU)
    j = JColumn.list_from_pylist(vals, JT.int16)
    assert p.dtype == T.list_(T.int16)
    assert_same_nested(p, j)
    assert Column.from_pylist([["a"], None], device=CPU).to_pylist() == \
        [["a"], None]


def test_unequal_fields_rejected():
    a = Column.from_numpy(np.asarray([1, 2], np.int32), device=CPU)
    b = Column.from_numpy(np.asarray([1], np.int32), device=CPU)
    with pytest.raises(ValueError):
        Column.struct_from_columns([a, b])
    with pytest.raises(ValueError):
        JColumn.struct_from_columns([JColumn.from_numpy(np.asarray(
            [1, 2], np.int32)), JColumn.from_numpy(np.asarray([1], np.int32))])


# --- gather, mask, mask_table -------------------------------------------------

GATHERS = [("gather_src", [3, 0, 4]), ("nested_strings", [1, 0]),
           ("list_of_list", [3, 3, 0, 2]), ("null_elements", [4, 0, 1, 3]),
           ("deep", [2, 4, 0, 0]), ("strings", [])]


@pytest.mark.parametrize("case,idx", GATHERS)
def test_list_gather(case, idx):
    p, j = both_lists(LISTS[case])
    gp = F.gather(Table([p]), torch.tensor(idx, dtype=torch.int64))
    gj = JF.gather(JTable([j]), jnp.asarray(idx, jnp.int64))
    assert isinstance(gp[0], LazyColumn)
    assert dtype_tree(gp[0].children[0].dtype) == \
        dtype_tree(p.dtype.children[0])
    assert gp[0].to_pylist() == [LISTS[case][i] for i in idx]
    assert_same_nested(forced(gp[0]), gj[0], case)


@pytest.mark.parametrize("idx", [[2, 0], [0, 1, 2, 2], []])
def test_struct_gather(idx):
    p, j = both_struct()
    gp = F.gather(Table([p]), torch.tensor(idx, dtype=torch.int64))
    gj = JF.gather(JTable([j]), jnp.asarray(idx, jnp.int64))
    assert_same_nested(forced(gp[0]), gj[0])


def test_struct_of_list_gather():
    p, j = both_struct_of_list()
    idx = [4, 2, 0, 1]
    gp = F.gather(Table([p]), torch.tensor(idx))
    gj = JF.gather(JTable([j]), jnp.asarray(idx))
    assert gp[0].to_pylist() == [(p.to_pylist()[i][0], i) if i != 2 else None
                                 for i in idx]
    assert_same_nested(forced(gp[0]), gj[0])


@pytest.mark.parametrize("case", ["mask_src", "list_of_list", "deep"])
def test_boolean_mask(case):
    vals = LISTS[case]
    p, j = both_lists(vals)
    ints = np.arange(len(vals), dtype=np.int32)
    mask = np.arange(len(vals)) % 2 == 0
    tp = F.apply_boolean_mask(
        Table([Column.from_numpy(ints, device=CPU), p]), torch.tensor(mask))
    tj = JF.apply_boolean_mask(JTable([JColumn.from_numpy(ints), j]),
                               jnp.asarray(mask))
    assert tp[1].to_pylist() == [v for v, m in zip(vals, mask) if m]
    assert_same_nested(forced(tp[1]), tj[1], case)


@pytest.mark.parametrize("which", ["struct", "struct_of_list", "list"])
def test_mask_table_keeps_children(which):
    if which == "struct":
        p, j = both_struct()
    elif which == "struct_of_list":
        p, j = both_struct_of_list()
    else:
        p, j = both_lists(LISTS["list_of_list"])
    mask = np.arange(p.num_rows) % 2 == 0
    tp = F.mask_table(Table([p]), torch.tensor(mask))
    tj = JF.mask_table(JTable([j]), jnp.asarray(mask))
    assert tp[0].children is not None
    assert_same_nested(forced(tp[0]), tj[0], which)


# --- concat and slice ---------------------------------------------------------

CONCATS = ["list_of_list", "null_elements", "deep", "struct_of_list",
           "struct"]


def _both(which):
    if which == "struct":
        return both_struct()
    if which == "struct_of_list":
        return both_struct_of_list()
    return both_lists(LISTS[which])


@pytest.mark.parametrize("which", CONCATS)
def test_concat(which):
    (p1, j1), (p2, j2) = _both(which), _both(which)
    gp = F.gather(Table([p2]), torch.tensor([1, 0]))
    gj = JF.gather(JTable([j2]), jnp.asarray([1, 0]))
    tp = C.concat_tables([Table([p1]), gp, Table([p1])])
    tj = JC.concat_tables([JTable([j1]), gj, JTable([j1])])
    assert tp.num_rows == 2 * p1.num_rows + 2
    assert_same_nested(forced(tp[0]), tj[0], which)


@pytest.mark.parametrize("which", CONCATS)
@pytest.mark.parametrize("start,length", [(1, 2), (0, None), (2, 0), (3, 9)])
def test_slice(which, start, length):
    p, j = _both(which)
    sp = C.slice_table(Table([p]), start, length)
    sj = JC.slice_table(JTable([j]), start, length)
    assert_same_nested(sp[0], sj[0], which)


def test_concat_dtype_mismatch_raises():
    p1, _ = both_lists(LISTS["int"])
    p2, _ = both_lists(LISTS["strings"])
    with pytest.raises(TypeError):
        C.concat_tables([Table([p1]), Table([p2])])


# --- dtype validation and the row layout ---------------------------------------

@pytest.mark.parametrize("args", [(T.TypeId.LIST,), (T.TypeId.STRUCT,),
                                  (T.TypeId.INT32, 0, (T.int64,))])
def test_dtype_validation(args):
    with pytest.raises(ValueError):
        T.DType(*args)
    with pytest.raises(ValueError):
        JT.DType(JT.TypeId(int(args[0])), *args[1:2],
                 *((JT.int64,),) if len(args) > 2 else ())


def test_layout_rejects_list():
    with pytest.raises(TypeError, match="LIST"):
        compute_row_layout([T.int32, T.list_(T.int32)])


def test_convert_rejects_struct():
    col = Column.struct_from_columns(
        [Column.from_numpy(np.asarray([1], np.int32), device=CPU)])
    with pytest.raises(TypeError, match="STRUCT"):
        RC.convert_to_rows(Table([col]))


# --- Arrow ---------------------------------------------------------------------

ARROW = {
    "ints": pa.array(LISTS["null_elements"], pa.list_(pa.int64())),
    "strings": pa.array(LISTS["strings"], pa.list_(pa.string())),
    "list_of_list": pa.array(LISTS["list_of_list"],
                             pa.list_(pa.list_(pa.int64()))),
    "sliced": pa.array([[1], [2, 3], None, [4]],
                       pa.list_(pa.int64()))[1:],
}


@pytest.mark.parametrize("name", list(ARROW))
def test_arrow_lists(name):
    arr = ARROW[name]
    p = A.from_arrow(arr, device=CPU)
    j = JA.from_arrow(arr)
    assert p.to_pylist() == j.to_pylist() == arr.to_pylist()
    assert A.to_arrow(p).to_pylist() == JA.to_arrow(j).to_pylist()
    back = A.from_arrow_buffers(A.to_arrow_buffers(p), device=CPU)
    assert_same_nested(back, p_as_jax_lists(p), name)


def p_as_jax_lists(p):
    """The JAX package's column of ``p``'s host values."""
    return JColumn.list_from_pylist(p.to_pylist(),
                                    JT.DType(JT.TypeId(int(
                                        p.dtype.children[0].id))) if
                                    not p.dtype.children[0].is_nested
                                    else None)


def test_arrow_null_list_covering_elements():
    """A null list slot whose offsets cover elements (Arrow allows it)
    comes back empty, as the JAX package's ``to_pylist`` route leaves
    it."""
    offsets = pa.array([0, 2, 4, 5], pa.int32())
    values = pa.array([1, 2, 3, 4, 5], pa.int64())
    arr = pa.ListArray.from_arrays(offsets, values,
                                   mask=pa.array([False, True, False]))
    p = A.from_arrow(arr, device=CPU)
    assert p.to_pylist() == JA.from_arrow(arr).to_pylist() == \
        [[1, 2], None, [5]]
    assert p.offsets.tolist() == [0, 2, 2, 3]


def test_arrow_struct_buffers_round_trip():
    p, _ = both_struct()
    back = A.from_arrow_buffers(A.to_arrow_buffers(p), device=CPU)
    assert back.to_pylist() == p.to_pylist()
    assert A.to_arrow(p).to_pylist() == [{"f0": 1, "f1": "x"},
                                         {"f0": 2, "f1": None}, None]


# --- the dictionary-codes row passthrough --------------------------------------

def _dict_tables(n=257, seed=3):
    rng = np.random.default_rng(seed)
    entries = ["", "a", "bcd", "éf", "longer entry"]
    codes = rng.integers(0, len(entries), n).astype(np.int32)
    valid = rng.random(n) >= 0.2
    ints = rng.integers(-50, 50, n).astype(np.int64)
    pd = DictColumn(torch.from_numpy(codes),
                    Column.strings_from_list(entries, device=CPU),
                    torch.from_numpy(valid))
    jd = JDictColumn(jnp.asarray(codes), JColumn.strings_from_list(entries),
                     jnp.asarray(valid))
    return (Table([Column.from_numpy(ints, device=CPU), pd]),
            JTable([JColumn.from_numpy(ints), jd]))


def test_dict_passthrough_equals_jax():
    tp, tj = _dict_tables()
    cp, dp = RC.dict_encode_for_rows(tp)
    cj, dj = JRC.dict_encode_for_rows(tj)
    assert sorted(dp) == sorted(dj) == [1]
    assert cp.schema == [T.int64, T.int32]
    bp, bj = RC.convert_to_rows(cp), JRC.convert_to_rows(cj)
    assert len(bp) == len(bj) == 1
    np.testing.assert_array_equal(bp[0].host_bytes(), bj[0].host_bytes())
    back = RC.restore_dict_columns(
        RC.convert_from_rows(bp[0], cp.schema), dp)
    jback = JRC.restore_dict_columns(
        JRC.convert_from_rows(bj[0], cj.schema), dj)
    assert isinstance(back[1], DictColumn)
    np.testing.assert_array_equal(back[1].codes.numpy(),
                                  np.asarray(jback[1].codes))
    assert back[1].to_pylist() == jback[1].to_pylist() == tp[1].to_pylist()
    assert back[0].to_pylist() == tp[0].to_pylist()


def test_dict_passthrough_without_dictionaries():
    t = Table([Column.from_numpy(np.arange(5, dtype=np.int32), device=CPU)])
    out, dicts = RC.dict_encode_for_rows(t)
    assert dicts == {} and out[0] is t[0]
    assert RC.restore_dict_columns(out, {})[0] is t[0]
