"""Columns across the two packages, for the port's op tests.

``to_jax`` builds the JAX package's column (or table) holding the same
values as a port column on the CPU, through numpy; ``assert_same`` holds a
port column against a JAX one: the same type, validity and payload.
FLOAT64 compares as bits (the JAX package stores uint32 bit pairs, the
port float64), or to a relative tolerance where the sums' order differs.
"""

import numpy as np
import jax.numpy as jnp

from spark_rapids_jni_tpu import Column as JColumn, Table as JTable
from spark_rapids_jni_tpu import types as JT
from spark_rapids_jni_tpu.column import DictColumn as JDictColumn

import spark_rapids_jni_tpu_torch as pt


def jdtype(dt):
    return JT.DType(JT.TypeId(int(dt.id)), dt.scale)


def _jvalid(col):
    return None if col.validity is None else jnp.asarray(
        col.validity.numpy())


def to_jax(col):
    """The JAX package's column with ``col``'s values (a port column on
    the CPU)."""
    if isinstance(col, pt.Table):
        return JTable([to_jax(c) for c in col.columns])
    if isinstance(col, pt.DictColumn):
        return JDictColumn(jnp.asarray(col.codes.numpy()),
                           to_jax(col.dictionary), _jvalid(col))
    dt = jdtype(col.dtype)
    if col.dtype.is_variable_width:
        return JColumn(dt, jnp.asarray(col.data.numpy()),
                       jnp.asarray(col.offsets.numpy()), _jvalid(col))
    if col.dtype.id == pt.TypeId.DECIMAL128:
        return JColumn(dt, jnp.asarray(col.data.numpy()), validity=_jvalid(col))
    valid = None if col.validity is None else col.validity.numpy()
    return JColumn.from_numpy(col.data.numpy(), dt, valid)


def payload(col) -> np.ndarray:
    """A JAX column's payload in the port's storage (FLOAT64 as float64)."""
    if col.dtype.id == JT.TypeId.FLOAT64:
        return col.to_numpy()
    return np.asarray(col.data)


def assert_same(p, j, rtol=None, what=""):
    """Port column ``p`` equals JAX column ``j``: type, validity, values
    (strings as chars and offsets, or as lists for DictColumns); null
    slots' payloads too, unless ``rtol`` is given (floats then compare to
    it on the valid rows)."""
    assert (int(p.dtype.id), p.dtype.scale) == (int(j.dtype.id),
                                                j.dtype.scale), what
    pv = p.validity_or_true().numpy()
    np.testing.assert_array_equal(pv, np.asarray(j.validity_or_true()),
                                  err_msg=f"{what}: validity")
    if p.dtype.is_variable_width:
        assert p.to_pylist() == j.to_pylist(), what
        if not isinstance(p, pt.DictColumn) and not isinstance(j, JDictColumn):
            np.testing.assert_array_equal(p.offsets.numpy(),
                                          np.asarray(j.offsets), what)
            np.testing.assert_array_equal(p.data.numpy(), np.asarray(j.data),
                                          what)
        return
    got, want = p.data.numpy(), payload(j)
    assert got.shape == want.shape, what
    if rtol is not None and got.dtype.kind == "f":
        np.testing.assert_allclose(got[pv], want[pv], rtol=rtol, atol=0,
                                   err_msg=what)
    elif got.dtype.kind == "f":
        np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8),
                                      err_msg=what)
    else:
        np.testing.assert_array_equal(got, want, err_msg=what)


def assert_same_table(p, j, rtol=None):
    assert p.num_columns == j.num_columns
    assert p.num_rows == j.num_rows
    for i, (pc, jc) in enumerate(zip(p.columns, j.columns)):
        assert_same(pc, jc, rtol, what=f"column {i}")


def dtype_tree(dt) -> tuple:
    """A dtype of either package as (type id, scale, children's trees)."""
    return (int(dt.id), dt.scale, tuple(dtype_tree(c) for c in dt.children))


def assert_same_nested(p, j, what=""):
    """Port column ``p`` equals JAX column ``j`` through any nesting: the
    dtype tree, the rows, the validity, a LIST's offsets (rebased to its
    first) and a STRING's chars and offsets, each child recursively, and
    the host values (``to_pylist``)."""
    assert dtype_tree(p.dtype) == dtype_tree(j.dtype), what
    assert p.num_rows == j.num_rows, what
    np.testing.assert_array_equal(p.validity_or_true().numpy(),
                                  np.asarray(j.validity_or_true()),
                                  err_msg=f"{what}: validity")
    if p.dtype.id == pt.TypeId.LIST:
        po, jo = p.offsets.numpy(), np.asarray(j.offsets)
        np.testing.assert_array_equal(po - po[0], jo - jo[0],
                                      err_msg=f"{what}: offsets")
        pc, jc = p.children[0], j.children[0]
        # compare the elements the offsets cover
        if (po[0], po[-1]) != (0, pc.num_rows) or \
                (jo[0], jo[-1]) != (0, jc.num_rows):
            assert p.to_pylist() == j.to_pylist(), what
            return
        assert_same_nested(pc, jc, f"{what}.element")
    elif p.dtype.id == pt.TypeId.STRUCT:
        for i, (pc, jc) in enumerate(zip(p.children, j.children)):
            assert_same_nested(pc, jc, f"{what}.f{i}")
    elif p.dtype.is_variable_width:
        np.testing.assert_array_equal(p.offsets.numpy(), np.asarray(j.offsets),
                                      err_msg=f"{what}: offsets")
        np.testing.assert_array_equal(p.data.numpy(), np.asarray(j.data),
                                      err_msg=f"{what}: chars")
        return                       # the bytes need not be UTF-8
    else:
        assert_same(p, j, what=what)
    assert p.to_pylist() == j.to_pylist(), what
