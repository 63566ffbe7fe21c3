"""ctypes binding to the host C++ JCUDF engine (``csrc/rowconv_engine.cpp``).

The same ``to_rows_np`` / ``from_rows_np`` surface as the numpy oracle
(``reference.py``), backed by the C++ engine built into the port's
JVM-facing library (``_native.jni_library``): an *independent* second
oracle for the GPU path, as the reference holds two engines against each
other (``tests/row_conversion.cpp:49-58``).  The counterpart of the JAX
package's ``rowconv/native.py``, on port tables.
"""

from __future__ import annotations

import ctypes

import numpy as np

from .. import _native
from .. import types as T
from ..column import Column, Table
from .layout import compute_row_layout


def _ptr_array(arrays: list) -> ctypes.Array:
    """C array of void* from numpy arrays (None → nullptr)."""
    out = (ctypes.c_void_p * len(arrays))()
    for i, a in enumerate(arrays):
        out[i] = None if a is None else a.ctypes.data
    return out


def _i32(arr) -> np.ndarray:
    return np.ascontiguousarray(arr, dtype=np.int32)


def layout_native(schema: list[T.DType]) -> tuple:
    """Row layout computed by the C++ engine: (column starts,
    validity_offset, fixed_plus_validity, fixed_row_size)."""
    lib = _native.jni_library()
    sizes = _i32([dt.itemsize for dt in schema])
    aligns = _i32([dt.row_alignment for dt in schema])
    n = len(schema)
    starts = np.zeros(n, dtype=np.int32)
    vo, fpv, rs = ctypes.c_int32(), ctypes.c_int32(), ctypes.c_int32()
    rc = lib.srjt_layout(sizes.ctypes.data, aligns.ctypes.data, n,
                         starts.ctypes.data, ctypes.byref(vo),
                         ctypes.byref(fpv), ctypes.byref(rs))
    if rc != 0:
        raise ValueError("srjt_layout rejected schema")
    return tuple(starts.tolist()), int(vo.value), int(fpv.value), int(rs.value)


def _host_cols(table: Table):
    """(data bytes, validity bytes or None, string offsets or None) per
    column.  Payloads are the port's storage (FLOAT64 native, DECIMAL128
    int64 lanes), so their raw bytes are the row slots."""
    datas, valids, offs = [], [], []
    for col in table.columns:
        data = np.ascontiguousarray(col.data.cpu().numpy())
        datas.append(data.view(np.uint8).reshape(-1))
        offs.append(_i32(col.offsets.cpu().numpy())
                    if col.dtype.is_variable_width else None)
        valids.append(None if col.validity is None else
                      col.validity.cpu().numpy().astype(np.uint8))
    return datas, valids, offs


def to_rows_np(table: Table) -> tuple[np.ndarray, np.ndarray]:
    """Table → (row bytes uint8 [total], row offsets int32 [n+1]) via C++."""
    lib = _native.jni_library()
    layout = compute_row_layout(table.schema)
    n = table.num_rows
    starts = _i32(layout.column_starts)
    sizes = _i32(layout.column_sizes)
    datas, valids, offs = _host_cols(table)

    if layout.fixed_width_only:
        out = np.empty(n * layout.fixed_row_size, dtype=np.uint8)
        lib.srjt_pack_fixed(
            _ptr_array(datas), _ptr_array(valids), starts.ctypes.data,
            sizes.ctypes.data, table.num_columns, n, layout.fixed_row_size,
            layout.validity_offset, out.ctypes.data)
        row_offsets = np.arange(n + 1, dtype=np.int64) * layout.fixed_row_size
        return out, row_offsets.astype(np.int32)

    var_offs = [offs[ci] for ci in layout.variable_column_indices]
    row_offsets = np.zeros(n + 1, dtype=np.int64)
    total = lib.srjt_var_row_offsets(
        _ptr_array(var_offs), len(var_offs), n, layout.fixed_plus_validity,
        row_offsets.ctypes.data)
    is_var = np.asarray([dt.is_variable_width for dt in table.schema],
                        dtype=np.uint8)
    out = np.empty(int(total), dtype=np.uint8)
    lib.srjt_pack_var(
        _ptr_array(datas), _ptr_array(var_offs), _ptr_array(valids),
        starts.ctypes.data, sizes.ctypes.data, is_var.ctypes.data,
        table.num_columns, n, row_offsets.ctypes.data, layout.validity_offset,
        layout.fixed_plus_validity, out.ctypes.data)
    return out, row_offsets.astype(np.int32)


def from_rows_np(row_bytes: np.ndarray, row_offsets: np.ndarray,
                 schema: list[T.DType], device=None) -> Table:
    """(row bytes, row offsets) + schema → Table on ``device`` (the GPU
    unless the caller asks for the CPU) via the C++ engine."""
    lib = _native.jni_library()
    schema = list(schema)
    layout = compute_row_layout(schema)
    # the byte stream, whatever words it is held in
    row_bytes = np.ascontiguousarray(row_bytes).view(np.uint8).reshape(-1)
    row_offsets64 = np.ascontiguousarray(row_offsets, dtype=np.int64)
    n = row_offsets64.shape[0] - 1
    starts = _i32(layout.column_starts)
    sizes = _i32(layout.column_sizes)
    is_var = np.asarray([dt.is_variable_width for dt in schema],
                        dtype=np.uint8)

    out_data, out_valid, out_str_offsets = [], [], []
    for dt in schema:
        if dt.is_variable_width:
            out_data.append(None)
            out_str_offsets.append(np.zeros(n + 1, dtype=np.int32))
        else:
            out_data.append(np.empty(n * dt.itemsize, dtype=np.uint8))
        out_valid.append(np.empty(n, dtype=np.uint8))

    chars = {}
    if layout.fixed_width_only:
        lib.srjt_unpack_fixed(
            row_bytes.ctypes.data, n, layout.fixed_row_size,
            starts.ctypes.data, sizes.ctypes.data, len(schema),
            layout.validity_offset, _ptr_array(out_data),
            _ptr_array(out_valid))
    else:
        lib.srjt_unpack_var(
            row_bytes.ctypes.data, row_offsets64.ctypes.data, n,
            starts.ctypes.data, sizes.ctypes.data, is_var.ctypes.data,
            len(schema), layout.validity_offset,
            _ptr_array(out_data),   # indexed by column; string slots null
            _ptr_array(out_str_offsets), _ptr_array(out_valid))
        for vi, ci in enumerate(layout.variable_column_indices):
            offs = out_str_offsets[vi]
            buf = np.empty(int(offs[-1]), dtype=np.uint8)
            lib.srjt_gather_chars(
                row_bytes.ctypes.data, row_offsets64.ctypes.data, n,
                layout.column_starts[ci], offs.ctypes.data, buf.ctypes.data)
            chars[ci] = (buf, offs)

    cols = []
    for ci, dt in enumerate(schema):
        valid = out_valid[ci].astype(bool)
        v = None if valid.all() else valid
        if dt.is_variable_width:
            buf, offs = chars[ci]
            cols.append(Column.strings_from_arrays(buf, offs, v, device))
        else:
            lanes = np.int64 if dt.id == T.TypeId.DECIMAL128 else dt.storage
            cols.append(Column.from_numpy(out_data[ci].view(lanes), dt, v,
                                          device))
    return Table(cols)
