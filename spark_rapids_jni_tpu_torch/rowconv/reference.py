"""Host (numpy) oracle for the JCUDF row format, the port's own copy.

Deliberately scalar and readable: it is the specification the device path
is held against, byte for byte.  A Python loop over rows and columns, so
keep it to slices of about ten thousand rows.
"""

from __future__ import annotations

import numpy as np

from .. import types as T
from ..column import Column, Table
from .layout import compute_row_layout, row_sizes_with_strings


def _row_bytes(col: Column) -> np.ndarray:
    """A fixed-width column's payload as host uint8 [n, itemsize]."""
    data = np.ascontiguousarray(col.data.cpu().numpy())
    return data.view(np.uint8).reshape(col.num_rows, col.dtype.itemsize)


def to_rows_np(table: Table) -> tuple[np.ndarray, np.ndarray]:
    """Table → (row bytes uint8 [total], row offsets int32 [n+1])."""
    layout = compute_row_layout(table.schema)
    n = table.num_rows
    host_offs = [None if c.offsets is None else c.offsets.cpu().numpy()
                 .astype(np.int64) for c in table.columns]
    host_chars = [c.data.cpu().numpy() if c.dtype.is_variable_width
                  else None for c in table.columns]
    host_fixed = [None if c.dtype.is_variable_width else _row_bytes(c)
                  for c in table.columns]
    host_valid = [c.validity_or_true().cpu().numpy() for c in table.columns]

    if layout.fixed_width_only:
        row_sizes = np.full(n, layout.fixed_row_size, dtype=np.int64)
    else:
        total_lens = np.zeros(n, dtype=np.int64)
        for ci in layout.variable_column_indices:
            total_lens += host_offs[ci][1:] - host_offs[ci][:-1]
        row_sizes = row_sizes_with_strings(layout, total_lens)
    row_offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(row_sizes, out=row_offsets[1:])
    out = np.zeros(int(row_offsets[-1]), dtype=np.uint8)

    for r in range(n):
        base = int(row_offsets[r])
        var_cursor = layout.fixed_plus_validity
        for ci, col in enumerate(table.columns):
            start = base + layout.column_starts[ci]
            if col.dtype.is_variable_width:
                offs = host_offs[ci]
                length = int(offs[r + 1] - offs[r])
                slot = np.asarray([var_cursor, length], dtype=np.uint32)
                out[start:start + 8] = slot.view(np.uint8)
                out[base + var_cursor:base + var_cursor + length] = \
                    host_chars[ci][offs[r]:offs[r + 1]]
                var_cursor += length
            else:
                sz = layout.column_sizes[ci]
                out[start:start + sz] = host_fixed[ci][r]
        # bit i of validity byte b is column b*8+i (RowConversion.java:56-58)
        vbase = base + layout.validity_offset
        for b in range(layout.validity_bytes):
            byte = 0
            for i in range(min(8, table.num_columns - b * 8)):
                if host_valid[b * 8 + i][r]:
                    byte |= 1 << i
            out[vbase + b] = byte
    return out, row_offsets.astype(np.int32)


def from_rows_np(row_bytes: np.ndarray, row_offsets: np.ndarray,
                 schema: list[T.DType], device=None) -> Table:
    """(row bytes, row offsets) + schema → Table (inverse of to_rows_np)."""
    layout = compute_row_layout(schema)
    row_bytes = np.asarray(row_bytes, dtype=np.uint8)
    row_offsets = np.asarray(row_offsets, dtype=np.int64)
    n = row_offsets.shape[0] - 1

    fixed = {ci: np.zeros((n, layout.column_sizes[ci]), dtype=np.uint8)
             for ci, dt in enumerate(schema) if not dt.is_variable_width}
    strings = {ci: [] for ci, dt in enumerate(schema) if dt.is_variable_width}
    validities = np.zeros((n, len(schema)), dtype=bool)
    for r in range(n):
        base = int(row_offsets[r])
        vbase = base + layout.validity_offset
        for ci, dt in enumerate(schema):
            validities[r, ci] = bool(
                (row_bytes[vbase + ci // 8] >> (ci % 8)) & 1)
            start = base + layout.column_starts[ci]
            if dt.is_variable_width:
                slot = row_bytes[start:start + 8].view(np.uint32)
                off, length = int(slot[0]), int(slot[1])
                strings[ci].append(row_bytes[base + off:base + off + length])
            else:
                fixed[ci][r] = row_bytes[start:start + layout.column_sizes[ci]]

    cols = []
    for ci, dt in enumerate(schema):
        valid = validities[:, ci]
        if dt.is_variable_width:
            offs = np.zeros(n + 1, dtype=np.int32)
            np.cumsum([len(b) for b in strings[ci]], out=offs[1:])
            chars = (np.concatenate(strings[ci]) if offs[-1]
                     else np.zeros(0, dtype=np.uint8))
            cols.append(Column.strings_from_arrays(chars, offs, valid, device))
        else:
            payload = fixed[ci].view(np.dtype(np.int64) if dt.id ==
                                     T.TypeId.DECIMAL128 else dt.storage)
            cols.append(Column.from_numpy(payload, dt, valid, device))
    return Table(cols)
