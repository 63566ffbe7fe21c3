"""Vectorized host (numpy) JCUDF engine for fixed-width tables.

The counterpart of the JAX package's ``rowconv/host.py``: the fastest
reasonable pure-numpy transcode (strided views and ``packbits``, no Python
loop over rows), a CPU baseline beside the GPU path.  ``reference.py`` stays
the deliberately scalar oracle.  Payloads are the port's storage (FLOAT64
as native float64, DECIMAL128 as int64 [n, 2] lanes), so a raw byte view of
a column is its row slot.
"""

from __future__ import annotations

import numpy as np

from .. import types as T
from ..column import Table
from .layout import compute_row_layout


def _valid_matrix(table: Table) -> np.ndarray:
    return np.stack([c.validity_or_true().cpu().numpy()
                     for c in table.columns], axis=1)


def to_rows_fixed_np(table: Table) -> np.ndarray:
    """Fixed-width table → uint8 [n, fixed_row_size]."""
    layout = compute_row_layout(table.schema)
    if not layout.fixed_width_only:
        raise ValueError("to_rows_fixed_np takes fixed-width tables only")
    n = table.num_rows
    out = np.zeros((n, layout.fixed_row_size), dtype=np.uint8)
    for ci, col in enumerate(table.columns):
        start = layout.column_starts[ci]
        sz = layout.column_sizes[ci]
        data = np.ascontiguousarray(col.data.cpu().numpy())
        out[:, start:start + sz] = data.view(np.uint8).reshape(n, sz)
    vbytes = np.packbits(_valid_matrix(table), axis=1, bitorder="little")
    out[:, layout.validity_offset:
        layout.validity_offset + layout.validity_bytes] = vbytes
    return out


def from_rows_fixed_np(rows: np.ndarray, schema) -> tuple[list, np.ndarray]:
    """uint8 [n, row_size] → (payload arrays in the port's storage, valid
    bool [n, ncols])."""
    layout = compute_row_layout(list(schema))
    if not layout.fixed_width_only:
        raise ValueError("from_rows_fixed_np takes fixed-width schemas only")
    n = rows.shape[0]
    datas = []
    for ci, dt in enumerate(layout.schema):
        start = layout.column_starts[ci]
        sz = layout.column_sizes[ci]
        b = np.ascontiguousarray(rows[:, start:start + sz])
        if dt.id == T.TypeId.DECIMAL128:
            datas.append(b.view(np.int64).reshape(n, 2))
        else:
            datas.append(b.view(dt.storage).reshape(n))
    vb = rows[:, layout.validity_offset:
              layout.validity_offset + layout.validity_bytes]
    valid = np.unpackbits(np.ascontiguousarray(vb), axis=1,
                          bitorder="little")[:, :layout.num_columns].astype(bool)
    return datas, valid
