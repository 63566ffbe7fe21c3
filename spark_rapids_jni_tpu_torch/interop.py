"""Tables and row batches to and from plain numpy arrays.

This is how a table crosses between the port and any other holder of the
same data (the JAX package in the tests, a data generator, a file).  Each
column is a tuple ``(type_id, scale, data, offsets, validity)``:

* ``data``: the payload, numpy: [n] of the type's storage dtype (FLOAT64 as
  float64 values), int64 [n, 2] for DECIMAL128, uint8 chars for STRING;
* ``offsets``: int32 [n+1] for STRING, else None;
* ``validity``: bool [n], or None when every row is valid.
"""

from __future__ import annotations

from typing import Iterable, Optional

import numpy as np
import torch

from . import types as T
from .column import Column, Table, resolve_device
from .rowconv.convert import RowBatch

ColumnArrays = tuple[int, int, np.ndarray, Optional[np.ndarray],
                     Optional[np.ndarray]]


def column_from_numpy(col: ColumnArrays, device=None) -> Column:
    type_id, scale, data, offsets, validity = col
    dt = T.DType(T.TypeId(type_id), scale)
    if dt.is_variable_width:
        return Column.strings_from_arrays(data, offsets, validity, device)
    return Column.from_numpy(data, dt, validity, device)


def column_to_numpy(col: Column) -> ColumnArrays:
    offsets = None if col.offsets is None else col.offsets.cpu().numpy()
    validity = None if col.validity is None else col.validity.cpu().numpy()
    return (int(col.dtype.id), col.dtype.scale, col.data.cpu().numpy(),
            offsets, validity)


def table_from_numpy(cols: Iterable[ColumnArrays], device=None) -> Table:
    dev = resolve_device(device)
    return Table([column_from_numpy(c, dev) for c in cols])


def table_to_numpy(table: Table) -> list[ColumnArrays]:
    return [column_to_numpy(c) for c in table.columns]


def batch_from_numpy(data: np.ndarray, offsets: np.ndarray,
                     device=None) -> RowBatch:
    """A row batch from its host bytes and int32 [n+1] offsets."""
    dev = resolve_device(device)
    data = np.ascontiguousarray(data).view(np.uint8).reshape(-1)
    offsets = np.ascontiguousarray(offsets, dtype=np.int32)
    return RowBatch(torch.from_numpy(data.copy()).to(dev),
                    torch.from_numpy(offsets.copy()).to(dev))
