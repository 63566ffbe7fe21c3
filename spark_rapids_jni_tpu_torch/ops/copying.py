"""Table copies: concatenate and slice (libcudf ``concatenate``,
``slice``).

The port's counterpart of the JAX package's ``ops/copying.py``.
Concatenation defers each column as a :class:`LazyColumn`, as the JAX
package's does, so that concatenating lazy join outputs forces none of
the columns the plan never reads; forced, it joins the column's
buffers and rebases string offsets on the device.  A slice takes host
bounds, and a STRING slice reads its two char bounds (two
synchronisations, through ``utils.syncs``).  A
:class:`DictColumn` concatenates or slices as its materialized chars, as
in the JAX package.
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..column import Column, LazyColumn, Table
from ..utils import syncs


def _concat_validity(cols: Sequence[Column]):
    if all(c.validity is None for c in cols):
        return None
    return torch.cat([c.validity_or_true() for c in cols])


def _rebase_offsets(cols: Sequence[Column]) -> torch.Tensor:
    parts = [cols[0].offsets]
    base = cols[0].offsets[-1]
    for c in cols[1:]:
        parts.append(c.offsets[1:] + base)
        base = base + c.offsets[-1]
    return torch.cat(parts)


def _concat_columns(cols: Sequence[Column]) -> Column:
    dt = cols[0].dtype
    for c in cols:
        if c.dtype != dt:
            raise TypeError(f"concat dtype mismatch: {c.dtype} vs {dt}")
    if dt.is_nested:
        raise NotImplementedError(f"concat of {dt.id.name} is not ported")
    v = _concat_validity(cols)
    if dt.is_variable_width:
        return Column(dt, torch.cat([c.data for c in cols]),
                      _rebase_offsets(cols), v)
    return Column(dt, torch.cat([c.data for c in cols]), validity=v)


def concat_tables(tables: Sequence[Table]) -> Table:
    """Row-wise concatenation (libcudf ``concatenate``), each column
    deferred.  Type mismatches raise here, not when a column is forced."""
    tables = list(tables)
    if not tables:
        raise ValueError("concat_tables needs at least one table")
    ncols = tables[0].num_columns
    for t in tables:
        if t.num_columns != ncols:
            raise ValueError("concat_tables: column count mismatch")
    for i in range(ncols):
        dt = tables[0][i].dtype
        for t in tables[1:]:
            if t[i].dtype != dt:
                raise TypeError(
                    f"concat dtype mismatch: {t[i].dtype} vs {dt}")
    n_out = sum(t.num_rows for t in tables)
    # each thunk holds its own column list only, not every input table
    by_index = [[t[i] for t in tables] for i in range(ncols)]
    return Table([
        LazyColumn(cols[0].dtype, n_out, cols[0].device,
                   lambda cols=cols: _concat_columns(cols))
        for cols in by_index])


def _slice_column(col: Column, start: int, stop: int) -> Column:
    v = None if col.validity is None else col.validity[start:stop]
    if col.dtype.is_nested:
        raise NotImplementedError(f"slice of {col.dtype.id.name} is not "
                                  "ported")
    if col.dtype.is_variable_width:
        offs = col.offsets[start:stop + 1]
        c0, c1 = syncs.scalar(offs[0]), syncs.scalar(offs[-1])
        chars = col.data[c0:c1]
        # cut into the chars taken, a no-op unless the tape is stale
        return Column(col.dtype, chars,
                      (offs - c0).clamp(0, chars.shape[0]), v)
    return Column(col.dtype, col.data[start:stop], validity=v)


def slice_table(table: Table, start: int, length: int | None = None) -> Table:
    """Zero-based row slice with host bounds (libcudf ``slice``)."""
    n = table.num_rows
    start = max(0, min(start, n))
    stop = n if length is None else max(start, min(start + length, n))
    return Table([_slice_column(c, start, stop) for c in table.columns])
