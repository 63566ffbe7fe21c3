"""Cumulative (scan) operations (libcudf ``scan``, Spark's running
aggregates).

The port's counterpart of the JAX package's ``ops/scan.py``, with cudf's
``null_policy::EXCLUDE``: a null row adds the identity to the running
value and stays null; a valid row sees the accumulation over the valid
rows so far.  Each scan is one torch op: ``cumsum``, or ``cummax`` /
``cummin`` (the JAX package's associative scans) in the widened domain
of ``ops.int64bits``.  Sums widen to int64 or float64, decimals to
decimal64 at their own scale.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import types as T
from ..column import Column, force_column
from .int64bits import identity, widened


def _scan(col: Column, op: str) -> Column:
    col = force_column(col)
    if (col.dtype.is_variable_width or col.dtype.is_nested
            or col.dtype.id == T.TypeId.DECIMAL128):
        raise TypeError(f"scan not supported on {col.dtype.id.name}")
    storage = np.dtype(col.dtype.storage)
    if op == "sum":
        # 64-bit like Spark's running sum; decimals keep their scale but
        # widen to decimal64 (decimal32 would wrap)
        if col.dtype.is_decimal:
            out_dt = T.decimal64(col.dtype.scale)
        else:
            out_dt = T.float64 if storage.kind == "f" else T.int64
        work, back = col.data.to(out_dt.torch_storage), (lambda r: r)
        ident = 0
    else:
        # min and max scan in the widened domain (any storage width)
        out_dt = col.dtype
        work, back = widened(col.data)
        ident = identity(storage, op)
    if col.validity is not None:
        work = torch.where(col.validity, work,
                           torch.full((), ident, dtype=work.dtype,
                                      device=work.device))
    if work.shape[0] == 0:
        res = work
    elif op == "sum":
        res = torch.cumsum(work, 0)
    elif op == "min":
        res = torch.cummin(work, 0).values
    else:
        res = torch.cummax(work, 0).values
    return Column(out_dt, back(res), validity=col.validity)


def cumulative_sum(col: Column) -> Column:
    return _scan(col, "sum")


def cumulative_min(col: Column) -> Column:
    return _scan(col, "min")


def cumulative_max(col: Column) -> Column:
    return _scan(col, "max")


def cumulative_count(col: Column) -> Column:
    """Running count of the valid rows (Spark count over an expanding
    window)."""
    col = force_column(col)
    ones = (col.validity.to(torch.int64) if col.validity is not None
            else torch.ones(col.num_rows, dtype=torch.int64,
                            device=col.device))
    return Column(T.int64, torch.cumsum(ones, 0))
