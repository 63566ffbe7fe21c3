"""Null-aware column reductions (libcudf ``reduce``).

The port's counterpart of the JAX package's ``ops/reductions.py``: null
slots take the operation's identity and the column reduces in one pass;
``valid_count`` counts the valid rows.  Spark semantics: aggregates skip
nulls, and min or max of an all-null column is the identity (callers check
``valid_count``).  Each returns a 0-d tensor on the column's device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..column import Column
from .int64bits import identity, widened


def _masked(data: torch.Tensor, col: Column, identity) -> torch.Tensor:
    if col.validity is None:
        return data
    return torch.where(col.validity, data, identity)


def valid_count(col: Column) -> torch.Tensor:
    if col.validity is None:
        return torch.full((), col.num_rows, dtype=torch.int64,
                          device=col.device)
    return col.validity.sum(dtype=torch.int64)


def sum_(col: Column) -> torch.Tensor:
    acc = torch.float64 if col.dtype.storage.kind == "f" else torch.int64
    return _masked(col.data.to(acc), col, 0).sum()


def _extreme(col: Column, agg: str) -> torch.Tensor:
    work, back = widened(col.data)
    ident = identity(np.dtype(col.dtype.storage), agg)
    data = _masked(work, col, ident)
    if data.shape[0] == 0:
        return back(torch.full((), ident, dtype=work.dtype,
                               device=col.device))
    return back(data.amin() if agg == "min" else data.amax())


def min_(col: Column) -> torch.Tensor:
    return _extreme(col, "min")


def max_(col: Column) -> torch.Tensor:
    return _extreme(col, "max")


def mean(col: Column) -> torch.Tensor:
    n = valid_count(col)
    return sum_(col).to(torch.float64) / n.clamp(min=1).to(torch.float64)
