"""Window functions (libcudf rolling and grouped windows, Spark's
``OVER (PARTITION BY … ORDER BY …)``).

The port's counterpart of the JAX package's ``ops/window.py``.  One
multi-key sort (``ops.sort.order_by``) puts the rows in (partition,
order) order; every window function is then a segmented scan, a global
prefix scan corrected at the partition heads, and its result goes back
to the input order through the inverse permutation.  Partition keys
compare as groupby compares them: FLOAT64 under Spark's equality
(``ops.filter.equality_key``: -0.0 is 0.0, every NaN one value), STRING
by order-preserving dictionary codes (``ops.strings.dictionary_encode``,
kernel B3 on the card), nulls one partition.

Supported: ``row_number``, ``rank``, ``dense_rank``, ``lag``/``lead``
and the partitioned running ``sum``, ``count``, ``max`` and ``min``.
Torch has no general associative scan, so the running extremes take
log2(n) doubling steps of ``torch.maximum``/``torch.minimum`` over rows
of one partition, which give the JAX package's reset-flag scan's values.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from .. import types as T
from ..column import Column, Table, force_column
from .filter import equality_key
from .groupby import neq_with_null_merge
from .int64bits import identity, widened
from .sort import order_by


def _sorted_key(col: Column, order: torch.Tensor) -> torch.Tensor:
    """A key column's equality lane(s) in window order: [n] or [n, 2]."""
    if col.dtype.is_variable_width:
        from . import strings
        codes, _ = strings.dictionary_encode(col)
        return codes.data[order]
    col = force_column(col)
    if col.dtype.id == T.TypeId.FLOAT64:
        return equality_key(col.data)[order]
    return col.data[order]


def _adjacent_neq(col: Column, order: torch.Tensor) -> torch.Tensor:
    """bool [n-1]: sorted row i+1 differs from row i on ``col``, nulls
    one value whatever their payload."""
    k = _sorted_key(col, order)
    neq = k[1:] != k[:-1]
    if neq.dim() == 2:                   # decimal128 limbs
        neq = neq.any(dim=1)
    v = col.validity
    if v is not None:
        sv = v[order]
        neq = neq_with_null_merge(neq, sv[1:], sv[:-1])
    return neq


class WindowSpec:
    """A resolved window: the rows' (partition, order) permutation, its
    inverse, the partition heads and each sorted row's partition."""

    def __init__(self, table: Table, partition_by: Sequence[int],
                 order_by_keys: Sequence[int],
                 ascending: Sequence[bool] | None = None):
        self.table = table
        n = table.num_rows
        dev = table.device
        keys = list(partition_by) + list(order_by_keys)
        asc = ([True] * len(partition_by)
               + (list(ascending) if ascending else
                  [True] * len(order_by_keys)))
        self.order = order_by(table, keys, asc)
        self.inv = torch.empty_like(self.order)
        self.inv[self.order] = torch.arange(n, dtype=self.order.dtype,
                                            device=dev)
        head = torch.zeros(n, dtype=torch.bool, device=dev)
        if n:
            head[:1].fill_(True)
            for ki in partition_by:
                head[1:] |= _adjacent_neq(table[ki], self.order)
        self.head = head
        self.seg_id = torch.cumsum(head, 0) - 1

    # -- the segmented-scan core --------------------------------------------
    def _seg_base(self, scanned: torch.Tensor) -> torch.Tensor:
        """Each sorted row's value of the inclusive global scan
        ``scanned`` just before its partition's head (0 in the first
        partition): subtracted, it makes the scan a segmented one."""
        n = scanned.shape[0]
        pos = torch.arange(n, dtype=torch.int64, device=scanned.device)
        head_pos = torch.where(self.head, pos, 0)
        if n:
            head_pos = torch.cummax(head_pos, 0).values
        prev = scanned[(head_pos - 1).clamp(min=0)]
        return torch.where(head_pos > 0, prev, torch.zeros_like(prev))

    def _to_input_order(self, sorted_vals: torch.Tensor, dtype: T.DType,
                        validity=None) -> Column:
        vals = sorted_vals[self.inv]
        v = None if validity is None else validity[self.inv]
        return Column(dtype, vals.to(dtype.torch_storage), validity=v)


def row_number(spec: WindowSpec) -> Column:
    """1-based position within the partition (Spark row_number())."""
    n = spec.table.num_rows
    pos = torch.arange(1, n + 1, dtype=torch.int64, device=spec.head.device)
    return spec._to_input_order(pos - spec._seg_base(pos), T.int64)


def _order_change(spec: WindowSpec, order_keys: Sequence[int]):
    """bool [n]: the sorted row differs from its predecessor on the ORDER
    keys or starts a partition, the tie boundary of rank and dense_rank.
    NULL is a value of its own, and the NULLs tie."""
    change = spec.head.clone()
    if spec.table.num_rows:
        for ki in order_keys:
            change[1:] |= _adjacent_neq(spec.table[ki], spec.order)
    return change


def rank(spec: WindowSpec, order_keys: Sequence[int]) -> Column:
    """Spark rank(): ties share a rank, gaps after ties."""
    n = spec.table.num_rows
    change = _order_change(spec, order_keys)
    pos = torch.arange(1, n + 1, dtype=torch.int64, device=change.device)
    # the row number of the first row of the tie run, within partition
    run_start = torch.where(change, pos, 0)
    if n:
        run_start = torch.cummax(run_start, 0).values
    return spec._to_input_order(run_start - spec._seg_base(pos), T.int64)


def dense_rank(spec: WindowSpec, order_keys: Sequence[int]) -> Column:
    """Spark dense_rank(): ties share a rank, no gaps."""
    change = _order_change(spec, order_keys)
    distinct = torch.cumsum(change, 0, dtype=torch.int64)
    return spec._to_input_order(distinct - spec._seg_base(distinct),
                                T.int64)


def lag(spec: WindowSpec, value_col: int, offset: int = 1) -> Column:
    """The value ``offset`` rows earlier in the partition; null at the
    head."""
    return _shift(spec, value_col, offset)


def lead(spec: WindowSpec, value_col: int, offset: int = 1) -> Column:
    """The value ``offset`` rows later in the partition; null at the
    tail."""
    return _shift(spec, value_col, -offset)


def _shift(spec: WindowSpec, value_col: int, offset: int) -> Column:
    col = force_column(spec.table[value_col])
    if col.dtype.is_variable_width or col.dtype.is_nested:
        raise TypeError(f"lag/lead not supported on {col.dtype.id.name}")
    n = col.num_rows
    src = torch.arange(n, dtype=torch.int64, device=col.device) - offset
    in_bounds = (src >= 0) & (src < n)
    src_c = src.clamp(0, max(n - 1, 0))
    sorted_vals = col.data[spec.order][src_c]
    # a row across a partition boundary is outside the window: null
    ok = in_bounds & (spec.seg_id == spec.seg_id[src_c])
    if col.validity is not None:
        ok = ok & col.validity[spec.order][src_c]
    return spec._to_input_order(sorted_vals, col.dtype, validity=ok)


def _check_scannable(col: Column) -> None:
    if (col.dtype.is_variable_width or col.dtype.is_nested
            or col.dtype.id == T.TypeId.DECIMAL128):
        raise TypeError(
            f"window scans not supported on {col.dtype.id.name}")


def running_sum(spec: WindowSpec, value_col: int) -> Column:
    """Partitioned running sum over the window order; a null adds 0 and
    stays null (the scan's EXCLUDE policy, ``ops.scan``).  A float sum is
    a global ``cumsum`` less the partition's base, as in the JAX package,
    so its last bits depend on the device's summation order."""
    col = force_column(spec.table[value_col])
    _check_scannable(col)
    acc_dt = (T.decimal64(col.dtype.scale) if col.dtype.is_decimal
              else T.float64 if col.dtype.storage.kind == "f"
              else T.int64)
    data = col.data[spec.order].to(acc_dt.torch_storage)
    sv = None if col.validity is None else col.validity[spec.order]
    if sv is not None:
        data = torch.where(sv, data, torch.zeros_like(data))
    scanned = torch.cumsum(data, 0)
    out = scanned - spec._seg_base(scanned)
    return spec._to_input_order(out, acc_dt, validity=sv)


def running_count(spec: WindowSpec, value_col: int) -> Column:
    """Partitioned running count of the valid rows."""
    col = force_column(spec.table[value_col])
    ones = (col.validity[spec.order].to(torch.int64)
            if col.validity is not None
            else torch.ones(col.num_rows, dtype=torch.int64,
                            device=col.device))
    scanned = torch.cumsum(ones, 0)
    return spec._to_input_order(scanned - spec._seg_base(scanned), T.int64)


def _running_extreme(spec: WindowSpec, value_col: int, is_max: bool):
    """Segmented cummax/cummin: max and min have no subtraction trick, so
    each doubling step ``d`` combines a row with the row ``d`` earlier
    where both lie in one partition (Hillis-Steele); after log2(n) steps
    each row holds the extreme of its partition so far."""
    col = force_column(spec.table[value_col])
    _check_scannable(col)
    agg = "max" if is_max else "min"
    data, back = widened(col.data[spec.order])
    sv = None if col.validity is None else col.validity[spec.order]
    if sv is not None:
        ident = identity(np.dtype(col.dtype.storage), agg)
        data = torch.where(sv, data, torch.full((), ident, dtype=data.dtype,
                                                device=data.device))
    combine = torch.maximum if is_max else torch.minimum
    n = data.shape[0]
    d = 1
    while d < n:
        same = spec.seg_id[d:] == spec.seg_id[:-d]
        step = data.clone()
        step[d:] = torch.where(same, combine(data[d:], data[:-d]), data[d:])
        data = step
        d *= 2
    return spec._to_input_order(back(data), col.dtype, validity=sv)


def running_max(spec: WindowSpec, value_col: int) -> Column:
    """Partitioned running max (nulls skipped, and stay null)."""
    return _running_extreme(spec, value_col, True)


def running_min(spec: WindowSpec, value_col: int) -> Column:
    """Partitioned running min (nulls skipped, and stay null)."""
    return _running_extreme(spec, value_col, False)
