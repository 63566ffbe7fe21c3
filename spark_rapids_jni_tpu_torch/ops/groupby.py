"""Sort-based groupby-aggregate (libcudf ``groupby``).

The port's counterpart of the JAX package's ``ops/groupby.py``
(``groupby_aggregate`` with every aggregate of ``_AGGS``, its empty and
grand-total paths, ``distinct``, the grouping sets, rollup, cube and
``nunique``).  The keys are sorted
(``ops.sort.order_by``), a segment starts wherever a key changes, and
the aggregates are segment reductions: ``index_add_`` for sums and counts
(int64 sums are exact in any order; float sums are not, and are held to
a tolerance), by parts of at most 1,024 rows and then by segment, so
that few rows add onto one address and a float sum stays short;
``scatter_reduce_`` for min, max, first and last.  The group count is
the one synchronisation (``utils.syncs``).  String keys become
order-preserving codes (``ops.strings.dictionary_encode``) and are
decoded at the end; DECIMAL128 sums are limb sums
(``decimal128.segmented_sum``); decimal means, variances and deviations
are taken in the value domain; FLOAT64 keys group under Spark's equality
(-0.0 is 0.0, every NaN one value), and FLOAT64 min, max, first and last
return a row's own value.

Grouping sets, rollup and cube are one groupby a set, concatenated with a
``grouping_id``; ``nunique`` is two groupbys.  The mergeable partial
states are not ported yet.
"""

from __future__ import annotations

import itertools
from typing import Sequence

import numpy as np
import torch

from .. import types as T
from ..column import Column, Table
from ..utils import syncs
from .filter import _gather_column, equality_key, gather
from .int64bits import TOPBIT, identity, widened
from .sort import f64_sort_key_lanes, order_by

_AGGS = ("sum", "count", "min", "max", "mean", "var", "std",
         "first", "last")


# -- segment reductions ------------------------------------------------------

def _segment_sum(x: torch.Tensor, seg: torch.Tensor, n: int) -> torch.Tensor:
    return torch.zeros(n, dtype=x.dtype, device=x.device).index_add_(0, seg, x)


# rows a partial float sum adds up before the partials are summed
_CHUNK = 1024


def _parts(seg: torch.Tensor, n: int):
    """Rows sorted by segment cut into parts: runs of at most _CHUNK rows
    of one segment.  Returns (part of each row, segment of each part,
    part count bound), or None where the segments are short already.  The
    bound needs no synchronisation; an unused part is empty and says
    segment 0."""
    rows = seg.shape[0]
    bound = n + rows // _CHUNK + 1
    if rows <= _CHUNK or 2 * bound >= rows:
        return None
    pos = torch.arange(rows, device=seg.device)
    new = torch.ones(rows, dtype=torch.bool, device=seg.device)
    new[1:] = (seg[1:] != seg[:-1]) | (pos[1:] % _CHUNK == 0)
    part = torch.cumsum(new, 0) - 1
    part_seg = torch.zeros(bound, dtype=seg.dtype, device=seg.device)
    part_seg.scatter_(0, part, seg)
    return part, part_seg, bound


def _sorted_segment_sum(x: torch.Tensor, seg: torch.Tensor,
                        n: int) -> torch.Tensor:
    """Segment sums of rows sorted by segment, by parts, then the parts'
    sums by segment, level by level.  One long run of ``index_add_`` onto
    one address serialises its atomics (a few ms for SF1's rows on four
    groups) and, for floats, loses a relative 1e-12 over a million equal
    addends (TPC-H Q1's discounts at SF1); parts keep it near 1e-15."""
    parts = _parts(seg, n)
    if parts is None:
        return _segment_sum(x, seg, n)
    part, part_seg, bound = parts
    return _sorted_segment_sum(_segment_sum(x, part, bound), part_seg, n)


def _sorted_d128_sum(col: Column, seg: torch.Tensor, n: int) -> Column:
    """``decimal128.segmented_sum`` of rows sorted by segment, by parts
    (sums mod 2^128 in any grouping are the same)."""
    from . import decimal128 as d128
    parts = _parts(seg, n)
    if parts is None:
        return d128.segmented_sum(col, seg, n)
    part, part_seg, bound = parts
    return d128.segmented_sum(d128.segmented_sum(col, part, bound), part_seg,
                              n)


def _segment_reduce(x: torch.Tensor, seg: torch.Tensor, n: int, how: str,
                    identity) -> torch.Tensor:
    """``how`` ("amin" or "amax") per segment; an empty segment gives
    ``identity``."""
    out = torch.full((n,), identity, dtype=x.dtype, device=x.device)
    return out.scatter_reduce_(0, seg, x, how)


def _segment_ids(sorted_keys, sorted_valid) -> torch.Tensor:
    """int64 segment id of every sorted row: 0-based, up by one at each new
    key tuple.  Nulls form one group whatever their payload."""
    n = sorted_keys[0].shape[0]
    head = torch.zeros(n, dtype=torch.bool, device=sorted_keys[0].device)
    for k, v in zip(sorted_keys, sorted_valid):
        neq = k[1:] != k[:-1]
        if v is not None:
            neq = neq_with_null_merge(neq, v[1:], v[:-1])
        head[1:] |= neq
    return torch.cumsum(head, 0)


def resolve_segments(seg: torch.Tensor) -> tuple[torch.Tensor, int]:
    """The segment count of non-empty sorted segment ids (the one
    synchronisation), and the ids cut below it: a no-op unless a stale
    tape gave the count, when it keeps every segment reduction in
    bounds."""
    ns = syncs.size(seg[-1], seg.shape[0] - 1) + 1
    return seg.clamp(max=ns - 1), ns


def neq_with_null_merge(neq, v1, v0):
    """Adjacent-key inequality under nulls-form-one-group: a validity flip
    is a boundary, two null neighbours are equal."""
    return (neq & v1 & v0) | (v1 != v0)


def _count(valid, seg, n_rows: int, num_segments: int) -> torch.Tensor:
    ones = (torch.ones(n_rows, dtype=torch.int64, device=seg.device)
            if valid is None else valid.to(torch.int64))
    return _sorted_segment_sum(ones, seg, num_segments)


def _select_pos(valid, seg, num_segments: int, agg: str) -> torch.Tensor:
    """The row of each segment that first or last returns: its first or
    last valid row (Spark's ignoreNulls)."""
    n = seg.shape[0]
    pos = torch.arange(n, dtype=torch.int64, device=seg.device)
    if agg == "first":
        vpos = pos if valid is None else torch.where(valid, pos, n)
        return _segment_reduce(vpos, seg, num_segments, "amin", n)
    vpos = pos if valid is None else torch.where(valid, pos, -1)
    return _segment_reduce(vpos, seg, num_segments, "amax", -1)


def _agg_segment(data, valid, seg, agg, num_segments, storage):
    """One aggregate over the segments of sorted ``data``."""
    n = seg.shape[0]
    if agg == "count":
        return _count(valid, seg, n, num_segments)
    if agg in ("sum", "mean"):
        acc = data.to(torch.float64 if storage.kind == "f" else torch.int64)
        if valid is not None:
            acc = torch.where(valid, acc, 0)
        s = _sorted_segment_sum(acc, seg, num_segments)
        if agg == "sum":
            return s
        cnt = _count(valid, seg, n, num_segments)
        return s.to(torch.float64) / cnt.clamp(min=1).to(torch.float64)
    if agg in ("first", "last"):
        p = _select_pos(valid, seg, num_segments, agg)
        return data[p.clamp(0, max(n - 1, 0))]
    if agg in ("min", "max"):
        work, back = widened(data)
        ident = identity(storage, agg)
        if valid is not None:
            work = torch.where(valid, work, ident)
        return back(_segment_reduce(work, seg, num_segments, "a" + agg,
                                    ident))
    raise ValueError(f"unknown aggregation {agg!r} (supported: {_AGGS})")


def _f64_select_pos(col: Column, seg, num_segments: int, agg: str):
    """The row whose FLOAT64 value min, max, first or last returns: min
    and max by the monotone key (NaN largest, -0.0 below 0.0), ties to the
    first row."""
    if agg in ("first", "last"):
        return _select_pos(col.validity, seg, num_segments, agg)
    n = seg.shape[0]
    lo_k, hi_k = f64_sort_key_lanes(col)
    key = ((hi_k << 32) | lo_k) ^ TOPBIT        # unsigned order, signed
    if agg == "max":
        key = ~key
    big = (1 << 63) - 1
    if col.validity is not None:
        key = torch.where(col.validity, key, big)
    best = _segment_reduce(key, seg, num_segments, "amin", big)
    hit = key == best[seg]
    if col.validity is not None:
        # a valid extreme can tie the null sentinel: never a null's value
        hit = hit & col.validity
    pos = torch.arange(n, dtype=torch.int64, device=seg.device)
    return _segment_reduce(torch.where(hit, pos, n), seg, num_segments,
                           "amin", n)


def _var_segment(x, valid, seg, num_segments, cnt, std: bool):
    """Sample variance or deviation (ddof 1, Spark's var_samp and
    stddev_samp), two passes: the segment means, then squared
    deviations."""
    x = x.to(torch.float64)
    if valid is not None:
        x = torch.where(valid, x, 0.0)
    cntf = cnt.to(torch.float64)
    mean = _sorted_segment_sum(x, seg, num_segments) / cntf.clamp(min=1.0)
    dev = x - mean[seg]
    if valid is not None:
        dev = torch.where(valid, dev, 0.0)
    var = (_sorted_segment_sum(dev * dev, seg, num_segments)
           / (cntf - 1.0).clamp(min=1.0))
    return torch.sqrt(var) if std else var


# -- the entry points --------------------------------------------------------

def groupby_aggregate(table: Table, key_indices: Sequence[int],
                      aggs: Sequence[tuple[int, str]]) -> Table:
    """GROUP BY the key columns, computing (value column, aggregate)
    pairs.  Returns [key columns..., aggregates...], one row a distinct
    key tuple, in key order."""
    n = table.num_rows
    if n == 0:
        if not key_indices:
            # GROUP BY () over no rows: one row, count 0, the rest null
            return _grand_total_empty(table, aggs)
        return _empty_result(table, key_indices, aggs)
    str_dicts: dict[int, Column] = {}
    work_cols = list(table.columns)
    for ki in key_indices:
        if table[ki].dtype.is_nested:
            raise NotImplementedError(
                f"{table[ki].dtype.id.name} columns cannot be groupby/"
                "distinct keys")
        if table[ki].dtype.is_variable_width:
            from . import strings
            codes, uniq = strings.dictionary_encode(table[ki])
            work_cols[ki] = codes
            str_dicts[ki] = uniq
    table = Table(work_cols)
    dev = table.device
    if not key_indices:
        seg = torch.zeros(n, dtype=torch.int64, device=dev)
        return _aggregate_sorted(table, [], {}, seg, 1, aggs, n)
    sorted_tbl = gather(table, order_by(table, list(key_indices)))
    skeys, svalid = [], []
    for ki in key_indices:
        col = sorted_tbl[ki]
        if col.dtype.id == T.TypeId.FLOAT64:
            skeys.append(equality_key(col.data))
            svalid.append(col.validity)
        elif col.dtype.id == T.TypeId.DECIMAL128:
            skeys += [col.data[:, 0], col.data[:, 1]]
            svalid += [col.validity, col.validity]
        else:
            skeys.append(col.data)
            svalid.append(col.validity)
    seg, num_segments = resolve_segments(_segment_ids(skeys, svalid))
    return _aggregate_sorted(sorted_tbl, list(key_indices), str_dicts, seg,
                             num_segments, aggs, n)


def _aggregate_sorted(sorted_tbl: Table, key_indices, str_dicts, seg,
                      num_segments: int, aggs, n: int) -> Table:
    """The key heads and aggregate columns over a key-sorted table (the
    keyed and the grand-total paths)."""
    dev = seg.device
    # an empty segment (a stale tape) heads at n: cut it to a row
    head_pos = _segment_reduce(torch.arange(n, dtype=torch.int64, device=dev),
                               seg, num_segments, "amin", n).clamp_(max=n - 1)
    out_cols = []
    for ki in key_indices:
        head = _gather_column(sorted_tbl[ki], head_pos)
        if ki in str_dicts:
            # the code is the dictionary's row
            dec = _gather_column(str_dicts[ki], head.data)
            out_cols.append(Column(dec.dtype, dec.data, dec.offsets,
                                   head.validity))
        else:
            out_cols.append(head)

    for vi, agg in aggs:
        col = sorted_tbl[vi]
        if agg == "count":
            # count never reads the payload: every type counts
            out_cols.append(Column(T.int64, _count(col.validity, seg, n,
                                                   num_segments)))
            continue
        if col.dtype.is_variable_width or col.dtype.is_nested:
            raise NotImplementedError(
                f"{agg!r} aggregation on {col.dtype.id.name} columns")
        if col.dtype.id == T.TypeId.DECIMAL128:
            if agg != "sum":
                raise NotImplementedError(
                    f"decimal128 groupby supports sum/count only, got {agg!r}")
            out_cols.append(_sorted_d128_sum(col, seg, num_segments))
            continue
        if (col.dtype.id == T.TypeId.FLOAT64
                and agg in ("min", "max", "first", "last")):
            p = _f64_select_pos(col, seg, num_segments, agg)
            vals = col.data[p.clamp(0, max(n - 1, 0))]
            v = (None if col.validity is None else
                 _count(col.validity, seg, n, num_segments) > 0)
            out_cols.append(Column(col.dtype, vals, validity=v))
            continue
        data = col.data
        if col.dtype.is_decimal and agg in ("mean", "var", "std"):
            # value-domain statistics: the payload is unscaled
            data = data.to(torch.float64) * (10.0 ** col.dtype.scale)
        if agg in ("var", "std"):
            cnt = _count(col.validity, seg, n, num_segments)
            res = _var_segment(data, col.validity, seg, num_segments, cnt,
                               std=(agg == "std"))
            out_cols.append(Column(T.float64, res, validity=cnt >= 2))
            continue
        storage = (np.dtype(np.float64) if col.dtype.is_decimal
                   and agg == "mean" else col.dtype.storage)
        res = _agg_segment(data, col.validity, seg, agg, num_segments,
                           storage)
        if agg in ("min", "max", "first", "last") and col.validity is not None:
            # over an all-null group these are null
            v = _count(col.validity, seg, n, num_segments) > 0
            out_cols.append(Column(col.dtype, res.to(col.dtype.torch_storage),
                                   validity=v))
        else:
            dt = _agg_out_dtype(col.dtype, agg)
            out_cols.append(Column(dt, res.to(dt.torch_storage)))
    return Table(out_cols)


def _agg_out_dtype(src: T.DType, agg: str) -> T.DType:
    """The aggregate's result type, for the populated and the empty
    paths alike."""
    if agg in ("min", "max", "first", "last"):
        return src
    if agg in ("mean", "var", "std"):
        return T.float64
    if agg == "count":
        return T.int64
    if src.id == T.TypeId.DECIMAL128:    # the limb sum keeps type and scale
        return src
    if src.is_decimal:                   # a decimal sum keeps the scale
        return T.decimal64(src.scale)
    return T.float64 if src.storage.kind == "f" else T.int64


def _cast_res(res: torch.Tensor, dt: T.DType) -> torch.Tensor:
    """An aggregate's result in ``dt``'s storage."""
    return res.to(dt.torch_storage)


def _take_rows(col: Column, idx: torch.Tensor) -> Column:
    """Rows of a fixed-width column, eager."""
    v = None if col.validity is None else col.validity[idx]
    return Column(col.dtype, col.data[idx], validity=v)


def _empty_column_of(dt: T.DType, device) -> Column:
    if dt.is_variable_width:
        return Column(dt, torch.zeros(0, dtype=torch.uint8, device=device),
                      torch.zeros(1, dtype=torch.int32, device=device))
    if dt.id == T.TypeId.DECIMAL128:
        return Column(dt, torch.zeros((0, 2), dtype=torch.int64,
                                      device=device))
    return Column(dt, torch.zeros(0, dtype=dt.torch_storage, device=device))


def _empty_result(table: Table, key_indices, aggs) -> Table:
    dev = table.device
    cols = [_empty_column_of(table[ki].dtype, dev) for ki in key_indices]
    cols += [_empty_column_of(_agg_out_dtype(table[vi].dtype, agg), dev)
             for vi, agg in aggs]
    return Table(cols)


def _grand_total_empty(table: Table, aggs) -> Table:
    """One grand-total row over no input rows: count 0 (valid), every
    other aggregate null."""
    dev = table.device
    cols = []
    for vi, agg in aggs:
        dt = _agg_out_dtype(table[vi].dtype, agg)
        if agg == "count":
            cols.append(Column(dt, torch.zeros(1, dtype=torch.int64,
                                               device=dev)))
            continue
        proto = _empty_column_of(dt, dev).data
        cols.append(Column(dt, proto.new_zeros((1,) + proto.shape[1:]),
                           validity=torch.zeros(1, dtype=torch.bool,
                                                device=dev)))
    return Table(cols)


def groupby_grouping_sets(table: Table, key_indices: Sequence[int],
                          sets: Sequence[Sequence[int]],
                          aggs: Sequence[tuple[int, str]]) -> Table:
    """GROUP BY GROUPING SETS (Spark's, libcudf groupby with grouping
    sets).

    ``sets`` holds positions into ``key_indices`` (rollup over keys [a, b]
    is ``[[0, 1], [0], []]``).  The output: every key column (null where
    the set drops it), the aggregates, then an int64 ``grouping_id``
    (Spark's bigint grouping_id) whose bit ``k``, the first key the most
    significant, is set when key ``k`` is not in the set.  One sorted
    ``groupby_aggregate`` a set, the results concatenated; callers order
    the result."""
    from .copying import concat_tables
    from .join import _null_column
    key_indices = list(key_indices)
    nk = len(key_indices)
    dev = table.device
    parts = []
    for s in sets:
        included = sorted(s)
        sub = groupby_aggregate(table, [key_indices[i] for i in included],
                                aggs)
        n = sub.num_rows
        gid = 0
        cols: list[Column] = []
        for k in range(nk):
            if k in included:
                cols.append(sub[included.index(k)])
            else:
                gid |= 1 << (nk - 1 - k)
                cols.append(_null_column(table[key_indices[k]].dtype, n,
                                         dev))
        cols += [sub[len(included) + ai] for ai in range(len(aggs))]
        cols.append(Column(T.int64, torch.full((n,), gid, dtype=torch.int64,
                                               device=dev)))
        parts.append(Table(cols))
    return concat_tables(parts)


def groupby_rollup(table: Table, key_indices: Sequence[int],
                   aggs: Sequence[tuple[int, str]]) -> Table:
    """GROUP BY ROLLUP (Spark's rollup): grouping sets over every prefix
    of the key list, from all keys down to the grand total."""
    nk = len(key_indices)
    sets = [list(range(k)) for k in range(nk, -1, -1)]
    return groupby_grouping_sets(table, key_indices, sets, aggs)


def groupby_cube(table: Table, key_indices: Sequence[int],
                 aggs: Sequence[tuple[int, str]]) -> Table:
    """GROUP BY CUBE (Spark's cube): grouping sets over every subset of
    the keys, the larger first."""
    nk = len(key_indices)
    sets = []
    for r in range(nk, -1, -1):
        sets.extend(itertools.combinations(range(nk), r))
    return groupby_grouping_sets(table, key_indices, sets, aggs)


def groupby_nunique(table: Table, key_indices: Sequence[int],
                    value_index: int) -> Table:
    """COUNT(DISTINCT value) GROUP BY keys (Spark's countDistinct, nulls
    not counted): the distinct (keys, value) tuples, then the valid
    values of each key group counted, two sorted groupbys."""
    sub = groupby_aggregate(table, list(key_indices) + [value_index], [])
    k = len(key_indices)
    return groupby_aggregate(sub, list(range(k)), [(k, "count")])


def distinct(table: Table) -> Table:
    """Distinct rows (Spark dropDuplicates over every column), in key
    order: a groupby on every column with no aggregates."""
    return groupby_aggregate(table, list(range(table.num_columns)), [])
