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
states (:func:`partial_aggregate_states`, :func:`merge_aggregate_states`,
:func:`finalize_aggregate_states`) carry ``stream/``'s incremental views.
"""

from __future__ import annotations

import itertools
from typing import NamedTuple, Sequence

import numpy as np
import torch

from .. import types as T
from ..column import Column, Table
from ..utils import metrics, syncs
from .filter import _gather_column, equality_key, gather
from .int64bits import TOPBIT, identity, widened
from .sort import f64_sort_key_lanes, order_by

_AGGS = ("sum", "count", "min", "max", "mean", "var", "std",
         "first", "last")
#: the aggregates with a mergeable partial-state form
MERGEABLE_AGGS = ("sum", "count", "min", "max", "mean", "var", "std")


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
    if metrics.recording():
        metrics.observe("groupby.groups", num_segments)
        metrics.annotate(groups=num_segments)
    metrics.profile_op("groupby", rows_in=n, groups=num_segments)
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


# ---------------------------------------------------------------------------
# Mergeable partial-aggregate states (incremental view maintenance)
# ---------------------------------------------------------------------------
# Every MERGEABLE_AGGS aggregate decomposes into a small set of state
# columns closed under a segment-merge:
#
#   count      -> [count]                   merge: int64 add
#   sum        -> [sum]                     merge: dtype-native segment sum
#   min / max  -> [min] / [max]             merge: selection over states
#   mean       -> [sum, count]   (int)      finalize: sum / count
#              -> [fsum, count]  (f/dec)    fsum = value-domain f64 sum
#   var / std  -> [count, fsum, m2]         merge: Chan's parallel M2 update
#
# so refresh = merge(old_state, partial(delta)).  Exactness contract
# (``merge_exact``): count always; sum over integer-kind storage and
# decimals (associative int/limb adds); min/max over any fixed width
# (selection — FLOAT64 keeps a row's own value, ties resolve to the
# earliest state row, which is the earliest input row because states are
# merged in input order); mean over plain integers (int sum + count, one
# final division).  Float sums/means and merged M2 variance are
# numerically stable but NOT bit-identical to a full recompute (float
# addition is not associative); callers gate on ``merge_exact`` when they
# need bit-parity.  An UNMERGED state finalizes bit-identical for every
# aggregate — the state pass mirrors ``_aggregate_sorted``'s formulas
# operation for operation.  FLOAT64 states are native float64, where the
# JAX package keeps uint32 bit pairs.

class StateCol(NamedTuple):
    kind: str    # "sum" | "count" | "min" | "max" | "fsum" | "m2"
    src: int     # value-column index in the input relation


class OutSpec(NamedTuple):
    agg: str
    mode: str                  # "passthrough" | "mean_int" | "mean_f" | "var" | "std"
    states: tuple[int, ...]    # positions into AggStateSpec.states
    exact: bool                # merge is bit-identical to full recompute


class AggStateSpec(NamedTuple):
    nkeys: int
    states: tuple[StateCol, ...]
    outs: tuple[OutSpec, ...]

    @property
    def exact(self) -> bool:
        return all(o.exact for o in self.outs)


def merge_exact(agg: str, dtype) -> bool:
    """True when merging partial states of ``agg`` over a ``dtype`` column
    reproduces the full recompute bit for bit (see the comment above)."""
    if agg == "count":
        return True
    if dtype.is_variable_width or dtype.is_nested:
        return False
    if agg in ("min", "max"):
        return True
    if agg == "sum":
        return (dtype.id == T.TypeId.DECIMAL128
                or dtype.storage.kind in ("i", "u"))
    if agg == "mean":
        return not dtype.is_decimal and dtype.storage.kind in ("i", "u")
    return False     # var/std: merged M2 is stable, not bit-exact


def plan_aggregate_states(aggs: Sequence[tuple[int, str]], dtypes,
                          nkeys: int) -> AggStateSpec:
    """Plan the state layout for ``aggs`` over a relation whose column
    ``i`` has dtype ``dtypes[i]``.  States are deduplicated: mean/var over
    the same column share their sum/count columns."""
    states: list[StateCol] = []

    def pos(kind: str, src: int) -> int:
        sc = StateCol(kind, src)
        if sc in states:
            return states.index(sc)
        states.append(sc)
        return len(states) - 1

    outs: list[OutSpec] = []
    for vi, agg in aggs:
        if agg not in MERGEABLE_AGGS:
            raise ValueError(
                f"aggregate {agg!r} has no mergeable state form "
                f"(supported: {MERGEABLE_AGGS})")
        dt = dtypes[vi]
        if agg != "count" and (dt.is_variable_width or dt.is_nested):
            raise NotImplementedError(
                f"{agg!r} state on {dt.id.name} columns")
        exact = merge_exact(agg, dt)
        if agg in ("sum", "count", "min", "max"):
            outs.append(OutSpec(agg, "passthrough", (pos(agg, vi),), exact))
        elif agg == "mean":
            if dt.is_decimal or dt.storage.kind == "f":
                outs.append(OutSpec(agg, "mean_f",
                                    (pos("fsum", vi), pos("count", vi)),
                                    exact))
            else:
                outs.append(OutSpec(agg, "mean_int",
                                    (pos("sum", vi), pos("count", vi)),
                                    exact))
        else:    # var / std
            outs.append(OutSpec(agg, agg,
                                (pos("count", vi), pos("fsum", vi),
                                 pos("m2", vi)), False))
    return AggStateSpec(nkeys, tuple(states), tuple(outs))


def _state_dtype(src_dt, kind: str):
    if kind == "count":
        return T.int64
    if kind == "sum":
        return _agg_out_dtype(src_dt, "sum")
    if kind in ("min", "max"):
        return src_dt
    return T.float64     # fsum / m2


def _value_f64(col: Column) -> torch.Tensor:
    """Value-domain float64 payload (decimal scale applied) — the
    accumulator basis shared by the mean/var paths of
    ``_aggregate_sorted``."""
    if col.dtype.is_decimal:
        return col.data.to(torch.float64) * (10.0 ** col.dtype.scale)
    return col.data.to(torch.float64)


def _encode_str_keys(table: Table, key_indices):
    """Swap variable-width key columns for order-preserving dictionary
    codes (the move ``groupby_aggregate`` makes)."""
    str_dicts: dict[int, Column] = {}
    work = list(table.columns)
    for ki in key_indices:
        if table[ki].dtype.is_nested:
            raise NotImplementedError(
                f"{table[ki].dtype.id.name} columns cannot be state keys")
        if table[ki].dtype.is_variable_width:
            from . import strings
            codes, uniq = strings.dictionary_encode(table[ki])
            work[ki] = codes
            str_dicts[ki] = uniq
    return Table(work), str_dicts


def _sorted_segments(table: Table, key_indices):
    """Key-sort + segment ids + group count (one synchronisation);
    ``table`` must already be string-encoded."""
    st = gather(table, order_by(table, list(key_indices)))
    skeys, svalid = [], []
    for ki in key_indices:
        col = st[ki]
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
    return st, seg, num_segments


def _head_key_cols(st: Table, key_indices, str_dicts, seg,
                   num_segments: int, n: int) -> list[Column]:
    head_pos = _segment_reduce(
        torch.arange(n, dtype=torch.int64, device=seg.device), seg,
        num_segments, "amin", n).clamp_(max=n - 1)
    cols = []
    for ki in key_indices:
        head = _gather_column(st[ki], head_pos)
        if ki in str_dicts:
            dec = _gather_column(str_dicts[ki], head.data)
            cols.append(Column(dec.dtype, dec.data, dec.offsets,
                               head.validity))
        else:
            cols.append(head)
    return cols


def _state_column(col: Column, kind: str, seg, num_segments: int,
                  n: int) -> Column:
    """One state column over a key-sorted relation — each branch mirrors
    the corresponding ``_aggregate_sorted`` formula exactly so an
    unmerged state finalizes bit-identical to ``groupby_aggregate``."""
    if kind == "count":
        return Column(T.int64, _count(col.validity, seg, n, num_segments))
    if col.dtype.is_variable_width or col.dtype.is_nested:
        raise NotImplementedError(
            f"{kind!r} state on {col.dtype.id.name} columns")
    if kind == "sum":
        if col.dtype.id == T.TypeId.DECIMAL128:
            return _sorted_d128_sum(col, seg, num_segments)
        res = _agg_segment(col.data, col.validity, seg, "sum", num_segments,
                           col.dtype.storage)
        dt = _agg_out_dtype(col.dtype, "sum")
        return Column(dt, res.to(dt.torch_storage))
    if kind in ("min", "max"):
        if col.dtype.id == T.TypeId.DECIMAL128:
            raise NotImplementedError("decimal128 min/max states")
        v = (None if col.validity is None else
             _count(col.validity, seg, n, num_segments) > 0)
        if col.dtype.id == T.TypeId.FLOAT64:
            p = _f64_select_pos(col, seg, num_segments, kind)
            return Column(col.dtype, col.data[p.clamp(0, max(n - 1, 0))],
                          validity=v)
        res = _agg_segment(col.data, col.validity, seg, kind, num_segments,
                           col.dtype.storage)
        return Column(col.dtype, res.to(col.dtype.torch_storage),
                      validity=v)
    if kind == "fsum":
        x = _value_f64(col)
        if col.validity is not None:
            x = torch.where(col.validity, x, 0.0)
        return Column(T.float64, _sorted_segment_sum(x, seg, num_segments))
    if kind == "m2":
        # _var_segment's two-pass M2 (ddof applied at finalize)
        cnt = _count(col.validity, seg, n, num_segments)
        x = _value_f64(col)
        if col.validity is not None:
            x = torch.where(col.validity, x, 0.0)
        cntf = cnt.to(torch.float64)
        mean = _sorted_segment_sum(x, seg, num_segments) / cntf.clamp(min=1.0)
        dev = x - mean[seg]
        if col.validity is not None:
            dev = torch.where(col.validity, dev, 0.0)
        return Column(T.float64,
                      _sorted_segment_sum(dev * dev, seg, num_segments))
    raise ValueError(f"unknown state kind {kind!r}")


def _empty_states(table: Table, key_indices, spec: AggStateSpec) -> Table:
    dev = table.device
    cols = [_empty_column_of(table[ki].dtype, dev) for ki in key_indices]
    for sc in spec.states:
        cols.append(_empty_column_of(
            _state_dtype(table[sc.src].dtype, sc.kind), dev))
    return Table(cols)


def partial_aggregate_states(table: Table, key_indices: Sequence[int],
                             aggs: Sequence[tuple[int, str]],
                             spec: AggStateSpec | None = None) -> Table:
    """Partial-aggregate state table for ``aggs`` GROUP BY ``key_indices``:
    [key columns..., state columns in spec order], one row per distinct
    key tuple, sorted by key.  Keys must be non-empty (grand-total views
    fall back to full recompute — the empty-input grand-total row has
    different null semantics than a merged empty state)."""
    key_indices = list(key_indices)
    if not key_indices:
        raise ValueError("partial aggregate states require group keys")
    if spec is None:
        spec = plan_aggregate_states(aggs, [c.dtype for c in table.columns],
                                     len(key_indices))
    n = table.num_rows
    with metrics.span("groupby.partial_states", keys=len(key_indices),
                      states=len(spec.states), rows=n):
        if n == 0:
            return _empty_states(table, key_indices, spec)
        enc, str_dicts = _encode_str_keys(table, key_indices)
        st, seg, ns = _sorted_segments(enc, key_indices)
        cols = _head_key_cols(st, key_indices, str_dicts, seg, ns, n)
        for sc in spec.states:
            cols.append(_state_column(st[sc.src], sc.kind, seg, ns, n))
        return Table(cols)


def merge_aggregate_states(spec: AggStateSpec, a: Table | None,
                           b: Table | None) -> Table:
    """Merge two state tables (layout per ``partial_aggregate_states``).
    ``a`` rows come first, so for groups present in both the earlier
    partition's representative key row and selection ties win — matching
    a stable full recompute over ``a``-then-``b`` input order."""
    if a is None:
        return b
    if b is None:
        return a
    from .copying import concat_tables
    t = concat_tables([a, b])
    n = t.num_rows
    if n == 0:
        return a
    nk = spec.nkeys
    key_indices = list(range(nk))
    with metrics.span("groupby.merge_states", states=len(spec.states),
                      rows=n):
        enc, str_dicts = _encode_str_keys(t, key_indices)
        st, seg, ns = _sorted_segments(enc, key_indices)
        cols = _head_key_cols(st, key_indices, str_dicts, seg, ns, n)
        for p, sc in enumerate(spec.states):
            col = st[nk + p]
            if sc.kind in ("sum", "count"):
                # counts merge by summing; the int64 state column keeps
                # its dtype through the sum branch
                merged = _state_column(col, "sum", seg, ns, n)
                if sc.kind == "count":
                    merged = Column(T.int64, merged.data)
                cols.append(merged)
            elif sc.kind in ("min", "max", "fsum"):
                cols.append(_state_column(col, sc.kind, seg, ns, n))
            else:    # m2 — Chan's parallel update, generalized to segments:
                # M2 = sum(m2_i) + sum(n_i * (mean_i - mean_comb)^2)
                ci = spec.states.index(StateCol("count", sc.src))
                si = spec.states.index(StateCol("fsum", sc.src))
                n_i = st[nk + ci].data.to(torch.float64)
                s_i = st[nk + si].data
                m_i = col.data
                big_n = _sorted_segment_sum(n_i, seg, ns)
                big_s = _sorted_segment_sum(s_i, seg, ns)
                mean_comb = big_s / big_n.clamp(min=1.0)
                mean_i = s_i / n_i.clamp(min=1.0)
                dev = mean_i - mean_comb[seg]
                m2 = (_sorted_segment_sum(m_i, seg, ns)
                      + _sorted_segment_sum(n_i * dev * dev, seg, ns))
                cols.append(Column(T.float64, m2))
        return Table(cols)


def finalize_aggregate_states(spec: AggStateSpec, state: Table) -> Table:
    """State table → the ``groupby_aggregate`` result it stands for:
    [key columns..., one column per requested aggregate], formulas
    mirroring ``_aggregate_sorted`` bit for bit."""
    nk = spec.nkeys
    cols = [state[i] for i in range(nk)]
    for o in spec.outs:
        if o.mode == "passthrough":
            cols.append(state[nk + o.states[0]])
        elif o.mode in ("mean_int", "mean_f"):
            s = state[nk + o.states[0]].data
            cnt = state[nk + o.states[1]].data
            res = s.to(torch.float64) / cnt.clamp(min=1).to(torch.float64)
            cols.append(Column(T.float64, res))
        else:    # var / std
            cnt = state[nk + o.states[0]].data
            m2 = state[nk + o.states[2]].data
            cntf = cnt.to(torch.float64)
            var = m2 / (cntf - 1.0).clamp(min=1.0)
            res = torch.sqrt(var) if o.mode == "std" else var
            cols.append(Column(T.float64, res, validity=cnt >= 2))
    return Table(cols)
