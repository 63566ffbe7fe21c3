"""Equi-joins (libcudf hash join).

The port's counterpart of the JAX package's ``ops/join.py``.  A join
probes a build-side index that ``ops.join_plan`` picks: a dense lookup
table for dense integer keys (TPC-DS surrogate keys), where a unique
build side skips the pair expansion, or a key sort probed by
``torch.searchsorted``.  Both give the same ``(lo, counts, row_ids)``, so
the expansion here is shared and the engines give identical indices:
pairs in probe-row order, each probe row's matches in build-row order.
The pair count is one synchronisation (``utils.syncs``); the expansion
is ``ops.filter.sized_repeat`` with that count as its size.  A left join
reads its match count too, unconditionally (the tape never depends on
the metrics state), and with metrics on each join observes
``join.match_rows``, ``join.expand.calls`` and
``join.expand.pair_elements`` where the JAX package's does; every join
reports its engine and match rows to an active plan-node profile
(``metrics.profile_op``).

Join keys are one fixed-width or STRING column, or a list of them (tuple
equality; a null in any key never matches).  ``join_plan.plan_keys``
packs tuples into one int64 where the windows allow, else probes on a
64-bit fingerprint and this module verifies every key lane on the
candidate pairs.  The table joins return :class:`LazyColumn`s through
``ops.filter.gather``.  With the arena on (``memory/arena.py``) the pair
expansion is admitted against the budget first
(``arena.reserve(pairs * PAIR_EXPANSION_BYTES)``), and a left join's
null fill takes the arena's pooled zeros.
"""

from __future__ import annotations

from typing import Literal, Sequence, Union

import torch

from .. import types as T
from ..column import Column, LazyColumn, Table, force_column
from ..memory import arena
from ..memory.budget import PAIR_EXPANSION_BYTES
from ..utils import metrics, syncs
from .filter import gather, sized_nonzero, sized_repeat
from .sort import _ordered

JoinKey = Union[Column, Sequence[Column]]
OnKey = Union[int, Sequence[int]]

_MAX_INT64 = (1 << 63) - 1


def _ordered_f64(values: torch.Tensor) -> torch.Tensor:
    """float64 → int64 keys in the same order and under Spark's equality
    (-0.0 is 0.0, every NaN one value, above +inf): the JAX package's u64
    ``ordered_key_u64`` with its top bit flipped, so that signed order is
    its unsigned order."""
    bits = values.contiguous().view(torch.int64)
    bits = torch.where(values == 0, 0, bits)
    bits = torch.where(torch.isnan(values), 0x7FF8000000000000, bits)
    return torch.where(bits < 0, bits ^ _MAX_INT64, bits)


def _key_with_nulls_last(col: Column):
    """A key's probe lane and its validity (null rows never match)."""
    if col.dtype.id == T.TypeId.FLOAT64:
        return _ordered_f64(col.data), col.validity
    # unsigned storage as int64 in the same order
    return _ordered(col.data), col.validity


def _as_key_cols(key) -> list:
    return list(key) if isinstance(key, (list, tuple)) else [key]


def join_indices(left: JoinKey, right: JoinKey,
                 how: Literal["inner", "left", "semi", "anti"] = "inner"):
    """(left_idx, right_idx) gather maps (int64) of an equi-join.

    Each side is one key column or an equal-length list of them.
    ``semi`` and ``anti`` return left_idx only; ``left`` marks unmatched
    rows with right_idx -1."""
    if how not in ("inner", "left", "semi", "anti"):
        raise ValueError(f"join_indices: unsupported how={how!r}")
    return _join_indices(_as_key_cols(left), _as_key_cols(right), how)


def _join_indices(lcols: list, rcols: list, how: str):
    from . import join_plan

    plan = join_plan.plan_keys(lcols, rcols)
    ix = join_plan.build_index(plan.rdata, plan.rvalid, plan.dense_ok)
    lo, counts = join_plan.probe_counts(ix, plan.ldata, plan.lvalid)
    nr = ix.row_ids.shape[0]
    if plan.verify:
        # candidate counts of a hashed lane: reject collisions first
        return _verified_join(plan, ix, lo, counts, how)
    n = plan.ldata.shape[0]
    dev = plan.ldata.device

    if how in ("semi", "anti"):
        m = (counts > 0) if how == "semi" else (counts == 0)
        return sized_nonzero(m, syncs.size(m.sum(), n))

    if ix.unique and nr > 0:
        # each probe row matches at most one build row: no expansion
        pos = lo.clamp(0, nr - 1)
        if how == "inner":
            total = syncs.size(counts.sum(), n)
            if metrics.recording():
                metrics.observe("join.match_rows", total)
            metrics.profile_op("join", engine=ix.kind, how=how,
                               match_rows=total, unique_build=True)
            left_idx = sized_nonzero(counts > 0, total)
            return left_idx, ix.row_ids[pos[left_idx]]
        left_idx = torch.arange(n, dtype=torch.int64, device=dev)
        right_idx = torch.where(counts > 0, ix.row_ids[pos], -1)
        return left_idx, right_idx

    if how == "left":
        # the match count needs its own read here (the total below holds
        # the unmatched rows' one row each); unconditional, so that a
        # tape never depends on the metrics state
        matched_rows = syncs.size(counts.sum(), n * max(nr, 1))
        out_counts = counts.clamp(min=1).to(torch.int64)
    else:
        matched_rows = None
        out_counts = counts.to(torch.int64)
    total = syncs.size(out_counts.sum(), n * max(nr, 1))
    match_rows = total if matched_rows is None else matched_rows
    if metrics.recording():
        metrics.count("join.expand.calls")
        metrics.observe("join.expand.pair_elements", total)
        metrics.observe("join.match_rows", match_rows)
        metrics.annotate(expand_pairs=total)
    metrics.profile_op("join", engine=ix.kind, how=how, expand_pairs=total,
                       match_rows=match_rows)
    # admission for the expansion's working set before it is made: under
    # pressure the arena spills LRU residents first (soft: an admitted
    # query completes)
    with arena.reserve(total * PAIR_EXPANSION_BYTES, tag="join.expand"):
        starts = torch.cumsum(out_counts, 0) - out_counts
        left_idx = sized_repeat(out_counts, total)
        within = torch.arange(total, dtype=torch.int64, device=dev) \
            - starts[left_idx]
        matched = within < counts[left_idx]
        if nr == 0:
            return left_idx, torch.full_like(left_idx, -1)
        r_pos = lo[left_idx].to(torch.int64) \
            + torch.where(matched, within, 0)
        right_idx = torch.where(matched,
                                ix.row_ids[r_pos.clamp(0, nr - 1)], -1)
        return left_idx, right_idx


def _pair_candidates(ix, lo, counts):
    """Aligned (probe row, build row) candidate pairs: a unique build's
    straight off its table, else by the shared expansion."""
    nr = ix.row_ids.shape[0]
    dev = counts.device
    total = syncs.size(counts.sum(), counts.shape[0] * nr)
    if nr == 0 or total == 0:
        z = torch.zeros(0, dtype=torch.int64, device=dev)
        return z, z
    if ix.unique:
        left_idx = sized_nonzero(counts > 0, total)
        right_idx = ix.row_ids[lo.clamp(0, nr - 1)[left_idx]]
        return left_idx, right_idx
    if metrics.recording():
        metrics.count("join.expand.calls")
        metrics.observe("join.expand.pair_elements", total)
    with arena.reserve(total * PAIR_EXPANSION_BYTES, tag="join.expand"):
        counts = counts.to(torch.int64)
        starts = torch.cumsum(counts, 0) - counts
        left_idx = sized_repeat(counts, total)
        within = torch.arange(total, dtype=torch.int64, device=dev) \
            - starts[left_idx]
        r_pos = lo[left_idx].to(torch.int64) + within
        return left_idx, ix.row_ids[r_pos.clamp(0, nr - 1)]


def _verified_join(plan, ix, lo, counts, how: str):
    """The fingerprint tail: candidate pairs on the hashed lane, then only
    those whose every key lane matches."""
    li, ri = _pair_candidates(ix, lo, counts)
    eq = torch.ones(li.shape[0], dtype=torch.bool, device=li.device)
    for ll, rl in plan.verify:
        eq = eq & (ll[li] == rl[ri])
    kept = syncs.size(eq.sum(), eq.shape[0])
    if metrics.recording():
        metrics.count("join.verify.candidates", int(li.shape[0]))
        metrics.count("join.verify.collisions", int(li.shape[0]) - kept)
        if how in ("inner", "left"):
            metrics.observe("join.match_rows", kept)
    metrics.profile_op("join", engine=ix.kind, how=how,
                       candidates=int(li.shape[0]), match_rows=kept)
    sel = sized_nonzero(eq, kept)
    li, ri = li[sel], ri[sel]
    if how == "inner":
        return li, ri
    n = plan.ldata.shape[0]
    has = torch.zeros(n, dtype=torch.bool, device=li.device)
    has.index_fill_(0, li, True)
    if how in ("semi", "anti"):
        m = has if how == "semi" else ~has
        return sized_nonzero(m, syncs.size(m.sum(), n))
    # left: the verified pairs and one row for each unmatched probe row,
    # back in probe-row order by a stable sort on the left index
    miss = ~has
    nm = syncs.size(miss.sum(), n)
    mi = sized_nonzero(miss, nm)
    left_idx = torch.cat([li, mi])
    right_idx = torch.cat([ri, torch.full((nm,), -1, dtype=torch.int64,
                                          device=li.device)])
    order = torch.sort(left_idx, stable=True).indices
    return left_idx[order], right_idx[order]


def _key_of(t: Table, on: OnKey):
    return [t[i] for i in on] if isinstance(on, (list, tuple)) else t[on]


def inner_join(left: Table, right: Table, left_on: OnKey,
               right_on: OnKey) -> Table:
    """Inner equi-join; the columns are left's then right's.
    ``left_on`` / ``right_on``: one column index or equal-length lists."""
    li, ri = join_indices(_key_of(left, left_on), _key_of(right, right_on),
                          "inner")
    return Table(list(gather(left, li).columns)
                 + list(gather(right, ri).columns))


def _null_column(dt: T.DType, n: int, device) -> Column:
    """An all-null column of ``n`` rows.  Its tensors are the arena's
    pooled zeros while the arena is on (``memory/arena.py``): shared, so
    nothing may write them in place."""
    nulls = arena.zeros(n, torch.bool, device)
    if dt.is_nested:
        raise NotImplementedError(f"null {dt.id.name} columns are not "
                                  "ported")
    if dt.is_variable_width:
        return Column(dt, arena.zeros(0, torch.uint8, device),
                      arena.zeros(n + 1, torch.int32, device), nulls)
    if dt.id == T.TypeId.DECIMAL128:
        return Column(dt, arena.zeros((n, 2), torch.int64, device),
                      validity=nulls)
    return Column(dt, arena.zeros(n, dt.torch_storage, device),
                  validity=nulls)


def left_join(left: Table, right: Table, left_on: OnKey,
              right_on: OnKey) -> Table:
    """Left outer equi-join; right's columns are null where unmatched."""
    li, ri = join_indices(_key_of(left, left_on), _key_of(right, right_on),
                          "left")
    lt = gather(left, li)
    if right.num_rows == 0:
        return Table(list(lt.columns)
                     + [_null_column(c.dtype, int(li.shape[0]), li.device)
                        for c in right.columns])
    matched = ri >= 0
    rt = gather(right, ri.clamp(min=0))

    def _with_matched(c):
        # deferred like the gather: the mask forces nothing unread
        def thunk(c=c):
            g = force_column(c)
            v = matched if g.validity is None else (g.validity & matched)
            return Column(g.dtype, g.data, g.offsets, v)
        return LazyColumn(c.dtype, c.num_rows, c.device, thunk)

    return Table(list(lt.columns) + [_with_matched(c) for c in rt.columns])


def right_join(left: Table, right: Table, left_on: OnKey,
               right_on: OnKey) -> Table:
    """Right outer equi-join: left's columns then right's, left's null
    where a right row is unmatched."""
    mirrored = left_join(right, left, right_on, left_on)
    cols = list(mirrored.columns)            # right ++ left
    return Table(cols[right.num_columns:] + cols[:right.num_columns])


def full_outer_join(left: Table, right: Table, left_on: OnKey,
                    right_on: OnKey) -> Table:
    """Full outer equi-join: the left join's rows, then right's unmatched
    rows with left's columns null (Spark FULL OUTER)."""
    from .copying import concat_tables
    lj = left_join(left, right, left_on, right_on)
    extra = anti_join(right, left, right_on, left_on)
    if extra.num_rows == 0:
        return lj
    dev = extra.device if extra.num_columns else left.device
    null_left = [_null_column(c.dtype, extra.num_rows, dev)
                 for c in left.columns]
    return concat_tables([lj, Table(null_left + list(extra.columns))])


def semi_join(left: Table, right: Table, left_on: OnKey,
              right_on: OnKey) -> Table:
    return gather(left, join_indices(_key_of(left, left_on),
                                     _key_of(right, right_on), "semi"))


def anti_join(left: Table, right: Table, left_on: OnKey,
              right_on: OnKey) -> Table:
    return gather(left, join_indices(_key_of(left, left_on),
                                     _key_of(right, right_on), "anti"))
