"""Row filtering and gathering (libcudf ``apply_boolean_mask``/``gather``).

The port's counterpart of the JAX package's ``ops/filter.py``.  A filter
is a count and a gather: the count of the mask (its one synchronisation,
through ``utils.syncs``), then :func:`sized_nonzero`'s indices of the
surviving rows.  ``gather`` returns :class:`LazyColumn`s, as the JAX
package's does: a column is gathered when the plan first reads it, and a
column it never reads is never gathered.  A :class:`DictColumn` gathers
its codes only, at once; a STRING column's chars move, when forced, as
one segmented copy to device offsets, kernel B4
(``rowconv.ragged.segmented_copy``), after one synchronisation for the
chars' total.  ``mask_table`` keeps every row and
nulls the failing ones, deferred likewise.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import types as T
from ..column import (Column, DictColumn, LazyColumn, Table, as_dict_column,
                      force_column)
from ..rowconv import ragged
from ..utils import metrics, syncs

_MAX_CHARS = 2**31 - 1


def _gather_strings(col: Column, idx: torch.Tensor) -> Column:
    """The rows ``idx`` of a STRING column: new offsets from the gathered
    lengths, the chars by B4 (one synchronisation for their total).  The
    offsets are cut at the total, a no-op unless a stale tape sized the
    chars."""
    offs = col.offsets.to(torch.int64)
    lens = (offs[1:] - offs[:-1])[idx]
    new = torch.zeros(idx.shape[0] + 1, dtype=torch.int64, device=idx.device)
    torch.cumsum(lens, 0, out=new[1:])
    total = syncs.size(new[-1])
    if total > _MAX_CHARS:
        raise ValueError(f"gathered chars ({total} bytes) exceed int32 "
                         "offsets")
    chars = ragged.segmented_copy(col.data, offs[:-1][idx], new[:-1], lens,
                                  total)
    v = None if col.validity is None else col.validity[idx]
    return Column(col.dtype, chars, new.clamp(max=total).to(torch.int32), v)


def _gather_column(col: Column, idx: torch.Tensor) -> Column:
    """The rows ``idx`` of ``col``, eager (a lazy input is forced)."""
    idx = idx.to(torch.int64)
    d = as_dict_column(col)
    if d is not None:
        # codes only: the dictionary is shared and no byte is read
        v = None if d.validity is None else d.validity[idx]
        return DictColumn(d.codes[idx], d.dictionary, v)
    col = force_column(col)
    if col.dtype.is_nested:
        raise NotImplementedError(
            f"gather of {col.dtype.id.name} columns is not ported")
    if col.dtype.is_variable_width:
        return _gather_strings(col, idx)
    v = None if col.validity is None else col.validity[idx]
    return Column(col.dtype, col.data[idx], validity=v)


def gather(table: Table, idx: torch.Tensor) -> Table:
    """Rows of ``table`` by index (libcudf gather).  Each column comes back
    a :class:`LazyColumn` that gathers when first read; a
    :class:`DictColumn` gathers its codes at once (no synchronisation, and
    it stays visible as a dictionary column)."""
    n_out = int(idx.shape[0])
    return Table([
        _gather_column(c, idx) if isinstance(c, DictColumn) else
        LazyColumn(c.dtype, n_out, idx.device,
                   lambda c=c: _gather_column(c, idx))
        for c in table.columns])


def sized_nonzero(mask: torch.Tensor, n_keep: int) -> torch.Tensor:
    """Ascending int64 indices of the True rows, shaped ``[n_keep]``: cut
    to the first ``n_keep``, or padded with zeros, as the JAX package's
    (``ops/filter.py:72-93``).  ``n_keep`` comes from the caller's count,
    so this adds no synchronisation: each True row scatters its index to
    its rank, the others to a slot past the end."""
    mask = mask.to(torch.bool)
    dev = mask.device
    n = mask.shape[0]
    rank = torch.cumsum(mask, 0) - 1
    keep = mask & (rank < n_keep)
    out = torch.zeros(n_keep + 1, dtype=torch.int64, device=dev)
    out.scatter_(0, torch.where(keep, rank, n_keep),
                 torch.arange(n, dtype=torch.int64, device=dev))
    return out[:n_keep]


def sized_repeat(counts: torch.Tensor, total: int) -> torch.Tensor:
    """``torch.repeat_interleave(counts, output_size=total)``, the index of
    each of ``counts``' rows repeated its count of times, in bounds for any
    ``total``: the counts' running sum is cut at ``total`` and the last row
    takes up any rest, so their sum is ``total`` exactly.  Where ``total``
    is the counts' true sum, as it is but under a stale tape, that
    changes nothing.  Needs ``counts`` non-empty unless ``total`` is 0."""
    k = counts.shape[0]
    if k == 0:
        if total:
            raise ValueError("sized_repeat: no rows to repeat")
        return torch.zeros(0, dtype=torch.int64, device=counts.device)
    ends = torch.cumsum(counts.to(torch.int64), 0).clamp_(max=total)
    ends[-1:].fill_(total)
    reps = ends.clone()
    reps[1:] -= ends[:-1]
    return torch.repeat_interleave(reps, output_size=total)


def apply_boolean_mask(table: Table, mask: torch.Tensor) -> Table:
    """Keep the rows where ``mask`` is True (compacting): the count (one
    synchronisation), then :func:`sized_nonzero` and a lazy gather."""
    n_keep = syncs.size(mask.sum(), mask.shape[0])
    metrics.profile_op("filter", rows_in=table.num_rows, rows_kept=n_keep)
    return gather(table, sized_nonzero(mask, n_keep))


def _masked(c: Column, mask: torch.Tensor) -> Column:
    v = mask if c.validity is None else (c.validity & mask)
    if isinstance(c, DictColumn):
        return DictColumn(c.codes, c.dictionary, v)
    return Column(c.dtype, c.data, c.offsets, v)


def mask_table(table: Table, mask: torch.Tensor) -> Table:
    """Filter without compaction: failing rows become null.  Reductions
    and groupbys honour validity, so the results match the compacting
    filter's.  A :class:`DictColumn` is masked at once (a validity AND);
    other columns are deferred, so that masking a wide table forces none
    of them."""
    return Table([
        _masked(c, mask) if isinstance(c, DictColumn) else
        LazyColumn(c.dtype, c.num_rows, c.device,
                   lambda c=c: _masked(force_column(c), mask))
        for c in table.columns])


def fill_null(col: Column, value) -> Column:
    """Nulls replaced by a scalar (Spark ``coalesce(col, lit)``);
    fixed-width columns only."""
    if (col.dtype.is_variable_width or col.dtype.is_nested
            or col.dtype.id == T.TypeId.DECIMAL128):
        raise TypeError(f"fill_null not supported on {col.dtype.id.name}")
    if col.validity is None:
        return col
    fill = torch.full((), value, dtype=col.data.dtype, device=col.device)
    return Column(col.dtype, torch.where(col.validity, col.data, fill))


def equality_key(values: torch.Tensor) -> torch.Tensor:
    """float64 → int64 bits under Spark's equality: -0.0 is 0.0 and every
    NaN one value (the JAX package's ``f64bits.equality_key_u64``)."""
    bits = values.contiguous().view(torch.int64)
    bits = torch.where(values == 0, 0, bits)
    return torch.where(torch.isnan(values), 0x7FF8000000000000, bits)


def _equality_key_host(fv: np.float64) -> int:
    """:func:`equality_key` of one host float64."""
    if np.isnan(fv):
        return 0x7FF8000000000000
    return 0 if fv == 0 else int(np.float64(fv).view(np.int64))


def _equal_any(data: torch.Tensor, probes: list) -> torch.Tensor:
    """bool [n]: the row equals one of the host scalars ``probes``, one
    compare each, so that no probe tensor is copied from the host."""
    m = torch.zeros(data.shape[0], dtype=torch.bool, device=data.device)
    for p in dict.fromkeys(probes):
        m |= data == p
    return m


def isin(col: Column, values) -> torch.Tensor:
    """Null-safe SQL ``col IN (v1, v2, …)``: a bool mask, False on null
    rows (Spark).  A probe that does not survive an exact round trip into
    the column's storage matches nothing; None matches nothing.  Each
    probe is a compare with a host scalar: nothing is copied from the
    host, so that the call can be captured in a CUDA graph."""
    dev = col.device
    if col.dtype.id == T.TypeId.STRING:
        from . import strings
        d = as_dict_column(col)
        if d is not None:
            nd = d.dictionary.num_rows
            if nd == 0:
                m = torch.zeros(col.num_rows, dtype=torch.bool, device=dev)
            else:
                dm = isin(d.dictionary, values)
                m = dm[d.codes.clamp(0, nd - 1).to(torch.int64)]
        else:
            payloads = [v.encode() if isinstance(v, str) else bytes(v)
                        for v in values if v is not None]
            m = torch.zeros(col.num_rows, dtype=torch.bool, device=dev)
            if payloads:
                width = max(strings._max_len(col),
                            max(len(p) for p in payloads), 1)
                mat, lens = strings.byte_matrix(col, width)
                for p in payloads:
                    eq = lens == len(p)
                    for k, b in enumerate(p):
                        eq = eq & (mat[:, k] == b)
                    m = m | eq
    elif col.dtype.is_nested or col.dtype.id == T.TypeId.DECIMAL128:
        raise NotImplementedError(f"isin on {col.dtype.id.name}")
    elif col.dtype.id == T.TypeId.FLOAT64:
        probes = []
        for v in values:
            if v is None:
                continue
            try:
                fv = np.float64(v)
            except (OverflowError, ValueError, TypeError):
                continue
            if np.isnan(fv) or fv == v or isinstance(v, float):
                probes.append(fv)
        m = _equal_any(equality_key(col.data),
                       [_equality_key_host(fv) for fv in probes])
    else:
        storage = col.dtype.storage
        kept = []
        for v in values:
            if v is None:
                continue
            try:
                cast_v = storage.type(v)
            except (OverflowError, ValueError, TypeError):
                continue
            if cast_v == v:
                kept.append(cast_v)
        if storage.kind == "f":
            m = _equal_any(col.data, [float(v) for v in kept])
        else:
            # uint64 compares by its bit pattern, as ``_as_int64`` keeps it
            from .decimal128 import _as_int64
            m = _equal_any(_as_int64(col.data),
                           [int(np.asarray(v, storage).view(np.int64))
                            if storage == np.uint64 else int(v)
                            for v in kept])
    if col.validity is not None:
        m = m & col.validity
    return m
