"""Multi-key table sort (libcudf ``sort``/``order_by``).

The port's counterpart of the JAX package's ``ops/sort.py``.  Torch has
no ``lexsort``: :func:`lexsort` runs one stable ``torch.sort`` a lane,
from the lowest-priority lane up, each on the permutation so far, which
orders rows exactly as ``jnp.lexsort`` does.  The lanes follow the JAX
package's rules: nulls tie on a key (their payload zeroed) and order by a
null-rank lane of higher priority, NULLS FIRST or LAST; descending keys
are order-reversed (``~`` for integers, negation for floats with an
explicit NaN lane, since Spark orders NaN largest in both directions);
FLOAT64 sorts by the monotone map of its bits, NaN above +inf; a
:class:`DictColumn` sorts by its rank codes, a STRING column by its byte
lanes, DECIMAL128 by its two lanes.
"""

from __future__ import annotations

from typing import Sequence

import torch

from .. import types as T
from ..column import Column, Table, as_dict_column
from .filter import gather
from .int64bits import MASK32, TOPBIT


def lexsort(lanes: Sequence[torch.Tensor]) -> torch.Tensor:
    """The permutation (int64) that sorts rows by ``lanes``, the last lane
    the primary key (``jnp.lexsort``'s convention), ties kept in order."""
    perm = None
    for lane in lanes:
        key = lane if perm is None else lane[perm]
        step = torch.sort(key, stable=True).indices
        perm = step if perm is None else perm[step]
    return perm


def _ordered(data: torch.Tensor) -> torch.Tensor:
    """Unsigned storage wider than a byte as int64 in the same order
    (torch sorts and inverts few unsigned dtypes); others unchanged."""
    if data.dtype == torch.uint64:
        return data.view(torch.int64) ^ TOPBIT
    if data.dtype in (torch.uint16, torch.uint32):
        return data.to(torch.int64)
    return data


def f64_sort_key_lanes(col: Column, descending: bool = False
                       ) -> list[torch.Tensor]:
    """Order-preserving 32-bit lanes (in int64) of a FLOAT64 column, low
    lane first: the monotone bits → uint map (negatives inverted,
    positives sign-flipped), every NaN the largest key, inverted for
    descending order."""
    bits = col.data.contiguous().view(torch.int64)
    lo, hi = bits & MASK32, (bits >> 32) & MASK32
    neg = hi >= 0x80000000
    hi_k = torch.where(neg, MASK32 - hi, hi ^ 0x80000000)
    lo_k = torch.where(neg, MASK32 - lo, lo)
    nan = torch.isnan(col.data)
    hi_k = torch.where(nan, MASK32, hi_k)
    lo_k = torch.where(nan, MASK32, lo_k)
    if descending:
        hi_k, lo_k = MASK32 - hi_k, MASK32 - lo_k
    return [lo_k, hi_k]


def _key_lanes(col: Column, asc: bool) -> list[torch.Tensor]:
    d = as_dict_column(col)
    if d is not None:
        from . import strings
        rank, _ = strings.dict_rank_codes(d)
        return [rank if asc else ~rank]
    if col.dtype.id == T.TypeId.STRING:
        from . import strings
        return strings.sort_key_lanes(col, descending=not asc)
    if col.dtype.id == T.TypeId.DECIMAL128:
        from . import decimal128 as d128
        return d128.sort_key_lanes(col, descending=not asc)
    if col.dtype.id == T.TypeId.FLOAT64:
        return f64_sort_key_lanes(col, descending=not asc)
    data = _ordered(col.data)
    if asc:
        return [data]
    if data.is_floating_point():
        # negation keeps NaN last, and Spark puts it first descending
        return [-data, torch.where(torch.isnan(data), 0, 1)]
    return [~data]


def order_by(table: Table, keys: Sequence[int],
             ascending: Sequence[bool] | None = None,
             nulls_first: Sequence[bool] | None = None) -> torch.Tensor:
    """The row order (int64) by the key columns, the first key primary;
    ascending and NULLS FIRST unless said otherwise."""
    ascending = list(ascending) if ascending else [True] * len(keys)
    nulls_first = list(nulls_first) if nulls_first else [True] * len(keys)
    if not keys:
        return torch.arange(table.num_rows, device=table.device)
    lanes = []
    for ki, asc, nf in reversed(list(zip(keys, ascending, nulls_first))):
        col = table[ki]
        key_lanes = _key_lanes(col, asc)
        if col.validity is not None:
            # null rows tie on this key, whatever their payload, so that
            # lower-priority keys order them
            key_lanes = [torch.where(col.validity, lane, 0)
                         for lane in key_lanes]
        lanes.extend(key_lanes)
        if col.validity is not None:
            # ascending whatever the key's direction: 0 nulls first, 2 last
            lanes.append(torch.where(col.validity, 1, 0 if nf else 2))
    return lexsort(lanes)


def sort_table(table: Table, keys: Sequence[int],
               ascending: Sequence[bool] | None = None,
               nulls_first: Sequence[bool] | None = None) -> Table:
    return gather(table, order_by(table, keys, ascending, nulls_first))
