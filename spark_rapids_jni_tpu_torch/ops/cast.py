"""Column casts: numeric, bool, decimal rescale, strings, decimal128.

The port's counterpart of the JAX package's ``ops/cast.py`` (:22-166).
Every cast is elementwise over the column's values, its validity carried
through (a STRING parse adds the nulls of the rows it rejects).  A
DECIMAL(s) holds ``unscaled * 10**s`` (cudf's negative-scale
convention), so a rescale from s1 to s2 multiplies or divides by
``10**(s1 - s2)``, rounding half away from zero on a divide, as Spark
does.  The port stores FLOAT64 as native float64, so a column's ``data``
is its values, where the JAX package decodes bit pairs.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import types as T
from ..column import Column


def cast(col: Column, to: T.DType) -> Column:
    """``col`` cast to ``to``, its validity kept."""
    src = col.dtype
    if src == to:
        return col
    if src.id == T.TypeId.STRING or to.id == T.TypeId.STRING:
        return _cast_string(col, to)
    if src.id == T.TypeId.DECIMAL128 or to.id == T.TypeId.DECIMAL128:
        return _cast_decimal128(col, to)

    data = col.data
    if src.is_decimal and to.is_decimal:
        data = _rescale(data, src.scale, to.scale)
    elif src.is_decimal:
        if to.storage.kind == "f":
            data = data.to(to.torch_storage).to(torch.float64) * (
                10.0 ** src.scale)
        else:
            data = _rescale(data, src.scale, 0)
    elif to.is_decimal:
        if src.storage.kind == "f":
            data = torch.round(data.to(torch.float64) * 10.0 ** (-to.scale))
        else:
            data = _rescale(data, 0, to.scale)
    elif src.id == T.TypeId.BOOL8 or to.id == T.TypeId.BOOL8:
        data = data != 0
    return Column(to, data.to(to.torch_storage), validity=col.validity)


def _in_range(parsed: Column, storage: np.dtype) -> torch.Tensor:
    """Rows of an INT64 or DECIMAL64 parse that fit ``storage``; past it
    Spark's CAST gives null, not a wrapped value."""
    if storage == np.uint64:
        # a parse tops out below 2^63 (its 18-digit guard): only the sign
        in_range = parsed.data >= 0
    else:
        info = np.iinfo(storage)
        in_range = ((parsed.data >= int(info.min))
                    & (parsed.data <= int(info.max)))
    return in_range if parsed.validity is None else parsed.validity & in_range


def _narrowed(parsed: Column, to: T.DType) -> Column:
    data = (parsed.data.view(torch.uint64) if to.id == T.TypeId.UINT64
            else parsed.data.to(to.torch_storage))
    return Column(to, data, validity=_in_range(parsed, to.storage))


def _is_time(dt: T.DType) -> bool:
    return dt.id != T.TypeId.TIMESTAMP_DAYS and (
        T.TypeId.TIMESTAMP_DAYS <= dt.id <= T.TypeId.DURATION_NANOSECONDS)


def _cast_string(col: Column, to: T.DType) -> Column:
    """STRING ↔ numeric, by the parsers and formatters of ``ops.strings``
    (Spark CAST: a row that does not parse is null)."""
    from . import strings as S
    src = col.dtype
    if src.id == T.TypeId.STRING:
        if to.id == T.TypeId.BOOL8:
            return S.to_bool(col)
        if to.id in (T.TypeId.DECIMAL64, T.TypeId.DECIMAL32):
            parsed = S.to_decimal(col, to.scale)
            return parsed if to.id == T.TypeId.DECIMAL64 else _narrowed(
                parsed, to)
        if to.id == T.TypeId.TIMESTAMP_DAYS:
            return S.to_date(col)
        if to.is_fixed_width and to.storage.kind in "iu" and not _is_time(to):
            parsed = S.to_int64(col)
            return parsed if to == T.int64 else _narrowed(parsed, to)
        raise NotImplementedError(f"STRING → {to.id.name}")
    if src.id == T.TypeId.BOOL8:
        return S.format_bool(col)
    if src.id == T.TypeId.TIMESTAMP_DAYS:
        return S.format_date(col)
    if src.id in (T.TypeId.DECIMAL32, T.TypeId.DECIMAL64):
        return S.format_decimal(col)
    if src.is_fixed_width and src.storage.kind in "iu" and not _is_time(src):
        return S.format_int64(col)
    raise NotImplementedError(f"{src.id.name} → STRING")


def _cast_decimal128(col: Column, to: T.DType) -> Column:
    """Casts into and out of DECIMAL128's int64 [n, 2] lanes."""
    from . import decimal128 as d128
    src = col.dtype
    if src.id == T.TypeId.DECIMAL128:
        if to.id == T.TypeId.DECIMAL128:
            return d128.rescale(col, to.scale)
        if to.id == T.TypeId.FLOAT64:
            return d128.to_float64(col)
        if to.is_decimal or T.TypeId.INT8 <= to.id <= T.TypeId.FLOAT64:
            mid = col if to.scale == src.scale else d128.rescale(col, to.scale)
            return d128.narrow(mid, to)
        raise NotImplementedError(f"decimal128 → {to.id.name}")
    if src.is_decimal or src.storage.kind in "iu" or src.id == T.TypeId.BOOL8:
        wide = d128.widen(col)
        if wide.dtype.scale != to.scale:
            wide = d128.rescale(wide, to.scale)
        return wide
    if src.storage.kind == "f":
        # two limbs: a float64 has 53 mantissa bits, so hi = ⌊x/2^64⌋ and
        # lo = x - hi·2^64 are each exact and reach the full 128-bit range
        scaled = torch.round(col.data.to(torch.float64)
                             * 10.0 ** (-to.scale))
        neg = scaled < 0
        mag = scaled.abs()
        hi_f = torch.floor(mag / 2.0 ** 64)
        lo_f = mag - hi_f * 2.0 ** 64                 # in [0, 2^64)
        lo = torch.where(lo_f >= 2.0 ** 63,
                         (lo_f - 2.0 ** 64).to(torch.int64),
                         lo_f.to(torch.int64))
        lanes = torch.stack([lo, hi_f.to(torch.int64)], dim=1)
        lanes = torch.where(neg[:, None], d128._negate_lanes(lanes), lanes)
        return Column(T.decimal128(to.scale), lanes, validity=col.validity)
    raise NotImplementedError(f"{src.id.name} → decimal128")


def _rescale(data: torch.Tensor, from_scale: int,
             to_scale: int) -> torch.Tensor:
    """int64 ``result`` with unscaled * 10**from_scale == result *
    10**to_scale, a divide rounding half away from zero (on magnitudes:
    floor division of a negative value would over-round)."""
    data = data.to(torch.int64)
    diff = from_scale - to_scale
    if diff >= 0:
        return data * 10 ** diff
    div = 10 ** (-diff)
    mag = (data.abs() + div // 2) // div
    return torch.where(data < 0, -mag, mag)
