"""Arrow interchange (the cudf ``to_arrow``/``from_arrow`` analog).

The port's counterpart of the JAX package's ``utils/arrow.py``.  A
column is the Arrow layout already (data, int32 offsets, validity), so
the interchange maps buffers: the card packs what Arrow stores
differently (validity and BOOL8 as little-endian bitmaps, every decimal
as Arrow's 16-byte decimal128), and one copy per buffer crosses to the
host.  Two levels:

* :class:`ArrowArray`, :func:`to_arrow_buffers`, :func:`from_arrow_buffers`:
  the buffers as host numpy arrays, with the type as an Arrow C data
  interface format string (``"i"``, ``"g"``, ``"u"``, ``"d:38,2"``,
  ``"tdD"``, ...).  No pyarrow needed.
* :func:`to_arrow`, :func:`from_arrow`, :func:`table_to_arrow`,
  :func:`table_from_arrow`: pyarrow arrays over those buffers
  (``pa.Array.from_buffers``); pyarrow is imported only when these are
  called.

The pyarrow results are the JAX package's: a decimal of any width
leaves as ``decimal128(38, s)`` and comes back as DECIMAL32 / 64 / 128 by
its precision (≤ 9, ≤ 18, more); the buffer level gives each width its
own precision, so a table comes back with its types.  Dates are
``date32``; a null slot comes
back with a zero payload (an empty string), as the JAX package's
``fill_null(0)`` gives.  LIST and STRUCT columns are not ported.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .. import column as _column
from .. import types as T
from ..column import Column, Table, resolve_device
from . import bitmask


@dataclasses.dataclass
class ArrowArray:
    """One Arrow array's buffers on the host.  ``validity`` is the
    little-endian bitmap (None: no nulls); ``offsets`` int32 [n+1] for
    strings; ``data`` the values (uint8 bitmap for booleans, 16-byte
    lanes as int64 [n, 2] for decimals, chars for strings)."""
    format: str
    length: int
    null_count: int
    validity: Optional[np.ndarray]
    offsets: Optional[np.ndarray]
    data: np.ndarray


_FIXED_FORMATS = {
    T.TypeId.INT8: "c", T.TypeId.INT16: "s", T.TypeId.INT32: "i",
    T.TypeId.INT64: "l", T.TypeId.UINT8: "C", T.TypeId.UINT16: "S",
    T.TypeId.UINT32: "I", T.TypeId.UINT64: "L", T.TypeId.FLOAT32: "f",
    T.TypeId.FLOAT64: "g", T.TypeId.TIMESTAMP_DAYS: "tdD",
    T.TypeId.TIMESTAMP_SECONDS: "tss:",
    T.TypeId.TIMESTAMP_MILLISECONDS: "tsm:",
    T.TypeId.TIMESTAMP_MICROSECONDS: "tsu:",
    T.TypeId.TIMESTAMP_NANOSECONDS: "tsn:",
}
_FORMAT_TYPES = {f: T.DType(t) for t, f in _FIXED_FORMATS.items()}


def _host(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


#: the most digits each decimal width holds: its Arrow precision
_DECIMAL_DIGITS = {T.TypeId.DECIMAL32: 9, T.TypeId.DECIMAL64: 18,
                   T.TypeId.DECIMAL128: 38}


def to_arrow_buffers(col: Column, decimal_precision=None) -> ArrowArray:
    """A column's Arrow buffers on the host.  A decimal's precision is
    ``decimal_precision``, or by default the most its width holds (9,
    18, 38), so that :func:`from_arrow_buffers` gives its width back;
    :func:`to_arrow` passes 38, as the JAX package's does."""
    dt = col.dtype
    n = col.num_rows
    if dt.is_nested:
        raise NotImplementedError(f"to_arrow: {dt.id.name} is not ported")
    if col.validity is None:
        validity, nulls = None, 0
    else:
        validity = _host(bitmask.pack_bits(col.validity))
        nulls = n - int(col.validity.sum())
    offsets = None
    if dt.id == T.TypeId.STRING:
        fmt, offsets, data = "u", _host(col.offsets), _host(col.data)
    elif dt.is_decimal:
        v = col.data
        if dt.id != T.TypeId.DECIMAL128:
            # widen to the two little-endian int64 lanes of decimal128
            lo = v.to(torch.int64)
            v = torch.stack([lo, lo >> 63], dim=1)
        p = decimal_precision or _DECIMAL_DIGITS[dt.id]
        fmt, data = f"d:{p},{-dt.scale}", _host(v)
    elif dt.id == T.TypeId.BOOL8:
        fmt, data = "b", _host(bitmask.pack_bits(col.data != 0))
    elif dt.id in _FIXED_FORMATS:
        fmt, data = _FIXED_FORMATS[dt.id], _host(col.data)
    else:
        raise NotImplementedError(f"to_arrow: unsupported type {dt}")
    return ArrowArray(fmt, n, nulls, validity, offsets, data)


def _decimal_type(fmt: str) -> tuple[int, T.DType]:
    precision, scale = (int(x) for x in fmt[2:].split(",")[:2])
    if precision <= 9:
        return precision, T.decimal32(-scale)
    if precision <= 18:
        return precision, T.decimal64(-scale)
    return precision, T.decimal128(-scale)


def from_arrow_buffers(a: ArrowArray, device=None) -> Column:
    """The column of an array's buffers, on ``device`` (None: the card)."""
    dev = resolve_device(device)
    n = a.length
    valid = None
    if a.null_count and a.validity is not None:
        valid = bitmask.unpack_bits(_column.upload(a.validity, dev), n)
    if a.format == "u":
        offs = np.asarray(a.offsets, dtype=np.int64)
        chars = np.asarray(a.data, dtype=np.uint8)
        if valid is not None:
            ok = np.unpackbits(a.validity,
                               bitorder="little")[:n].astype(bool)
            lens = np.diff(offs)
            if lens[~ok].any():
                # a null slot with bytes: drop them, as the JAX package's
                # to_pylist round trip does
                keep = np.repeat(ok, lens)
                chars = chars[offs[0]:offs[-1]][keep]
                offs = np.concatenate(
                    [[0], np.cumsum(np.where(ok, lens, 0))])
        chars = chars[offs[0]:offs[-1]]
        col = Column.strings_from_arrays(chars, offs - offs[0], None, dev)
        return Column(T.string, col.data, col.offsets, valid)
    if a.format == "b":
        data = bitmask.unpack_bits(_column.upload(a.data, dev),
                                   n).to(torch.uint8)
        dt = T.bool8
    elif a.format.startswith("d:"):
        _, dt = _decimal_type(a.format)
        lanes = _column.upload(
            np.asarray(a.data).view(np.int64).reshape(n, 2), dev)
        data = (lanes if dt.id == T.TypeId.DECIMAL128
                else lanes[:, 0].to(dt.torch_storage).contiguous())
    elif a.format in _FORMAT_TYPES:
        dt = _FORMAT_TYPES[a.format]
        data = _column.upload(
            np.asarray(a.data).view(dt.storage).reshape(n), dev)
    else:
        raise NotImplementedError(
            f"from_arrow: unsupported Arrow format {a.format!r}")
    if valid is not None:
        # a null slot's payload is zero, as the JAX package's fill_null(0)
        keep = valid if data.dim() == 1 else valid[:, None]
        data = torch.where(keep, data, torch.zeros_like(data))
    return Column(dt, data, validity=valid)


# --- pyarrow -----------------------------------------------------------------


def _pa():
    import pyarrow as pa
    return pa


def _pa_type(fmt: str):
    pa = _pa()
    if fmt.startswith("d:"):
        precision, scale = (int(x) for x in fmt[2:].split(",")[:2])
        return pa.decimal128(precision, scale)
    simple = {"c": pa.int8(), "s": pa.int16(), "i": pa.int32(),
              "l": pa.int64(), "C": pa.uint8(), "S": pa.uint16(),
              "I": pa.uint32(), "L": pa.uint64(), "f": pa.float32(),
              "g": pa.float64(), "b": pa.bool_(), "u": pa.string(),
              "tdD": pa.date32(), "tss:": pa.timestamp("s"),
              "tsm:": pa.timestamp("ms"), "tsu:": pa.timestamp("us"),
              "tsn:": pa.timestamp("ns")}
    return simple[fmt]


def _format_of(t) -> str:
    pa = _pa()
    if pa.types.is_decimal(t):
        if t.bit_width != 128:
            raise NotImplementedError(f"from_arrow: unsupported type {t}")
        return f"d:{t.precision},{t.scale}"
    names = {"int8": "c", "int16": "s", "int32": "i", "int64": "l",
             "uint8": "C", "uint16": "S", "uint32": "I", "uint64": "L",
             "float": "f", "double": "g", "bool": "b", "string": "u",
             "date32[day]": "tdD", "timestamp[s]": "tss:",
             "timestamp[ms]": "tsm:", "timestamp[us]": "tsu:",
             "timestamp[ns]": "tsn:"}
    key = str(t)
    if key not in names:
        raise NotImplementedError(f"from_arrow: unsupported Arrow type {t}")
    return names[key]


def _bits(buf, offset: int, n: int) -> np.ndarray:
    """``n`` bits from bit ``offset`` of an Arrow bitmap, re-based to 0."""
    raw = np.frombuffer(buf, dtype=np.uint8)
    if offset % 8 == 0:
        return raw[offset // 8:offset // 8 + -(-n // 8)].copy()
    bits = np.unpackbits(raw, bitorder="little")[offset:offset + n]
    return np.packbits(bits, bitorder="little")


def arrow_buffers_of(arr) -> ArrowArray:
    """A pyarrow Array's (or ChunkedArray's) buffers as an
    :class:`ArrowArray`, re-based to offset 0."""
    pa = _pa()
    if isinstance(arr, pa.ChunkedArray):
        arr = arr.combine_chunks()
    fmt = _format_of(arr.type)
    n, off = len(arr), arr.offset
    bufs = arr.buffers()
    validity = None
    if arr.null_count and bufs[0] is not None:
        validity = _bits(bufs[0], off, n)
    offsets = None
    if fmt == "u":
        offsets = np.frombuffer(bufs[1], dtype=np.int32)[off:off + n + 1]
        data = (np.frombuffer(bufs[2], dtype=np.uint8) if bufs[2] is not None
                else np.zeros(0, np.uint8))
    elif fmt == "b":
        data = _bits(bufs[1], off, n)
    else:
        width = 16 if fmt.startswith("d:") else arr.type.bit_width // 8
        raw = np.frombuffer(bufs[1], dtype=np.uint8)
        data = raw[off * width:(off + n) * width]
        if fmt.startswith("d:"):
            data = data.view(np.int64).reshape(n, 2)
    return ArrowArray(fmt, n, arr.null_count, validity, offsets, data)


def from_arrow(arr, device=None) -> Column:
    """pyarrow Array / ChunkedArray → column on ``device`` (None: the
    card)."""
    return from_arrow_buffers(arrow_buffers_of(arr), device)


def to_arrow(col: Column):
    """Column → pyarrow Array (a host copy)."""
    pa = _pa()
    a = to_arrow_buffers(col, decimal_precision=38)
    bufs = [None if a.validity is None else pa.py_buffer(a.validity)]
    if a.offsets is not None:
        bufs.append(pa.py_buffer(np.ascontiguousarray(a.offsets)))
    bufs.append(pa.py_buffer(np.ascontiguousarray(a.data)))
    return pa.Array.from_buffers(_pa_type(a.format), a.length, bufs,
                                 null_count=a.null_count)


def table_from_arrow(tbl, device=None) -> Table:
    """pyarrow Table → Table (column order kept)."""
    return Table([from_arrow(tbl.column(i), device)
                  for i in range(tbl.num_columns)])


def table_to_arrow(table: Table, names=None):
    """Table → pyarrow Table."""
    pa = _pa()
    names = names or [f"c{i}" for i in range(table.num_columns)]
    # from_arrays keeps duplicate names (a dict would drop them)
    return pa.Table.from_arrays([to_arrow(c) for c in table.columns],
                                names=list(names))
