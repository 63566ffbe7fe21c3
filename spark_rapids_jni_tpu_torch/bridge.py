"""Python side of the device bridge (``csrc/device_bridge.cpp``).

The JVM-facing library's trampoline forwards a host table handle, or a row
batch handle with its schema, here when the process hosts a CPython
runtime.  This module reads the handle's buffers through the same
library's C accessors as numpy views of the C memory (no host copy),
uploads them to the bridge's device, runs :func:`convert_to_rows` /
:func:`convert_from_rows` there, downloads the result and hands it back
through ``srjt_rows_import`` / ``srjt_table``, which copy it into new
handles.  It completes the JNI → GPU path the reference gets from
``RowConversionJni.cpp:24-45`` driving CUDA directly.

The bridge's device is the GPU (``column.resolve_device()``), so a process
without one fails every call; a caller that wants the CPU says so with
:func:`use_device`.  The two entry points return a raw handle as ``int``, 0
on failure, with the exception's text stored for
``srjt_device_last_error``: no exception crosses the C boundary.  The steps
between handle and handle are public, so that a caller can time them.
"""

from __future__ import annotations

import contextlib
import contextvars
import ctypes as C
from typing import Optional

import numpy as np
import torch

from . import _native
from . import types as T
from .column import Column, Table, resolve_device
from .rowconv.convert import RowBatch, convert_from_rows, convert_to_rows

_DEVICE: contextvars.ContextVar[Optional[torch.device]] = \
    contextvars.ContextVar("srjt_bridge_device", default=None)
_SCALED = (T.TypeId.DECIMAL32, T.TypeId.DECIMAL64)


@contextlib.contextmanager
def use_device(device):
    """Runs the bridge calls made inside the block (on this thread) on
    ``device``, for instance ``"cpu"``."""
    token = _DEVICE.set(torch.device(device))
    try:
        yield
    finally:
        _DEVICE.reset(token)


def device() -> torch.device:
    """The device the bridge converts on: the GPU unless :func:`use_device`
    says otherwise; raises when that is CUDA and there is none."""
    return resolve_device(_DEVICE.get())


def _view(ptr: Optional[int], n: int, dtype) -> np.ndarray:
    """``n`` items of ``dtype`` at C address ``ptr``, a numpy view."""
    dtype = np.dtype(dtype)
    if n == 0:
        return np.zeros(0, dtype)
    buf = (C.c_uint8 * (n * dtype.itemsize)).from_address(ptr)
    return np.frombuffer(buf, dtype=dtype)


def _dtype(type_id: int, scale: int) -> T.DType:
    tid = T.TypeId(type_id)
    return T.DType(tid, scale if tid in _SCALED else 0)


# ---------------------------------------------------------------------------
# to rows
# ---------------------------------------------------------------------------

def read_table(lib: C.CDLL, handle: int) -> list:
    """The columns of host table ``handle`` as ``interop`` column tuples
    ``(type_id, scale, data, offsets, validity)`` of numpy views of its C
    buffers: fixed-width data in its storage dtype (FLOAT64 as its raw
    float64 bytes), string offsets int32, validity one uint8 a row, or None
    when every row is valid.  The views live as long as the table."""
    t = C.c_void_p(handle)
    n = lib.srjt_table_rows(t)
    cols = []
    for i in range(lib.srjt_table_cols(t)):
        h = lib.srjt_table_column(t, i)      # a new shared handle
        try:
            dt = _dtype(lib.srjt_column_type(h), lib.srjt_column_scale(h))
            vptr = lib.srjt_column_valid(h)
            valid = _view(vptr, n, np.uint8) if vptr else None
            if valid is not None and valid.all():
                valid = None
            size = lib.srjt_column_data_size(h)
            if dt.is_variable_width:
                data = _view(lib.srjt_column_data(h), size, np.uint8)
                offsets = _view(lib.srjt_column_offsets(h), n + 1, np.int32)
            else:
                data = _view(lib.srjt_column_data(h), size // dt.itemsize,
                             dt.storage)
                offsets = None
        finally:
            lib.srjt_column_free(h)
        cols.append((int(dt.id), dt.scale, data, offsets, valid))
    return cols


def upload(cols: list, dev: torch.device) -> Table:
    """Column tuples of :func:`read_table` → a :class:`Table` on ``dev``
    (one copy a buffer; on the CPU the tensors are the views themselves)."""
    out = []
    for type_id, scale, data, offsets, valid in cols:
        v = None if valid is None else torch.from_numpy(valid).to(dev).bool()
        o = None if offsets is None else torch.from_numpy(offsets).to(dev)
        out.append(Column(_dtype(type_id, scale),
                          torch.from_numpy(data).to(dev), o, v))
    return Table(out)


def download(batches: list[RowBatch]) -> list[tuple]:
    """Row batches → host (uint8 bytes, int32 offsets) pairs."""
    return [(b.data.cpu().numpy(), b.offsets.cpu().numpy()) for b in batches]


def import_rows(lib: C.CDLL, host_batches: list[tuple]) -> int:
    """Host row batches → a new RowBatches handle: ``srjt_rows_import`` of
    the first, ``srjt_rows_import_append`` of each other, each a copy."""
    out = None
    try:
        for data, offsets in host_batches:
            if data.size == 0:
                data = np.zeros(1, np.uint8)[:0]   # a non-null pointer
            args = (data.ctypes.data, data.size, offsets.ctypes.data,
                    offsets.size - 1)
            if out is None:
                out = lib.srjt_rows_import(*args)
                if not out:
                    raise ValueError("srjt_rows_import refused a row batch")
            elif not lib.srjt_rows_import_append(out, *args):
                raise ValueError("srjt_rows_import_append refused a row batch")
        if out is None:
            raise ValueError("no row batch to import")
        result, out = out, None
        return result
    finally:
        if out:
            lib.srjt_rows_free(out)


# ---------------------------------------------------------------------------
# from rows
# ---------------------------------------------------------------------------

def read_schema(type_ids_ptr: int, scales_ptr: int, ncols: int) -> list:
    tids = _view(type_ids_ptr, ncols, np.int32)
    scales = (_view(scales_ptr, ncols, np.int32) if scales_ptr
              else np.zeros(ncols, np.int32))
    return [_dtype(int(t), int(s)) for t, s in zip(tids, scales)]


def read_rows(lib: C.CDLL, handle: int, batch: int) -> tuple:
    """Batch ``batch`` of RowBatches ``handle``: numpy views of its uint8
    bytes and int32 offsets."""
    h = C.c_void_p(handle)
    nb = lib.srjt_rows_num_batches(h)
    if not 0 <= batch < nb:
        raise IndexError(f"batch {batch} of a handle holding {nb}")
    size = lib.srjt_rows_batch_size(h, batch)
    n = lib.srjt_rows_batch_rows(h, batch)
    return (_view(lib.srjt_rows_batch_data(h, batch), size, np.uint8),
            _view(lib.srjt_rows_batch_offsets(h, batch), n + 1, np.int32))


def upload_rows(rows: tuple, dev: torch.device) -> RowBatch:
    data, offsets = rows
    return RowBatch(torch.from_numpy(data).to(dev),
                    torch.from_numpy(offsets).to(dev))


def download_table(table: Table) -> list:
    """A table → host column tuples, validity always present (uint8), as
    the host engine gives it."""
    return [(int(c.dtype.id), c.dtype.scale, c.data.cpu().numpy(),
             None if c.offsets is None else c.offsets.cpu().numpy(),
             c.validity_or_true().to(torch.uint8).cpu().numpy())
            for c in table.columns]


def import_table(lib: C.CDLL, cols: list) -> int:
    """Host column tuples → a new host table handle (each buffer copied)."""
    handles = []
    try:
        for type_id, scale, data, offsets, valid in cols:
            data = np.ascontiguousarray(data)
            valid = np.ascontiguousarray(valid, dtype=np.uint8)
            if offsets is None:
                h = lib.srjt_column_fixed(type_id, scale, valid.size,
                                          data.ctypes.data, valid.ctypes.data)
            else:
                offsets = np.ascontiguousarray(offsets, dtype=np.int32)
                h = lib.srjt_column_string(valid.size, offsets.ctypes.data,
                                           data.ctypes.data, valid.ctypes.data)
            if not h:
                raise ValueError(f"the host table refused a "
                                 f"{T.TypeId(type_id).name} column")
            handles.append(h)
        out = lib.srjt_table((C.c_void_p * len(handles))(*handles),
                             len(handles))
        if not out:
            raise ValueError("srjt_table refused the columns")
        return out
    finally:
        for h in handles:
            lib.srjt_column_free(h)


# ---------------------------------------------------------------------------
# entry points of the trampoline
# ---------------------------------------------------------------------------

def _fail(exc: Exception) -> int:
    _native.jni_library().srjt_device_set_error(
        f"{type(exc).__name__}: {exc}".encode())
    return 0


def to_rows_from_handle(table_handle: int) -> int:
    """Host table handle → RowBatches handle, converted on the bridge's
    device; 0 on failure."""
    try:
        dev = device()
        lib = _native.jni_library()
        table = upload(read_table(lib, table_handle), dev)
        return import_rows(lib, download(convert_to_rows(table)))
    except Exception as exc:   # the C boundary: no exception may cross it
        return _fail(exc)


def from_rows_from_handle(rows_handle: int, batch: int, type_ids_ptr: int,
                          scales_ptr: int, ncols: int) -> int:
    """Batch ``batch`` of a RowBatches handle → host table handle,
    converted on the bridge's device; 0 on failure."""
    try:
        dev = device()
        lib = _native.jni_library()
        schema = read_schema(type_ids_ptr, scales_ptr, ncols)
        batch_ = upload_rows(read_rows(lib, rows_handle, batch), dev)
        return import_table(lib, download_table(
            convert_from_rows(batch_, schema)))
    except Exception as exc:   # the C boundary: no exception may cross it
        return _fail(exc)
