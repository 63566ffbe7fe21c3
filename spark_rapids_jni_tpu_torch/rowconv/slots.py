"""Slots: the fixed region of JCUDF rows, columns ↔ rows (B8, B9).

Every column's value sits in its slot of each row, the validity bits at
``validity_offset``, zeros in the gaps and the padding
(:mod:`.layout`).  :func:`pack_slots` writes that region of a batch of rows
from the columns; :func:`unpack_slots` reads the columns back out of it.
Both directions of every row conversion go through them: the fixed-width
path's rows, the string path's row matrix before B1 packs it and the fixed
region B3 cuts out of string rows, the repartition join's shuffle, the JNI
bridge, and the dictionary-codes passthrough.

No TPU kernel stands behind them: the JAX package writes the slots in
plain XLA (``rowconv/convert.py`` ``_to_rows_fixed_full``,
``_from_rows_fixed_full``).  Each wrapper checks its tensors and then, by
the device they lie on:

* CUDA: launches its hand-written kernel from ``csrc/slots.cu`` on the
  current stream, once for each group of at most :data:`LAUNCH_COLUMNS`
  columns, and adds one to its ``launches`` count a launch, or raises;
* CPU: runs its plain PyTorch version, the port's torch code of the slots
  (a strided byte copy a column, the validity through
  :func:`..utils.bitmask.pack_bool_matrix`).

There is no other route.  Column descriptors go to the kernel by value, so
a launch copies nothing from the host and a CUDA graph can capture it.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

from .. import _native
from ..utils import bitmask
from .layout import RowLayout
from .ragged import _route

# columns a launch: the kernel's descriptor block (kMaxCols in
# csrc/slots.cu), a multiple of 8 so that one launch owns each validity byte
LAUNCH_COLUMNS = 128


def _reinterpret(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``t.view(dtype)`` of a contiguous copy.  An empty tensor (whose
    strides torch may leave at 0) gets a fresh empty one of the new shape,
    and a one-row tensor a fresh copy: torch counts a slice of one row as
    contiguous though it keeps its parent's row stride, which ``view``
    refuses."""
    if t.numel() == 0:
        return torch.empty((*t.shape[:-1],
                            t.shape[-1] * t.element_size() // dtype.itemsize),
                           dtype=dtype, device=t.device)
    if t.dim() > 1 and t.shape[0] == 1:
        t = t.clone(memory_format=torch.contiguous_format)
    return t.contiguous().view(dtype)


def _operand(t: torch.Tensor, what: str, device: torch.device,
             nbytes: int) -> torch.Tensor:
    """``t`` contiguous (a copy only where it is not), holding ``nbytes``."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{what} must be a torch.Tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{what} is on {t.device}, expected {device}")
    if t.numel() * t.element_size() != nbytes:
        raise ValueError(f"{what} holds {t.numel() * t.element_size()} "
                         f"bytes, expected {nbytes}")
    return t if t.is_contiguous() else t.contiguous()


def _validities(valids, n: int, ncols: int, device) -> list:
    if len(valids) != ncols:
        raise ValueError(f"{len(valids)} validity vectors for {ncols} columns")
    out = []
    for c, v in enumerate(valids):
        if v is not None:
            v = _operand(v.to(torch.bool), f"valids[{c}]", device, n)
        out.append(v)
    return out


def launch_groups(layout: RowLayout, width: int) -> list:
    """One launch's columns and the bytes of each row it owns:
    ``(c0, c1, (lo, hi), (vlo, vhi))`` for columns [c0, c1), which write
    row bytes [lo, hi) (their slots and the gaps after them) and [vlo,
    vhi) (their validity bytes, and for the last group the padding up to
    ``width``).  The ranges of the groups tile [0, width)."""
    ncols = layout.num_columns
    vo = layout.validity_offset
    starts = layout.column_starts
    out = []
    for c0 in range(0, ncols, LAUNCH_COLUMNS):
        c1 = min(c0 + LAUNCH_COLUMNS, ncols)
        last = c1 == ncols
        out.append((c0, c1,
                    (0 if c0 == 0 else starts[c0], vo if last else starts[c1]),
                    (vo + c0 // 8, width if last else vo + c1 // 8)))
    return out


# ---------------------------------------------------------------------------
# B8 pack: columns → the fixed region of each row
# ---------------------------------------------------------------------------

def pack_slots_plain(layout: RowLayout, datas: Sequence[torch.Tensor],
                     valids: Sequence[Optional[torch.Tensor]],
                     out: torch.Tensor,
                     offsets: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of :func:`pack_slots`: zeros, then one strided byte
    copy a column and the packed validity bytes."""
    n, width = out.shape
    if offsets is not None:
        offsets.copy_(torch.arange(0, n * width + 1, width, dtype=torch.int32,
                                   device=out.device))
    out.zero_()
    for start, w, d in zip(layout.column_starts, layout.column_sizes, datas):
        out[:, start:start + w] = _reinterpret(d, torch.uint8).reshape(n, w)
    vo = layout.validity_offset
    ones = torch.ones(n, dtype=torch.bool, device=out.device)
    out[:, vo:vo + layout.validity_bytes] = bitmask.pack_bool_matrix(
        torch.stack([ones if v is None else v for v in valids]).t())
    return out


def pack_slots(layout: RowLayout, datas: Sequence[torch.Tensor],
               valids: Sequence[Optional[torch.Tensor]],
               out: torch.Tensor,
               offsets: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Write the fixed region of ``n`` rows: every byte of ``out``, uint8
    [n, width] (``width`` at least ``layout.fixed_plus_validity``; rows
    ``out.stride(0)`` bytes apart, so a view of the first columns of a
    wider row matrix will do).  Returns ``out``.

    ``datas[c]``: column c's ``layout.column_sizes[c]`` bytes a row,
    little-endian, as its payload tensor holds them (a string column's
    slot: int32 [n, 2] of (offset, length)).  ``valids[c]``: bool [n], or
    None for a column without nulls.  Inputs that are not contiguous (a
    column of a validity matrix) are copied first.

    ``offsets``: int32 [n + 1] that also receives each row's byte offset,
    ``r * width`` (the fixed-width path's batch; its rows must be back to
    back and fewer than 2**31 bytes), or None."""
    dev = out.device
    ncols = layout.num_columns
    if out.dtype != torch.uint8 or out.dim() != 2:
        raise TypeError("out must be a uint8 matrix [n, width]")
    n, width = out.shape
    if width < layout.fixed_plus_validity:
        raise ValueError(f"out has {width} bytes a row, the fixed region "
                         f"{layout.fixed_plus_validity}")
    if n > 1 and width > 1 and (out.stride(1) != 1 or out.stride(0) < width):
        raise ValueError("out's rows must be contiguous bytes")
    if len(datas) != ncols:
        raise ValueError(f"{len(datas)} columns for a layout of {ncols}")
    datas = [_operand(d, f"datas[{c}]", dev, n * layout.column_sizes[c])
             for c, d in enumerate(datas)]
    valids = _validities(valids, n, ncols, dev)
    if offsets is not None:
        if (offsets.dtype != torch.int32 or offsets.shape != (n + 1,)
                or not offsets.is_contiguous() or offsets.device != dev):
            raise ValueError(f"offsets must be a contiguous int32 [{n + 1}] "
                             f"on {dev}")
        if (n > 1 and out.stride(0) != width) or n * width >= 2**31:
            raise ValueError("offsets need rows back to back, under 2**31 "
                             "bytes")
    if _route(dev) == "plain":
        return pack_slots_plain(layout, datas, valids, out, offsets)
    if n == 0:
        if offsets is not None:
            offsets.zero_()
        return out
    for c0, c1, (lo, hi), (vlo, vhi) in launch_groups(layout, width):
        desc = (ctypes.c_int64 * (4 * (c1 - c0)))()
        for k, c in enumerate(range(c0, c1)):
            v = valids[c]
            desc[4 * k:4 * k + 4] = (datas[c].data_ptr(),
                                     0 if v is None else v.data_ptr(),
                                     layout.column_starts[c],
                                     layout.column_sizes[c])
        # the first launch writes the offsets
        offs = offsets.data_ptr() if offsets is not None and c0 == 0 else 0
        _native.launch("slots", "srjt_pack_slots", dev, desc, c1 - c0, n,
                       width, out.stride(0) if n > 1 else width,
                       layout.validity_offset + c0 // 8, -(-(c1 - c0) // 8),
                       lo, hi, vlo, vhi, out.data_ptr(), offs)
        pack_slots.launches += 1
    return out


pack_slots.launches = 0


# ---------------------------------------------------------------------------
# B9 unpack: the fixed region of each row → columns
# ---------------------------------------------------------------------------

def unpack_slots_plain(layout: RowLayout, rows: torch.Tensor):
    """Plain version of :func:`unpack_slots`: one strided byte copy a
    column, the validity bits unpacked column-major."""
    payloads = [_reinterpret(rows[:, s:s + w], torch.uint8)
                for s, w in zip(layout.column_starts, layout.column_sizes)]
    vo = layout.validity_offset
    valid = bitmask.unpack_bool_matrix(
        rows[:, vo:vo + layout.validity_bytes], layout.num_columns)
    return payloads, valid.t()


def unpack_slots(layout: RowLayout, rows: torch.Tensor):
    """Read the columns out of the fixed region of ``rows``, uint8 [n, W]
    (W at least ``layout.fixed_plus_validity``; copied first if its rows
    are not back to back).  Returns (payloads, valid): ``payloads[c]``
    uint8 [n, column_sizes[c]], contiguous (a string column's: its slots'
    (offset, length) uint32 pairs), and ``valid`` bool [ncols, n],
    contiguous, a row a column."""
    dev = rows.device
    ncols = layout.num_columns
    if rows.dtype != torch.uint8 or rows.dim() != 2:
        raise TypeError("rows must be a uint8 matrix [n, W]")
    n, W = rows.shape
    if W < layout.fixed_plus_validity:
        raise ValueError(f"rows have {W} bytes, the fixed region "
                         f"{layout.fixed_plus_validity}")
    if _route(dev) == "plain":
        return unpack_slots_plain(layout, rows)
    payloads = [torch.empty((n, w), dtype=torch.uint8, device=dev)
                for w in layout.column_sizes]
    valid = torch.empty((ncols, n), dtype=torch.bool, device=dev)
    if n == 0:
        return payloads, valid
    if not rows.is_contiguous():
        rows = rows.contiguous()
    for c0, c1, _, _ in launch_groups(layout, W):
        desc = (ctypes.c_int64 * (4 * (c1 - c0)))()
        for k, c in enumerate(range(c0, c1)):
            desc[4 * k:4 * k + 4] = (payloads[c].data_ptr(),
                                     valid[c].data_ptr(),
                                     layout.column_starts[c],
                                     layout.column_sizes[c])
        _native.launch("slots", "srjt_unpack_slots", dev, desc, c1 - c0, n,
                       W, layout.validity_offset + c0 // 8, rows.data_ptr())
        unpack_slots.launches += 1
    return payloads, valid


unpack_slots.launches = 0

# every kernel wrapper of this module, in the order of the kernel table
KERNELS = (pack_slots, unpack_slots)


def reset_launches() -> None:
    for fn in KERNELS:
        fn.launches = 0


def launch_counts() -> dict[str, int]:
    return {fn.__name__: fn.launches for fn in KERNELS}
