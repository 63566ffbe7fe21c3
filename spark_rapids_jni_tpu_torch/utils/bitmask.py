"""Validity bitmasks: boolean vectors ↔ little-endian bit bytes.

Bit ``i`` of byte ``j`` is element ``j*8 + i`` (Arrow/cudf order), which is
also the order of the JCUDF validity bytes (``RowConversion.java:56-58``).
The reference transposes validity with warp ballots
(``row_conversion.cu:710-810``); here it is eight shift-and-or passes over
the columns, a handful of elementwise torch ops on any device.

The matrix functions work column-major inside: a table's validity is one
vector per column, so ``pack_bool_matrix(stack(vectors, 0).t())`` and
``unpack_bool_matrix(...).t()`` touch only contiguous rows of that layout.
"""

from __future__ import annotations

import numpy as np
import torch


def pack_bool_matrix(valid: torch.Tensor) -> torch.Tensor:
    """bool [rows, cols] → uint8 [rows, ⌈cols/8⌉]; bit i of byte k is
    column ``k*8 + i``.  The result is a transposed view."""
    rows, cols = valid.shape
    nbytes = -(-cols // 8)
    padded = torch.zeros((nbytes * 8, rows), dtype=torch.uint8,
                         device=valid.device)
    padded[:cols] = valid.t()
    bits = padded.view(nbytes, 8, rows)
    out = torch.zeros((nbytes, rows), dtype=torch.uint8, device=valid.device)
    for i in range(8):
        out |= bits[:, i] << i
    return out.t()


def unpack_bool_matrix(row_bytes: torch.Tensor, cols: int) -> torch.Tensor:
    """Inverse of :func:`pack_bool_matrix`: uint8 [rows, ⌈cols/8⌉] →
    bool [rows, cols], a transposed view of a contiguous [cols, rows]."""
    rows, nbytes = row_bytes.shape
    by_col = row_bytes.t().contiguous()
    shifts = torch.arange(8, dtype=torch.uint8, device=row_bytes.device)
    bits = (by_col[:, None, :] >> shifts[None, :, None]) & 1
    return bits.reshape(nbytes * 8, rows)[:cols].to(torch.bool).t()


def pack_bits(valid: torch.Tensor) -> torch.Tensor:
    """bool [n] → uint8 [⌈n/8⌉] little-endian bitmask."""
    return pack_bool_matrix(valid.reshape(1, -1)).reshape(-1)


def unpack_bits(mask: torch.Tensor, n: int) -> torch.Tensor:
    """uint8 bitmask → bool [n]."""
    return unpack_bool_matrix(mask.reshape(1, -1), n).reshape(-1)


# numpy twins (the host's oracle and the tests' reference)

def pack_bits_np(valid: np.ndarray) -> np.ndarray:
    """bool [n] → uint8 [⌈n/8⌉] little-endian bitmask, on the host."""
    return np.packbits(np.asarray(valid, dtype=np.uint8), bitorder="little")


def unpack_bits_np(mask: np.ndarray, n: int) -> np.ndarray:
    """uint8 bitmask → bool [n], on the host."""
    return np.unpackbits(np.asarray(mask, dtype=np.uint8),
                         count=n, bitorder="little").astype(bool)
