"""String keys: the padded byte matrix, sort lanes and dictionary codes.

The port's counterpart of the key subset of the JAX package's
``ops/strings.py`` (``byte_matrix``, ``sort_key_lanes``,
``dict_rank_codes``, ``dictionary_encode``, :46-237): what sorts,
groupbys and string ``isin`` need.  A STRING column's rows become a
zero-padded byte matrix [n, L] (L the longest row rounded up to 4, one
synchronisation), packed big-endian into 32-bit lanes so that numeric
lane order is lexicographic byte order.  On the card the matrix is
kernel B3's work (``rowconv.ragged.unpack_rows``); on the CPU its plain
version's.  Lanes are int64 tensors holding the JAX package's uint32
values.

The rest of the JAX module (equality, LIKE, case, substrings, shared
encodings) is not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import types as T
from ..column import Column, DictColumn
from ..rowconv import ragged
from .int64bits import MASK32


def _lengths(col: Column) -> torch.Tensor:
    return col.offsets[1:] - col.offsets[:-1]


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def _max_len(col: Column) -> int:
    """The longest row, in bytes (one synchronisation)."""
    if col.num_rows == 0:
        return 0
    return int(_lengths(col).max())


def byte_matrix(col: Column, width: Optional[int] = None):
    """Padded byte view: (uint8 [n, L], int32 lengths [n]).

    ``mat[i, j]`` is the j-th byte of row i, zero past its length;
    ``width`` pins L (callers comparing two columns share the larger),
    else L is the longest row; either way rounded up to a multiple of 4,
    at least 4.  Kernel B3 cuts the rows out of the chars."""
    lens = _lengths(col)
    if width is None:
        width = _max_len(col)
    L = max(_round_up(width, 4), 4)
    if col.data.shape[0] == 0:
        return (torch.zeros((col.num_rows, L), dtype=torch.uint8,
                            device=col.device), lens)
    mat = ragged.unpack_rows(col.data, col.offsets.to(torch.int64), L)
    return mat, lens


def _u32_lanes(mat: torch.Tensor) -> torch.Tensor:
    """[n, L] bytes → [n, L/4] big-endian 32-bit lanes, in int64."""
    n, L = mat.shape
    b = mat.reshape(n, L // 4, 4).to(torch.int64)
    return (b[..., 0] << 24) | (b[..., 1] << 16) | (b[..., 2] << 8) | b[..., 3]


def sort_key_lanes(col: Column, descending: bool = False) -> list[torch.Tensor]:
    """Lanes for a lexicographic sort, in increasing priority: the length
    (the tiebreak that puts a string after its proper prefix), then the
    last 4-byte lane up to the first."""
    mat, lens = byte_matrix(col)
    lanes = _u32_lanes(mat)
    out = [-lens if descending else lens]
    for k in range(lanes.shape[1] - 1, -1, -1):
        lane = lanes[:, k]
        out.append(MASK32 - lane if descending else lane)
    return out


def dict_rank_codes(dcol: DictColumn) -> tuple[torch.Tensor, Column]:
    """Order-preserving rank of every row of a :class:`DictColumn`, and the
    sorted distinct dictionary the ranks index.  The re-encode runs over
    the dictionary alone; one gather maps the codes to ranks, and
    duplicate dictionary entries (merged row groups) share a rank."""
    rank, uniq = dictionary_encode(dcol.dictionary)
    nd = dcol.dictionary.num_rows
    if nd == 0:
        return torch.zeros_like(dcol.codes), uniq
    return rank.data[dcol.codes.clamp(0, nd - 1).to(torch.int64)], uniq


def dictionary_encode(col: Column) -> tuple[Column, Column]:
    """Order-preserving dense codes: (int32 codes column, dictionary).

    ``codes[i]`` is the rank of row i's string among the distinct strings
    and indexes the returned dictionary.  Null rows encode as the empty
    key, which they share, with the validity carried through.  A
    :class:`DictColumn` re-encodes through its dictionary only."""
    if isinstance(col, DictColumn):
        rows, uniq = dict_rank_codes(col)
        if col.validity is not None:
            rows = torch.where(col.validity, rows, 0)
        return Column(T.int32, rows, validity=col.validity), uniq
    from .filter import _gather_column
    from .sort import lexsort
    n = col.num_rows
    dev = col.device
    if n == 0:
        return (Column(T.int32, torch.zeros(0, dtype=torch.int32, device=dev)),
                Column(T.string, torch.zeros(0, dtype=torch.uint8, device=dev),
                       torch.zeros(1, dtype=torch.int32, device=dev)))
    mat, lens = byte_matrix(col)
    if col.validity is not None:
        mat = torch.where(col.validity[:, None], mat, 0)
        lens = torch.where(col.validity, lens, 0)
    lanes = _u32_lanes(mat)
    order = lexsort([lens] + [lanes[:, k]
                              for k in range(lanes.shape[1] - 1, -1, -1)])
    s_lanes, s_lens = lanes[order], lens[order]
    head = torch.zeros(n, dtype=torch.int32, device=dev)
    head[1:] = ((s_lanes[1:] != s_lanes[:-1]).any(dim=1)
                | (s_lens[1:] != s_lens[:-1]))
    codes_sorted = torch.cumsum(head, 0, dtype=torch.int32)
    codes = torch.empty_like(codes_sorted)
    codes[order] = codes_sorted
    ndict = int(codes_sorted[-1]) + 1            # one synchronisation
    # each code's representative: its first row, or its first valid row
    # where it has one, so that a null row's bytes never name a group
    seg = codes_sorted.to(torch.int64)
    first_pos = torch.full((ndict,), n, dtype=torch.int64, device=dev)
    first_pos.scatter_reduce_(0, seg, order, "amin")
    if col.validity is not None:
        first_valid = torch.full((ndict + 1,), n, dtype=torch.int64,
                                 device=dev)
        first_valid.scatter_reduce_(
            0, torch.where(col.validity[order], seg, ndict), order, "amin")
        first_pos = torch.where(first_valid[:ndict] < n, first_valid[:ndict],
                                first_pos)
    uniq = _gather_column(Column(col.dtype, col.data, col.offsets), first_pos)
    return Column(T.int32, codes, validity=col.validity), uniq
