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

Equality (``equal_to``, ``equal_to_scalar``, a :class:`DictColumn`'s
predicate over its dictionary) and ``encode_shared``, the one dictionary
that string join keys are coded against (:239-325), came with the joins;
the matchers ``contains``, ``starts_with``, ``ends_with`` and ``like``
(:587-716) with the grouping sets: a :class:`DictColumn` matches its
dictionary only, any other column compares the pattern's bytes at every
start of its byte matrix (B3's on the card).  The rest of the JAX module
(the parsers, the formatters, case, substrings, concatenation) is not
ported yet.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from .. import types as T
from ..column import Column, DictColumn, as_dict_column
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
    d = as_dict_column(col)
    if d is not None:
        rows, uniq = dict_rank_codes(d)
        if d.validity is not None:
            rows = torch.where(d.validity, rows, 0)
        return Column(T.int32, rows, validity=d.validity), uniq
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


def _as_bool_column(mask: torch.Tensor, validity) -> Column:
    return Column(T.bool8, mask.to(torch.uint8), validity=validity)


def _dict_predicate(col: Column, fn) -> Optional[Column]:
    """A per-row string predicate of a :class:`DictColumn`: ``fn`` once
    over the dictionary, then gathered by code; None when ``col`` holds
    no dictionary (the caller takes the byte-matrix path)."""
    d = as_dict_column(col)
    if d is None:
        return None
    nd = d.dictionary.num_rows
    if nd == 0:
        bits = torch.zeros(d.num_rows, dtype=torch.bool, device=d.device)
    else:
        dmask = fn(d.dictionary)
        bits = (dmask.data != 0)[d.codes.clamp(0, nd - 1).to(torch.int64)]
    return _as_bool_column(bits, d.validity)


def encode_shared(cols: Sequence[Column]) -> list[Column]:
    """Codes of several STRING columns against one shared dictionary, so
    that code equality is string equality across them (the string
    equi-join key).  :class:`DictColumn` inputs add their dictionaries to
    the encode, not their rows, and map their codes with one gather."""
    dicts = [as_dict_column(c) for c in cols]
    if any(d is not None for d in dicts):
        parts = [d.dictionary if d is not None else c
                 for c, d in zip(cols, dicts)]
        shared = encode_shared(parts)
        out = []
        for c, d, s in zip(cols, dicts, shared):
            if d is None:
                out.append(s)
                continue
            nd = d.dictionary.num_rows
            rows = (s.data[d.codes.clamp(0, nd - 1).to(torch.int64)] if nd
                    else torch.zeros_like(d.codes))
            if d.validity is not None:
                rows = torch.where(d.validity, rows, 0)
            out.append(Column(T.int32, rows, validity=d.validity))
        return out
    dev = cols[0].device
    sizes = [c.num_rows for c in cols]
    chars = torch.cat([c.data for c in cols])
    offs_parts = [torch.zeros(1, dtype=torch.int64, device=dev)]
    char_base = 0
    for c in cols:
        offs_parts.append(c.offsets[1:].to(torch.int64) + char_base)
        char_base += int(c.data.shape[0])
    if char_base >= 2**31:
        raise ValueError(f"encode_shared: {char_base} chars exceed int32 "
                         "offsets")
    validity = (None if all(c.validity is None for c in cols)
                else torch.cat([c.validity_or_true() for c in cols]))
    combined = Column(T.string, chars, torch.cat(offs_parts).to(torch.int32),
                      validity)
    codes, _ = dictionary_encode(combined)
    out, base = [], 0
    for c, sz in zip(cols, sizes):
        out.append(Column(T.int32, codes.data[base:base + sz],
                          validity=c.validity))
        base += sz
    return out


def equal_to(a: Column, b: Column) -> Column:
    """Row-wise string equality, a BOOL8 column, null where either side
    is."""
    la, lb = _lengths(a), _lengths(b)
    width = max(_max_len(a), _max_len(b))
    ma, _ = byte_matrix(a, width)
    mb, _ = byte_matrix(b, width)
    eq = (la == lb) & (ma == mb).all(dim=1)
    v = None
    if a.validity is not None or b.validity is not None:
        v = a.validity_or_true() & b.validity_or_true()
    return _as_bool_column(eq, v)


def equal_to_scalar(col: Column, value) -> Column:
    """``col == value`` (a str or bytes), a BOOL8 column; null rows stay
    null.  A :class:`DictColumn` compares its dictionary only."""
    hit = _dict_predicate(col, lambda u: equal_to_scalar(u, value))
    if hit is not None:
        return hit
    payload = value.encode("utf-8") if isinstance(value, str) else bytes(value)
    lens = _lengths(col)
    mat, _ = byte_matrix(col, max(len(payload), 1))
    target = torch.zeros(mat.shape[1], dtype=torch.uint8)
    if payload:
        target[:len(payload)] = torch.frombuffer(bytearray(payload),
                                                 dtype=torch.uint8)
    eq = (lens == len(payload)) & (mat == target.to(mat.device)).all(dim=1)
    return _as_bool_column(eq, col.validity)


# -- substring search (cudf strings::contains / find; Spark LIKE) ----------

def _match_at(mat: torch.Tensor, lens: torch.Tensor, pat: bytes,
              wildcard: Optional[int] = None) -> torch.Tensor:
    """bool [n, L]: does ``pat`` match at byte position s?  One compare a
    pattern byte; ``wildcard`` bytes (SQL '_') match any byte.  A match
    must fit inside its row: positions with s + len(pat) > len are
    False."""
    n, L = mat.shape
    s = torch.arange(L, dtype=torch.int64, device=mat.device)
    ok = (s[None, :] + len(pat)) <= lens[:, None]
    for k, pb in enumerate(pat):
        if wildcard is not None and pb == wildcard:
            continue
        cmp = torch.zeros((n, L), dtype=torch.bool, device=mat.device)
        cmp[:, :L - k] = mat[:, k:] == pb
        ok = ok & cmp
    return ok


def _search_matrix(col: Column, min_width: int):
    """The byte matrix as wide as the longest row and the pattern both
    (``byte_matrix``'s width pins L: the pattern's length alone would cut
    longer rows and lose matches)."""
    return byte_matrix(col, width=max(_max_len(col), min_width, 1))


def _pattern(pat) -> bytes:
    return pat.encode() if isinstance(pat, str) else bytes(pat)


def contains(col: Column, pat) -> Column:
    """True where the row contains ``pat`` (Spark ``contains``, LIKE
    '%pat%'); the empty pattern matches every row; null rows stay null."""
    hit = _dict_predicate(col, lambda u: contains(u, pat))
    if hit is not None:
        return hit
    p = _pattern(pat)
    mat, lens = _search_matrix(col, len(p))
    return _as_bool_column(_match_at(mat, lens, p).any(dim=1), col.validity)


def starts_with(col: Column, pat) -> Column:
    hit = _dict_predicate(col, lambda u: starts_with(u, pat))
    if hit is not None:
        return hit
    p = _pattern(pat)
    mat, lens = _search_matrix(col, len(p))
    return _as_bool_column(_match_at(mat, lens, p)[:, 0], col.validity)


def _at_end(hits: torch.Tensor, lens: torch.Tensor, m: int) -> torch.Tensor:
    """Each row's hit at position len - m (clamped into the matrix, as
    the JAX package's ``take_along_axis``) and that position."""
    pos = (lens.to(torch.int64) - m).clamp(0, hits.shape[1] - 1)
    return torch.gather(hits, 1, pos[:, None])[:, 0], pos


def ends_with(col: Column, pat) -> Column:
    hit = _dict_predicate(col, lambda u: ends_with(u, pat))
    if hit is not None:
        return hit
    p = _pattern(pat)
    mat, lens = _search_matrix(col, len(p))
    at_end, _ = _at_end(_match_at(mat, lens, p), lens, len(p))
    return _as_bool_column(at_end & (lens >= len(p)), col.validity)


def like(col: Column, pattern: str) -> Column:
    """SQL LIKE with ``%`` (any run) and ``_`` (any one byte), the Spark
    and cudf ``strings::like`` subset without an escape character.

    The pieces between ``%`` match left to right, each at its earliest
    position past the previous piece's end; a first piece is anchored at
    the start unless the pattern starts with ``%``, a last one at the end
    unless it ends with ``%``."""
    hit = _dict_predicate(col, lambda u: like(u, pattern))
    if hit is not None:
        return hit
    pat = pattern.encode()
    pieces = pat.split(b"%")
    anchored_start = not pattern.startswith("%")
    anchored_end = not pattern.endswith("%")
    mat, lens = _search_matrix(col, max((len(p) for p in pieces),
                                        default=0))
    n, L = mat.shape
    dev = mat.device
    okv = torch.ones(n, dtype=torch.bool, device=dev)
    cur = torch.zeros(n, dtype=torch.int64, device=dev)   # earliest start
    idx = torch.arange(L, dtype=torch.int64, device=dev)
    for pi, piece in enumerate(pieces):
        if not piece:
            continue
        hits = _match_at(mat, lens, piece, wildcard=ord("_"))
        is_first, is_last = pi == 0, pi == len(pieces) - 1
        if is_first and anchored_start:
            okv = okv & hits[:, 0]
            cur = cur.clamp(min=len(piece))
            if is_last and anchored_end:
                okv = okv & (lens == len(piece))
            continue
        if is_last and anchored_end:
            at_end, pos = _at_end(hits, lens, len(piece))
            okv = okv & at_end & (lens >= len(piece)) & (pos >= cur)
            continue
        # a floating piece: its earliest match at a position >= cur
        usable = hits & (idx[None, :] >= cur[:, None])
        okv = okv & usable.any(dim=1)
        # torch's argmax takes no bool: the first 1 of the uint8 view
        cur = usable.to(torch.uint8).argmax(dim=1) + len(piece)
    if not any(pieces):
        # all '%' (or empty): "%...%" matches every row, "" the empty one
        okv = (torch.ones(n, dtype=torch.bool, device=dev) if b"%" in pat
               else lens == 0)
    return _as_bool_column(okv, col.validity)
