"""STRING columns: byte matrices, keys, matchers, casts and transforms.

The port's counterpart of the JAX package's ``ops/strings.py``, the whole
module.  A STRING column's rows become a zero-padded byte matrix [n, L]
(L the longest row rounded up to 4, one synchronisation): on the card
kernel B3's work (``rowconv.ragged.unpack_rows``), on the CPU its plain
version's.  On it rest:

* the keys (``byte_matrix``, ``sort_key_lanes``, ``dict_rank_codes``,
  ``dictionary_encode``, :46-237): 32-bit big-endian lanes, held in int64
  tensors, whose numeric order is lexicographic byte order;
* equality and ``encode_shared``, the one dictionary that string join
  keys are coded against (:239-325);
* the matchers ``contains``, ``starts_with``, ``ends_with`` and ``like``
  (:587-716): a :class:`DictColumn` matches its dictionary only;
* the parsers ``to_int64``, ``to_decimal``, ``to_date`` and ``to_bool``
  (:403-585, :876-898), Spark CAST semantics: whitespace trimmed, null
  for a malformed row, for more than 18 significant digits and for an
  impossible date, round half up on dropped digits.  A
  :class:`DictColumn` reaches them materialized (B5 → B6 → B2), as in
  the JAX package.

The formatters ``format_int64``, ``format_decimal``, ``format_date`` and
``format_bool`` (:717-874, :900-909) lay each row's text into a byte
matrix and cut the rows out of it with one gather.  Torch has almost no
uint64 arithmetic, so the digits of a uint64 magnitude come from int64
tensors that hold its bits: an unsigned ``u // 10`` is
``((u >> 1) & INT64_MAX) // 5``, and ``u - 10 * q`` wraps to the digit.
``upper``, ``lower``, ``substring`` and ``concat`` (:327-400) gather
chars; the first three transform a :class:`DictColumn`'s dictionary and
keep its codes.  Each op that builds chars synchronises once, on their
total.
"""

from __future__ import annotations

import threading
from typing import Optional, Sequence

import torch

from .. import types as T
from ..column import Column, DictColumn, as_dict_column
from ..rowconv import ragged
from ..utils import syncs
from .int64bits import MASK32, TOPBIT


def _lengths(col: Column) -> torch.Tensor:
    return col.offsets[1:] - col.offsets[:-1]


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def _max_len(col: Column) -> int:
    """The longest row, in bytes: one synchronisation, memoized on the
    offsets tensor (plans re-touch the same dimension columns), as in the
    JAX package."""
    if col.num_rows == 0:
        return 0
    hit = syncs.memo_get("strwidth", (col.offsets,))
    if hit is not None:
        return hit
    width = syncs.size(_lengths(col).max())
    syncs.memo_put("strwidth", (col.offsets,), width)
    return width


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
    # a pure function of the payload, re-touched by every groupby, window
    # and join over one dimension column: memoized, as in the JAX package
    memo_key = (col.data, col.offsets) + (
        (col.validity,) if col.validity is not None else ())
    memo_tag = f"dictenc{'v' if col.validity is not None else ''}"
    hit = syncs.memo_get(memo_tag, memo_key)
    if hit is not None:
        return hit
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
    ndict = syncs.size(codes_sorted[-1], n - 1) + 1   # one synchronisation
    # codes past the dictionary only under a stale tape: cut them there
    codes_sorted = codes_sorted.clamp_(max=ndict - 1)
    codes = torch.empty_like(codes_sorted)
    codes[order] = codes_sorted
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
    # a code no row holds (a stale tape) keeps n: cut it to a row
    uniq = _gather_column(Column(col.dtype, col.data, col.offsets),
                          first_pos.clamp_(max=n - 1))
    out = (Column(T.int32, codes, validity=col.validity), uniq)
    syncs.memo_put(memo_tag, memo_key, out)
    return out


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
    # the rows of the payload's length whose first bytes are its bytes (a
    # compare a byte with a host scalar: nothing is copied from the host)
    eq = lens == len(payload)
    for k, b in enumerate(payload):
        eq = eq & (mat[:, k] == b)
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


# -- elementwise transforms --------------------------------------------------

def upper(col: Column) -> Column:
    """ASCII uppercase; a :class:`DictColumn` transforms its dictionary."""
    d = as_dict_column(col)
    if d is not None:
        return DictColumn(d.codes, upper(d.dictionary), d.validity)
    c = col.data
    return Column(T.string, torch.where((c >= 97) & (c <= 122), c - 32, c),
                  col.offsets, col.validity)


def lower(col: Column) -> Column:
    """ASCII lowercase; a :class:`DictColumn` transforms its dictionary."""
    d = as_dict_column(col)
    if d is not None:
        return DictColumn(d.codes, lower(d.dictionary), d.validity)
    c = col.data
    return Column(T.string, torch.where((c >= 65) & (c <= 90), c + 32, c),
                  col.offsets, col.validity)


def _new_offsets(lens: torch.Tensor,
                 upper: int) -> tuple[torch.Tensor, int]:
    """int32 offsets [n+1] of rows of ``lens`` bytes, and their total (the
    one synchronisation), at most ``upper``; the offsets are cut at the
    total, a no-op unless the tape is stale."""
    offs = torch.zeros(lens.shape[0] + 1, dtype=torch.int32,
                       device=lens.device)
    offs[1:] = torch.cumsum(lens, 0, dtype=torch.int32)
    total = syncs.size(offs[-1], upper)
    return offs.clamp_(max=total), total


def _char_rows(offs: torch.Tensor, total: int):
    """(row of each output char, its position within the row): the JAX
    package's ``_segment_of``, without a synchronisation."""
    from .filter import sized_repeat
    row_of = sized_repeat((offs[1:] - offs[:-1]).to(torch.int64), total)
    within = (torch.arange(total, dtype=torch.int64, device=offs.device)
              - offs[:-1].to(torch.int64)[row_of])
    return row_of, within


def _take_chars(data: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """``data[src]``, each index cut into ``data`` (zeros from an empty
    one): reads stay in bounds whatever the tape said."""
    n = data.shape[0]
    if n == 0:
        return torch.zeros(src.shape[0], dtype=torch.uint8,
                           device=data.device)
    return data[src.clamp(0, n - 1)]


def _empty_chars(device) -> torch.Tensor:
    return torch.zeros(0, dtype=torch.uint8, device=device)


def substring(col: Column, start: int, length: Optional[int] = None) -> Column:
    """The 0-based byte substring [start, start+length) of every row; a
    :class:`DictColumn` cuts its dictionary."""
    if start < 0:
        raise ValueError("substring start must be >= 0")
    d = as_dict_column(col)
    if d is not None:
        return DictColumn(d.codes, substring(d.dictionary, start, length),
                          d.validity)
    new_lens = (_lengths(col) - start).clamp(min=0)
    if length is not None:
        new_lens = new_lens.clamp(max=length)
    new_offs, total = _new_offsets(new_lens, col.data.shape[0])
    if total == 0:
        return Column(T.string, _empty_chars(col.device), new_offs,
                      col.validity)
    row_of, within = _char_rows(new_offs, total)
    src = col.offsets[:-1].to(torch.int64)[row_of] + start + within
    return Column(T.string, _take_chars(col.data, src), new_offs,
                  col.validity)


def concat(a: Column, b: Column) -> Column:
    """Row-wise ``a[i] + b[i]``, null where either side is (Spark
    ``concat``)."""
    la, lb = _lengths(a), _lengths(b)
    valid = None
    if a.validity is not None or b.validity is not None:
        valid = a.validity_or_true() & b.validity_or_true()
        la = torch.where(valid, la, 0)
        lb = torch.where(valid, lb, 0)
    new_offs, total = _new_offsets(la + lb,
                                   a.data.shape[0] + b.data.shape[0])
    if total == 0:
        return Column(T.string, _empty_chars(a.device), new_offs, valid)
    row_of, within = _char_rows(new_offs, total)
    la_row = la.to(torch.int64)[row_of]
    ca = _take_chars(a.data, a.offsets[:-1].to(torch.int64)[row_of] + within)
    cb = _take_chars(b.data, b.offsets[:-1].to(torch.int64)[row_of] + within
                     - la_row)
    return Column(T.string, torch.where(within < la_row, ca, cb), new_offs,
                  valid)


# -- numeric and date parsing (cudf strings::to_integers / to_fixed_point /
#    to_timestamps; the Mortgage ETL's casts) --------------------------------

_POW10 = [10 ** k for k in range(20)]

# constant tables on each device, made once (outside any graph capture: a
# capture refuses the pageable host copy torch.tensor makes)
_CONSTS: dict = {}
_CONSTS_MU = threading.Lock()


def _const(name: str, values, dtype, device) -> torch.Tensor:
    """The constant table ``name`` (``values`` as ``dtype``) on ``device``,
    built on its first use there and kept.  Read-only: callers never
    write into it."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    key = (name, dev)
    t = _CONSTS.get(key)
    if t is None:
        # the stream's capture state lives on the host: no tensor is read
        if (dev.type == "cuda"  # srjt-lint: disable=trace-branch
                and torch.cuda.is_current_stream_capturing()):
            raise RuntimeError(f"constant table {name!r} first needed "
                               "inside a CUDA-graph capture: run the query "
                               "eagerly once first")
        with _CONSTS_MU:
            t = _CONSTS.get(key)
            if t is None:
                t = _CONSTS[key] = torch.tensor(values, dtype=dtype,
                                                device=dev)
    return t


def _pow10(exp: torch.Tensor) -> torch.Tensor:
    """10 ** exp for int64 exponents in [0, 18], by a table gather."""
    return _const("pow10", _POW10[:19], torch.int64, exp.device)[exp]


def _positions(mat: torch.Tensor) -> torch.Tensor:
    return torch.arange(mat.shape[1], dtype=torch.int64, device=mat.device)


def _row_cumsum(mask: torch.Tensor) -> torch.Tensor:
    """int64 [n, L]: the inclusive count of ``mask``'s trues along each
    row, by a scan over the outer dimension of the transpose.  Torch's
    scan along a short innermost dimension is slow on the card: on an
    H100 its scans held 850 of the Mortgage ETL's 920 busy ms at
    12,000,000 × 12 (``PERF.md`` §5)."""
    return torch.cumsum(mask.t().to(torch.int64).contiguous(), dim=0).t()


def _suffix_count(mask: torch.Tensor) -> torch.Tensor:
    """int64 [n, L]: how many of ``mask``'s trues lie right of each
    position (the position itself excluded)."""
    return mask.sum(dim=1, keepdim=True) - _row_cumsum(mask)


def _leading_run(mask: torch.Tensor) -> torch.Tensor:
    """int64 [n]: the trues at the start of each row, before its first
    false (the sum of the JAX package's ``cumprod``)."""
    first_false = (~mask).to(torch.uint8).argmax(dim=1)
    return torch.where(mask.all(dim=1), mask.shape[1], first_false)


def _trimmed(mat: torch.Tensor, lens: torch.Tensor):
    """Each row left-justified past its leading whitespace, its trailing
    whitespace dropped from the length: Spark CAST trims all ASCII
    whitespace (space, \\t, \\n, \\v, \\f, \\r; UTF8String.trimAll)."""
    L = mat.shape[1]
    j = _positions(mat)
    lens64 = lens.to(torch.int64)
    in_row = j[None, :] < lens64[:, None]
    is_space = (mat == ord(" ")) | ((mat >= 9) & (mat <= 13))
    lead = _leading_run(is_space & in_row)
    trail = _leading_run((is_space | ~in_row).flip(1)) - (L - lens64)
    new_lens = (lens64 - lead - trail.clamp(min=0)).clamp(min=0)
    src = (j[None, :] + lead[:, None]).clamp(0, L - 1)
    shifted = torch.gather(mat, 1, src)
    shifted = torch.where(j[None, :] < new_lens[:, None], shifted, 0)
    return shifted, new_lens.to(lens.dtype)


def _digit_scan(mat: torch.Tensor, lens: torch.Tensor):
    """(digits int64 [n, L], -1 off the digits; neg bool [n]; is_digit
    bool [n, L]): a leading '-' or '+' is consumed, any other byte is the
    caller's to judge."""
    j = _positions(mat)
    in_row = j[None, :] < lens.to(torch.int64)[:, None]
    neg = mat[:, 0] == ord("-")
    signed = neg | (mat[:, 0] == ord("+"))
    consumed = signed[:, None] & (j[None, :] == 0)
    is_digit = in_row & ~consumed & (mat >= ord("0")) & (mat <= ord("9"))
    digits = torch.where(is_digit, mat.to(torch.int64) - ord("0"), -1)
    return digits, neg, is_digit


def _junk(mat: torch.Tensor, lens: torch.Tensor, allowed: torch.Tensor):
    """bool [n]: the row holds a byte that is neither ``allowed`` nor a
    sign in its first position."""
    j = _positions(mat)
    in_row = j[None, :] < lens.to(torch.int64)[:, None]
    sign0 = ((mat == ord("-")) | (mat == ord("+"))) & (j[None, :] == 0)
    return (in_row & ~allowed & ~sign0).any(dim=1)


def _significant_digits(digits: torch.Tensor,
                        which: torch.Tensor) -> torch.Tensor:
    """Per row, the digits in ``which`` from its first nonzero one on."""
    seen = _row_cumsum(which & (digits > 0)) > 0
    return (which & seen).sum(dim=1)


def _valid(ok: torch.Tensor, col: Column) -> torch.Tensor:
    return ok if col.validity is None else ok & col.validity


def to_int64(col: Column) -> Column:
    """Decimal integer strings → INT64, null for an empty or malformed row
    and past 18 significant digits (Spark CAST): each digit weighted by
    10 ** (the digits right of it), one sum a row."""
    mat, lens = byte_matrix(col)
    mat, lens = _trimmed(mat, lens)
    digits, neg, is_digit = _digit_scan(mat, lens)
    ok = (is_digit.any(dim=1) & ~_junk(mat, lens, is_digit)
          & (_significant_digits(digits, is_digit) <= 18))
    weight = torch.where(is_digit,
                         _pow10(_suffix_count(is_digit).clamp(0, 18)), 0)
    vals = (torch.where(is_digit, digits, 0) * weight).sum(dim=1)
    vals = torch.where(neg, -vals, vals)
    return Column(T.int64, vals, validity=_valid(ok, col))


def to_decimal(col: Column, scale: int) -> Column:
    """"123.45"-style strings → DECIMAL64(scale), rounding half up on the
    first dropped digit; null for a malformed row and when the integer
    digits and the kept fraction pass 18 digits."""
    mat, lens = byte_matrix(col)
    mat, lens = _trimmed(mat, lens)
    digits, neg, is_digit = _digit_scan(mat, lens)
    j = _positions(mat)
    is_dot = (j[None, :] < lens.to(torch.int64)[:, None]) & (mat == ord("."))
    ok = (is_digit.any(dim=1) & ~_junk(mat, lens, is_digit | is_dot)
          & (is_dot.sum(dim=1) <= 1))
    # a digit's exponent: its integer digits to the right plus the kept
    # fraction, or the kept fraction less its 1-based place after the dot
    after_dot = _row_cumsum(is_dot) > 0
    frac_digit = is_digit & after_dot
    frac_pos = torch.where(frac_digit, _row_cumsum(frac_digit), 0)
    int_digit = is_digit & ~after_dot
    keep = -scale
    exp = torch.where(int_digit, _suffix_count(int_digit) + keep,
                      torch.where(is_digit, keep - frac_pos, -1))
    kept = is_digit & (exp >= 0)
    ok = ok & (_significant_digits(digits, int_digit) + keep <= 18)
    weight = torch.where(kept, _pow10(exp.clamp(0, 18)), 0)
    vals = (torch.where(kept, digits, 0) * weight).sum(dim=1)
    # exp == -1 marks the first dropped digit under either sign of scale
    first_drop = is_digit & (exp == -1)
    roundup = torch.where(first_drop, digits, 0).sum(dim=1) >= 5
    vals = vals + roundup.to(torch.int64)
    vals = torch.where(neg, -vals, vals)
    return Column(T.decimal64(scale), vals, validity=_valid(ok, col))


def _days_from_civil(y: torch.Tensor, m: torch.Tensor,
                     d: torch.Tensor) -> torch.Tensor:
    """Gregorian (y, m, d) → days since 1970-01-01 (Hinnant), on floor
    division: torch's ``//`` floors and its ``%`` takes the divisor's
    sign, as the JAX package's do."""
    y = y - (m <= 2).to(y.dtype)
    era = torch.where(y >= 0, y, y - 399) // 400
    yoe = y - era * 400
    mp = (m + 9) % 12
    doy = (153 * mp + 2) // 5 + d - 1
    doe = yoe * 365 + yoe // 4 - yoe // 100 + doy
    return era * 146097 + doe - 719468


def _slice_int(mat: torch.Tensor, start: int, width: int):
    """(value, every byte a digit) of a fixed byte slice of each row."""
    sub = mat[:, start:start + width].to(torch.int64) - ord("0")
    digits_ok = ((sub >= 0) & (sub <= 9)).all(dim=1)
    w = _const(f"pow10_desc{width}", _POW10[width - 1::-1], torch.int64,
               mat.device)
    return (sub.clamp(0, 9) * w).sum(dim=1), digits_ok


_DAYS_IN_MONTH = (31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31)


def to_date(col: Column, fmt: str = "%Y-%m-%d") -> Column:
    """Fixed-layout date strings → TIMESTAMP_DAYS, "%Y-%m-%d" or
    "%m/%d/%Y" (the mortgage files' layout).  A wrong length, separator
    or digit, or an impossible date (Feb 31), is null (Spark CAST)."""
    mat, lens = byte_matrix(col, width=10)
    if fmt == "%Y-%m-%d":
        y, oy = _slice_int(mat, 0, 4)
        m, om = _slice_int(mat, 5, 2)
        d, od = _slice_int(mat, 8, 2)
        seps = (mat[:, 4] == ord("-")) & (mat[:, 7] == ord("-"))
    elif fmt == "%m/%d/%Y":
        m, om = _slice_int(mat, 0, 2)
        d, od = _slice_int(mat, 3, 2)
        y, oy = _slice_int(mat, 6, 4)
        seps = (mat[:, 2] == ord("/")) & (mat[:, 5] == ord("/"))
    else:
        raise NotImplementedError(f"unsupported date format {fmt!r}")
    leap = ((y % 4 == 0) & (y % 100 != 0)) | (y % 400 == 0)
    msafe = m.clamp(1, 12)
    dim = (_const("days_in_month", _DAYS_IN_MONTH, torch.int64,
                  mat.device)[msafe - 1]
           + (leap & (msafe == 2)).to(torch.int64))
    ok = ((lens == 10) & seps & oy & om & od
          & (m >= 1) & (m <= 12) & (d >= 1) & (d <= dim))
    days = _days_from_civil(y, msafe, d.clamp(1, 31)).to(torch.int32)
    return Column(T.timestamp_days, days, validity=_valid(ok, col))


_TRUE_WORDS = (b"true", b"t", b"yes", b"y", b"1")
_FALSE_WORDS = (b"false", b"f", b"no", b"n", b"0")


def to_bool(col: Column) -> Column:
    """Spark CAST(string AS BOOLEAN): true/false/t/f/yes/no/y/n/1/0 in
    any case, trimmed; anything else is null."""
    mat, lens = _search_matrix(lower(col), 5)
    mat, lens = _trimmed(mat, lens)

    def word_eq(word: bytes) -> torch.Tensor:
        m = lens == len(word)
        for k, b in enumerate(word):
            m = m & (mat[:, k] == b)
        return m

    is_true = torch.zeros(col.num_rows, dtype=torch.bool, device=mat.device)
    is_false = torch.zeros_like(is_true)
    for w in _TRUE_WORDS:
        is_true = is_true | word_eq(w)
    for w in _FALSE_WORDS:
        is_false = is_false | word_eq(w)
    return Column(T.bool8, is_true.to(torch.uint8),
                  validity=_valid(is_true | is_false, col))


# -- numbers and dates → strings (cudf strings::from_integers /
#    from_fixed_point; Spark CAST(x AS STRING)) ------------------------------

_INT64_MAX = (1 << 63) - 1


def _as_int64_bits(v: int) -> int:
    """A uint64 value as the int64 with the same bits."""
    return v - (1 << 64) if v >= (1 << 63) else v


def _udiv_even(u: torch.Tensor, div: int) -> torch.Tensor:
    """Unsigned ``u // div`` of int64 tensors holding uint64 bits, for an
    even ``div``: (u >> 1, logical) // (div / 2)."""
    return ((u >> 1) & _INT64_MAX) // (div // 2)


def _digit_matrix(mag: torch.Tensor, width: int) -> torch.Tensor:
    """uint8 [n, width]: the ASCII digits of ``mag`` (uint64 bits in
    int64) mod 10**width, right-aligned: one unsigned divide by 10 a
    column, from the last, and the remainder by a wrapping subtract."""
    cols = []
    x = mag
    for _ in range(width):
        q = _udiv_even(x, 10)
        cols.append((x - 10 * q).to(torch.uint8) + ord("0"))
        x = q
    return torch.stack(cols[::-1], dim=1)


def _ndigits(mag: torch.Tensor, up_to: int = 18) -> torch.Tensor:
    """Decimal digits of ``mag`` (uint64 bits in int64; 0 has one), up to
    1 + ``up_to``: unsigned compares, as signed ones with the top bit
    flipped."""
    flipped = mag ^ TOPBIT
    n = torch.ones_like(mag, dtype=torch.int32)
    for k in range(1, up_to + 1):
        bound = _as_int64_bits(_POW10[k]) ^ TOPBIT
        n = n + (flipped >= bound).to(torch.int32)
    return n


def _uint64_magnitude(v: torch.Tensor):
    """(|v| as uint64 bits in int64, v < 0): INT64_MIN's magnitude 2^63
    wraps to its own bits, which is right."""
    neg = v < 0
    return torch.where(neg, 0 - v, v), neg


def _matrix_to_strings(mat: torch.Tensor, starts: torch.Tensor,
                       lens: torch.Tensor, validity) -> Column:
    """A STRING column of each row's bytes [start, start + len) of
    ``mat``; null rows take no bytes."""
    if validity is not None:
        lens = torch.where(validity, lens, 0)
    new_offs, total = _new_offsets(lens, mat.shape[0] * mat.shape[1])
    if total == 0:
        return Column(T.string, _empty_chars(mat.device), new_offs, validity)
    row_of, within = _char_rows(new_offs, total)
    chars = mat[row_of, (starts.to(torch.int64)[row_of] + within)
                .clamp(0, mat.shape[1] - 1)]
    return Column(T.string, chars, new_offs, validity)


def _put_sign(mat: torch.Tensor, starts: torch.Tensor,
              neg: torch.Tensor) -> torch.Tensor:
    """'-' written at each negative row's start (its first digit's left)."""
    rows = torch.arange(mat.shape[0], device=mat.device)
    spos = starts.to(torch.int64).clamp(min=0)
    mat.index_put_((rows, spos),
                   torch.where(neg, ord("-"), mat[rows, spos]).to(torch.uint8))
    return mat


def _format_unsigned(mag: torch.Tensor, neg: torch.Tensor, validity,
                     trailing_zeros: int = 0) -> Column:
    """Magnitudes (uint64 bits in int64) and signs → decimal strings;
    ``trailing_zeros`` literal zeros follow the digits (positive decimal
    scales), but for a magnitude of 0, which stays "0"."""
    n = mag.shape[0]
    nd = _ndigits(mag, up_to=19)
    W = 21                                     # '-' and up to 20 digits
    parts = [torch.full((n, 1), ord("-"), dtype=torch.uint8,
                        device=mag.device), _digit_matrix(mag, W - 1)]
    if trailing_zeros:
        parts.append(torch.full((n, trailing_zeros), ord("0"),
                                dtype=torch.uint8, device=mag.device))
    mat = torch.cat(parts, dim=1)
    tz = torch.where(mag == 0, 0, trailing_zeros).to(torch.int32)
    lens = nd + tz + neg.to(torch.int32)
    starts = torch.where(neg, (W - 1) - nd, W - nd)
    return _matrix_to_strings(_put_sign(mat, starts, neg), starts, lens,
                              validity)


def format_int64(col: Column) -> Column:
    """An integer column → decimal strings (Spark CAST(x AS STRING)),
    exact for INT64_MIN and for uint64 values from 2^63 on."""
    if col.data.dtype == torch.uint64:
        mag = col.data.view(torch.int64)
        neg = torch.zeros(col.num_rows, dtype=torch.bool, device=col.device)
    else:
        mag, neg = _uint64_magnitude(col.data.to(torch.int64))
    return _format_unsigned(mag, neg, col.validity)


def format_decimal(col: Column) -> Column:
    """A decimal32/64 column → strings with its scale's fraction digits
    ("123.45" for 12345 at scale -2); scale 0 formats as an integer, a
    positive scale appends literal zeros (a multiply would wrap)."""
    if col.dtype.scale == 0:
        return format_int64(col)
    mag, neg = _uint64_magnitude(col.data.to(torch.int64))
    if col.dtype.scale > 0:
        return _format_unsigned(mag, neg, col.validity,
                                trailing_zeros=col.dtype.scale)
    n = col.num_rows
    k = -col.dtype.scale
    int_part = _udiv_even(mag, 10 ** k)
    frac = mag - int_part * 10 ** k             # wraps to [0, 10**k)
    nd_int = _ndigits(int_part, up_to=19)
    WI = 20
    dev = mag.device
    mat = torch.cat([
        torch.full((n, 1), ord("-"), dtype=torch.uint8, device=dev),
        _digit_matrix(int_part, WI),
        torch.full((n, 1), ord("."), dtype=torch.uint8, device=dev),
        _digit_matrix(frac, k)], dim=1)
    # [0] '-', [1..WI] the integer digits right-aligned, [WI+1] '.', then
    # the fraction; a row starts at its sign or its first integer digit
    first_digit = 1 + WI - nd_int
    starts = torch.where(neg, first_digit - 1, first_digit)
    lens = nd_int + 1 + k + neg.to(torch.int32)
    return _matrix_to_strings(_put_sign(mat, starts, neg), starts, lens,
                              col.validity)


def _civil_from_days(days: torch.Tensor):
    """Days since 1970-01-01 → (y, m, d), Hinnant's civil_from_days on
    floor division (the inverse of :func:`_days_from_civil`)."""
    z = days.to(torch.int64) + 719468
    era = z // 146097
    doe = z - era * 146097
    yoe = (doe - doe // 1460 + doe // 36524 - doe // 146096) // 365
    y = yoe + era * 400
    doy = doe - (365 * yoe + yoe // 4 - yoe // 100)
    mp = (5 * doy + 2) // 153
    d = doy - (153 * mp + 2) // 5 + 1
    m = mp + torch.where(mp < 10, 3, -9)
    y = y + (m <= 2).to(torch.int64)
    return y, m, d


def format_date(col: Column) -> Column:
    """TIMESTAMP_DAYS → ISO "YYYY-MM-DD" (Spark CAST(date AS STRING));
    a year outside 0000-9999 is null."""
    y, m, d = _civil_from_days(col.data)
    ok = (y >= 0) & (y <= 9999)
    n = col.num_rows
    dash = torch.full((n, 1), ord("-"), dtype=torch.uint8, device=col.device)
    mat = torch.cat([_digit_matrix(y.clamp(0, 9999), 4), dash,
                     _digit_matrix(m, 2), dash, _digit_matrix(d, 2)], dim=1)
    starts = torch.zeros(n, dtype=torch.int32, device=col.device)
    lens = torch.full((n,), 10, dtype=torch.int32, device=col.device)
    return _matrix_to_strings(mat, starts, lens, _valid(ok, col))


def format_bool(col: Column) -> Column:
    """BOOL8 → "true" / "false" (Spark CAST(boolean AS STRING))."""
    b = col.data != 0
    lit = _const("false_true", list(b"falsetrue\x00"), torch.uint8,
                 col.device)
    mat5 = torch.where(b[:, None], lit[None, 5:10], lit[None, :5])
    lens = torch.where(b, 4, 5).to(torch.int32)
    starts = torch.zeros(col.num_rows, dtype=torch.int32, device=col.device)
    return _matrix_to_strings(mat5, starts, lens, col.validity)
