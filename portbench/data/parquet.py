"""A numpy Parquet writer: the pages and footer the benchmark's files need.

The benchmark's own copy of the writer the port's tests use
(``tools/torch_lineitem_parquet.py``), cut to what its configurations
write and rewritten so that it imports nothing of the port: data pages v1,
UNCOMPRESSED, PLAIN and RLE_DICTIONARY pages (the codes as bit-packed runs
of at most 63 groups, as parquet-mr writes them), PLAIN strings,
FIXED_LEN_BYTE_ARRAY decimals, definition levels for OPTIONAL columns,
min/max statistics, and a thrift compact footer written by its own
encoder.  A dictionary-encoded chunk falls back to PLAIN at the first page
that would take its dictionary past ``dict_page_bytes``, as parquet-mr
does, and keeps its dictionary in first-occurrence order.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Optional

import numpy as np

MAGIC = b"PAR1"
PHYS = {"INT32": 1, "INT64": 2, "DOUBLE": 5, "BYTE_ARRAY": 6,
        "FIXED_LEN_BYTE_ARRAY": 7}
NP_TYPES = {"INT32": np.dtype("<i4"), "INT64": np.dtype("<i8"),
            "DOUBLE": np.dtype("<f8")}
CONVERTED = {"UTF8": 0, "DECIMAL": 5, "DATE": 6}
ENC_PLAIN, ENC_RLE, ENC_RLE_DICTIONARY = 0, 3, 8
PAGE_DATA, PAGE_DICTIONARY = 0, 2
CODEC_UNCOMPRESSED = 0
MAX_BP_GROUPS = 63           # parquet-mr's longest bit-packed run


# ---------------------------------------------------------------------------
# thrift compact protocol (the footer and page headers)
# ---------------------------------------------------------------------------

T_BOOL_TRUE, T_BOOL_FALSE, T_I32, T_I64, T_BINARY, T_LIST, T_STRUCT = (
    1, 2, 5, 6, 8, 9, 12)


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        if n < 0x80:
            out.append(n)
            return bytes(out)
        out.append((n & 0x7F) | 0x80)
        n >>= 7


def _zigzag(n: int) -> int:
    return (n << 1) ^ (n >> 63)


def _value(ttype: int, v) -> bytes:
    if ttype in (T_I32, T_I64):
        return _varint(_zigzag(int(v)))
    if ttype == T_BINARY:
        return _varint(len(v)) + bytes(v)
    if ttype == T_STRUCT:
        return tstruct(v)
    if ttype == T_LIST:
        etype, items = v
        head = (bytes([(len(items) << 4) | etype]) if len(items) < 15
                else bytes([0xF0 | etype]) + _varint(len(items)))
        return head + b"".join(_value(etype, x) for x in items)
    raise ValueError(f"thrift type {ttype}")


def tstruct(fields) -> bytes:
    """A compact-protocol struct of ``(field id, type, value)`` triples in
    ascending id order; a field whose value is None is left out.  A bool
    is ``T_BOOL_TRUE`` with a Python bool; a list is ``(element type,
    items)``; a struct is its own list of triples."""
    out = bytearray()
    last = 0
    for fid, ttype, v in fields:
        if v is None:
            continue
        if ttype == T_BOOL_TRUE:
            ttype = T_BOOL_TRUE if v else T_BOOL_FALSE
        delta = fid - last
        if 0 < delta <= 15:
            out.append((delta << 4) | ttype)
        else:
            out.append(ttype)
            out += _varint(((fid << 1) ^ (fid >> 15)) & 0xFFFFFFFF)
        if ttype not in (T_BOOL_TRUE, T_BOOL_FALSE):
            out += _value(ttype, v)
        last = fid
    out.append(0)
    return bytes(out)


# ---------------------------------------------------------------------------
# columns
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ParquetColumn:
    """One column to write.  Numbers: ``values`` is a numpy array
    (FIXED_LEN_BYTE_ARRAY decimals: int64 unscaled values).  Dictionary
    strings: ``values`` is int codes into ``vocab`` (a list of bytes).
    PLAIN strings: ``strings`` is (chars uint8, int64 offsets [n+1]) and
    ``values`` the row numbers.  ``validity`` (bool, True = present) makes
    the column OPTIONAL."""

    name: str
    phys: str
    values: np.ndarray
    encoding: str = "plain"                    # plain | dict
    converted: Optional[str] = None            # UTF8 | DATE | DECIMAL
    vocab: Optional[list] = None
    validity: Optional[np.ndarray] = None
    strings: Optional[tuple] = None
    decimal: Optional[tuple] = None            # (precision, scale)
    type_length: int = 0


def plain_strings_column(name: str, chars: np.ndarray, offsets: np.ndarray,
                         validity=None) -> ParquetColumn:
    n = offsets.shape[0] - 1
    return ParquetColumn(name, "BYTE_ARRAY", np.arange(n, dtype=np.int64),
                         "plain", "UTF8", None, validity, (chars, offsets))


def flba_width(precision: int) -> int:
    """The fewest bytes whose two's complement holds ``precision``
    digits."""
    w = 1
    while 10 ** precision - 1 >= 1 << (8 * w - 1):
        w += 1
    return w


def decimal_column(name: str, values, precision: int,
                   scale: int) -> ParquetColumn:
    return ParquetColumn(name, "FIXED_LEN_BYTE_ARRAY",
                         np.asarray(values, np.int64), "plain", "DECIMAL",
                         decimal=(precision, scale),
                         type_length=flba_width(precision))


def flba_bytes(values: np.ndarray, width: int) -> bytes:
    """int64 values as big-endian two's complement of ``width`` (<= 8)
    bytes."""
    be = np.ascontiguousarray(values, ">i8").view(np.uint8).reshape(-1, 8)
    return be[:, 8 - width:].tobytes()


# ---------------------------------------------------------------------------
# encodings
# ---------------------------------------------------------------------------

def bit_packed_runs(values: np.ndarray, bw: int) -> bytes:
    """The RLE/bit-packed hybrid stream of ``values`` as bit-packed runs
    of at most ``MAX_BP_GROUPS`` groups of 8, LSB first."""
    n = values.shape[0]
    if n == 0:
        return b""
    groups = -(-n // 8)
    v = np.zeros(groups * 8, np.uint64)
    v[:n] = values
    bits = np.empty((groups * 8, bw), np.uint8)
    for b in range(bw):
        bits[:, b] = (v >> np.uint64(b)) & np.uint64(1)
    packed = np.packbits(bits.reshape(-1), bitorder="little").tobytes()
    out = bytearray()
    for g0 in range(0, groups, MAX_BP_GROUPS):
        g = min(MAX_BP_GROUPS, groups - g0)
        out += _varint((g << 1) | 1)
        out += packed[g0 * bw:(g0 + g) * bw]
    return bytes(out)


def _vocab_strings(vocab: list) -> tuple:
    """(chars, int64 offsets) of a list of bytes."""
    lens = np.array([len(v) for v in vocab], np.int64)
    offs = np.zeros(len(vocab) + 1, np.int64)
    np.cumsum(lens, out=offs[1:])
    return np.frombuffer(b"".join(vocab), np.uint8), offs


def _plain_records(chars: np.ndarray, offsets: np.ndarray,
                   rows: np.ndarray) -> bytes:
    """PLAIN BYTE_ARRAY records (4-byte length, chars) of ``rows``."""
    lens = offsets[rows + 1] - offsets[rows]
    k = rows.shape[0]
    rec = np.zeros(k + 1, np.int64)
    np.cumsum(lens + 4, out=rec[1:])
    buf = np.empty(int(rec[-1]), np.uint8)
    buf[(rec[:-1, None] + np.arange(4)).reshape(-1)] = (
        lens.astype("<u4").view(np.uint8))
    before = rec[:-1] - 4 * np.arange(k)
    within = np.arange(int(lens.sum()), dtype=np.int64)
    buf[np.repeat(rec[:-1] + 4 - before, lens) + within] = chars[
        np.repeat(offsets[rows] - before, lens) + within]
    return buf.tobytes()


def _first_occurrence(values: np.ndarray):
    """(distinct values in first-occurrence order, code of every value)."""
    n = values.shape[0]
    if values.dtype.kind in "iu" and n:
        lo = int(values.min())
        span = int(values.max()) - lo + 1
        if span <= 4 * n:
            off = (values - lo).astype(np.intp)
            first = np.full(span, n, np.int64)
            np.minimum.at(first, off, np.arange(n))
            seen = np.flatnonzero(first < n)
            order = seen[np.argsort(first[seen])]
            rank = np.empty(span, np.int64)
            rank[order] = np.arange(order.shape[0])
            return (order + lo).astype(values.dtype), rank[off]
    uniq, first, inverse = np.unique(values, return_index=True,
                                     return_inverse=True)
    order = np.argsort(first, kind="stable")
    rank = np.empty_like(order)
    rank[order] = np.arange(order.shape[0])
    return uniq[order], rank[inverse.reshape(-1)]


def _encode_plain(col: ParquetColumn, present: np.ndarray) -> bytes:
    """PLAIN bytes of present values (numbers, unscaled decimals, row
    numbers of PLAIN strings or vocab codes)."""
    if col.phys == "BYTE_ARRAY":
        if col.strings is not None:
            return _plain_records(*col.strings, present)
        return _plain_records(*_vocab_strings(col.vocab), present)
    if col.phys == "FIXED_LEN_BYTE_ARRAY":
        return flba_bytes(present, col.type_length)
    return np.ascontiguousarray(present, NP_TYPES[col.phys]).tobytes()


def _entry_bytes(col: ParquetColumn, entries: np.ndarray) -> np.ndarray:
    """Bytes each dictionary entry takes in the PLAIN dictionary page."""
    if col.phys == "BYTE_ARRAY":
        offs = (col.strings[1] if col.strings is not None
                else _vocab_strings(col.vocab)[1])
        return 4 + (offs[entries + 1] - offs[entries])
    width = (col.type_length if col.phys == "FIXED_LEN_BYTE_ARRAY"
             else NP_TYPES[col.phys].itemsize)
    return np.full(entries.shape[0], width, np.int64)


def _stat_bytes(col: ParquetColumn, present: np.ndarray):
    """(min, max) PLAIN-encoded, or None (nothing present, decimals and
    PLAIN strings)."""
    if (present.shape[0] == 0 or col.strings is not None
            or col.decimal is not None):
        return None
    if col.phys == "BYTE_ARRAY":
        strs = [col.vocab[c] for c in np.unique(present)]
        return min(strs), max(strs)
    dt = NP_TYPES[col.phys]
    return (np.asarray(present.min(), dt).tobytes(),
            np.asarray(present.max(), dt).tobytes())


def _page(ptype: int, body: bytes, header_field) -> bytes:
    header = tstruct([(1, T_I32, ptype), (2, T_I32, len(body)),
                      (3, T_I32, len(body)), header_field])
    return header + body


def _rows_per_page(col: ParquetColumn, bw: int, data_page_bytes: int,
                   page_row_limit: Optional[int]) -> int:
    if col.strings is not None:
        offs = col.strings[1]
        n = max(offs.shape[0] - 1, 1)
        bits = 8 * (4 + -(-int(offs[-1] - offs[0]) // n))
    elif col.encoding == "dict":
        bits = bw
    elif col.phys == "FIXED_LEN_BYTE_ARRAY":
        bits = 8 * col.type_length
    else:
        bits = NP_TYPES[col.phys].itemsize * 8
    bits += 1 if col.validity is not None else 0
    per = data_page_bytes * 8 // max(bits, 1)
    if page_row_limit:
        per = min(per, page_row_limit)
    return max(8, -(-per // 8) * 8)


def _dictionary_pages(col, codes, entries, page_present,
                      dict_page_bytes) -> int:
    """How many leading pages stay dictionary-encoded: all, or those
    before the first page whose values take the dictionary past
    ``dict_page_bytes``."""
    if dict_page_bytes is None or codes.shape[0] == 0:
        return len(page_present)
    size = np.cumsum(_entry_bytes(col, entries))
    seen = np.maximum.accumulate(codes) + 1
    for p, (a, b) in enumerate(page_present):
        if b > a and size[seen[b - 1] - 1] > dict_page_bytes:
            return p
    return len(page_present)


def _write_chunk(out: bytearray, col: ParquetColumn, lo: int, hi: int,
                 opts: dict) -> list:
    start = len(out)
    vals = col.values[lo:hi]
    valid = None if col.validity is None else col.validity[lo:hi]
    present = vals if valid is None else vals[valid]
    rows = hi - lo
    codes = entries = None
    bw = 0
    if col.encoding == "dict":
        entries, codes = _first_occurrence(present)
        bw = max(1, int(len(entries) - 1).bit_length())
    per = _rows_per_page(col, bw, opts["data_page_bytes"],
                         opts["page_row_limit"])
    cuts = [(p0, min(rows, p0 + per)) for p0 in range(0, max(rows, 1), per)]
    counts = [p1 - p0 if valid is None else int(valid[p0:p1].sum())
              for p0, p1 in cuts]
    ends = np.cumsum([0] + counts)
    page_present = list(zip(ends[:-1].tolist(), ends[1:].tolist()))
    n_dict_pages = (_dictionary_pages(col, codes, entries, page_present,
                                      opts["dict_page_bytes"])
                    if col.encoding == "dict" else 0)
    dict_page_offset = None
    usize = 0
    used = {ENC_RLE}
    if n_dict_pages:
        last = page_present[n_dict_pages - 1][1]
        n_entries = int(codes[:last].max()) + 1 if last else 0
        entries = entries[:n_entries]
        bw = max(1, int(n_entries - 1).bit_length())
        dict_page_offset = start
        page = _page(PAGE_DICTIONARY, _encode_plain(col, entries),
                     (7, T_STRUCT, [(1, T_I32, n_entries),
                                    (2, T_I32, ENC_PLAIN)]))
        out += page
        usize += len(page)
        used |= {ENC_PLAIN, ENC_RLE_DICTIONARY}
    data_page_offset = len(out)
    for p, ((p0, p1), (a, b)) in enumerate(zip(cuts, page_present)):
        levels = b""
        if valid is not None:
            lv = bit_packed_runs(valid[p0:p1].astype(np.uint8), 1)
            levels = struct.pack("<I", len(lv)) + lv
        if p < n_dict_pages:
            enc = ENC_RLE_DICTIONARY
            body = bytes([bw]) + bit_packed_runs(codes[a:b], bw)
        else:
            enc = ENC_PLAIN
            body = _encode_plain(col, present[a:b])
        used.add(enc)
        page = _page(PAGE_DATA, levels + body, (
            5, T_STRUCT, [(1, T_I32, p1 - p0), (2, T_I32, enc),
                          (3, T_I32, ENC_RLE), (4, T_I32, ENC_RLE)]))
        out += page
        usize += len(page)
    size = len(out) - start
    stats = _stat_bytes(col, present)
    null_count = 0 if valid is None else int((~valid).sum())
    statistics = [(3, T_I64, null_count),
                  (5, T_BINARY, None if stats is None else stats[1]),
                  (6, T_BINARY, None if stats is None else stats[0])]
    md = [(1, T_I32, PHYS[col.phys]),
          (2, T_LIST, (T_I32, sorted(used))),
          (3, T_LIST, (T_BINARY, [col.name.encode()])),
          (4, T_I32, CODEC_UNCOMPRESSED),
          (5, T_I64, rows), (6, T_I64, usize), (7, T_I64, size),
          (9, T_I64, data_page_offset), (11, T_I64, dict_page_offset),
          (12, T_STRUCT, statistics)]
    return [(2, T_I64, start), (3, T_STRUCT, md)]


def write_parquet(columns: list, row_group_rows: int,
                  data_page_bytes: int = 1 << 20,
                  dict_page_bytes: Optional[int] = None,
                  page_row_limit: Optional[int] = None) -> bytes:
    """The UNCOMPRESSED Parquet file holding ``columns`` (equal lengths),
    cut into row groups of ``row_group_rows`` and data pages of about
    ``data_page_bytes`` (at most ``page_row_limit`` rows).  With
    ``dict_page_bytes`` every dictionary-encoded chunk falls back to PLAIN
    at the first page that takes its dictionary past that size."""
    opts = dict(data_page_bytes=data_page_bytes,
                dict_page_bytes=dict_page_bytes,
                page_row_limit=page_row_limit)
    n = columns[0].values.shape[0]
    out = bytearray(MAGIC)
    groups = []
    for lo in range(0, max(n, 1), max(row_group_rows, 1)):
        hi = min(n, lo + row_group_rows)
        first = len(out)
        chunks = [_write_chunk(out, c, lo, hi, opts) for c in columns]
        size = len(out) - first
        groups.append([(1, T_LIST, (T_STRUCT, chunks)),
                       (2, T_I64, size), (3, T_I64, hi - lo),
                       (5, T_I64, first), (6, T_I64, size)])
    schema = [[(4, T_BINARY, b"schema"), (5, T_I32, len(columns))]]
    for c in columns:
        precision, scale = c.decimal or (None, None)
        schema.append([
            (1, T_I32, PHYS[c.phys]),
            (2, T_I32, c.type_length or None),
            (3, T_I32, 0 if c.validity is None else 1),
            (4, T_BINARY, c.name.encode()),
            (6, T_I32, CONVERTED.get(c.converted)),
            (7, T_I32, scale), (8, T_I32, precision)])
    footer = tstruct([
        (1, T_I32, 1),
        (2, T_LIST, (T_STRUCT, schema)),
        (3, T_I64, n),
        (4, T_LIST, (T_STRUCT, groups)),
        (6, T_BINARY, b"portbench parquet writer"),
        (7, T_LIST, (T_STRUCT, [[(1, T_STRUCT, [])] for _ in columns]))])
    out += footer + struct.pack("<I", len(footer)) + MAGIC
    return bytes(out)
