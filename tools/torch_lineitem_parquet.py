#!/usr/bin/env python3
"""A numpy-only Parquet writer and TPC-H lineitem generator.

    python3 tools/torch_lineitem_parquet.py --rows 6001215 [--spark] --out lineitem.parquet

Test data for the PyTorch port's device scan, shared by ``chip_smoke.py``
and the tests: the card's machine has no pyarrow, and the repository holds
no Parquet file.  The writer emits only what the port's scan reads: PLAIN
and RLE_DICTIONARY pages (the codes as bit-packed runs of at most 63
groups, as parquet-mr writes them), PLAIN strings, DECIMALs as
FIXED_LEN_BYTE_ARRAY or BYTE_ARRAY (big-endian two's complement, the
latter at each value's fewest bytes, as parquet-mr's legacy writers do),
INT96 timestamps, DELTA_BINARY_PACKED and DELTA_BYTE_ARRAY pages,
definition levels for OPTIONAL columns, data pages v1 or DataPageV2,
UNCOMPRESSED, SNAPPY (a small greedy compressor in C,
``tools/torch_snappy_compress.cpp``, built with the host compiler into
``build/torch_tools/`` at first use) or GZIP (``zlib``), and a thrift
compact footer with min/max statistics (none for decimals and INT96; null
counts only for PLAIN strings).  Each row group writes its dictionary in
first-occurrence order, as parquet-mr and pyarrow do; with a dictionary
page size, a dictionary-encoded chunk keeps its leading dictionary pages
and falls back to PLAIN (DELTA for the v2 writer) from the first page
that would take its dictionary past that size, as parquet-mr does
(``SPARK_DEFAULTS``, ``--spark``).  The tests read its output back with
pyarrow, which checks the writer apart from both scanners.

The generator follows TPC-H v3.0.1 §4.2.3 for lineitem's 16 columns: keys
INT64 (orderkey sparse as dbgen makes it, partkey uniform in
[1, 200000·SF], suppkey by the spec's formula), linenumber INT32, the
measures DOUBLE, the dates DATE, returnflag / linestatus / shipinstruct /
shipmode as dictionary strings, and ``l_comment``, text of 10-43 chars,
as PLAIN strings with the dictionary off, as Spark writes a
high-cardinality text column when a user turns the dictionary off for it.
Like dbgen, a comment is a substring of a text pool made of the grammar's
words (§4.2.2.10) at a random offset and of a random length.  Its numbers
come from numpy's generator, not dbgen's, so the rows differ from dbgen's
while their distributions match.  ``LINEITEM_NO_COMMENT`` names the first
15 columns, for files without ``l_comment``.

``LINEITEM_Q1`` is TPC-H Q1's layout of ``benchmarks/tpch_data.py``: the
flags as dictionary strings, ``l_quantity`` INT64, ``l_extendedprice``
FLBA DECIMAL(12,2) PLAIN (``quantity × retail cents``, exact),
``l_discount`` and ``l_tax`` FLBA DECIMAL(4,2) dictionary-encoded, and
``l_shipdate`` DATE (``--q1`` writes it).
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import struct
import subprocess
import sys
import zlib
from typing import Optional

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from spark_rapids_jni_tpu_torch.parquet.thrift import (  # noqa: E402
    CompactWriter, Field, ListValue, Struct, TType)

MAGIC = b"PAR1"
PHYS = {"INT32": 1, "INT64": 2, "INT96": 3, "DOUBLE": 5, "BYTE_ARRAY": 6,
        "FIXED_LEN_BYTE_ARRAY": 7}
_NP = {"INT32": np.dtype("<i4"), "INT64": np.dtype("<i8"),
       "DOUBLE": np.dtype("<f8")}
CONVERTED = {"UTF8": 0, "DECIMAL": 5, "DATE": 6}
ENC_PLAIN, ENC_RLE, ENC_DELTA_BINARY_PACKED, ENC_DELTA_BYTE_ARRAY, \
    ENC_RLE_DICTIONARY = 0, 3, 5, 7, 8
PAGE_DATA, PAGE_DICTIONARY, PAGE_DATA_V2 = 0, 2, 3
CODECS = {"UNCOMPRESSED": 0, "SNAPPY": 1, "GZIP": 2}
MAX_BP_GROUPS = 63           # parquet-mr's longest bit-packed run
# DELTA_BINARY_PACKED blocks as parquet-mr writes them: 128 values in 4
# miniblocks of 32
DELTA_BLOCK, DELTA_MINIBLOCKS = 128, 4
DELTA_PER_MINI = DELTA_BLOCK // DELTA_MINIBLOCKS
JULIAN_UNIX_EPOCH = 2440588          # Julian day of 1970-01-01
NS_PER_DAY = 86_400_000_000_000
# what Spark 3 (parquet-mr 1.12 and later) writes by default: SNAPPY,
# every column dictionary-encoded with a fallback once its dictionary
# passes 1 MiB (parquet.dictionary.page.size), pages of 1 MiB
# (parquet.page.size) and of at most 20,000 rows
# (parquet.page.row.count.limit); parquet.writer.version=v2 adds
# DataPageV2 and the DELTA fallbacks
SPARK_DEFAULTS = dict(codec="SNAPPY", dict_page_bytes=1 << 20,
                      data_page_bytes=1 << 20, page_row_limit=20_000)


@dataclasses.dataclass
class ParquetColumn:
    """One column to write.  Numbers: ``values`` is a numpy array
    (FIXED_LEN_BYTE_ARRAY decimals: int64 unscaled values).  Strings and
    BYTE_ARRAY decimals: ``values`` is int codes into ``vocab`` (a list of
    bytes).  ``validity`` (bool, True = present) makes the column
    OPTIONAL; null slots of ``values`` are ignored."""

    name: str
    phys: str                                  # INT32 | INT64 | INT96 |
    #                                            DOUBLE | BYTE_ARRAY |
    #                                            FIXED_LEN_BYTE_ARRAY
    values: np.ndarray                         # INT96: int64 nanoseconds,
    #                                            or raw records [n, 12]
    encoding: str = "plain"                    # plain | dict | delta
    converted: Optional[str] = None            # UTF8 | DATE | DECIMAL
    vocab: Optional[list] = None
    validity: Optional[np.ndarray] = None
    # PLAIN strings: (chars uint8, int64 offsets [n+1]); ``values`` then
    # holds the row numbers, or, dictionary-encoded, each row's string's
    # index
    strings: Optional[tuple] = None
    # DECIMAL: (precision, scale); FIXED_LEN_BYTE_ARRAY: its width
    decimal: Optional[tuple] = None
    type_length: int = 0


def strings_column(name: str, strings, validity=None) -> ParquetColumn:
    """A dictionary-encoded string column from host strings."""
    vocab, codes = np.unique(np.asarray([s.encode() for s in strings],
                                        dtype=object), return_inverse=True)
    return ParquetColumn(name, "BYTE_ARRAY", codes.astype(np.int64), "dict",
                         "UTF8", list(vocab), validity)


def plain_strings_column(name: str, chars: np.ndarray, offsets: np.ndarray,
                         validity=None) -> ParquetColumn:
    """A PLAIN string column from chars and int64 offsets [n+1]."""
    n = offsets.shape[0] - 1
    return ParquetColumn(name, "BYTE_ARRAY", np.arange(n, dtype=np.int64),
                         "plain", "UTF8", None, validity, (chars, offsets))


def flba_width(precision: int) -> int:
    """The fewest bytes whose two's complement holds every value of
    ``precision`` digits (parquet's FLBA DECIMAL width)."""
    w = 1
    while 10 ** precision - 1 >= 1 << (8 * w - 1):
        w += 1
    return w


def decimal_column(name: str, values, precision: int, scale: int,
                   encoding: str = "plain", validity=None,
                   byte_array: bool = False) -> ParquetColumn:
    """A DECIMAL(precision, scale) column of unscaled ints: FIXED_LEN_BYTE_ARRAY
    of ``flba_width(precision)`` bytes (``values`` int64), or with
    ``byte_array`` BYTE_ARRAY of each value's fewest bytes (``values`` any
    Python ints)."""
    if not byte_array:
        return ParquetColumn(name, "FIXED_LEN_BYTE_ARRAY",
                             np.asarray(values, np.int64), encoding,
                             "DECIMAL", validity=validity,
                             decimal=(precision, scale),
                             type_length=flba_width(precision))
    ints = [int(v) for v in values]
    if encoding == "dict":
        vocab = sorted(set(ints))
        index = {v: i for i, v in enumerate(vocab)}
        return ParquetColumn(name, "BYTE_ARRAY",
                             np.array([index[v] for v in ints], np.int64),
                             "dict", "DECIMAL",
                             [be_bytes(v) for v in vocab], validity,
                             decimal=(precision, scale))
    payloads = [be_bytes(v) for v in ints]
    offs = np.zeros(len(ints) + 1, np.int64)
    np.cumsum([len(p) for p in payloads], out=offs[1:])
    chars = np.frombuffer(b"".join(payloads), np.uint8)
    return ParquetColumn(name, "BYTE_ARRAY",
                         np.arange(len(ints), dtype=np.int64), "plain",
                         "DECIMAL", None, validity, (chars, offs),
                         decimal=(precision, scale))


def be_bytes(v: int) -> bytes:
    """``v`` as big-endian two's complement in its fewest bytes (Java's
    ``BigInteger.toByteArray``)."""
    return v.to_bytes(((v if v >= 0 else ~v).bit_length() + 8) // 8, "big",
                      signed=True)


def flba_bytes(values: np.ndarray, width: int) -> bytes:
    """int64 values as big-endian two's complement of ``width`` bytes."""
    be = np.ascontiguousarray(values, ">i8").view(np.uint8).reshape(-1, 8)
    if width <= 8:
        return be[:, 8 - width:].tobytes()
    fill = np.where(be[:, :1] >= 0x80, 0xFF, 0).astype(np.uint8)
    return np.concatenate([np.repeat(fill, width - 8, axis=1), be],
                          axis=1).tobytes()


# ---------------------------------------------------------------------------
# thrift helpers
# ---------------------------------------------------------------------------

def _struct(*fields) -> Struct:
    return Struct([Field(fid, tt, v) for fid, tt, v in fields
                   if v is not None])


def _i32(fid, v):
    return (fid, TType.I32, None if v is None else int(v))


def _i64(fid, v):
    return (fid, TType.I64, None if v is None else int(v))


def _thrift(s: Struct) -> bytes:
    w = CompactWriter()
    w.write_struct(s)
    return w.getvalue()


# ---------------------------------------------------------------------------
# encodings
# ---------------------------------------------------------------------------

def _uleb(n: int) -> bytes:
    out = bytearray()
    while True:
        if n < 0x80:
            out.append(n)
            return bytes(out)
        out.append((n & 0x7F) | 0x80)
        n >>= 7


def bit_packed_runs(values: np.ndarray, bw: int) -> bytes:
    """The RLE/bit-packed hybrid stream of ``values`` as bit-packed runs of
    at most ``MAX_BP_GROUPS`` groups of 8, LSB first."""
    n = values.shape[0]
    if n == 0:
        return b""
    groups = -(-n // 8)
    v = np.zeros(groups * 8, np.uint64)
    v[:n] = values
    bits = ((v[:, None] >> np.arange(bw, dtype=np.uint64)) & 1).astype(np.uint8)
    packed = np.packbits(bits.reshape(-1), bitorder="little").tobytes()
    out = bytearray()
    for g0 in range(0, groups, MAX_BP_GROUPS):
        g = min(MAX_BP_GROUPS, groups - g0)
        out += _uleb((g << 1) | 1)
        out += packed[g0 * bw:(g0 + g) * bw]
    return bytes(out)


def _plain_strings(vocab: list, entries: np.ndarray) -> bytes:
    return b"".join(struct.pack("<I", len(vocab[e])) + vocab[e]
                    for e in entries)


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
    before = rec[:-1] - 4 * np.arange(k)            # chars of earlier rows
    within = np.arange(int(lens.sum()), dtype=np.int64)
    buf[np.repeat(rec[:-1] + 4 - before, lens) + within] = chars[
        np.repeat(offsets[rows] - before, lens) + within]
    return buf.tobytes()


def _first_occurrence(values: np.ndarray):
    """(distinct values in first-occurrence order, code of every value).
    Integers of a span up to 4x their count take a table, not a sort."""
    n = values.shape[0]
    if values.ndim == 1 and values.dtype.kind in "iu" and n:
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
                                     return_inverse=True,
                                     axis=0 if values.ndim > 1 else None)
    order = np.argsort(first, kind="stable")
    rank = np.empty_like(order)
    rank[order] = np.arange(order.shape[0])
    return uniq[order], rank[inverse.reshape(-1)]


# ---------------------------------------------------------------------------
# codecs
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=1)
def _snappy_library() -> ctypes.CDLL:
    """``torch_snappy_compress.cpp`` built with the host compiler into
    ``build/torch_tools/`` (named by a hash of its source) and loaded."""
    from spark_rapids_jni_tpu_torch import _native
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "torch_snappy_compress.cpp")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(_native.HOST_FLAGS)
                                .encode()).hexdigest()[:16]
    build = os.path.join(ROOT, "build", "torch_tools")
    lib = os.path.join(build, f"libtorch_snappy_compress_{digest}.so")
    if not os.path.exists(lib):
        os.makedirs(build, exist_ok=True)
        tmp = f"{lib}.{os.getpid()}.tmp"
        cxx = shutil.which("c++") or "/usr/bin/g++"
        subprocess.run([cxx, *_native.HOST_FLAGS, "-o", tmp, src], check=True,
                       capture_output=True, timeout=_native.BUILD_TIMEOUT_S)
        os.replace(tmp, lib)
    dll = ctypes.CDLL(lib)
    dll.srjt_snappy_compress.argtypes = (ctypes.c_void_p, ctypes.c_int64,
                                         ctypes.c_void_p, ctypes.c_void_p)
    dll.srjt_snappy_compress.restype = ctypes.c_int64
    dll.srjt_snappy_max_compressed.argtypes = (ctypes.c_int64,)
    dll.srjt_snappy_max_compressed.restype = ctypes.c_int64
    return dll


def snappy_compress(data: bytes) -> bytes:
    """``data`` as one raw Snappy block (the greedy compressor of
    ``tools/torch_snappy_compress.cpp``)."""
    lib = _snappy_library()
    src = np.frombuffer(data, np.uint8)
    dst = np.empty(lib.srjt_snappy_max_compressed(src.size), np.uint8)
    table = np.empty(1 << 16, np.int64)
    n = lib.srjt_snappy_compress(src.ctypes.data if src.size else None,
                                 src.size, dst.ctypes.data, table.ctypes.data)
    return dst[:n].tobytes()


def compress(body: bytes, codec: str) -> bytes:
    """A page body in ``codec`` (UNCOMPRESSED, SNAPPY or GZIP)."""
    if codec == "UNCOMPRESSED":
        return body
    if codec == "GZIP":
        z = zlib.compressobj(6, zlib.DEFLATED, 31)       # gzip framing
        return z.compress(body) + z.flush()
    if codec == "SNAPPY":
        return snappy_compress(body)
    raise ValueError(f"codec {codec}")


# ---------------------------------------------------------------------------
# PLAIN and DELTA values
# ---------------------------------------------------------------------------

def int96_bytes(ns: np.ndarray) -> bytes:
    """int64 nanoseconds since the epoch as INT96 timestamps: 8
    little-endian bytes of nanoseconds in the day, then the 4-byte Julian
    day (Impala's layout, Spark's default timestamp type)."""
    ns = np.asarray(ns, np.int64)
    days = np.floor_divide(ns, NS_PER_DAY)
    rec = np.empty((ns.shape[0], 12), np.uint8)
    rec[:, :8] = (ns - days * NS_PER_DAY).astype("<i8").view(
        np.uint8).reshape(-1, 8)
    rec[:, 8:] = (days + JULIAN_UNIX_EPOCH).astype("<i4").view(
        np.uint8).reshape(-1, 4)
    return rec.tobytes()


def _zigzag(v: int) -> int:
    return (v << 1) ^ (v >> 63)


def _bit_lengths(x: np.ndarray) -> np.ndarray:
    """The bit length of each uint64."""
    out = np.zeros(x.shape[0], np.int64)
    x = x.copy()
    while x.any():
        out += x != 0
        x >>= np.uint64(1)
    return out


def delta_binary_packed(values: np.ndarray) -> bytes:
    """DELTA_BINARY_PACKED of int64 values, as parquet-mr writes it: blocks
    of 128 deltas in 4 miniblocks of 32, each block's deltas less its
    smallest, bit-packed LSB first at its miniblock's width; a miniblock
    past the last value gets width 0 and no bytes.  Deltas wrap as
    int64."""
    v = np.asarray(values, np.int64)
    n = v.shape[0]
    out = bytearray(_uleb(DELTA_BLOCK) + _uleb(DELTA_MINIBLOCKS) + _uleb(n)
                    + _uleb(_zigzag(int(v[0]) if n else 0)))
    if n <= 1:
        return bytes(out)
    d = (v[1:].view(np.uint64) - v[:-1].view(np.uint64)).view(np.int64)
    nb = -(-d.shape[0] // DELTA_BLOCK)
    mins = np.array([d[b * DELTA_BLOCK:(b + 1) * DELTA_BLOCK].min()
                     for b in range(nb)], np.int64)
    blocks = np.repeat(mins, DELTA_BLOCK).reshape(nb, DELTA_BLOCK)
    blocks.reshape(-1)[:d.shape[0]] = d
    rel = blocks.view(np.uint64) - mins.view(np.uint64)[:, None]
    minis = rel.reshape(-1, DELTA_PER_MINI)
    widths = _bit_lengths(minis.max(axis=1))
    needed = np.arange(minis.shape[0]) * DELTA_PER_MINI < d.shape[0]
    widths[~needed] = 0
    packed = [b""] * minis.shape[0]
    for w in np.unique(widths[widths > 0]).tolist():
        sel = np.flatnonzero(widths == w)
        bits = ((minis[sel, :, None] >> np.arange(w, dtype=np.uint64))
                & np.uint64(1)).astype(np.uint8)
        rows = np.packbits(bits.reshape(sel.shape[0], -1), axis=1,
                           bitorder="little")
        for i, row in zip(sel.tolist(), rows):
            packed[i] = row.tobytes()
    for b in range(nb):
        out += _uleb(_zigzag(int(mins[b])))
        out += bytes(widths[b * DELTA_MINIBLOCKS:(b + 1) * DELTA_MINIBLOCKS]
                     .astype(np.uint8))
        out += b"".join(packed[b * DELTA_MINIBLOCKS:(b + 1) * DELTA_MINIBLOCKS])
    return bytes(out)


def delta_byte_array(chars: np.ndarray, offsets: np.ndarray) -> bytes:
    """DELTA_BYTE_ARRAY of the values at int64 ``offsets`` [k+1] of
    ``chars``: each value's prefix shared with the value before it and
    the lengths of the rest, both DELTA_BINARY_PACKED, then those rests
    back to back."""
    k = offsets.shape[0] - 1
    lens = offsets[1:] - offsets[:-1]
    prefix = np.zeros(k, np.int64)
    if k > 1:
        most = np.minimum(lens[1:], lens[:-1])
        alive = np.flatnonzero(most > 0)
        j = 0
        while alive.shape[0]:
            same = (chars[offsets[1:-1][alive] + j]
                    == chars[offsets[:-2][alive] + j])
            alive = alive[same]
            prefix[alive + 1] += 1
            j += 1
            alive = alive[most[alive] > j]
    rest = lens - prefix
    dst = np.zeros(k + 1, np.int64)
    np.cumsum(rest, out=dst[1:])
    src = (np.repeat(offsets[:-1] + prefix - dst[:-1], rest)
           + np.arange(int(dst[-1]), dtype=np.int64))
    return (delta_binary_packed(prefix) + delta_binary_packed(rest)
            + chars[src].tobytes())


def _string_values(col: ParquetColumn, present: np.ndarray) -> tuple:
    """(chars, int64 offsets [k+1]) of the present values of a BYTE_ARRAY
    or FIXED_LEN_BYTE_ARRAY column."""
    if col.phys == "FIXED_LEN_BYTE_ARRAY":
        w = col.type_length
        return (np.frombuffer(flba_bytes(present, w), np.uint8),
                np.arange(present.shape[0] + 1, dtype=np.int64) * w)
    if col.strings is not None:
        chars, offs = col.strings
        lo, hi = offs[present], offs[present + 1]
    else:
        vlen = np.array([len(v) for v in col.vocab], np.int64)
        vstart = np.concatenate([[0], np.cumsum(vlen)[:-1]]).astype(np.int64)
        chars = np.frombuffer(b"".join(col.vocab), np.uint8)
        lo = vstart[present]
        hi = lo + vlen[present]
    out = np.zeros(present.shape[0] + 1, np.int64)
    np.cumsum(hi - lo, out=out[1:])
    src = (np.repeat(lo - out[:-1], hi - lo)
           + np.arange(int(out[-1]), dtype=np.int64))
    return chars[src], out


def _encode(col: ParquetColumn, present: np.ndarray, enc: int) -> bytes:
    """Present values (numbers, unscaled decimals, row numbers or vocab
    codes) in encoding ``enc``."""
    if enc == ENC_DELTA_BINARY_PACKED:
        return delta_binary_packed(present)
    if enc == ENC_DELTA_BYTE_ARRAY:
        return delta_byte_array(*_string_values(col, present))
    if col.phys == "BYTE_ARRAY":
        if col.strings is not None:
            return _plain_records(*col.strings, present)
        return _plain_strings(col.vocab, present)
    if col.phys == "FIXED_LEN_BYTE_ARRAY":
        return flba_bytes(present, col.type_length)
    if col.phys == "INT96":
        return (int96_bytes(present) if present.ndim == 1
                else np.ascontiguousarray(present, np.uint8).tobytes())
    return np.ascontiguousarray(present, _NP[col.phys]).tobytes()


def _entry_bytes(col: ParquetColumn, entries: np.ndarray) -> np.ndarray:
    """Bytes each dictionary entry takes in the PLAIN dictionary page."""
    if col.phys == "BYTE_ARRAY" and col.strings is not None:
        offs = col.strings[1]
        return 4 + (offs[entries + 1] - offs[entries])
    if col.phys == "BYTE_ARRAY":
        _, offs = _string_values(col, entries)
        return 4 + (offs[1:] - offs[:-1])
    width = {"INT96": 12, "FIXED_LEN_BYTE_ARRAY": col.type_length}.get(
        col.phys) or _NP[col.phys].itemsize
    return np.full(entries.shape[0], width, np.int64)


def _stat_bytes(col: ParquetColumn, present: np.ndarray):
    """(min, max) PLAIN-encoded, or None when nothing is present (and for
    decimals, INT96 and PLAIN-string columns)."""
    if (present.shape[0] == 0 or col.strings is not None
            or col.decimal is not None or col.phys == "INT96"):
        return None
    if col.phys == "BYTE_ARRAY":
        strs = [col.vocab[c] for c in np.unique(present)]
        return min(strs), max(strs)
    dt = _NP[col.phys]
    return (np.asarray(present.min(), dt).tobytes(),
            np.asarray(present.max(), dt).tobytes())


def _page(ptype: int, body: bytes, header_field, codec: str = "UNCOMPRESSED",
          plain_prefix: bytes = b"") -> tuple[bytes, int]:
    """(header and stored page, bytes of header and uncompressed page):
    ``plain_prefix`` (a DataPageV2's levels) stays uncompressed."""
    stored = plain_prefix + compress(body, codec)
    usize = len(plain_prefix) + len(body)
    header = _thrift(_struct(_i32(1, ptype), _i32(2, usize),
                             _i32(3, len(stored)), header_field))
    return header + stored, len(header) + usize


@dataclasses.dataclass
class WriteOptions:
    """How :func:`write_parquet` cuts and encodes the pages."""

    data_page_bytes: int = 1 << 20
    pages_per_chunk: Optional[int] = None
    codec: str = "UNCOMPRESSED"
    # with a size, a dictionary-encoded chunk falls back, as parquet-mr's
    # does, at the first page whose values take its dictionary past it
    dict_page_bytes: Optional[int] = None
    page_version: int = 1                  # 2: DataPageV2, DELTA fallback
    page_row_limit: Optional[int] = None


def _rows_per_page(col: ParquetColumn, bw: int, rows: int,
                   opts: WriteOptions) -> int:
    if opts.pages_per_chunk:
        per = -(-rows // opts.pages_per_chunk)
    else:
        if col.strings is not None:
            offs = col.strings[1]
            n = max(offs.shape[0] - 1, 1)
            bits = 8 * (4 + -(-int(offs[-1] - offs[0]) // n))
        elif col.encoding == "dict":
            bits = bw
        elif col.phys in ("FIXED_LEN_BYTE_ARRAY", "INT96"):
            bits = 8 * (col.type_length or 12)
        else:
            bits = _NP[col.phys].itemsize * 8
        bits += 1 if col.validity is not None else 0
        per = opts.data_page_bytes * 8 // max(bits, 1)
    if opts.page_row_limit:
        per = min(per, opts.page_row_limit)
    return max(8, -(-per // 8) * 8)


def _fallback_encoding(col: ParquetColumn, opts: WriteOptions) -> int:
    """The encoding of the pages after a dictionary's fallback (and of a
    ``delta`` column): PLAIN for the v1 writer; for the v2 writer, and for
    ``delta``, DELTA_BINARY_PACKED for INT32 and INT64, DELTA_BYTE_ARRAY
    for byte arrays, PLAIN for the rest, as parquet-mr chooses."""
    if opts.page_version == 1 and col.encoding != "delta":
        return ENC_PLAIN
    if col.phys in ("INT32", "INT64"):
        return ENC_DELTA_BINARY_PACKED
    if col.phys in ("BYTE_ARRAY", "FIXED_LEN_BYTE_ARRAY"):
        return ENC_DELTA_BYTE_ARRAY
    if col.encoding == "delta":
        raise ValueError(f"column {col.name}: no DELTA encoding for "
                         f"{col.phys}")
    return ENC_PLAIN


def _dictionary_pages(col: ParquetColumn, codes: np.ndarray,
                      entries: np.ndarray, page_present: list,
                      opts: WriteOptions) -> int:
    """How many leading pages stay dictionary-encoded: all of them, or,
    with ``opts.dict_page_bytes``, those before the first page whose
    values take the dictionary (its entries in first-occurrence order)
    past that size.  (parquet-mr also falls back when the first page's
    codes and dictionary outweigh its PLAIN bytes; that test is left
    out, so a column of distinct values keeps one leading dictionary
    page.)"""
    if opts.dict_page_bytes is None or codes.shape[0] == 0:
        return len(page_present)
    size = np.cumsum(_entry_bytes(col, entries))
    seen = np.maximum.accumulate(codes) + 1      # entries after each value
    for p, (a, b) in enumerate(page_present):
        if b > a and size[seen[b - 1] - 1] > opts.dict_page_bytes:
            return p
    return len(page_present)


def _write_chunk(out: bytearray, col: ParquetColumn, lo: int, hi: int,
                 opts: WriteOptions) -> Struct:
    """Append one column chunk at the end of ``out``; returns its
    ColumnChunk struct."""
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
    per = _rows_per_page(col, bw, rows, opts)
    cuts = [(p0, min(rows, p0 + per)) for p0 in range(0, max(rows, 1), per)]
    counts = [p1 - p0 if valid is None else int(valid[p0:p1].sum())
              for p0, p1 in cuts]
    ends = np.cumsum([0] + counts)
    page_present = list(zip(ends[:-1].tolist(), ends[1:].tolist()))
    n_dict_pages = (_dictionary_pages(col, codes, entries, page_present, opts)
                    if col.encoding == "dict" else 0)
    fallback = _fallback_encoding(col, opts)
    dict_page_offset = None
    usize = 0
    used = {ENC_RLE}
    if n_dict_pages:
        last = page_present[n_dict_pages - 1][1]
        n_entries = int(codes[:last].max()) + 1 if last else 0
        entries = entries[:n_entries]
        bw = max(1, int(n_entries - 1).bit_length())
        dict_page_offset = start
        page, size = _page(
            PAGE_DICTIONARY, _encode(col, entries, ENC_PLAIN),
            (7, TType.STRUCT, _struct(_i32(1, n_entries), _i32(2, ENC_PLAIN))),
            opts.codec)
        out += page
        usize += size
        used |= {ENC_PLAIN, ENC_RLE_DICTIONARY}
    data_page_offset = len(out)
    for p, ((p0, p1), (a, b)) in enumerate(zip(cuts, page_present)):
        levels = b""
        if valid is not None:
            levels = bit_packed_runs(valid[p0:p1].astype(np.uint8), 1)
        if p < n_dict_pages:
            enc = ENC_RLE_DICTIONARY
            body = bytes([bw]) + bit_packed_runs(codes[a:b], bw)
        else:
            enc = fallback
            body = _encode(col, present[a:b], enc)
        used.add(enc)
        if opts.page_version == 2:
            page, size = _page(PAGE_DATA_V2, body, (8, TType.STRUCT, _struct(
                _i32(1, p1 - p0), _i32(2, (p1 - p0) - (b - a)),
                _i32(3, p1 - p0), _i32(4, enc), _i32(5, len(levels)),
                _i32(6, 0),
                (7, TType.BOOL_TRUE, opts.codec != "UNCOMPRESSED"))),
                opts.codec, levels)
        else:
            if valid is not None:
                levels = struct.pack("<I", len(levels)) + levels
            page, size = _page(PAGE_DATA, levels + body, (
                5, TType.STRUCT, _struct(_i32(1, p1 - p0), _i32(2, enc),
                                         _i32(3, ENC_RLE), _i32(4, ENC_RLE))),
                opts.codec)
        out += page
        usize += size
    size = len(out) - start
    stats = _stat_bytes(col, present)
    null_count = 0 if valid is None else int((~valid).sum())
    statistics = _struct(
        _i64(3, null_count),
        (5, TType.BINARY, None if stats is None else stats[1]),
        (6, TType.BINARY, None if stats is None else stats[0]))
    md = _struct(
        _i32(1, PHYS[col.phys]),
        (2, TType.LIST, ListValue(TType.I32, sorted(used))),
        (3, TType.LIST, ListValue(TType.BINARY, [col.name.encode()])),
        _i32(4, CODECS[opts.codec]),
        _i64(5, rows), _i64(6, usize), _i64(7, size),
        _i64(9, data_page_offset), _i64(11, dict_page_offset),
        (12, TType.STRUCT, statistics))
    return _struct(_i64(2, start), (3, TType.STRUCT, md))


def write_parquet(columns: list[ParquetColumn], row_group_rows: int,
                  data_page_bytes: int = 1 << 20,
                  pages_per_chunk: Optional[int] = None,
                  **options) -> bytes:
    """The Parquet file holding ``columns`` (equal lengths), cut into row
    groups of ``row_group_rows`` and data pages of about
    ``data_page_bytes`` (or ``pages_per_chunk`` pages a chunk).  A table
    of zero rows gets one row group of zero rows.  ``options`` are the
    other fields of :class:`WriteOptions`: the codec, the dictionary
    fallback's size, the page version and the rows a page may hold."""
    opts = WriteOptions(data_page_bytes, pages_per_chunk, **options)
    n = columns[0].values.shape[0]
    out = bytearray(MAGIC)
    groups = []
    for lo in range(0, max(n, 1), max(row_group_rows, 1)):
        hi = min(n, lo + row_group_rows)
        first = len(out)
        chunks = [_write_chunk(out, c, lo, hi, opts) for c in columns]
        size = len(out) - first
        groups.append(_struct(
            (1, TType.LIST, ListValue(TType.STRUCT, chunks)),
            _i64(2, size), _i64(3, hi - lo), _i64(5, first), _i64(6, size)))
    schema = [_struct((4, TType.BINARY, b"schema"), _i32(5, len(columns)))]
    for c in columns:
        precision, scale = c.decimal or (None, None)
        schema.append(_struct(
            _i32(1, PHYS[c.phys]),
            _i32(2, c.type_length or None),
            _i32(3, 0 if c.validity is None else 1),
            (4, TType.BINARY, c.name.encode()),
            _i32(6, CONVERTED.get(c.converted)),
            _i32(7, scale), _i32(8, precision)))
    meta = _struct(
        _i32(1, 1),
        (2, TType.LIST, ListValue(TType.STRUCT, schema)),
        _i64(3, n),
        (4, TType.LIST, ListValue(TType.STRUCT, groups)),
        (6, TType.BINARY, b"spark_rapids_jni_tpu_torch lineitem writer"),
        # TYPE_ORDER for every column: readers then trust min/max_value
        (7, TType.LIST, ListValue(TType.STRUCT, [
            _struct((1, TType.STRUCT, Struct([]))) for _ in columns])))
    footer = _thrift(meta)
    out += footer + struct.pack("<I", len(footer)) + MAGIC
    return bytes(out)


# ---------------------------------------------------------------------------
# TPC-H lineitem
# ---------------------------------------------------------------------------

SF1_ROWS = 6_001_215
EPOCH = np.datetime64("1970-01-01", "D")
START_DATE = int((np.datetime64("1992-01-01", "D") - EPOCH).astype(int))
END_DATE = int((np.datetime64("1998-12-31", "D") - EPOCH).astype(int))
CURRENT_DATE = int((np.datetime64("1995-06-17", "D") - EPOCH).astype(int))
VOCAB = {
    "l_returnflag": [b"A", b"N", b"R"],
    "l_linestatus": [b"F", b"O"],
    "l_shipinstruct": [b"DELIVER IN PERSON", b"COLLECT COD", b"NONE",
                       b"TAKE BACK RETURN"],
    "l_shipmode": [b"REG AIR", b"AIR", b"RAIL", b"SHIP", b"TRUCK", b"MAIL",
                   b"FOB"],
}
# (name, physical type, converted type, encoding), in lineitem's order
LINEITEM = (
    ("l_orderkey", "INT64", None, "plain"),
    ("l_partkey", "INT64", None, "plain"),
    ("l_suppkey", "INT64", None, "plain"),
    ("l_linenumber", "INT32", None, "dict"),
    ("l_quantity", "DOUBLE", None, "dict"),
    ("l_extendedprice", "DOUBLE", None, "plain"),
    ("l_discount", "DOUBLE", None, "dict"),
    ("l_tax", "DOUBLE", None, "dict"),
    ("l_returnflag", "BYTE_ARRAY", "UTF8", "dict"),
    ("l_linestatus", "BYTE_ARRAY", "UTF8", "dict"),
    ("l_shipdate", "INT32", "DATE", "dict"),
    ("l_commitdate", "INT32", "DATE", "dict"),
    ("l_receiptdate", "INT32", "DATE", "dict"),
    ("l_shipinstruct", "BYTE_ARRAY", "UTF8", "dict"),
    ("l_shipmode", "BYTE_ARRAY", "UTF8", "dict"),
    ("l_comment", "BYTE_ARRAY", "UTF8", "plain"),
)
LINEITEM_NO_COMMENT = LINEITEM[:15]
# TPC-H Q1's columns as benchmarks/tpch_data.py:29-43 types them, in its
# order; decimals by (precision, scale), written from the generator's
# unscaled arrays (``<name>_unscaled``)
LINEITEM_Q1 = (
    ("l_returnflag", "BYTE_ARRAY", "UTF8", "dict"),
    ("l_linestatus", "BYTE_ARRAY", "UTF8", "dict"),
    ("l_quantity", "INT64", None, "plain"),
    ("l_extendedprice", "FIXED_LEN_BYTE_ARRAY", "DECIMAL", "plain"),
    ("l_discount", "FIXED_LEN_BYTE_ARRAY", "DECIMAL", "dict"),
    ("l_tax", "FIXED_LEN_BYTE_ARRAY", "DECIMAL", "dict"),
    ("l_shipdate", "INT32", "DATE", "dict"),
)
Q1_DECIMALS = {"l_extendedprice": (12, 2), "l_discount": (4, 2),
               "l_tax": (4, 2)}
# TPC-H v3.0.1 §4.2.3: L_COMMENT is text of 10 to 43 chars
COMMENT_LEN = (10, 43)
# words of the text grammar (TPC-H v3.0.1 §4.2.2.10): nouns, verbs,
# adjectives, adverbs and prepositions
COMMENT_WORDS = tuple("""
foxes ideas theodolites pinto beans instructions dependencies excuses
platelets asymptotes courts dolphins multipliers sauternes warthogs frets
dinos attainments somas Tiresias patterns forges braids hockey players
frays warhorses dugouts notornis epitaphs pearls tithes waters orbits gifts
sheaves depths sentiments decoys realms pains grouches escapades
sleep wake are cajole haggle nag use boost affix detect integrate maintain
nod was lose sublate solve thrash promise engage hinder print x-ray breach
eat grow impress mold poach serve run dazzle snooze doze unwind kindle play
hang believe doubt
furious sly careful blithe quick fluffy slow quiet ruthless thin close
dogged daring brave stealthy permanent enticing idle busy regular final
ironic even bold silent
sometimes always never furiously slyly carefully blithely quickly fluffily
slowly quietly ruthlessly thinly closely doggedly daringly bravely
stealthily permanently enticingly idly busily regularly finally ironically
evenly boldly silently
about above across after against along among around at atop before behind
beneath beside besides between beyond by despite during except for from
inside into near of on outside over past since through throughout to toward
under until up upon without with within
""".split())
# the text pool comments are cut from (dbgen keeps one of 300 MB)
TEXT_POOL_BYTES = 1 << 22
# rows of comments made at a time, to bound the index arrays
COMMENT_BLOCK_ROWS = 1 << 20


def generate_lineitem(n_rows: int, seed: int) -> dict[str, np.ndarray]:
    """Lineitem columns as numpy arrays (strings as int8 codes into
    ``VOCAB``), ``n_rows`` rows; the scale factor follows from the rows
    (``n_rows / SF1_ROWS``).  The money columns come in cents too,
    int64, as ``<name>_unscaled`` (the values of their DECIMAL(…, 2))."""
    rng = np.random.default_rng(seed)
    sf = n_rows / SF1_ROWS
    n_orders = max(1, -(-n_rows // 4))
    # 1-7 lines an order, nudged so that the lines add up to n_rows
    lines = rng.integers(1, 8, n_orders)
    diff = n_rows - int(lines.sum())
    while diff:
        can = np.flatnonzero(lines < 7) if diff > 0 else np.flatnonzero(lines > 1)
        pick = rng.choice(can, min(abs(diff), can.shape[0]), replace=False)
        lines[pick] += 1 if diff > 0 else -1
        diff = n_rows - int(lines.sum())
    order = np.repeat(np.arange(n_orders, dtype=np.int64), lines)
    first = np.cumsum(lines) - lines
    linenumber = (np.arange(n_rows) - first[order] + 1).astype(np.int32)
    okey = np.arange(1, n_orders + 1, dtype=np.int64)
    orderkey = ((okey >> 3) << 5) | (okey & 7)          # dbgen's MK_SPARSE
    orderdate = rng.integers(START_DATE, END_DATE - 151 + 1, n_orders)

    n_parts = max(1, int(round(200_000 * sf)))
    n_supp = max(1, int(round(10_000 * sf)))
    partkey = rng.integers(1, n_parts + 1, n_rows).astype(np.int64)
    corr = rng.integers(0, 4, n_rows)
    suppkey = ((partkey + corr * (n_supp // 4 + (partkey - 1) // n_supp))
               % n_supp + 1).astype(np.int64)
    quantity = rng.integers(1, 51, n_rows)
    retail_cents = 90000 + (partkey // 10) % 20001 + 100 * (partkey % 1000)
    ship = orderdate[order] + rng.integers(1, 122, n_rows)
    commit = orderdate[order] + rng.integers(30, 91, n_rows)
    receipt = ship + rng.integers(1, 31, n_rows)
    returnflag = np.where(receipt <= CURRENT_DATE,
                          np.where(rng.random(n_rows) < 0.5, 2, 0), 1)
    discount = rng.integers(0, 11, n_rows)
    tax = rng.integers(0, 9, n_rows)
    return {
        "l_orderkey": orderkey[order],
        "l_partkey": partkey,
        "l_suppkey": suppkey,
        "l_linenumber": linenumber,
        "l_quantity": quantity.astype(np.float64),
        "l_extendedprice": (quantity * retail_cents) / 100.0,
        "l_discount": discount / 100.0,
        "l_tax": tax / 100.0,
        "l_returnflag": returnflag.astype(np.int8),
        "l_linestatus": (ship > CURRENT_DATE).astype(np.int8),
        "l_shipdate": ship.astype(np.int32),
        "l_commitdate": commit.astype(np.int32),
        "l_receiptdate": receipt.astype(np.int32),
        "l_shipinstruct": rng.integers(0, 4, n_rows).astype(np.int8),
        "l_shipmode": rng.integers(0, 7, n_rows).astype(np.int8),
        "l_extendedprice_unscaled": (quantity * retail_cents).astype(np.int64),
        "l_discount_unscaled": discount.astype(np.int64),
        "l_tax_unscaled": tax.astype(np.int64),
    }


def text_pool(rng: np.random.Generator, size: int = TEXT_POOL_BYTES
              ) -> np.ndarray:
    """``size`` bytes of the grammar's words, each followed by a space,
    drawn uniformly from a seeded word stream."""
    words = [w.encode() + b" " for w in COMMENT_WORDS]
    wlen = np.array([len(w) for w in words], np.int64)
    wstart = np.concatenate([[0], np.cumsum(wlen)[:-1]])
    table = np.frombuffer(b"".join(words), np.uint8)
    pick = rng.integers(0, len(words), -(-size // int(wlen.min())))
    lens = wlen[pick]
    dst = np.concatenate([[0], np.cumsum(lens)[:-1]])
    within = np.arange(int(lens.sum()), dtype=np.int64)
    pool = table[np.repeat(wstart[pick] - dst, lens) + within]
    return pool[:size]


def generate_comments(n_rows: int, seed: int) -> tuple:
    """``l_comment`` as (chars uint8, int64 offsets [n+1]): each comment
    a substring of the text pool at a random offset, of a random length in
    ``COMMENT_LEN`` (dbgen's text rule, §4.2.2.10).  Its own generator, so
    the other columns do not depend on it."""
    rng = np.random.default_rng([seed, len(LINEITEM)])
    pool = text_pool(rng)
    lo, hi = COMMENT_LEN
    lens = rng.integers(lo, hi + 1, n_rows)
    starts = rng.integers(0, pool.shape[0] - lens + 1)
    offs = np.zeros(n_rows + 1, np.int64)
    np.cumsum(lens, out=offs[1:])
    chars = np.empty(int(offs[-1]), np.uint8)
    for r0 in range(0, n_rows, COMMENT_BLOCK_ROWS):
        r1 = min(n_rows, r0 + COMMENT_BLOCK_ROWS)
        c0, c1 = int(offs[r0]), int(offs[r1])
        within = np.arange(c1 - c0, dtype=np.int64)
        chars[c0:c1] = pool[np.repeat(starts[r0:r1] - offs[r0:r1] + c0,
                                      lens[r0:r1]) + within]
    return chars, offs


def lineitem_columns(data: dict, validity: Optional[dict] = None,
                     columns=LINEITEM, int96_dates: bool = False,
                     all_dictionary: bool = False) -> list[ParquetColumn]:
    """The ParquetColumns of ``columns``; with ``int96_dates`` the DATE
    columns become INT96 timestamps (midnight of each day), with
    ``all_dictionary`` every column is dictionary-encoded, as parquet-mr
    encodes them."""
    validity = validity or {}
    out = []
    for name, phys, conv, enc in columns:
        enc = "dict" if all_dictionary else enc
        if name == "l_comment":
            col = plain_strings_column(name, *data[name], validity.get(name))
            col.encoding = enc
            out.append(col)
        elif conv == "DECIMAL":
            out.append(decimal_column(name, data[name + "_unscaled"],
                                      *Q1_DECIMALS[name], enc,
                                      validity.get(name)))
        elif conv == "DATE" and int96_dates:
            out.append(ParquetColumn(name, "INT96",
                                     data[name].astype(np.int64) * NS_PER_DAY,
                                     enc, None, None, validity.get(name)))
        else:
            out.append(ParquetColumn(name, phys, data[name], enc, conv,
                                     VOCAB.get(name), validity.get(name)))
    return out


def lineitem_parquet(n_rows: int, seed: int, row_group_rows: int = 1 << 20,
                     null_fraction: float = 0.0,
                     pages_per_chunk: Optional[int] = None,
                     data_page_bytes: int = 1 << 20, columns=LINEITEM,
                     codec: str = "UNCOMPRESSED",
                     dict_page_bytes: Optional[int] = None,
                     page_version: int = 1, int96_dates: bool = False,
                     page_row_limit: Optional[int] = None):
    """(file bytes, column arrays, validity by column or {}) for a
    lineitem file of ``columns`` (all 16, ``LINEITEM_NO_COMMENT`` or
    ``LINEITEM_Q1``);
    with ``null_fraction`` every column is OPTIONAL with that share of
    nulls.  ``l_comment`` comes as (chars, int64 offsets).  ``codec`` is
    UNCOMPRESSED, SNAPPY or GZIP.  With ``dict_page_bytes`` every column
    is dictionary-encoded and falls back, as parquet-mr's writer does, at
    the first page that takes its dictionary past that size: to PLAIN, or
    with ``page_version`` 2 (DataPageV2 pages, parquet-mr's v2 writer) to
    DELTA_BINARY_PACKED for the keys and DELTA_BYTE_ARRAY for strings.
    ``int96_dates`` writes the three dates as INT96 timestamps.
    ``page_row_limit`` caps the rows of a page.  ``SPARK_DEFAULTS`` holds
    the options of a file as Spark writes it."""
    data = generate_lineitem(n_rows, seed)
    if any(name == "l_comment" for name, *_ in columns):
        data["l_comment"] = generate_comments(n_rows, seed)
    validity = {}
    if null_fraction:
        rng = np.random.default_rng(seed + 1)
        validity = {name: rng.random(n_rows) >= null_fraction
                    for name, *_ in columns}
    cols = lineitem_columns(data, validity, columns, int96_dates,
                            dict_page_bytes is not None)
    raw = write_parquet(cols, row_group_rows, data_page_bytes,
                        pages_per_chunk, codec=codec,
                        dict_page_bytes=dict_page_bytes,
                        page_version=page_version,
                        page_row_limit=page_row_limit)
    return raw, data, validity


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=SF1_ROWS)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--row-group-rows", type=int, default=1 << 20)
    ap.add_argument("--null-fraction", type=float, default=0.0)
    ap.add_argument("--no-comment", action="store_true",
                    help="write the 15 columns without l_comment")
    ap.add_argument("--q1", action="store_true",
                    help="write TPC-H Q1's 7 columns (FLBA decimals)")
    ap.add_argument("--spark", action="store_true",
                    help="write the file as Spark's defaults do "
                         "(SPARK_DEFAULTS)")
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    raw, _, _ = lineitem_parquet(
        args.rows, args.seed, args.row_group_rows, args.null_fraction,
        columns=(LINEITEM_Q1 if args.q1 else
                 LINEITEM_NO_COMMENT if args.no_comment else LINEITEM),
        **(SPARK_DEFAULTS if args.spark else {}))
    with open(args.out, "wb") as f:
        f.write(raw)
    print(f"{args.out}: {args.rows} rows, {len(raw)} bytes")
    return 0


if __name__ == "__main__":
    sys.exit(main())
