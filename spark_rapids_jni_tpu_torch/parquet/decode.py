"""Parquet page walk: the host half of the device scan.

The port's subset of the JAX package's ``parquet/decode.py``: the thrift
field ids and enums, page decompression (SNAPPY in C, ``csrc/
snappy_native.cpp``; GZIP through ``zlib``), the RLE/bit-packed hybrid
decoder, the sequential page reader, the leaf-schema walk, PLAIN decode of
dictionary pages, the offsets walk of PLAIN string pages (a C function
built at first use, :func:`byte_array_offsets`), and the DELTA_* decoders.
Everything here is host code and runs before any byte reaches the device
(``device_scan.py``).

The DELTA_BINARY_PACKED, DELTA_LENGTH_BYTE_ARRAY and DELTA_BYTE_ARRAY
pages are the only values decoded on the host (:func:`delta_page`, as the
JAX package decodes them); they reach the device as PLAIN values.  INT96
is a TIMESTAMP_NANOSECONDS column, its days and nanoseconds combined on
the device.  A FIXED_LEN_BYTE_ARRAY that is not a DECIMAL (a UUID) is a
STRING of ``type_len`` bytes a value, as in the JAX package.  A
single-level LIST leaf carries ``d_list``, the definition level at its
repeated node, from which the scan builds the list offsets and validity
(``device_scan.py``).  Outside the port so far, and raised as
:class:`NotImplementedError` naming the encoding, codec or type (no
silent host decode): BOOLEAN other than PLAIN or dictionary-encoded, a
DECIMAL over FIXED_LEN_BYTE_ARRAY of more than 16 bytes, codecs other
than UNCOMPRESSED, SNAPPY and GZIP, lists of lists and MAP
(:class:`NestedDecodeUnsupported`).
"""

from __future__ import annotations

import ctypes
import struct as _struct
import zlib

import numpy as np

from .. import _native
from .. import types as T
from ..utils.tracing import func_range
from .footer import CC, FMD, RG, SE  # noqa: F401  (re-exported field ids)
from .thrift import CompactReader, Struct

# parquet physical types
PT_BOOLEAN, PT_INT32, PT_INT64, PT_INT96, PT_FLOAT, PT_DOUBLE, PT_BYTE_ARRAY, \
    PT_FIXED_LEN_BYTE_ARRAY = range(8)
PHYS_NAMES = ("BOOLEAN", "INT32", "INT64", "INT96", "FLOAT", "DOUBLE",
              "BYTE_ARRAY", "FIXED_LEN_BYTE_ARRAY")
# encodings
ENC_PLAIN, _, ENC_PLAIN_DICTIONARY, ENC_RLE, ENC_BIT_PACKED, \
    ENC_DELTA_BINARY_PACKED, ENC_DELTA_LENGTH_BYTE_ARRAY, \
    ENC_DELTA_BYTE_ARRAY, ENC_RLE_DICTIONARY = range(9)
ENCODING_NAMES = ("PLAIN", "GROUP_VAR_INT", "PLAIN_DICTIONARY", "RLE",
                  "BIT_PACKED", "DELTA_BINARY_PACKED",
                  "DELTA_LENGTH_BYTE_ARRAY", "DELTA_BYTE_ARRAY",
                  "RLE_DICTIONARY")
# codecs
CODEC_UNCOMPRESSED, CODEC_SNAPPY, CODEC_GZIP = 0, 1, 2
CODEC_NAMES = ("UNCOMPRESSED", "SNAPPY", "GZIP", "LZO", "BROTLI", "LZ4",
               "ZSTD", "LZ4_RAW")
# page types
PAGE_DATA, PAGE_INDEX, PAGE_DICTIONARY, PAGE_DATA_V2 = range(4)


class PH:          # PageHeader field ids (public parquet.thrift)
    TYPE = 1
    UNCOMPRESSED_SIZE = 2
    COMPRESSED_SIZE = 3
    DATA_PAGE = 5
    DICT_PAGE = 7
    DATA_PAGE_V2 = 8


class DPH:         # DataPageHeader
    NUM_VALUES = 1
    ENCODING = 2
    DEF_LEVEL_ENCODING = 3
    REP_LEVEL_ENCODING = 4


class DPH2:        # DataPageHeaderV2
    NUM_VALUES = 1
    NUM_NULLS = 2
    NUM_ROWS = 3
    ENCODING = 4
    DEF_LEVELS_BYTE_LENGTH = 5
    REP_LEVELS_BYTE_LENGTH = 6
    IS_COMPRESSED = 7


class CMD:         # ColumnMetaData (decode-relevant fields)
    TYPE = 1
    ENCODINGS = 2
    PATH = 3
    CODEC = 4
    NUM_VALUES = 5
    TOTAL_UNCOMPRESSED_SIZE = 6
    TOTAL_COMPRESSED_SIZE = 7
    DATA_PAGE_OFFSET = 9
    INDEX_PAGE_OFFSET = 10
    DICT_PAGE_OFFSET = 11
    STATISTICS = 12


class ST:          # Statistics (row-group pruning fields)
    MAX = 1        # deprecated physical-order max (fallback)
    MIN = 2        # deprecated physical-order min (fallback)
    NULL_COUNT = 3
    DISTINCT_COUNT = 4
    MAX_VALUE = 5  # logical-order max (preferred)
    MIN_VALUE = 6  # logical-order min (preferred)


_PHYS_DT = {PT_BOOLEAN: T.bool8, PT_INT32: T.int32, PT_INT64: T.int64,
            PT_INT96: T.timestamp_ns, PT_FLOAT: T.float32,
            PT_DOUBLE: T.float64, PT_BYTE_ARRAY: T.string,
            PT_FIXED_LEN_BYTE_ARRAY: T.string}
# bytes of a PLAIN value of each fixed-width physical type
PHYS_WIDTH = {PT_INT32: 4, PT_INT64: 8, PT_INT96: 12, PT_FLOAT: 4,
              PT_DOUBLE: 8}
# the widest decimal the port's lanes hold (DECIMAL128)
MAX_DECIMAL_BYTES = 16

# ConvertedType enum values (public parquet.thrift)
CT_UTF8, CT_MAP, CT_MAP_KEY_VALUE, CT_LIST, CT_ENUM, CT_DECIMAL, CT_DATE, \
    CT_TIME_MILLIS, CT_TIME_MICROS, CT_TIMESTAMP_MILLIS, \
    CT_TIMESTAMP_MICROS = range(11)

# SchemaElement decimal metadata (parquet.thrift SchemaElement)
SE_SCALE, SE_PRECISION = 7, 8


def enum_name(names: tuple, i) -> str:
    return names[i] if isinstance(i, int) and 0 <= i < len(names) else str(i)


def decompress(data, codec: int, uncompressed_size: int, column: str = "?"):
    """A page body in its codec → raw page bytes (a memoryview or bytes) of
    the header's ``uncompressed_size``.  SNAPPY goes through the C
    decompressor, GZIP through ``zlib``; a body either rejects, or that
    comes out at another size, raises ``ValueError`` naming ``column``."""
    if codec == CODEC_UNCOMPRESSED:
        return data
    if codec not in (CODEC_SNAPPY, CODEC_GZIP):
        raise NotImplementedError(
            f"parquet codec {enum_name(CODEC_NAMES, codec)} is not supported "
            "by the port's scan (UNCOMPRESSED, SNAPPY and GZIP are)")
    # what tools/torch_profile_scan.py reads as the walk's decompression
    with func_range("parquet.scan.decompress"):
        if codec == CODEC_GZIP:
            try:
                out = zlib.decompress(data, wbits=31)
            except zlib.error as e:
                raise ValueError(f"column {column}: GZIP page does not "
                                 f"decompress ({e})") from None
            if len(out) != uncompressed_size:
                raise ValueError(f"column {column}: GZIP page holds "
                                 f"{len(out)} bytes, its header says "
                                 f"{uncompressed_size}")
            return out
        src = np.frombuffer(data, dtype=np.uint8)
        out = np.empty(uncompressed_size, dtype=np.uint8)
        fn = _native.host_library("snappy_native").srjt_snappy_decompress
        rc = fn(src.ctypes.data if src.size else None, src.size,
                out.ctypes.data, uncompressed_size)
        if rc != uncompressed_size:
            raise ValueError(f"column {column}: SNAPPY page rejected by the "
                             f"decompressor (code {rc}, expected "
                             f"{uncompressed_size} bytes)")
        return memoryview(out)


def bit_width(max_level: int) -> int:
    return int(max_level).bit_length()


def decode_rle_bitpacked_hybrid(buf, bit_width: int, count: int) -> np.ndarray:
    """RLE/bit-packed hybrid (parquet format): returns uint32 [count].

    The host decoder, which the tests hold the device expansion
    (``rle_device.expand``) against.
    """
    out = np.empty(count, dtype=np.uint32)
    pos = 0
    written = 0
    if bit_width == 0:
        out[:] = 0
        return out
    while written < count:
        header = 0
        shift = 0
        while True:
            b = buf[pos]; pos += 1
            header |= (b & 0x7F) << shift
            if not b & 0x80:
                break
            shift += 7
        if header & 1:   # bit-packed run: (header>>1) groups of 8 values
            groups = header >> 1
            n_vals = groups * 8
            n_bytes = groups * bit_width
            chunk = np.frombuffer(buf, dtype=np.uint8, count=n_bytes,
                                  offset=pos)
            pos += n_bytes
            bits = np.unpackbits(chunk, bitorder="little")
            vals = bits.reshape(n_vals, bit_width)
            weights = (1 << np.arange(bit_width, dtype=np.uint32))
            decoded = (vals.astype(np.uint32) * weights).sum(axis=1,
                                                             dtype=np.uint32)
            take = min(n_vals, count - written)
            out[written:written + take] = decoded[:take]
            written += take
        else:            # RLE run: value stored in ceil(bit_width/8) bytes
            run_len = header >> 1
            n_bytes = (bit_width + 7) // 8
            val = int.from_bytes(buf[pos:pos + n_bytes], "little")
            pos += n_bytes
            take = min(run_len, count - written)
            out[written:written + take] = val
            written += take
    return out


def decode_plain_strings(data, n: int,
                         column: str = "?") -> tuple[np.ndarray, np.ndarray]:
    """PLAIN BYTE_ARRAY values (a string dictionary page) → (chars uint8
    with the 4-byte length prefixes stripped, int64 offsets [n+1])."""
    offsets = byte_array_offsets(data, n, column).astype(np.int64)
    lens = offsets[1:] - offsets[:-1]
    # value i's chars follow its prefix and the i records before it
    starts = 4 * np.arange(1, n + 1, dtype=np.int64) + offsets[:-1]
    src = (np.repeat(starts - offsets[:-1], lens)
           + np.arange(int(offsets[-1]), dtype=np.int64))
    return np.frombuffer(data, dtype=np.uint8)[src], offsets


_MAX_CHARS = 2**31 - 1


def byte_array_offsets(page, n: int, column: str = "?") -> np.ndarray:
    """The int32 char offsets [n+1] of the first ``n`` values of a PLAIN
    BYTE_ARRAY page (length prefixes excluded); the values take the page's
    first ``4 * n + offsets[n]`` bytes.  The walk is a C function
    (``csrc/plain_strings.cpp``), built with the host compiler at first
    use.  A page that ends inside a value, or whose chars pass 2^31 - 1,
    raises ``ValueError`` naming ``column``."""
    buf = np.frombuffer(page, dtype=np.uint8)
    offs = np.empty(n + 1, dtype=np.int32)
    fn = _native.host_library("plain_strings").srjt_byte_array_offsets
    total = fn(buf.ctypes.data_as(ctypes.c_void_p) if buf.size else None,
               buf.size, n, offs.ctypes.data)
    if total == -2:
        raise ValueError(f"column {column}: PLAIN string page holds more "
                         f"than {_MAX_CHARS} chars")
    if total < 0:
        raise ValueError(f"column {column}: PLAIN string page ends inside "
                         f"one of its {n} values")
    return offs


def byte_array_offsets_plain(page, n: int, column: str = "?") -> np.ndarray:
    """Python twin of :func:`byte_array_offsets`, for the tests."""
    mv = memoryview(page).cast("B")
    offs = np.zeros(n + 1, dtype=np.int32)
    pos = total = 0
    for i in range(n):
        if pos + 4 > len(mv):
            raise ValueError(f"column {column}: PLAIN string page ends "
                             f"inside one of its {n} values")
        (ln,) = _struct.unpack_from("<I", mv, pos)
        pos += 4
        if ln > len(mv) - pos:
            raise ValueError(f"column {column}: PLAIN string page ends "
                             f"inside one of its {n} values")
        pos += ln
        total += ln
        if total > _MAX_CHARS:
            raise ValueError(f"column {column}: PLAIN string page holds "
                             f"more than {_MAX_CHARS} chars")
        offs[i + 1] = total
    return offs


def _uleb128(buf, pos: int, column: str) -> tuple[int, int]:
    out = shift = 0
    while True:
        if pos >= len(buf) or shift > 63:
            raise ValueError(f"column {column}: DELTA stream ends inside a "
                             "varint")
        b = buf[pos]
        pos += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            if out >> 64:
                raise ValueError(f"column {column}: DELTA varint passes 64 "
                                 "bits")
            return out, pos
        shift += 7


def _zigzag(v: int) -> int:
    return (v >> 1) ^ -(v & 1)


def decode_delta_binary_packed(buf, pos: int = 0, column: str = "?"
                               ) -> tuple[np.ndarray, int]:
    """DELTA_BINARY_PACKED at ``buf[pos:]`` → (int64 values, end position).

    The layout of the parquet encodings spec: ULEB128 block size,
    miniblocks a block, value count, zigzag first value; then per block a
    zigzag min delta, one bit width a miniblock and the LSB-first packed
    deltas.  Values are the first plus the running sum of (min delta +
    delta), wrapping as int64 (the JAX package's
    ``decode_delta_binary_packed``, ``spark_rapids_jni_tpu/parquet/
    decode.py:238-283``).  The host walks the block headers; each bit
    width's miniblocks unpack in one numpy pass.  A miniblock past the
    last value has no bytes, whatever bit width its header gives (the
    spec's rule; the JAX package skips ``width × values / 8`` bytes there,
    which writers that leave those widths 0 make the same)."""
    buf = memoryview(buf).cast("B")
    block_size, pos = _uleb128(buf, pos, column)
    n_mini, pos = _uleb128(buf, pos, column)
    total, pos = _uleb128(buf, pos, column)
    first_raw, pos = _uleb128(buf, pos, column)
    if n_mini == 0 or block_size % n_mini or (block_size // n_mini) % 8:
        raise ValueError(f"column {column}: DELTA block of {block_size} "
                         f"values in {n_mini} miniblocks")
    per = block_size // n_mini
    starts, widths, mins = [], [], []
    remaining = total - 1
    while remaining > 0:
        min_raw, pos = _uleb128(buf, pos, column)
        if pos + n_mini > len(buf):
            raise ValueError(f"column {column}: DELTA block header past the "
                             "end of its page")
        bws = bytes(buf[pos:pos + n_mini])
        pos += n_mini
        for bw in bws:
            if remaining <= 0:
                break
            if bw > 64:
                raise ValueError(f"column {column}: DELTA bit width {bw}")
            starts.append(pos)
            widths.append(bw)
            mins.append(_zigzag(min_raw))
            pos += bw * per // 8
            remaining -= per
    if pos > len(buf):
        raise ValueError(f"column {column}: DELTA miniblocks past the end "
                         "of their page")
    raw = np.frombuffer(buf, np.uint8)
    deltas = np.zeros((len(starts), per), np.uint64)
    widths_a = np.asarray(widths, np.int64)
    starts_a = np.asarray(starts, np.int64)
    for bw in np.unique(widths_a[widths_a > 0]).tolist():
        sel = np.flatnonzero(widths_a == bw)
        nb = bw * per // 8
        chunk = raw[starts_a[sel, None] + np.arange(nb)]
        bits = np.unpackbits(chunk, axis=1, bitorder="little").reshape(
            sel.shape[0], per, bw)
        acc = np.zeros((sel.shape[0], per), np.uint64)
        for b in range(bw):
            acc |= bits[:, :, b].astype(np.uint64) << np.uint64(b)
        deltas[sel] = acc
    deltas += np.asarray(mins, np.int64).astype(np.uint64)[:, None]
    out = np.empty(max(total, 0), np.int64)
    if total:
        steps = deltas.reshape(-1)[:total - 1].view(np.int64)
        out[0] = _zigzag(first_raw)
        np.cumsum(steps, out=out[1:])
        out[1:] += out[0]
    return out, pos


def decode_delta_length_byte_array(buf, n: int, column: str = "?"
                                   ) -> tuple[np.ndarray, np.ndarray]:
    """DELTA_LENGTH_BYTE_ARRAY → (chars uint8, int64 lengths [n]): the
    lengths DELTA_BINARY_PACKED, then every value's chars back to back."""
    lens, pos = decode_delta_binary_packed(buf, 0, column)
    if lens.shape[0] < n or (lens[:n] < 0).any():
        raise ValueError(f"column {column}: DELTA_LENGTH_BYTE_ARRAY lengths "
                         f"hold {lens.shape[0]} values, expected {n}")
    lens = lens[:n]
    total = int(lens.sum())
    if pos + total > len(buf):
        raise ValueError(f"column {column}: DELTA_LENGTH_BYTE_ARRAY chars "
                         "run past the end of their page")
    return np.frombuffer(buf, np.uint8, total, pos), lens


def decode_delta_byte_array(buf, n: int, column: str = "?"
                            ) -> tuple[np.ndarray, np.ndarray]:
    """DELTA_BYTE_ARRAY → (chars uint8, int64 lengths [n]): prefix lengths
    and suffix lengths, both DELTA_BINARY_PACKED, then the suffixes; value
    i is value i-1's first prefix[i] bytes and its suffix.  The rebuild is
    a C function (``csrc/plain_strings.cpp``)."""
    prefix, pos = decode_delta_binary_packed(buf, 0, column)
    suffix, pos = decode_delta_binary_packed(buf, pos, column)
    if prefix.shape[0] < n or suffix.shape[0] < n:
        raise ValueError(f"column {column}: DELTA_BYTE_ARRAY lengths hold "
                         f"{min(prefix.shape[0], suffix.shape[0])} values, "
                         f"expected {n}")
    prefix = np.ascontiguousarray(prefix[:n])
    suffix = np.ascontiguousarray(suffix[:n])
    lens = prefix + suffix
    if (prefix < 0).any() or (suffix < 0).any():
        raise ValueError(f"column {column}: DELTA_BYTE_ARRAY negative length")
    stream = np.frombuffer(buf, np.uint8)[pos:]
    out = np.empty(int(lens.sum()), np.uint8)
    fn = _native.host_library("plain_strings").srjt_delta_byte_array
    rc = fn(prefix.ctypes.data, suffix.ctypes.data, n,
            stream.ctypes.data if stream.size else None, stream.size,
            out.ctypes.data, out.size)
    if rc != out.size:
        raise ValueError(f"column {column}: DELTA_BYTE_ARRAY values do not "
                         f"rebuild (code {rc})")
    return out, lens


def delta_byte_array_plain(prefix, suffix_lens, stream) -> np.ndarray:
    """Python twin of the C rebuild in :func:`decode_delta_byte_array`
    (the JAX package's loop), for the tests."""
    lens = [int(p) + int(s) for p, s in zip(prefix, suffix_lens)]
    out = bytearray()
    prev = spos = 0
    for p, s, ln in zip(prefix, suffix_lens, lens):
        start = len(out)
        out += out[prev:prev + int(p)]
        out += bytes(stream[spos:spos + int(s)])
        spos += int(s)
        prev = start
    return np.frombuffer(bytes(out), np.uint8)


def plain_records(chars: np.ndarray, lens: np.ndarray) -> bytes:
    """Values as PLAIN BYTE_ARRAY records (4-byte little-endian length,
    then the chars), the form the scan stages strings in."""
    k = lens.shape[0]
    rec = np.zeros(k + 1, np.int64)
    np.cumsum(lens + 4, out=rec[1:])
    out = np.empty(int(rec[-1]), np.uint8)
    out[(rec[:-1, None] + np.arange(4)).reshape(-1)] = (
        lens.astype("<u4").view(np.uint8))
    mask = np.ones(out.shape[0], bool)
    mask[(rec[:-1, None] + np.arange(4)).reshape(-1)] = False
    out[mask] = chars
    return out.tobytes()


def delta_page(page, enc: int, leaf: "Leaf", n: int):
    """A DELTA_* page's ``n`` values decoded on the host, in the form the
    scan stages PLAIN values in: little-endian words for INT32 and INT64,
    the values back to back for FIXED_LEN_BYTE_ARRAY, and (PLAIN records,
    int32 char offsets [n+1]) for BYTE_ARRAY.  Raises
    ``NotImplementedError`` for an encoding the physical type cannot
    take."""
    phys, column = leaf.phys, leaf.path
    if enc == ENC_DELTA_BINARY_PACKED and phys in (PT_INT32, PT_INT64):
        vals, _ = decode_delta_binary_packed(page, 0, column)
        if vals.shape[0] < n:
            raise ValueError(f"column {column}: DELTA_BINARY_PACKED page "
                             f"holds {vals.shape[0]} values, expected {n}")
        return vals[:n].astype("<i4" if phys == PT_INT32 else "<i8").tobytes()
    if enc == ENC_DELTA_LENGTH_BYTE_ARRAY and phys == PT_BYTE_ARRAY:
        chars, lens = decode_delta_length_byte_array(page, n, column)
    elif enc == ENC_DELTA_BYTE_ARRAY and phys in (PT_BYTE_ARRAY,
                                                    PT_FIXED_LEN_BYTE_ARRAY):
        chars, lens = decode_delta_byte_array(page, n, column)
    else:
        raise NotImplementedError(
            f"column {column}: encoding {enum_name(ENCODING_NAMES, enc)} of "
            f"{enum_name(PHYS_NAMES, phys)} is not supported by the port's "
            "scan")
    if phys == PT_FIXED_LEN_BYTE_ARRAY:
        if (lens != leaf.type_len).any():
            raise ValueError(f"column {column}: a DELTA_BYTE_ARRAY value is "
                             f"not {leaf.type_len} bytes")
        return chars.tobytes()
    offs = np.zeros(n + 1, np.int64)
    np.cumsum(lens, out=offs[1:])
    if offs[-1] > _MAX_CHARS:
        raise ValueError(f"column {column}: DELTA string page holds more "
                         f"than {_MAX_CHARS} chars")
    return plain_records(chars, lens), offs.astype(np.int32)


class PageStream:
    """Sequential reader over a column chunk's pages (zero-copy: pages
    are memoryview slices of the file)."""

    def __init__(self, buf: memoryview):
        self.buf = buf
        self.pos = 0

    def next_page(self) -> tuple[Struct, memoryview]:
        reader = CompactReader(self.buf, self.pos)
        header = reader.read_struct()
        self.pos = reader.pos
        comp_size = header.get(PH.COMPRESSED_SIZE)
        if comp_size is None or self.pos + comp_size > len(self.buf):
            raise ValueError("page runs past the end of its column chunk")
        raw = self.buf[self.pos:self.pos + comp_size]
        self.pos += comp_size
        return header, raw


class Leaf:
    """One leaf column's schema facts, gathered by the depth-first walk."""

    def __init__(self, elem, max_def, max_rep, path, d_list=0):
        self.elem = elem
        self.max_def = max_def          # def level meaning "value present"
        self.max_rep = max_rep          # 0 = flat, 1 = single-level list
        self.d_list = d_list            # def level at the repeated node
        self.path = path
        # struct leaves keep their dotted path; a LIST leaf takes its outer
        # field's name (the chunk path is "name.list.element")
        self.name = path.split(".")[0] if max_rep > 0 else path

    @property
    def phys(self) -> int:
        return self.elem.get(SE.TYPE)

    @property
    def type_len(self) -> int:
        """FIXED_LEN_BYTE_ARRAY's width in bytes (0 for other types)."""
        return self.elem.get(SE.TYPE_LENGTH, 0) or 0

    def logical_dtype(self) -> T.DType:
        """Element-level logical dtype from the physical and converted
        types, for the types the port's scan decodes.  A DECIMAL over
        BYTE_ARRAY or FIXED_LEN_BYTE_ARRAY is decimal32, decimal64 or
        decimal128 by its precision (at most 9, at most 18, more), and
        other FIXED_LEN_BYTE_ARRAY is STRING, as in the JAX package."""
        phys = self.phys
        ct = self.elem.get(SE.CONVERTED_TYPE)
        if ct == CT_DECIMAL:
            scale = -(self.elem.get(SE_SCALE, 0) or 0)
            precision = self.elem.get(SE_PRECISION, 0) or 0
            if phys == PT_INT32:
                return T.decimal32(scale)
            if phys == PT_INT64:
                return T.decimal64(scale)
            if phys == PT_BYTE_ARRAY or (
                    phys == PT_FIXED_LEN_BYTE_ARRAY
                    and 0 < self.type_len <= MAX_DECIMAL_BYTES):
                if precision and precision <= 9:
                    return T.decimal32(scale)
                if precision and precision <= 18:
                    return T.decimal64(scale)
                return T.decimal128(scale)
            raise NotImplementedError(
                f"column {self.path}: DECIMAL on {enum_name(PHYS_NAMES, phys)} "
                f"of {self.type_len} bytes is not supported by the port's "
                "scan")
        if ct == CT_DATE and phys == PT_INT32:
            return T.timestamp_days
        if ct == CT_TIMESTAMP_MILLIS and phys == PT_INT64:
            return T.timestamp_ms
        if ct == CT_TIMESTAMP_MICROS and phys == PT_INT64:
            return T.timestamp_us
        if phys not in _PHYS_DT:
            raise NotImplementedError(
                f"column {self.path}: physical type "
                f"{enum_name(PHYS_NAMES, phys)} is not supported by the port's "
                "scan")
        return _PHYS_DT[phys]


class NestedDecodeUnsupported(NotImplementedError):
    """The file's schema needs nested decode the scan does not do (lists
    of lists, MAP), raised by the schema walk before any page is read."""


def leaf_schema_elements(meta: Struct) -> list[Leaf]:
    """Depth-first walk: the leaves with their Dremel levels and, under a
    repeated node, ``d_list`` (the JAX package's ``_leaf_schema_elements``,
    ``spark_rapids_jni_tpu/parquet/decode.py:622-665``).

    Raises :class:`NestedDecodeUnsupported` for lists of lists and MAP
    groups, naming their paths, as the JAX package does.  A single-level
    list leaf is returned with ``max_rep`` 1."""
    schema = meta.get(FMD.SCHEMA).values
    out: list[Leaf] = []
    bad: list[str] = []

    def walk(idx: int, depth_def: int, depth_rep: int, d_list: int,
             prefix: str):
        elem = schema[idx]
        n = elem.get(SE.NUM_CHILDREN, 0) or 0
        name = elem.get(SE.NAME, b"").decode("utf-8")
        rep = elem.get(SE.REPETITION_TYPE, 0)
        # optional (1) adds a definition level; repeated (2) adds both a
        # definition and a repetition level
        my_def = depth_def + (1 if rep in (1, 2) else 0)
        my_rep = depth_rep + (1 if rep == 2 else 0)
        my_dlist = my_def if rep == 2 else d_list
        path = f"{prefix}.{name}" if prefix else name
        ct = elem.get(SE.CONVERTED_TYPE)
        if my_rep > 1:
            bad.append(f"{path} (nested lists, max_rep > 1)")
        elif n and ct in (CT_MAP, CT_MAP_KEY_VALUE):
            bad.append(f"{path} (MAP)")
        idx += 1
        if n == 0:
            out.append(Leaf(elem, my_def, my_rep, path, my_dlist))
            return idx
        for _ in range(n):
            idx = walk(idx, my_def, my_rep, my_dlist, path)
        return idx

    idx = 1
    root_children = schema[0].get(SE.NUM_CHILDREN, 0) or 0
    for _ in range(root_children):
        idx = walk(idx, 0, 0, 0, "")
    if bad:
        raise NestedDecodeUnsupported(
            "nested decode is not supported by the port's scan: "
            + ", ".join(bad))
    return out
