"""Pure-Python raw-Snappy decompressor.

Parquet data pages default to the Snappy codec in most writers (Spark,
pyarrow), and the image ships no ``python-snappy`` — the reference gets
Snappy via libcudf's nvcomp integration (SURVEY §2.9; nvcomp is shipped in
the reference jar, pom.xml:462-469).  This is a dependency-free decoder for
the raw Snappy block format (no framing, as used inside Parquet pages):

* preamble: uncompressed length as little-endian varint;
* elements: tag byte, low two bits select literal / 1-2-4-byte-offset copy
  (https format description lives in the public snappy repo's format_description.txt).

The port's own copy of the JAX package's ``parquet/snappy.py``, kept as
the plain version of the scan's C decompressor (``csrc/snappy_native.cpp``,
``decode.decompress``): the tests hold the two against each other.  It
runs at host-Python element rate, so the scan never calls it.
"""

from __future__ import annotations


class SnappyError(ValueError):
    pass


def decompress(buf: bytes | bytearray | memoryview,
               expected_size: int | None = None,
               max_size: int = 1 << 30) -> bytes:
    """Decompress a raw Snappy block.

    ``expected_size`` (when the caller knows it, e.g. from the Parquet page
    header) is validated against the stream's own length varint BEFORE the
    output buffer is allocated — the varint is untrusted input and may
    otherwise demand a multi-terabyte allocation.  ``max_size`` bounds the
    allocation when no expected size is available.
    """
    buf = memoryview(buf)
    # uncompressed-length varint
    n = 0
    shift = 0
    i = 0
    while True:
        if i >= len(buf):
            raise SnappyError("truncated length varint")
        b = buf[i]
        i += 1
        n |= (b & 0x7F) << shift
        if not (b & 0x80):
            break
        shift += 7
        if shift > 35:
            raise SnappyError("length varint too long")
    if expected_size is not None and n != expected_size:
        raise SnappyError(
            f"length varint {n} != page header size {expected_size}")
    if n > max_size:
        raise SnappyError(f"uncompressed length {n} exceeds cap {max_size}")

    out = bytearray(n)
    pos = 0
    L = len(buf)
    while i < L:
        tag = buf[i]
        i += 1
        t = tag & 3
        if t == 0:                       # literal
            ln = tag >> 2
            if ln >= 60:
                k = ln - 59              # 1..4 extra length bytes
                if i + k > L:
                    raise SnappyError("truncated literal length")
                ln = int.from_bytes(buf[i:i + k], "little")
                i += k
            ln += 1
            if i + ln > L or pos + ln > n:
                raise SnappyError("literal overruns buffer")
            out[pos:pos + ln] = buf[i:i + ln]
            i += ln
            pos += ln
            continue
        if t == 1:                       # copy, 3-bit length, 11-bit offset
            if i >= L:
                raise SnappyError("truncated copy-1")
            ln = ((tag >> 2) & 0x7) + 4
            off = ((tag >> 5) << 8) | buf[i]
            i += 1
        elif t == 2:                     # copy, 6-bit length, 16-bit offset
            if i + 2 > L:
                raise SnappyError("truncated copy-2")
            ln = (tag >> 2) + 1
            off = int.from_bytes(buf[i:i + 2], "little")
            i += 2
        else:                            # copy, 6-bit length, 32-bit offset
            if i + 4 > L:
                raise SnappyError("truncated copy-4")
            ln = (tag >> 2) + 1
            off = int.from_bytes(buf[i:i + 4], "little")
            i += 4
        if off == 0 or off > pos or pos + ln > n:
            raise SnappyError("copy out of range")
        start = pos - off
        if off >= ln:
            out[pos:pos + ln] = out[start:start + ln]
        else:
            # overlapping copy: RLE-style run, repeat the period
            for j in range(ln):
                out[pos + j] = out[start + j]
        pos += ln
    if pos != n:
        raise SnappyError(f"decoded {pos} bytes, header said {n}")
    return bytes(out)
