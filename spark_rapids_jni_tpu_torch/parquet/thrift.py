"""Generic Thrift Compact Protocol reader/writer.

The port's own copy of the JAX package's ``parquet/thrift.py``.

The reference parses Parquet footers with Apache Thrift's TCompactProtocol
into *generated* typed structs (``NativeParquetJni.cpp:27-32,521-550``).
This implementation takes a different architecture on purpose: it parses into
a **generic field tree** (field-id → typed value, order preserved).  That
keeps the engine schema-agnostic — unknown fields survive a
parse→prune→serialize round trip verbatim, so footers written by newer
Parquet writers are never corrupted by pruning — and needs no thrift codegen
anywhere in the build.

Size-bomb guards mirror the reference (``NativeParquetJni.cpp:536-540``):
strings ≤ 100 MB, containers ≤ 1M elements.

Wire format implemented from the public Thrift Compact Protocol spec:
ULEB128 varints, zigzag ints, field-id delta headers, size-prefixed binaries,
list headers packing element type + size.
"""

from __future__ import annotations

import dataclasses
import struct as _struct
from typing import Any, Iterator, Optional

MAX_STRING_SIZE = 100 * 1000 * 1000   # NativeParquetJni.cpp:538
MAX_CONTAINER_SIZE = 1000 * 1000      # NativeParquetJni.cpp:540


class TType:
    STOP = 0
    BOOL_TRUE = 1     # compact: bool value lives in the field header
    BOOL_FALSE = 2
    BYTE = 3
    I16 = 4
    I32 = 5
    I64 = 6
    DOUBLE = 7
    BINARY = 8
    LIST = 9
    SET = 10
    MAP = 11
    STRUCT = 12


@dataclasses.dataclass
class Field:
    fid: int
    ttype: int
    value: Any


class Struct:
    """A generic thrift struct: ordered fields addressable by field id."""

    __slots__ = ("fields",)

    def __init__(self, fields: Optional[list[Field]] = None):
        self.fields: list[Field] = fields if fields is not None else []

    def get(self, fid: int, default=None):
        for f in self.fields:
            if f.fid == fid:
                return f.value
        return default

    def get_field(self, fid: int) -> Optional[Field]:
        for f in self.fields:
            if f.fid == fid:
                return f
        return None

    def has(self, fid: int) -> bool:
        return self.get_field(fid) is not None

    def set(self, fid: int, ttype: int, value) -> None:
        f = self.get_field(fid)
        if f is None:
            self.fields.append(Field(fid, ttype, value))
            self.fields.sort(key=lambda x: x.fid)
        else:
            f.ttype = ttype
            f.value = value

    def remove(self, fid: int) -> None:
        self.fields = [f for f in self.fields if f.fid != fid]

    def __repr__(self):
        return f"Struct({self.fields!r})"


@dataclasses.dataclass
class ListValue:
    elem_type: int
    values: list

    def __iter__(self) -> Iterator:
        return iter(self.values)

    def __len__(self):
        return len(self.values)


# ---------------------------------------------------------------------------
# reader
# ---------------------------------------------------------------------------

class ThriftError(ValueError):
    pass


class CompactReader:
    def __init__(self, buf: bytes, pos: int = 0):
        self.buf = buf
        self.pos = pos

    # -- primitives ---------------------------------------------------------
    def _byte(self) -> int:
        if self.pos >= len(self.buf):
            raise ThriftError("unexpected end of thrift data")
        b = self.buf[self.pos]
        self.pos += 1
        return b

    def read_varint(self) -> int:
        result = 0
        shift = 0
        while True:
            b = self._byte()
            result |= (b & 0x7F) << shift
            if not b & 0x80:
                return result
            shift += 7
            if shift > 63:
                raise ThriftError("varint too long")

    def read_zigzag(self) -> int:
        n = self.read_varint()
        return (n >> 1) ^ -(n & 1)

    def read_binary(self) -> bytes:
        size = self.read_varint()
        if size > MAX_STRING_SIZE:
            raise ThriftError(f"string size {size} exceeds limit")
        if self.pos + size > len(self.buf):
            raise ThriftError("string extends past end of buffer")
        out = self.buf[self.pos:self.pos + size]
        self.pos += size
        return out

    def read_double(self) -> float:
        if self.pos + 8 > len(self.buf):
            raise ThriftError("double extends past end of buffer")
        (v,) = _struct.unpack_from("<d", self.buf, self.pos)
        self.pos += 8
        return v

    # -- values -------------------------------------------------------------
    def read_value(self, ttype: int):
        if ttype == TType.BOOL_TRUE:
            return True
        if ttype == TType.BOOL_FALSE:
            return False
        if ttype == TType.BYTE:
            b = self._byte()
            return b - 256 if b >= 128 else b
        if ttype in (TType.I16, TType.I32, TType.I64):
            return self.read_zigzag()
        if ttype == TType.DOUBLE:
            return self.read_double()
        if ttype == TType.BINARY:
            return self.read_binary()
        if ttype in (TType.LIST, TType.SET):
            return self.read_list()
        if ttype == TType.MAP:
            return self.read_map()
        if ttype == TType.STRUCT:
            return self.read_struct()
        raise ThriftError(f"unknown compact type {ttype}")

    def read_list(self) -> ListValue:
        header = self._byte()
        size = (header >> 4) & 0x0F
        elem_type = header & 0x0F
        if size == 15:
            size = self.read_varint()
        if size > MAX_CONTAINER_SIZE:
            raise ThriftError(f"container size {size} exceeds limit")
        if elem_type in (TType.BOOL_TRUE, TType.BOOL_FALSE):
            # in lists, each bool is one byte (1=true, 2=false) — unlike in
            # structs where the value lives in the field header
            return ListValue(elem_type,
                             [self._byte() == 1 for _ in range(size)])
        return ListValue(elem_type,
                         [self.read_value(elem_type) for _ in range(size)])

    def read_map(self):
        size = self.read_varint()
        if size > MAX_CONTAINER_SIZE:
            raise ThriftError(f"map size {size} exceeds limit")
        if size == 0:
            return (0, 0, [])
        kv = self._byte()
        ktype, vtype = (kv >> 4) & 0x0F, kv & 0x0F
        pairs = [(self.read_value(ktype), self.read_value(vtype))
                 for _ in range(size)]
        return (ktype, vtype, pairs)

    def read_struct(self) -> Struct:
        fields: list[Field] = []
        last_fid = 0
        while True:
            header = self._byte()
            if header == TType.STOP:
                return Struct(fields)
            delta = (header >> 4) & 0x0F
            ttype = header & 0x0F
            fid = last_fid + delta if delta else self.read_zigzag()
            fields.append(Field(fid, ttype, self.read_value(ttype)))
            last_fid = fid


# ---------------------------------------------------------------------------
# writer
# ---------------------------------------------------------------------------

class CompactWriter:
    def __init__(self):
        self.out = bytearray()

    def write_varint(self, n: int) -> None:
        while True:
            if n & ~0x7F == 0:
                self.out.append(n)
                return
            self.out.append((n & 0x7F) | 0x80)
            n >>= 7

    def write_zigzag(self, n: int) -> None:
        self.write_varint((n << 1) ^ (n >> 63) if n >= 0 else ((n << 1) ^ -1) & ((1 << 64) - 1))

    def write_binary(self, b: bytes) -> None:
        self.write_varint(len(b))
        self.out += b

    def write_value(self, ttype: int, value) -> None:
        if ttype in (TType.BOOL_TRUE, TType.BOOL_FALSE):
            # only reached inside lists; structs encode bools in the header
            self.out.append(TType.BOOL_TRUE if value else TType.BOOL_FALSE)
        elif ttype == TType.BYTE:
            self.out.append(value & 0xFF)
        elif ttype in (TType.I16, TType.I32, TType.I64):
            self.write_zigzag(value)
        elif ttype == TType.DOUBLE:
            self.out += _struct.pack("<d", value)
        elif ttype == TType.BINARY:
            self.write_binary(value)
        elif ttype in (TType.LIST, TType.SET):
            self.write_list(value)
        elif ttype == TType.MAP:
            self.write_map(value)
        elif ttype == TType.STRUCT:
            self.write_struct(value)
        else:
            raise ThriftError(f"cannot write compact type {ttype}")

    def write_list(self, lv: ListValue) -> None:
        size = len(lv.values)
        if size < 15:
            self.out.append((size << 4) | lv.elem_type)
        else:
            self.out.append(0xF0 | lv.elem_type)
            self.write_varint(size)
        for v in lv.values:
            self.write_value(lv.elem_type, v)

    def write_map(self, mv) -> None:
        ktype, vtype, pairs = mv
        self.write_varint(len(pairs))
        if pairs:
            self.out.append((ktype << 4) | vtype)
            for k, v in pairs:
                self.write_value(ktype, k)
                self.write_value(vtype, v)

    def write_struct(self, s: Struct) -> None:
        last_fid = 0
        for f in s.fields:
            ttype = f.ttype
            if ttype in (TType.BOOL_TRUE, TType.BOOL_FALSE):
                ttype = TType.BOOL_TRUE if f.value else TType.BOOL_FALSE
            delta = f.fid - last_fid
            if 0 < delta <= 15:
                self.out.append((delta << 4) | ttype)
            else:
                self.out.append(ttype)
                self.write_zigzag_i16(f.fid)
            if ttype not in (TType.BOOL_TRUE, TType.BOOL_FALSE):
                self.write_value(ttype, f.value)
            last_fid = f.fid
        self.out.append(TType.STOP)

    def write_zigzag_i16(self, n: int) -> None:
        self.write_varint(((n << 1) ^ (n >> 15)) & 0xFFFFFFFF)

    def getvalue(self) -> bytes:
        return bytes(self.out)


def parse_struct(buf: bytes) -> Struct:
    return CompactReader(buf).read_struct()


def serialize_struct(s: Struct) -> bytes:
    w = CompactWriter()
    w.write_struct(s)
    return w.getvalue()
