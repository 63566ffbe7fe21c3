"""Data type system of the PyTorch port.

The same (type_id, scale) pairs as the JAX package's ``types.py``, so a
schema crosses the JNI surface identically (``RowConversion.java:110-120``).
Each fixed-width type names its storage as a numpy dtype and as a torch
dtype.  Unlike the JAX package, FLOAT64 is stored as native float64: torch
on a GPU exposes the IEEE bits directly (``.view(torch.uint8)``), so the
uint32 bit-pair workaround of XLA:TPU does not carry over.  The row bytes
are the same either way, since both are little-endian views of one value.

LIST and STRUCT are column types with child types (``DType.children``:
LIST one element type, STRUCT one a field), as in the JAX package; the
JCUDF row layout rejects them (``row_conversion.cu:1268-1271``).
"""

from __future__ import annotations

import dataclasses
import enum

import numpy as np
import torch


class TypeId(enum.IntEnum):
    """Stable type identifiers (the values of the JAX package's TypeId)."""

    EMPTY = 0
    INT8 = 1
    INT16 = 2
    INT32 = 3
    INT64 = 4
    UINT8 = 5
    UINT16 = 6
    UINT32 = 7
    UINT64 = 8
    FLOAT32 = 9
    FLOAT64 = 10
    BOOL8 = 11
    TIMESTAMP_DAYS = 12
    TIMESTAMP_SECONDS = 13
    TIMESTAMP_MILLISECONDS = 14
    TIMESTAMP_MICROSECONDS = 15
    TIMESTAMP_NANOSECONDS = 16
    DURATION_DAYS = 17
    DURATION_SECONDS = 18
    DURATION_MILLISECONDS = 19
    DURATION_MICROSECONDS = 20
    DURATION_NANOSECONDS = 21
    DECIMAL32 = 22
    DECIMAL64 = 23
    STRING = 24
    LIST = 25
    STRUCT = 26
    DECIMAL128 = 27


# numpy storage dtype of each fixed-width payload
_STORAGE: dict[TypeId, np.dtype] = {
    TypeId.INT8: np.dtype(np.int8),
    TypeId.INT16: np.dtype(np.int16),
    TypeId.INT32: np.dtype(np.int32),
    TypeId.INT64: np.dtype(np.int64),
    TypeId.UINT8: np.dtype(np.uint8),
    TypeId.UINT16: np.dtype(np.uint16),
    TypeId.UINT32: np.dtype(np.uint32),
    TypeId.UINT64: np.dtype(np.uint64),
    TypeId.FLOAT32: np.dtype(np.float32),
    TypeId.FLOAT64: np.dtype(np.float64),
    # BOOL8 is one byte, value 0/1 (RowConversion.java:60-67)
    TypeId.BOOL8: np.dtype(np.uint8),
    TypeId.TIMESTAMP_DAYS: np.dtype(np.int32),
    TypeId.TIMESTAMP_SECONDS: np.dtype(np.int64),
    TypeId.TIMESTAMP_MILLISECONDS: np.dtype(np.int64),
    TypeId.TIMESTAMP_MICROSECONDS: np.dtype(np.int64),
    TypeId.TIMESTAMP_NANOSECONDS: np.dtype(np.int64),
    TypeId.DURATION_DAYS: np.dtype(np.int32),
    TypeId.DURATION_SECONDS: np.dtype(np.int64),
    TypeId.DURATION_MILLISECONDS: np.dtype(np.int64),
    TypeId.DURATION_MICROSECONDS: np.dtype(np.int64),
    TypeId.DURATION_NANOSECONDS: np.dtype(np.int64),
    TypeId.DECIMAL32: np.dtype(np.int32),
    TypeId.DECIMAL64: np.dtype(np.int64),
}

# numpy → torch for every storage dtype above.  The unsigned 16/32/64-bit
# torch dtypes have few operators; the port only views and copies them.
TORCH_DTYPE: dict[np.dtype, torch.dtype] = {
    np.dtype(np.int8): torch.int8,
    np.dtype(np.int16): torch.int16,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64,
    np.dtype(np.uint8): torch.uint8,
    np.dtype(np.uint16): torch.uint16,
    np.dtype(np.uint32): torch.uint32,
    np.dtype(np.uint64): torch.uint64,
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
}

_VARIABLE_WIDTH = frozenset({TypeId.STRING, TypeId.LIST})


@dataclasses.dataclass(frozen=True)
class DType:
    """A logical column type: (type_id, scale).

    ``scale`` is meaningful for the decimal types only: the stored integer
    ``unscaled`` stands for ``unscaled * 10**scale``.
    """

    id: TypeId
    scale: int = 0
    children: tuple = ()

    def __post_init__(self):
        if self.scale != 0 and self.id not in (
                TypeId.DECIMAL32, TypeId.DECIMAL64, TypeId.DECIMAL128):
            raise ValueError(f"scale only valid for decimal types, got {self.id!r}")
        if self.id == TypeId.LIST and len(self.children) != 1:
            raise ValueError("LIST dtype requires exactly one child (element) type")
        if self.id == TypeId.STRUCT and not self.children:
            raise ValueError("STRUCT dtype requires at least one field type")
        if self.children and self.id not in (TypeId.LIST, TypeId.STRUCT):
            raise ValueError(f"children only valid for nested types, got {self.id!r}")

    @property
    def is_fixed_width(self) -> bool:
        return self.id in _STORAGE

    @property
    def is_variable_width(self) -> bool:
        return self.id in _VARIABLE_WIDTH

    @property
    def is_decimal(self) -> bool:
        return self.id in (TypeId.DECIMAL32, TypeId.DECIMAL64, TypeId.DECIMAL128)

    @property
    def is_nested(self) -> bool:
        return self.id in (TypeId.LIST, TypeId.STRUCT)

    @property
    def storage(self) -> np.dtype:
        """numpy storage dtype of the fixed-width payload."""
        if not self.is_fixed_width:
            raise TypeError(f"{self.id.name} has no fixed-width storage dtype")
        return _STORAGE[self.id]

    @property
    def torch_storage(self) -> torch.dtype:
        """torch dtype of the payload tensor.  DECIMAL128 is int64 [n, 2]
        (low lane, then the sign-carrying high lane)."""
        if self.id == TypeId.DECIMAL128:
            return torch.int64
        return TORCH_DTYPE[self.storage]

    @property
    def itemsize(self) -> int:
        """Bytes one value occupies in a JCUDF row: the storage size, 16 for
        DECIMAL128, and an 8-byte (offset, length) uint32 pair for strings
        (``row_conversion.cu:1288-1295,1342-1350``)."""
        if self.is_variable_width:
            return 8
        if self.id == TypeId.DECIMAL128:
            return 16
        return self.storage.itemsize

    @property
    def row_alignment(self) -> int:
        """Alignment of the column's slot in a JCUDF row: its own size for
        fixed-width types, 4 for string slots (``row_conversion.cu:1331-1370``)."""
        if self.is_variable_width:
            return 4
        if self.id == TypeId.DECIMAL128:
            return 16
        return self.storage.itemsize

    def __repr__(self) -> str:
        if self.is_decimal:
            return f"DType({self.id.name}, scale={self.scale})"
        return f"DType({self.id.name})"


int8 = DType(TypeId.INT8)
int16 = DType(TypeId.INT16)
int32 = DType(TypeId.INT32)
int64 = DType(TypeId.INT64)
uint8 = DType(TypeId.UINT8)
uint16 = DType(TypeId.UINT16)
uint32 = DType(TypeId.UINT32)
uint64 = DType(TypeId.UINT64)
float32 = DType(TypeId.FLOAT32)
float64 = DType(TypeId.FLOAT64)
bool8 = DType(TypeId.BOOL8)
timestamp_days = DType(TypeId.TIMESTAMP_DAYS)
timestamp_seconds = DType(TypeId.TIMESTAMP_SECONDS)
timestamp_ms = DType(TypeId.TIMESTAMP_MILLISECONDS)
timestamp_us = DType(TypeId.TIMESTAMP_MICROSECONDS)
timestamp_ns = DType(TypeId.TIMESTAMP_NANOSECONDS)
string = DType(TypeId.STRING)


def decimal32(scale: int) -> DType:
    return DType(TypeId.DECIMAL32, scale)


def decimal64(scale: int) -> DType:
    return DType(TypeId.DECIMAL64, scale)


def decimal128(scale: int) -> DType:
    """128-bit decimal, stored as int64 [n, 2] lanes (low, high)."""
    return DType(TypeId.DECIMAL128, scale)


def list_(element: DType) -> DType:
    return DType(TypeId.LIST, 0, (element,))


def struct_(*fields: DType) -> DType:
    return DType(TypeId.STRUCT, 0, tuple(fields))


def from_numpy(dt: np.dtype) -> DType:
    """The logical DType of a numpy dtype."""
    dt = np.dtype(dt)
    if dt == np.bool_:
        return bool8
    for tid in (
        TypeId.INT8, TypeId.INT16, TypeId.INT32, TypeId.INT64,
        TypeId.UINT8, TypeId.UINT16, TypeId.UINT32, TypeId.UINT64,
        TypeId.FLOAT32, TypeId.FLOAT64,
    ):
        if dt == _STORAGE[tid]:
            return DType(tid)
    raise TypeError(f"no DType mapping for numpy dtype {dt}")
