"""Device columns and tables of the PyTorch port.

A :class:`Column` holds flat torch tensors on one device, in the Arrow
layout the JAX package uses (``spark_rapids_jni_tpu/column.py``):

* fixed-width: ``data`` is [n] of ``dtype.torch_storage`` (DECIMAL128:
  int64 [n, 2]; FLOAT64: native float64; BOOL8: uint8 0/1);
* STRING: ``data`` is the uint8 chars buffer, ``offsets`` int32 [n+1];
* ``validity``: bool [n], True = valid, or None when every row is valid.

Constructors place data on the GPU unless the caller passes
``device="cpu"``; with no CUDA device they raise rather than run on the CPU.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from . import types as T


def resolve_device(device=None) -> torch.device:
    """``None`` means the GPU; asking for CUDA without one raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU")
    return dev


def _validity_tensor(validity, device) -> Optional[torch.Tensor]:
    if validity is None:
        return None
    return torch.as_tensor(np.asarray(validity, dtype=bool), device=device)


@dataclasses.dataclass
class Column:
    """One device column (see the module docstring for the layout)."""

    dtype: T.DType
    data: torch.Tensor
    offsets: Optional[torch.Tensor] = None
    validity: Optional[torch.Tensor] = None

    @property
    def num_rows(self) -> int:
        if self.dtype.is_variable_width:
            return self.offsets.shape[0] - 1
        return self.data.shape[0]

    def __len__(self) -> int:
        return self.num_rows

    @property
    def device(self) -> torch.device:
        return self.data.device

    def validity_or_true(self) -> torch.Tensor:
        if self.validity is None:
            return torch.ones(self.num_rows, dtype=torch.bool,
                              device=self.device)
        return self.validity

    @staticmethod
    def from_numpy(arr: np.ndarray, dtype: T.DType | None = None,
                   validity: np.ndarray | None = None,
                   device=None) -> "Column":
        """A fixed-width column from a host array (DECIMAL128: int64
        [n, 2] lanes)."""
        dev = resolve_device(device)
        arr = np.asarray(arr)
        if dtype is None:
            dtype = T.from_numpy(arr.dtype)
        if dtype.id == T.TypeId.DECIMAL128:
            storage = np.ascontiguousarray(arr, dtype=np.int64).reshape(-1, 2)
        else:
            storage = np.ascontiguousarray(arr, dtype=dtype.storage).reshape(-1)
        return Column(dtype, torch.from_numpy(storage.copy()).to(dev),
                      validity=_validity_tensor(validity, dev))

    @staticmethod
    def strings_from_arrays(chars: np.ndarray, offsets: np.ndarray,
                            validity: np.ndarray | None = None,
                            device=None) -> "Column":
        """A STRING column from a uint8 chars buffer and int32 [n+1]
        offsets."""
        dev = resolve_device(device)
        chars = np.ascontiguousarray(chars, dtype=np.uint8).reshape(-1)
        offsets = np.ascontiguousarray(offsets, dtype=np.int32).reshape(-1)
        return Column(T.string, torch.from_numpy(chars.copy()).to(dev),
                      torch.from_numpy(offsets.copy()).to(dev),
                      _validity_tensor(validity, dev))

    @staticmethod
    def strings_from_list(strings: Sequence[Optional[str]],
                          device=None) -> "Column":
        """A STRING column from host strings (None ⇒ a null, empty row)."""
        valid = np.asarray([s is not None for s in strings], dtype=bool)
        payloads = [s.encode("utf-8") if s is not None else b""
                    for s in strings]
        offsets = np.zeros(len(strings) + 1, dtype=np.int32)
        np.cumsum([len(p) for p in payloads], out=offsets[1:])
        chars = np.frombuffer(b"".join(payloads), dtype=np.uint8)
        return Column.strings_from_arrays(
            chars, offsets, None if valid.all() else valid, device)

    def to_numpy(self) -> np.ndarray:
        """Host copy of a fixed-width payload (FLOAT64 as float64 values)."""
        return self.data.cpu().numpy()

    def to_pylist(self):
        """Host list with ``None`` for nulls (tests and debugging)."""
        valid = self.validity_or_true().cpu().numpy()
        if self.dtype.id == T.TypeId.STRING:
            offsets = self.offsets.cpu().numpy()
            chars = self.data.cpu().numpy().tobytes()
            return [chars[offsets[i]:offsets[i + 1]].decode("utf-8")
                    if valid[i] else None for i in range(self.num_rows)]
        if self.dtype.id == T.TypeId.DECIMAL128:
            lanes = self.to_numpy()
            lo = lanes[:, 0].astype(np.uint64)
            hi = lanes[:, 1]
            return [int(hi[i]) * (1 << 64) + int(lo[i]) if valid[i] else None
                    for i in range(self.num_rows)]
        vals = self.to_numpy()
        if self.dtype.id == T.TypeId.BOOL8:
            vals = vals.astype(bool)
        return [vals[i].item() if valid[i] else None
                for i in range(self.num_rows)]


@dataclasses.dataclass
class Table:
    """An ordered collection of equal-length columns."""

    columns: list[Column]

    def __post_init__(self):
        if self.columns:
            n = self.columns[0].num_rows
            for i, c in enumerate(self.columns):
                if c.num_rows != n:
                    raise ValueError(
                        f"column {i} has {c.num_rows} rows, expected {n}")

    @property
    def num_columns(self) -> int:
        return len(self.columns)

    @property
    def num_rows(self) -> int:
        return self.columns[0].num_rows if self.columns else 0

    @property
    def schema(self) -> list[T.DType]:
        return [c.dtype for c in self.columns]

    @property
    def device(self) -> torch.device:
        """The one device every column lives on."""
        devices = {c.device for c in self.columns}
        if len(devices) != 1:
            raise ValueError(f"table columns span devices {sorted(map(str, devices))}")
        return devices.pop()

    def __getitem__(self, i: int) -> Column:
        return self.columns[i]

    def __iter__(self):
        return iter(self.columns)
