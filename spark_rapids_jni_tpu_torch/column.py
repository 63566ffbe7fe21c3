"""Device columns and tables of the PyTorch port.

A :class:`Column` holds flat torch tensors on one device, in the Arrow
layout the JAX package uses (``spark_rapids_jni_tpu/column.py``):

* fixed-width: ``data`` is [n] of ``dtype.torch_storage`` (DECIMAL128:
  int64 [n, 2]; FLOAT64: native float64; BOOL8: uint8 0/1);
* STRING: ``data`` is the uint8 chars buffer, ``offsets`` int32 [n+1];
* LIST: ``offsets`` int32 [n+1] into ``children[0]``, the element column
  (any type, lists too); ``data`` an empty uint8 tensor on the device;
* STRUCT: ``children`` one column a field, all of ``num_rows`` rows (the
  first field's); ``data`` empty, ``offsets`` None;
* ``validity``: bool [n], True = valid, or None when every row is valid.

Nested columns are the JAX package's column hierarchy
(``spark_rapids_jni_tpu/column.py:58-75``): a null LIST row may still
cover elements (a gather keeps them), as there.

Constructors place data on the GPU unless the caller passes
``device="cpu"``; with no CUDA device they raise rather than run on the CPU.
Their host → device copies go through one funnel, :func:`upload` (the
fault shim's ``torch.h2d`` site, ``faultinj/torch_shim.py``), and a
STRING column born on the host seeds its offsets' host mirror
(``utils/hostcache.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from . import types as T
from .utils import bitmask, hostcache, syncs


def resolve_device(device=None) -> torch.device:
    """``None`` means the GPU; asking for CUDA without one raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU")
    return dev


def upload(host: np.ndarray, device: torch.device) -> torch.Tensor:
    """A copy of the host array ``host`` on ``device``: the constructors'
    one host → device funnel."""
    return torch.from_numpy(np.array(host, copy=True)).to(device)


def _empty(device) -> torch.Tensor:
    """The ``data`` of a nested column: no bytes, on its device."""
    return torch.zeros(0, dtype=torch.uint8, device=device)


def _validity_tensor(validity, device) -> Optional[torch.Tensor]:
    if validity is None:
        return None
    return upload(np.asarray(validity, dtype=bool), device)


@dataclasses.dataclass
class Column:
    """One device column (see the module docstring for the layout)."""

    dtype: T.DType
    data: torch.Tensor
    offsets: Optional[torch.Tensor] = None
    validity: Optional[torch.Tensor] = None
    # nested types: LIST → [element column]; STRUCT → one per field
    children: Optional[list] = None

    @property
    def num_rows(self) -> int:
        if self.dtype.id == T.TypeId.STRUCT:
            return self.children[0].num_rows
        if self.dtype.is_variable_width:
            return self.offsets.shape[0] - 1
        return self.data.shape[0]

    def __len__(self) -> int:
        return self.num_rows

    @property
    def device(self) -> torch.device:
        return self.data.device

    @property
    def null_count(self) -> int:
        """The null rows (one counted read of the device)."""
        if self.validity is None:
            return 0
        return syncs.scalar((~self.validity).sum())

    def validity_or_true(self) -> torch.Tensor:
        if self.validity is None:
            return torch.ones(self.num_rows, dtype=torch.bool,
                              device=self.device)
        return self.validity

    def validity_bitmask(self) -> torch.Tensor:
        """Arrow/cudf little-endian packed validity bitmask (uint8)."""
        return bitmask.pack_bits(self.validity_or_true())

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
        return Column(dtype, upload(storage, dev),
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
        doffs = upload(offsets, dev)
        hostcache.seed(doffs, offsets.astype(np.int64))
        return Column(T.string, upload(chars, dev), doffs,
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

    @staticmethod
    def list_from_pylist(values, element_dtype: T.DType | None = None,
                         device=None) -> "Column":
        """A LIST column from nested host lists (None ⇒ a null row).  The
        element column is built recursively (:meth:`from_pylist`), its
        type inferred unless ``element_dtype`` gives it."""
        dev = resolve_device(device)
        valid = np.asarray([v is not None for v in values], dtype=bool)
        flat = []
        lengths = np.zeros(len(values), dtype=np.int32)
        for i, v in enumerate(values):
            if v is not None:
                flat.extend(v)
                lengths[i] = len(v)
        offsets = np.zeros(len(values) + 1, dtype=np.int32)
        np.cumsum(lengths, out=offsets[1:])
        child = Column.from_pylist(flat, element_dtype, dev)
        doffs = upload(offsets, dev)
        hostcache.seed(doffs, offsets.astype(np.int64))
        return Column(T.list_(child.dtype), _empty(dev), doffs,
                      None if valid.all() else upload(valid, dev), [child])

    @staticmethod
    def struct_from_columns(fields: Sequence["Column"],
                            validity: np.ndarray | None = None,
                            device=None) -> "Column":
        """A STRUCT column of equal-length field columns, on ``device``
        (None: the fields' device)."""
        fields = list(fields)
        n = fields[0].num_rows
        for f in fields:
            if f.num_rows != n:
                raise ValueError("struct fields must have equal length")
        dev = fields[0].device if device is None else resolve_device(device)
        return Column(T.struct_(*[f.dtype for f in fields]), _empty(dev),
                      None, _validity_tensor(validity, dev), fields)

    @staticmethod
    def from_pylist(values, dtype: T.DType | None = None,
                    device=None) -> "Column":
        """A column from a flat host list (None ⇒ null), its type inferred
        unless ``dtype`` gives it: strings, lists (LIST, recursively) or
        numbers (the JAX package's ``_column_from_pylist``)."""
        if dtype is not None and dtype.id == T.TypeId.LIST:
            return Column.list_from_pylist(values, dtype.children[0], device)
        if dtype is not None and dtype.id == T.TypeId.STRING:
            return Column.strings_from_list(values, device)
        sample = next((v for v in values if v is not None), None)
        if dtype is None:
            if isinstance(sample, str):
                return Column.strings_from_list(values, device)
            if isinstance(sample, (list, tuple)):
                return Column.list_from_pylist(values, None, device)
        arr = np.asarray([0 if v is None else v for v in values])
        validity = (np.asarray([v is not None for v in values])
                    if any(v is None for v in values) else None)
        if dtype is not None:
            arr = arr.astype(dtype.storage)
        elif not values:
            arr = arr.astype(np.int32)
        return Column.from_numpy(arr, dtype, validity, device)

    def to_numpy(self) -> np.ndarray:
        """Host copy of a fixed-width payload (FLOAT64 as float64 values)."""
        return self.data.cpu().numpy()

    def to_pylist(self):
        """Host list with ``None`` for nulls (tests and debugging); a LIST
        row is a list, a STRUCT row a tuple of its fields."""
        valid = self.validity_or_true().cpu().numpy()
        if self.dtype.id == T.TypeId.STRING:
            offsets = hostcache.host_i64(self.offsets)
            chars = self.data.cpu().numpy().tobytes()
            return [chars[offsets[i]:offsets[i + 1]].decode("utf-8")
                    if valid[i] else None for i in range(self.num_rows)]
        if self.dtype.id == T.TypeId.LIST:
            offsets = hostcache.host_i64(self.offsets)
            elems = self.children[0].to_pylist()
            return [elems[offsets[i]:offsets[i + 1]] if valid[i] else None
                    for i in range(self.num_rows)]
        if self.dtype.id == T.TypeId.STRUCT:
            fields = [f.to_pylist() for f in self.children]
            return [tuple(f[i] for f in fields) if valid[i] else None
                    for i in range(self.num_rows)]
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


class DictColumn(Column):
    """A STRING column held as dictionary codes and a small dictionary.

    The counterpart of the JAX package's ``DictColumn``
    (``spark_rapids_jni_tpu/column.py:224-337``): ``codes`` is int32 [n]
    into ``dictionary`` (a plain STRING :class:`Column` of the entries, no
    validity), and the row validity rides on the codes.  A null row holds
    code 0 and materializes with zero length.

    The chars materialize at the output boundary: :meth:`materialize`, or
    any read of ``data`` / ``offsets``, builds the equivalent plain column
    once and keeps it.
    """

    def __init__(self, codes: torch.Tensor, dictionary: Column,
                 validity: Optional[torch.Tensor] = None):
        if codes.dtype != torch.int32 or codes.dim() != 1:
            raise TypeError("DictColumn codes must be int32 [n]")
        if dictionary.dtype.id != T.TypeId.STRING:
            raise TypeError("a DictColumn's dictionary is a STRING column")
        self.dtype = T.string
        self.codes = codes
        self.dictionary = dictionary
        self.validity = validity
        self._mat: Optional[Column] = None

    def materialize(self) -> Column:
        """The equivalent plain STRING column (memoized).

        The path of the JAX scan's ``_dict_str_chars``
        (``device_scan.py:513-527``): kernel B5 cuts the dictionary's chars
        into a padded word matrix [D, Lw], B6 gathers a row per code, and
        B2 packs each row's first length bytes at device offsets into the
        chars stream.  The dictionary offsets stay on the device; the syncs
        are the longest entry, the codes' bounds (B6's wrapper) and the
        chars total, all through ``utils.syncs``.

        Under capture or replay a column materialized already resolves
        its sizes again, as the JAX package's does
        (``spark_rapids_jni_tpu/column.py:258-268``): a fresh copy of it
        in the replay materializes, and the tape must hold the same sizes
        at the same places in both runs."""
        if self._mat is not None:
            if syncs.mode() != "normal":
                if self._has_chars(self._longest_entry()):
                    from .rowconv import bytepath
                    bytepath.check_codes(self.codes, self.dictionary.num_rows)
                    syncs.scalar(self._mat.offsets[-1])
                else:
                    self._check_empty_dictionary()
            return self._mat
        from .rowconv import bytepath, ragged
        from .rowconv.convert import _reinterpret
        dev = self.codes.device
        n = self.num_rows
        doffs = self.dictionary.offsets.to(torch.int64)
        offs = torch.zeros(n + 1, dtype=torch.int64, device=dev)
        lmax = self._longest_entry()
        if not self._has_chars(lmax):
            self._check_empty_dictionary()
            chars = torch.zeros(0, dtype=torch.uint8, device=dev)
        else:
            # rows padded to 16 bytes, so that B6 moves 16-byte vectors
            lw = -(-lmax // 16) * 4
            mat = bytepath.extract_rows(self.dictionary.data, doffs, lw * 4)
            rows = bytepath.gather_rows(mat, self.codes)
            lens = (doffs[1:] - doffs[:-1])[self.codes.to(torch.int64)]
            if self.validity is not None:
                lens = torch.where(self.validity, lens, 0)
            torch.cumsum(lens, 0, out=offs[1:])
            total = syncs.size(offs[-1])
            if total >= 2**31:
                raise ValueError(f"materialized chars ({total} bytes) exceed "
                                 "int32 offsets")
            # cut at the total, a no-op unless the tape is stale
            offs.clamp_(max=total)
            chars = ragged.pack_rows(_reinterpret(rows, torch.uint8), offs,
                                     total)
        self._mat = Column(T.string, chars, offs.to(torch.int32),
                           self.validity)
        return self._mat

    def _longest_entry(self) -> int:
        """The dictionary's longest entry in bytes (one synchronisation;
        0 for an empty dictionary, which needs none)."""
        doffs = self.dictionary.offsets
        if doffs.shape[0] < 2:
            return 0
        return syncs.size((doffs[1:] - doffs[:-1]).max())

    def _has_chars(self, lmax: int) -> bool:
        return self.dictionary.num_rows > 0 and lmax > 0 and self.num_rows > 0

    def _check_empty_dictionary(self) -> None:
        """Every code must name an entry: valid rows over an empty
        dictionary raise (one synchronisation)."""
        if (self.num_rows and self.dictionary.num_rows == 0
                and syncs.scalar(self.validity_or_true().any())):
            raise IndexError("DictColumn has valid rows but an empty "
                             "dictionary")

    # touching the bytes is the output boundary
    @property
    def data(self) -> torch.Tensor:
        return self.materialize().data

    @property
    def offsets(self) -> torch.Tensor:
        return self.materialize().offsets

    @property
    def num_rows(self) -> int:
        return self.codes.shape[0]

    @property
    def device(self) -> torch.device:
        return self.codes.device

    def to_pylist(self):
        """Host list decoded through the dictionary (no materialization)."""
        entries = self.dictionary.to_pylist()
        codes = self.codes.cpu().numpy()
        valid = self.validity_or_true().cpu().numpy()
        return [entries[c] if v else None for c, v in zip(codes, valid)]

    def __repr__(self) -> str:
        return (f"DictColumn(rows={self.num_rows}, "
                f"dictionary={self.dictionary.num_rows} entries)")


def as_dict_column(col: Column) -> Optional[DictColumn]:
    """``col`` as a :class:`DictColumn` if it is one, looking through a
    lazy wrapper (which this forces), else None: the dispatch point of the
    ops that read dictionary codes."""
    if isinstance(col, DictColumn):
        return col
    if isinstance(col, LazyColumn):
        inner = col._force()
        if isinstance(inner, DictColumn):
            return inner
    return None


class LazyColumn(Column):
    """A column whose payload is computed on first access.

    The counterpart of the JAX package's ``LazyColumn``
    (``spark_rapids_jni_tpu/column.py:353-425``): the row gathers of
    filters, joins, sorts and concatenations return these, so that a
    column the rest of the plan never reads is never gathered, and a
    STRING column never pays its gather's synchronisation.  Reading
    ``data``, ``offsets`` or ``validity`` runs the thunk once and keeps
    its column; ``dtype``, ``num_rows`` and ``device`` answer without
    forcing.  The thunk may return a :class:`DictColumn`; ops that read
    codes see it through :func:`as_dict_column`.
    """

    def __init__(self, dtype: T.DType, num_rows: int, device, thunk):
        self.dtype = dtype
        self._n = num_rows
        self._device = torch.device(device)
        self._thunk = thunk
        self._col: Optional[Column] = None

    def _force(self) -> Column:
        if self._col is None:
            self._col = self._thunk()
            self._thunk = None
        return self._col

    @property
    def forced(self) -> bool:
        return self._col is not None

    @property
    def data(self) -> torch.Tensor:
        return self._force().data

    @property
    def offsets(self) -> Optional[torch.Tensor]:
        return self._force().offsets

    @property
    def validity(self) -> Optional[torch.Tensor]:
        return self._force().validity

    @property
    def children(self) -> Optional[list]:
        return self._force().children

    @property
    def num_rows(self) -> int:
        return self._n

    @property
    def device(self) -> torch.device:
        return self._device

    def to_pylist(self):
        return self._force().to_pylist()

    def __repr__(self) -> str:
        state = "forced" if self.forced else "deferred"
        return f"LazyColumn({self.dtype.id.name}, rows={self._n}, {state})"


def force_column(col: Column) -> Column:
    """The eager form of ``col``: a :class:`LazyColumn`'s column, forced
    (a :class:`DictColumn` stays one), else ``col`` itself."""
    return col._force() if isinstance(col, LazyColumn) else col


@dataclasses.dataclass
class Table:
    """An ordered collection of equal-length columns.  A scanned table
    counts in ``host_decoded_cols`` the columns whose values were decoded
    on the host, and ``fused_filter_complete`` says that the scan's row
    filter evaluated every conjunct of its ``row_predicate``
    (``parquet.device_scan.scan_table``)."""

    columns: list[Column]
    host_decoded_cols: int = 0
    fused_filter_complete: bool = False

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

    @staticmethod
    def from_pydict(data: dict, dtypes: dict | None = None,
                    device=None) -> "Table":
        """A table from ``{name: host list}`` (None ⇒ null), each column's
        type from ``dtypes`` or inferred (the JAX package's
        ``Table.from_pydict``; the names are not kept)."""
        return Table([Column.from_pylist(values, (dtypes or {}).get(name),
                                         device)
                      for name, values in data.items()])
