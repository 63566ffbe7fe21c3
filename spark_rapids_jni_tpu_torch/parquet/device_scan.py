"""Device Parquet scan: Parquet file bytes in host memory → a device Table.

The port's counterpart of the JAX package's ``parquet/device_scan.py``
(``scan_table`` :1121, ``_walk_chunk_raw`` :66, ``_stage_column_parts``
:851, ``_scan_dict_str`` :667).  The split between host and device is the
same:

* host: footer parse, page walk, decompression, the dictionary pages'
  length prefixes, the char offsets of PLAIN string pages (a C walker,
  ``decode.byte_array_offsets``), and the run headers of definition
  levels and dictionary codes (``rle_device.parse_runs``).  Every byte
  range the device needs goes into one slab per file (``staging.Slab``),
  copied to the card once.
* device: PLAIN payloads and numeric dictionaries become owned words with
  kernel B7 (``bytepath.u8_to_u32``); PLAIN strings lose their length
  prefixes in one segmented copy (kernel B4, ``ragged.segmented_copy``);
  level and code runs expand with torch ops (``rle_device.expand``);
  dictionary gathers and the spread of present values over null slots are
  torch ops.  A dictionary-encoded string column stays a
  :class:`DictColumn` (codes and dictionary) unless
  ``dict_strings=False``; its chars materialize through B5 → B6 → B2.

Column kinds, as in the JAX package: ``plain`` (INT32, INT64, FLOAT,
DOUBLE and their DATE / TIMESTAMP / DECIMAL annotations, and
FIXED_LEN_BYTE_ARRAY decimals), ``dict`` (dictionary-encoded numerics and
FLBA decimals), ``bool`` (PLAIN BOOLEAN), ``plain_str`` (PLAIN
strings) and ``dict_str`` (dictionary-encoded strings).  BYTE_ARRAY
decimals are staged as strings and decoded from their chars.  Decimals
over byte strings (big-endian two's complement) become (lo, hi) int64
lanes on the device, narrowed to the low lane for precisions up to 18;
booleans unpack as a bit-packed run of width 1 (``rle_device.expand``).
Row groups whose dictionaries differ are merged: their dictionaries
concatenate and their codes are rebased.  Anything else, chunks that mix
PLAIN and dictionary pages included, raises ``NotImplementedError`` naming
what it met; there is no host fallback (the JAX package decodes
BYTE_ARRAY decimals and BOOLEAN dictionaries on the host).
FLOAT64 is native ``torch.float64`` (the JAX package stores uint32 bit
pairs).
"""

from __future__ import annotations

import dataclasses
import struct as _struct
from typing import Optional

import numpy as np
import torch
from torch.profiler import record_function

from .. import types as T
from ..column import Column, DictColumn, Table, resolve_device
from ..rowconv import bytepath, ragged
from ..rowconv.convert import _reinterpret
from . import decode as D
from . import rle_device as RLE
from .footer import extract_footer_bytes
from .staging import Slab
from .thrift import parse_struct

_WIDTH = {D.PT_INT32: 4, D.PT_INT64: 8, D.PT_FLOAT: 4, D.PT_DOUBLE: 8}
# char offsets are int32, as in the JAX package
_MAX_CHARS = 2**31 - 1


@dataclasses.dataclass
class _ChunkWalk:
    """What the page walk of one column chunk keeps for the device."""

    kind: Optional[str] = None        # "plain" | "dict"; None: no data page
    n: int = 0                        # values (rows) in the chunk
    n_present: int = 0                # non-null values
    values: list = dataclasses.field(default_factory=list)   # PLAIN ranges
    # per PLAIN string page: its int32 char offsets (prefixes excluded)
    str_offsets: list = dataclasses.field(default_factory=list)
    dictionary: object = None         # PLAIN bytes, or (chars, offsets)
    n_dict: int = 0
    idx_plans: list = dataclasses.field(default_factory=list)
    # per data page: (RunPlan of its def levels, or None when no value is
    # null, and its value count)
    def_plans: list = dataclasses.field(default_factory=list)


def _walk_chunk(mv: memoryview, chunk, leaf: D.Leaf) -> _ChunkWalk:
    md = chunk.get(D.CC.META_DATA)
    phys = md.get(D.CMD.TYPE)
    codec = md.get(D.CMD.CODEC, 0)
    num_values = md.get(D.CMD.NUM_VALUES)
    start = md.get(D.CMD.DATA_PAGE_OFFSET)
    dict_off = md.get(D.CMD.DICT_PAGE_OFFSET)
    if dict_off is not None and dict_off < start:
        start = dict_off
    total = md.get(D.CMD.TOTAL_COMPRESSED_SIZE)
    if start < 0 or start + total > len(mv):
        raise ValueError(f"column {leaf.path}: chunk lies outside the file")
    stream = D.PageStream(mv[start:start + total])
    # strings and BYTE_ARRAY decimals walk alike: chars and offsets
    is_str = phys == D.PT_BYTE_ARRAY
    is_bool = phys == D.PT_BOOLEAN
    width = (leaf.type_len if phys == D.PT_FIXED_LEN_BYTE_ARRAY
             else _WIDTH.get(phys, 0))
    def_bw = D.bit_width(leaf.max_def)
    walk = _ChunkWalk()
    decoded = 0
    while decoded < num_values:
        header, raw = stream.next_page()
        ptype = header.get(D.PH.TYPE)
        usize = header.get(D.PH.UNCOMPRESSED_SIZE)
        if ptype == D.PAGE_DICTIONARY:
            m = header.get(D.PH.DICT_PAGE).get(D.DPH.NUM_VALUES)
            data = D.decompress(raw, codec, usize)
            if is_bool:
                raise NotImplementedError(
                    f"column {leaf.path}: a BOOLEAN dictionary is not "
                    "supported by the port's scan")
            if is_str:
                walk.dictionary = D.decode_plain_strings(data, m, leaf.path)
            else:
                if len(data) < m * width:
                    raise ValueError(f"column {leaf.path}: dictionary page "
                                     "is shorter than its values")
                walk.dictionary = data[:m * width]
            walk.n_dict = m
            continue
        if ptype == D.PAGE_DATA:
            dph = header.get(D.PH.DATA_PAGE)
            n = dph.get(D.DPH.NUM_VALUES)
            enc = dph.get(D.DPH.ENCODING)
            data = D.decompress(raw, codec, usize)
            pos = 0
            levels = None
            if leaf.max_def > 0:
                (ln,) = _struct.unpack_from("<I", data, pos)
                levels = data[pos + 4:pos + 4 + ln]
                pos += 4 + ln
            page_vals = data[pos:]
        elif ptype == D.PAGE_DATA_V2:
            dph = header.get(D.PH.DATA_PAGE_V2)
            n = dph.get(D.DPH2.NUM_VALUES)
            enc = dph.get(D.DPH2.ENCODING)
            dl_len = dph.get(D.DPH2.DEF_LEVELS_BYTE_LENGTH, 0)
            rl_len = dph.get(D.DPH2.REP_LEVELS_BYTE_LENGTH, 0)
            body = raw[dl_len + rl_len:]
            if dph.get(D.DPH2.IS_COMPRESSED, True):
                body = D.decompress(body, codec, usize - dl_len - rl_len)
            levels = raw[rl_len:rl_len + dl_len] if leaf.max_def > 0 else None
            page_vals = body
        else:
            continue                    # index pages

        n_present = n
        plan = None
        if levels is not None:
            plan = RLE.parse_runs(levels, def_bw, n)
            n_present = RLE.present_count(plan, leaf.max_def)
        walk.def_plans.append((None if n_present == n else plan, n))

        if is_bool:
            # a PLAIN page's bits are one bit-packed run of width 1
            if enc != D.ENC_PLAIN:
                raise NotImplementedError(
                    f"column {leaf.path}: encoding "
                    f"{D.enum_name(D.ENCODING_NAMES, enc)} of BOOLEAN is not "
                    "supported by the port's scan (PLAIN is)")
            need = (n_present + 7) // 8
            if len(page_vals) < need:
                raise ValueError(f"column {leaf.path}: PLAIN BOOLEAN page "
                                 f"holds {len(page_vals)} bytes, needs {need}")
            walk.idx_plans.append(RLE.bit_packed_plan(page_vals[:need],
                                                      n_present))
            page_kind = "plain"
        elif enc == D.ENC_PLAIN and is_str:
            offs = D.byte_array_offsets(page_vals, n_present, leaf.path)
            # the page's records, length prefixes and chars, and no more
            walk.values.append(page_vals[:4 * n_present + int(offs[-1])])
            walk.str_offsets.append(offs)
            page_kind = "plain"
        elif enc == D.ENC_PLAIN:
            need = n_present * width
            if len(page_vals) < need:
                raise ValueError(f"column {leaf.path}: PLAIN page holds "
                                 f"{len(page_vals)} bytes, needs {need}")
            walk.values.append(page_vals[:need])
            page_kind = "plain"
        elif enc in (D.ENC_PLAIN_DICTIONARY, D.ENC_RLE_DICTIONARY):
            if walk.dictionary is None:
                raise ValueError(f"column {leaf.path}: dictionary-encoded "
                                 "page before its dictionary page")
            if n_present:
                if len(page_vals) == 0:
                    raise ValueError(f"column {leaf.path}: empty "
                                     "dictionary-encoded page")
                walk.idx_plans.append(
                    RLE.parse_runs(page_vals[1:], page_vals[0], n_present))
            page_kind = "dict"
        else:
            raise NotImplementedError(
                f"column {leaf.path}: encoding "
                f"{D.enum_name(D.ENCODING_NAMES, enc)} is not supported by the "
                "port's scan (PLAIN and dictionary encodings are)")
        if walk.kind not in (None, page_kind):
            raise NotImplementedError(
                f"column {leaf.path}: a chunk that mixes PLAIN and "
                "dictionary-encoded pages is not supported by the port's scan")
        walk.kind = page_kind
        walk.n += n
        walk.n_present += n_present
        decoded += n
    return walk


@dataclasses.dataclass
class _ColumnSpec:
    """Where one column's bytes and run tables sit in the slab."""

    leaf: D.Leaf
    dtype: T.DType
    kind: str                         # "plain" | "dict" | "bool" |
    #                                   "plain_str" | "dict_str"
    n: int
    n_present: int
    values: tuple = (0, 0)            # (byte offset, bytes): PLAIN values,
    #                                   PLAIN string records, dictionary
    #                                   values or chars
    str_offsets: tuple = (0, 0)       # PLAIN strings: (byte offset, bytes)
    #                                   of int32 char offsets [n_present+1]
    n_chars: int = 0
    n_dict: int = 0
    dict_offsets: Optional[np.ndarray] = None     # int64 [D+1], strings
    idx_runs: tuple = (0, 0)          # (int64 offset, runs): codes, or
    #                                   BOOLEAN values
    def_runs: Optional[tuple] = None  # (int64 offset, runs), None: no nulls


def _queue_runs(slab: Slab, tables: list[np.ndarray]) -> tuple[int, int]:
    table = (np.concatenate(tables) if tables
             else np.zeros((0, RLE.RUN_FIELDS), np.int64))
    return slab.add_meta(table), table.shape[0]


def _queue_range(slab: Slab, pieces) -> tuple[int, int]:
    """Queue byte ranges back to back: (offset of the first, total)."""
    start = slab.nbytes
    for p in pieces:
        slab.add(p)
    return start, slab.nbytes - start


def _same_dictionary(a, b, is_str: bool) -> bool:
    if is_str:
        return (np.array_equal(a[1], b[1])
                and np.array_equal(a[0], b[0]))
    return bytes(a) == bytes(b)


def _stage_column(walks: list[_ChunkWalk], leaf: D.Leaf,
                  slab: Slab) -> _ColumnSpec:
    dt = leaf.logical_dtype()
    is_str = leaf.phys == D.PT_BYTE_ARRAY
    kinds = {w.kind for w in walks} - {None}
    if len(kinds) > 1:
        raise NotImplementedError(
            f"column {leaf.path}: row groups that mix PLAIN and dictionary "
            "encodings are not supported by the port's scan")
    kind = kinds.pop() if kinds else ("dict" if is_str else "plain")
    if is_str:
        kind = "plain_str" if kind == "plain" else "dict_str"
    if leaf.phys == D.PT_BOOLEAN:
        kind = "bool"
    spec = _ColumnSpec(leaf, dt, kind, sum(w.n for w in walks),
                       sum(w.n_present for w in walks))

    if any(p is not None for w in walks for p, _ in w.def_plans):
        tables = []
        for w in walks:
            for plan, k in w.def_plans:
                if plan is None:
                    tables.append(RLE.constant_run(k, leaf.max_def))
                else:
                    tables.append(RLE.run_table(plan, slab.add(plan.payload)))
        spec.def_runs = _queue_runs(slab, tables)

    if kind == "plain":
        spec.values = _queue_range(slab, [p for w in walks for p in w.values])
        return spec

    if kind == "bool":
        spec.idx_runs = _queue_runs(
            slab, [RLE.run_table(plan, slab.add(plan.payload))
                   for w in walks for plan in w.idx_plans])
        return spec

    if kind == "plain_str":
        # the pages' records back to back, then the column's char offsets
        spec.values = _queue_range(slab, [p for w in walks for p in w.values])
        offs = np.zeros(spec.n_present + 1, np.int64)
        pos = 0
        for o in (o for w in walks for o in w.str_offsets):
            k = o.shape[0] - 1
            offs[pos + 1:pos + k + 1] = o[1:] + offs[pos]
            pos += k
        if offs[-1] > _MAX_CHARS:
            raise ValueError(f"column {leaf.path}: PLAIN string chars "
                             f"({offs[-1]} bytes) exceed int32 offsets")
        if dt.is_decimal:
            _check_decimal_widths(offs, leaf)
        spec.n_chars = int(offs[-1])
        spec.str_offsets = _queue_range(slab, [offs.astype(np.int32)])
        return spec

    # dictionaries: one when every row group wrote the same, else all of
    # them concatenated with each row group's codes rebased
    with_dict = [w for w in walks if w.dictionary is not None]
    same = all(_same_dictionary(w.dictionary, with_dict[0].dictionary, is_str)
               for w in with_dict[1:])
    merged = with_dict[:1] if same else with_dict
    spec.n_dict = sum(w.n_dict for w in merged)
    if is_str:
        spec.values = _queue_range(slab, [w.dictionary[0] for w in merged])
        offs = np.zeros(spec.n_dict + 1, np.int64)
        pos = 0
        for w in merged:
            o = w.dictionary[1]
            offs[pos + 1:pos + w.n_dict + 1] = o[1:] + offs[pos]
            pos += w.n_dict
        if offs[-1] > _MAX_CHARS:
            raise ValueError(f"column {leaf.path}: dictionary chars "
                             f"({offs[-1]} bytes) exceed int32 offsets")
        if dt.is_decimal:
            _check_decimal_widths(offs, leaf)
        spec.dict_offsets = offs
    else:
        spec.values = _queue_range(slab, [w.dictionary for w in merged])
    tables = []
    addend = 0
    for w in walks:
        for plan in w.idx_plans:
            tables.append(RLE.run_table(plan, slab.add(plan.payload), addend))
        if not same and w.dictionary is not None:
            addend += w.n_dict
    spec.idx_runs = _queue_runs(slab, tables)
    return spec


def _check_decimal_widths(offs: np.ndarray, leaf: D.Leaf) -> None:
    """BYTE_ARRAY decimals: every value fits the 16 bytes of the lanes
    (the offsets are the host's, so this costs no synchronisation)."""
    if offs.shape[0] > 1 and int(np.diff(offs).max()) > D.MAX_DECIMAL_BYTES:
        raise ValueError(f"column {leaf.path}: a BYTE_ARRAY decimal is wider "
                         f"than {D.MAX_DECIMAL_BYTES} bytes")


def _runs(meta: torch.Tensor, where: tuple[int, int]) -> torch.Tensor:
    off, r = where
    return meta[off:off + RLE.RUN_FIELDS * r].view(r, RLE.RUN_FIELDS)


def _spread(present: torch.Tensor, valid: Optional[torch.Tensor],
            n: int) -> torch.Tensor:
    """Present values [k] → [n] at the valid slots, zeros at the nulls
    (a cumulative count and a gather: no synchronisation)."""
    if valid is None:
        return present
    if present.shape[0] == 0:
        return torch.zeros((n,) + present.shape[1:], dtype=present.dtype,
                           device=valid.device)
    pos = (torch.cumsum(valid, 0) - 1).clamp(0, present.shape[0] - 1)
    mask = valid if present.dim() == 1 else valid[:, None]
    return torch.where(mask, present[pos], torch.zeros((), dtype=present.dtype,
                                                       device=valid.device))


def _typed(data: torch.Tensor, where: tuple[int, int],
           dt: T.DType) -> torch.Tensor:
    """A PLAIN range → owned words (kernel B7) → the column's storage."""
    start, nbytes = where
    return _reinterpret(bytepath.u8_to_u32(data, start, nbytes // 4),
                        dt.torch_storage)


def _narrow(lanes: torch.Tensor, dt: T.DType) -> torch.Tensor:
    """(lo, hi) decimal lanes → the column's storage: the lanes for
    DECIMAL128, the low lane for decimal32 and decimal64."""
    if dt.id == T.TypeId.DECIMAL128:
        return lanes
    return lanes[:, 0].to(dt.torch_storage).contiguous()


def _flba_lanes(data: torch.Tensor, where: tuple[int, int],
                width: int) -> torch.Tensor:
    """FIXED_LEN_BYTE_ARRAY decimals in the slab (big-endian two's
    complement of ``width`` <= 16 bytes) → int64 [k, 2] (lo, hi): each
    value sign-extended to 16 bytes, reversed to little-endian and read
    as two int64 words (the JAX package's ``_device_flba_decimal``)."""
    start, nbytes = where
    k = nbytes // width
    raw = data[start:start + k * width].view(k, width)
    full = torch.empty((k, 16), dtype=torch.uint8, device=data.device)
    if width < 16:
        fill = torch.where(raw[:, :1] >= 128, 255, 0).to(torch.uint8)
        full[:, :16 - width] = fill
    full[:, 16 - width:] = raw
    return full.flip(1).view(torch.int64)


def _varlen_lanes(chars: torch.Tensor, offs: torch.Tensor) -> torch.Tensor:
    """BYTE_ARRAY decimals (big-endian two's complement, at most 16 bytes
    each, an empty one 0) at int64 ``offs`` [k+1] of ``chars`` → int64
    [k, 2] (lo, hi): little-endian byte j of value i is its byte
    ``offs[i+1] - 1 - j``, or the sign's fill past its length."""
    k = offs.shape[0] - 1
    dev = chars.device
    if k == 0 or chars.shape[0] == 0:
        return torch.zeros((k, 2), dtype=torch.int64, device=dev)
    last = chars.shape[0] - 1
    lens = offs[1:] - offs[:-1]
    j = torch.arange(16, dtype=torch.int64, device=dev)
    inside = j < lens[:, None]
    first = chars[offs[:-1].clamp(0, last)]
    fill = torch.where((lens > 0) & (first >= 128), 255, 0).to(torch.uint8)
    src = (offs[1:, None] - 1 - j).clamp(0, last)
    return torch.where(inside, chars[src], fill[:, None]).view(torch.int64)


def _values(spec: _ColumnSpec, data: torch.Tensor,
            where: tuple[int, int]) -> torch.Tensor:
    """A fixed-width range of the slab (PLAIN values or a dictionary) →
    the column's storage."""
    if spec.leaf.phys == D.PT_FIXED_LEN_BYTE_ARRAY:
        return _narrow(_flba_lanes(data, where, spec.leaf.type_len),
                       spec.dtype)
    return _typed(data, where, spec.dtype)


def _plain_chars(spec: _ColumnSpec,
                 data: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """PLAIN BYTE_ARRAY records in the slab → (chars, int32 offsets
    [n_present+1]) of the present values.  The records were queued back
    to back, so value i's chars start at the first record's offset +
    4·(i+1) (its prefix and those before it) + its char offset; one
    segmented copy (B4) strips every prefix."""
    offs = _typed(data, spec.str_offsets, T.int32)
    o64 = offs.to(torch.int64)
    lens = o64[1:] - o64[:-1]
    first = torch.arange(1, spec.n_present + 1, dtype=torch.int64,
                         device=data.device)
    src = spec.values[0] + 4 * first + o64[:-1]
    chars = ragged.segmented_copy(data, src, o64[:-1], lens, spec.n_chars)
    return chars, offs


def _plain_strings(spec: _ColumnSpec, data: torch.Tensor,
                   valid: Optional[torch.Tensor]) -> Column:
    """PLAIN string records in the slab → a string column."""
    chars, offs = _plain_chars(spec, data)
    if valid is not None:
        o64 = offs.to(torch.int64)
        full = torch.zeros(spec.n + 1, dtype=torch.int64, device=data.device)
        torch.cumsum(_spread(o64[1:] - o64[:-1], valid, spec.n), 0,
                     out=full[1:])
        offs = full.to(torch.int32)
    return Column(spec.dtype, chars, offs, valid)


def _decode(spec: _ColumnSpec, data: torch.Tensor, meta: torch.Tensor,
            dict_strings: bool, checks: list) -> Column:
    leaf, dt, n = spec.leaf, spec.dtype, spec.n
    valid = None
    if spec.def_runs is not None:
        levels = RLE.expand(data, _runs(meta, spec.def_runs), n)
        valid = levels == leaf.max_def
    if spec.kind == "bool":
        present = RLE.expand(data, _runs(meta, spec.idx_runs), spec.n_present)
        return Column(dt, _spread(present.to(torch.uint8), valid, n),
                      validity=valid)
    if spec.kind == "plain":
        return Column(dt, _spread(_values(spec, data, spec.values), valid, n),
                      validity=valid)
    if spec.kind == "plain_str" and dt.is_decimal:
        chars, offs = _plain_chars(spec, data)
        lanes = _varlen_lanes(chars, offs.to(torch.int64))
        return Column(dt, _spread(_narrow(lanes, dt), valid, n),
                      validity=valid)
    if spec.kind == "plain_str":
        return _plain_strings(spec, data, valid)

    idx = RLE.expand(data, _runs(meta, spec.idx_runs), spec.n_present)
    if spec.n_present and spec.n_dict == 0:
        raise ValueError(f"column {leaf.path}: codes but an empty dictionary")
    if spec.n_present:
        # checked once for the whole scan, at its one synchronisation
        checks.append(((idx < 0) | (idx >= spec.n_dict)).any())
    start, nbytes = spec.values
    if spec.kind == "dict" or dt.is_decimal:
        if spec.kind == "dict":
            dvals = _values(spec, data, spec.values)
        else:           # BYTE_ARRAY decimals: the dictionary's chars
            doffs = torch.from_numpy(spec.dict_offsets).to(data.device)
            dvals = _narrow(_varlen_lanes(data[start:start + nbytes], doffs),
                            dt)
        safe = idx.clamp(0, max(spec.n_dict - 1, 0)).to(torch.int64)
        present = dvals[safe] if spec.n_dict else dvals[:0]
        return Column(dt, _spread(present, valid, n), validity=valid)

    dictionary = Column(
        T.string, data[start:start + nbytes].clone(),
        torch.from_numpy(spec.dict_offsets.astype(np.int32)).to(data.device))
    col = DictColumn(_spread(idx, valid, n), dictionary, valid)
    return col if dict_strings else col.materialize()


def _column_indices(leaves: list[D.Leaf], columns) -> list[int]:
    names = [leaf.name for leaf in leaves]
    if columns is None:
        return list(range(len(leaves)))
    missing = [c for c in columns if c not in names]
    if missing:
        raise KeyError(f"no column named {missing} (the file has {names})")
    return [names.index(c) for c in columns]


def scan_table(file_bytes, columns: Optional[list[str]] = None,
               row_groups: Optional[list[int]] = None,
               dict_strings: bool = True, device=None) -> Table:
    """Decode a Parquet file held in host memory into a device Table.

    ``columns`` selects leaf columns by name (None: all), ``row_groups``
    selects row groups by index (None: all; file order is kept).  With
    ``dict_strings`` (the JAX package's default ``SRJT_DICT_STRINGS=1``)
    a dictionary-encoded string column comes back as a
    :class:`DictColumn`; without it, materialized.  The table lands on
    the GPU unless ``device`` says otherwise.

    Host synchronisations: the wait for the slab's copy and one check that
    every dictionary code names an entry (raises ``ValueError``)."""
    dev = resolve_device(device)
    mv = memoryview(file_bytes).cast("B")
    meta = parse_struct(bytes(extract_footer_bytes(mv)))
    leaves = D.leaf_schema_elements(meta)
    want = _column_indices(leaves, columns)
    groups = meta.get(D.FMD.ROW_GROUPS)
    groups_list = list(groups.values) if groups is not None else []
    if row_groups is None:
        kept = list(range(len(groups_list)))
    else:
        kept = sorted(set(row_groups))
        bad = [g for g in kept if not 0 <= g < len(groups_list)]
        if bad:
            raise IndexError(f"row groups {bad} outside the file's "
                             f"{len(groups_list)}")
    for i in want:
        if leaves[i].max_rep > 0:
            raise NotImplementedError(
                f"column {leaves[i].path}: repeated (LIST) columns are not "
                "supported by the port's scan")

    slab = Slab()
    specs = []
    # the three spans are what tools/torch_profile_scan.py reads
    with record_function("parquet.scan.walk"):
        for i in want:
            walks = [_walk_chunk(mv, groups_list[g].get(D.RG.COLUMNS)
                                 .values[i], leaves[i]) for g in kept]
            specs.append(_stage_column(walks, leaves[i], slab))
    with record_function("parquet.scan.upload"):
        data, run_tables = slab.upload(dev)
    checks: list[torch.Tensor] = []
    try:
        with record_function("parquet.scan.decode"):
            cols = [_decode(s, data, run_tables, dict_strings, checks)
                    for s in specs]
            if checks and bool(torch.stack(checks).any()):
                raise ValueError("a dictionary code names no entry of its "
                                 "dictionary")
    finally:
        slab.release()
    return Table(cols)


# as in the JAX package: callers may name the scan read_table
read_table = scan_table
