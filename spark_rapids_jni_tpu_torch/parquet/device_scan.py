"""Device Parquet scan: Parquet file bytes in host memory → a device Table.

The port's counterpart of the JAX package's ``parquet/device_scan.py``
(``scan_table`` :1121, ``_walk_chunk_raw`` :66, ``_stage_column_parts``
:851, ``_scan_dict_str`` :667, ``_prune_row_groups`` :1083).  The split
between host and device is the same:

* host: footer parse, row-group pruning by footer statistics
  (``rowgroup_predicate``), page walk, decompression (SNAPPY in C, GZIP by
  ``zlib``), the dictionary pages' length prefixes, the char offsets of
  PLAIN string pages (a C walker, ``decode.byte_array_offsets``), the run
  headers of definition levels and dictionary codes
  (``rle_device.parse_runs``), and the DELTA_* pages, which are decoded
  here and staged as PLAIN values (``decode.delta_page``; the table's
  ``host_decoded_cols`` counts those columns).  Every byte range the
  device needs goes into one slab per file (``staging.Slab``), copied to
  the card once.
* device: PLAIN payloads and numeric dictionaries become owned words with
  kernel B7 (``bytepath.u8_to_u32``); PLAIN strings lose their length
  prefixes in one segmented copy (kernel B4, ``ragged.segmented_copy``);
  level and code runs expand with torch ops (``rle_device.expand``);
  dictionary gathers, INT96's days and nanoseconds, and the spread of
  present values over null slots are torch ops.  A dictionary-encoded
  string column stays a :class:`DictColumn` (codes and dictionary) unless
  ``dict_strings=False``; its chars materialize through B5 → B6 → B2.

Column kinds, as in the JAX package: ``plain`` (INT32, INT64, INT96,
FLOAT, DOUBLE and their DATE / TIMESTAMP / DECIMAL annotations, and
FIXED_LEN_BYTE_ARRAY decimals), ``dict`` (dictionary-encoded numerics and
FLBA decimals), ``bool`` (PLAIN BOOLEAN), ``plain_str`` (PLAIN strings)
and ``dict_str`` (dictionary-encoded strings); ``mixed`` and
``mixed_str`` are chunks whose dictionary fell back to PLAIN or DELTA
pages part way, as parquet-mr writes them: each run of pages decodes by
its own route, the present values join in page order, and a mixed string
column comes back materialized (the JAX package reads these on its host
path).  BYTE_ARRAY decimals are staged as strings and decoded from their
chars.  Decimals over byte strings (big-endian two's complement) become
(lo, hi) int64 lanes on the device, narrowed to the low lane for
precisions up to 18; booleans unpack as a bit-packed run of width 1
(``rle_device.expand``).  Row groups whose dictionaries differ are
merged: their dictionaries concatenate and their codes are rebased.
Anything else raises ``NotImplementedError`` naming what it met; there is
no fallback (the JAX package decodes BOOLEAN dictionaries on the host).
FLOAT64 is native ``torch.float64`` (the JAX package stores uint32 bit
pairs).
"""

from __future__ import annotations

import collections
import dataclasses
import struct as _struct
from typing import Optional

import numpy as np
import torch

from .. import types as T
from ..column import Column, DictColumn, Table, resolve_device
from ..rowconv import bytepath, ragged
from ..rowconv.convert import _reinterpret
from ..utils import knobs, metrics
from ..utils.tracing import func_range, traced
from . import decode as D
from . import rle_device as RLE
from . import rowfilter
from .footer import extract_footer_bytes
from .staging import Slab
from .thrift import parse_struct

# char offsets are int32, as in the JAX package
_MAX_CHARS = 2**31 - 1

#: since :func:`reset_counts`: ``rowgroups_pruned`` / ``rowgroups_kept``
#: by footer statistics, and of the fused row filter, ``rowfilter.scans``
#: (scans it pruned), ``rowfilter.rows_kept`` and ``rowfilter.complete``
#: (scans where it evaluated every conjunct)
COUNTS: collections.Counter = collections.Counter()


def reset_counts() -> None:
    COUNTS.clear()


# the JAX package's metric name of each count
_METRIC = {"rowgroups_pruned": "plan.scan.rowgroups_pruned",
           "rowgroups_kept": "plan.scan.rowgroups_kept",
           "rowfilter.scans": "parquet.rowfilter.fused_scans"}


def _count(key: str, n: int = 1) -> None:
    """Count ``n`` in :data:`COUNTS` and, as the JAX package's site does,
    in ``utils.metrics``."""
    COUNTS[key] += n
    metrics.count(_METRIC.get(key, "parquet." + key), n)


@dataclasses.dataclass
class _ChunkWalk:
    """What the page walk of one column chunk keeps for the device."""

    n: int = 0                        # values (rows) in the chunk
    # consecutive data pages of one kind, in page order: [kind, values]
    # with kind "plain" (PLAIN, or DELTA decoded on the host) or "dict"
    runs: list = dataclasses.field(default_factory=list)
    values: list = dataclasses.field(default_factory=list)   # PLAIN ranges
    # per PLAIN string page: its int32 char offsets (prefixes excluded)
    str_offsets: list = dataclasses.field(default_factory=list)
    dictionary: object = None         # PLAIN bytes, or (chars, offsets)
    n_dict: int = 0
    idx_plans: list = dataclasses.field(default_factory=list)
    # per data page: (RunPlan of its def levels, or None when no value is
    # null, and its value count)
    def_plans: list = dataclasses.field(default_factory=list)
    host_decoded: bool = False        # a DELTA page was decoded on the host


def _add_run(runs: list, kind: str, k: int) -> None:
    """Append ``k`` values of ``kind`` to a list of runs, joining a run of
    the same kind."""
    if runs and runs[-1][0] == kind:
        runs[-1][1] += k
    else:
        runs.append([kind, k])


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
             else D.PHYS_WIDTH.get(phys, 0))
    def_bw = D.bit_width(leaf.max_def)
    walk = _ChunkWalk()
    decoded = 0
    while decoded < num_values:
        header, raw = stream.next_page()
        ptype = header.get(D.PH.TYPE)
        usize = header.get(D.PH.UNCOMPRESSED_SIZE)
        if ptype == D.PAGE_DICTIONARY:
            m = header.get(D.PH.DICT_PAGE).get(D.DPH.NUM_VALUES)
            data = D.decompress(raw, codec, usize, leaf.path)
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
            data = D.decompress(raw, codec, usize, leaf.path)
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
                body = D.decompress(body, codec, usize - dl_len - rl_len,
                                    leaf.path)
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

        page_kind = "plain"
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
        elif enc == D.ENC_PLAIN and is_str:
            offs = D.byte_array_offsets(page_vals, n_present, leaf.path)
            # the page's records, length prefixes and chars, and no more
            walk.values.append(page_vals[:4 * n_present + int(offs[-1])])
            walk.str_offsets.append(offs)
        elif enc == D.ENC_PLAIN:
            need = n_present * width
            if len(page_vals) < need:
                raise ValueError(f"column {leaf.path}: PLAIN page holds "
                                 f"{len(page_vals)} bytes, needs {need}")
            walk.values.append(page_vals[:need])
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
        elif enc in (D.ENC_DELTA_BINARY_PACKED, D.ENC_DELTA_LENGTH_BYTE_ARRAY,
                     D.ENC_DELTA_BYTE_ARRAY):
            # decoded on the host, staged as PLAIN values
            got = D.delta_page(page_vals, enc, leaf, n_present)
            if is_str:
                walk.values.append(got[0])
                walk.str_offsets.append(got[1])
            else:
                walk.values.append(got)
            walk.host_decoded = True
        else:
            raise NotImplementedError(
                f"column {leaf.path}: encoding "
                f"{D.enum_name(D.ENCODING_NAMES, enc)} is not supported by the "
                "port's scan (PLAIN, dictionary and DELTA encodings are)")
        _add_run(walk.runs, page_kind, n_present)
        walk.n += n
        decoded += n
    return walk


@dataclasses.dataclass
class _ColumnSpec:
    """Where one column's bytes and run tables sit in the slab."""

    leaf: D.Leaf
    dtype: T.DType
    kind: str                         # "plain" | "dict" | "mixed" | "bool",
    #                                   or for strings "plain_str" |
    #                                   "dict_str" | "mixed_str"
    n: int
    n_present: int
    # runs of PLAIN and dictionary-coded present values, in page order
    runs: list = dataclasses.field(default_factory=list)
    n_plain: int = 0                  # present values in PLAIN runs
    n_coded: int = 0                  # present values in dictionary runs
    values: tuple = (0, 0)            # (byte offset, bytes): PLAIN values
    #                                   or PLAIN string records
    str_offsets: tuple = (0, 0)       # PLAIN strings: (byte offset, bytes)
    #                                   of int32 char offsets [n_plain+1]
    plain_char_offsets: Optional[np.ndarray] = None   # the same, host int64
    n_chars: int = 0
    dict_values: tuple = (0, 0)       # (byte offset, bytes): dictionary
    #                                   values or chars
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


def _column_kind(runs: list, leaf: D.Leaf) -> str:
    kinds = {k for k, _ in runs}
    if leaf.phys == D.PT_BOOLEAN:
        return "bool"
    is_str = leaf.phys == D.PT_BYTE_ARRAY
    if len(kinds) > 1:
        kind = "mixed"
    else:
        kind = kinds.pop() if kinds else ("dict" if is_str else "plain")
    return kind + "_str" if is_str else kind


def _stage_column(walks: list[_ChunkWalk], leaf: D.Leaf,
                  slab: Slab) -> _ColumnSpec:
    dt = leaf.logical_dtype()
    is_str = leaf.phys == D.PT_BYTE_ARRAY
    runs = []
    for w in walks:
        for kind, k in w.runs:
            _add_run(runs, kind, k)
    kind = _column_kind(runs, leaf)
    spec = _ColumnSpec(leaf, dt, kind, sum(w.n for w in walks),
                       sum(k for _, k in runs), [tuple(r) for r in runs])
    spec.n_plain = sum(k for r, k in runs if r == "plain")
    spec.n_coded = spec.n_present - spec.n_plain

    if any(p is not None for w in walks for p, _ in w.def_plans):
        tables = []
        for w in walks:
            for plan, k in w.def_plans:
                if plan is None:
                    tables.append(RLE.constant_run(k, leaf.max_def))
                else:
                    tables.append(RLE.run_table(plan, slab.add(plan.payload)))
        spec.def_runs = _queue_runs(slab, tables)

    if kind == "bool":
        spec.idx_runs = _queue_runs(
            slab, [RLE.run_table(plan, slab.add(plan.payload))
                   for w in walks for plan in w.idx_plans])
        return spec

    if kind in ("plain", "mixed"):
        spec.values = _queue_range(slab, [p for w in walks for p in w.values])
    elif kind in ("plain_str", "mixed_str"):
        # the pages' records back to back, then the column's char offsets
        spec.values = _queue_range(slab, [p for w in walks for p in w.values])
        offs = np.zeros(spec.n_plain + 1, np.int64)
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
        spec.plain_char_offsets = offs
        spec.str_offsets = _queue_range(slab, [offs.astype(np.int32)])
    if kind in ("plain", "plain_str"):
        return spec

    # dictionaries: one when every row group wrote the same, else all of
    # them concatenated with each row group's codes rebased; a PLAIN run
    # between two row groups' codes changes neither
    with_dict = [w for w in walks if w.dictionary is not None]
    same = all(_same_dictionary(w.dictionary, with_dict[0].dictionary, is_str)
               for w in with_dict[1:])
    merged = with_dict[:1] if same else with_dict
    spec.n_dict = sum(w.n_dict for w in merged)
    if is_str:
        spec.dict_values = _queue_range(slab,
                                        [w.dictionary[0] for w in merged])
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
        spec.dict_values = _queue_range(slab, [w.dictionary for w in merged])
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


# INT96: the Julian day of 1970-01-01, and 86,400 * 10^9 ns a day as an
# odd factor and a shift (86_400_000_000_000 == 1_318_359_375 << 16), so
# that (day - epoch) * odd stays inside int64 for any int32 day and only
# the shift wraps, as the JAX package's int64 product does
_JULIAN_UNIX_EPOCH = 2440588
_NS_PER_DAY_ODD, _NS_PER_DAY_SHIFT = 1_318_359_375, 16


def _int96_nanos(data: torch.Tensor, where: tuple[int, int]) -> torch.Tensor:
    """INT96 timestamps in the slab (8 little-endian bytes of nanoseconds
    in the day, then a 4-byte Julian day) → int64 nanoseconds since the
    epoch, ``(day − 2440588) · 86_400_000_000_000 + nanos`` with the JAX
    package's wrapping int64 arithmetic (``spark_rapids_jni_tpu/parquet/
    decode.py:317-326``): B7 makes the words, torch ops combine them."""
    start, nbytes = where
    k = nbytes // 12
    w = bytepath.u8_to_u32(data, start, 3 * k).view(k, 3).to(torch.int64)
    nanos = (w[:, 0] & 0xFFFFFFFF) | (w[:, 1] << 32)
    days = ((w[:, 2] - _JULIAN_UNIX_EPOCH) * _NS_PER_DAY_ODD
            ) << _NS_PER_DAY_SHIFT
    return days + nanos


def _values(spec: _ColumnSpec, data: torch.Tensor,
            where: tuple[int, int]) -> torch.Tensor:
    """A fixed-width range of the slab (PLAIN values or a dictionary) →
    the column's storage."""
    if spec.leaf.phys == D.PT_FIXED_LEN_BYTE_ARRAY:
        return _narrow(_flba_lanes(data, where, spec.leaf.type_len),
                       spec.dtype)
    if spec.leaf.phys == D.PT_INT96:
        return _int96_nanos(data, where)
    return _typed(data, where, spec.dtype)


def _plain_chars(spec: _ColumnSpec,
                 data: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """PLAIN BYTE_ARRAY records in the slab → (chars, int32 offsets
    [n_plain+1]) of the PLAIN runs' present values.  The records were
    queued back to back, so value i's chars start at the first record's
    offset + 4·(i+1) (its prefix and those before it) + its char offset;
    one segmented copy (B4) strips every prefix."""
    offs = _typed(data, spec.str_offsets, T.int32)
    o64 = offs.to(torch.int64)
    lens = o64[1:] - o64[:-1]
    first = torch.arange(1, spec.n_plain + 1, dtype=torch.int64,
                         device=data.device)
    src = spec.values[0] + 4 * first + o64[:-1]
    chars = ragged.segmented_copy(data, src, o64[:-1], lens, spec.n_chars)
    return chars, offs


def _string_column(spec: _ColumnSpec, chars: torch.Tensor,
                   offs: torch.Tensor, valid: Optional[torch.Tensor]) -> Column:
    """The present values' chars and offsets [n_present+1] → a string
    column, the lengths spread over the null slots."""
    if valid is not None:
        o64 = offs.to(torch.int64)
        full = torch.zeros(spec.n + 1, dtype=torch.int64, device=chars.device)
        torch.cumsum(_spread(o64[1:] - o64[:-1], valid, spec.n), 0,
                     out=full[1:])
        offs = full
    return Column(spec.dtype, chars, offs.to(torch.int32), valid)


def _codes(spec: _ColumnSpec, data: torch.Tensor, meta: torch.Tensor,
           checks: list) -> torch.Tensor:
    """The dictionary runs' codes, int32 [n_coded], rebased onto the merged
    dictionary; their bounds are checked at the scan's one
    synchronisation."""
    idx = RLE.expand(data, _runs(meta, spec.idx_runs), spec.n_coded)
    if spec.n_coded and spec.n_dict == 0:
        raise ValueError(f"column {spec.leaf.path}: codes but an empty "
                         "dictionary")
    if spec.n_coded:
        checks.append(((idx < 0) | (idx >= spec.n_dict)).any())
    return idx


def _in_range(idx: torch.Tensor, spec: _ColumnSpec) -> torch.Tensor:
    return idx.clamp(0, max(spec.n_dict - 1, 0))


def _dictionary(spec: _ColumnSpec, data: torch.Tensor) -> torch.Tensor:
    """The merged dictionary of a numeric or decimal column → the column's
    storage (BYTE_ARRAY decimals from the dictionary's chars)."""
    if spec.leaf.phys != D.PT_BYTE_ARRAY:
        return _values(spec, data, spec.dict_values)
    start, nbytes = spec.dict_values
    doffs = torch.from_numpy(spec.dict_offsets).to(data.device)
    return _narrow(_varlen_lanes(data[start:start + nbytes], doffs),
                   spec.dtype)


def _plain_values(spec: _ColumnSpec, data: torch.Tensor) -> torch.Tensor:
    """The PLAIN runs' present values → the column's storage (BYTE_ARRAY
    decimals from their chars)."""
    if spec.leaf.phys != D.PT_BYTE_ARRAY:
        return _values(spec, data, spec.values)
    chars, offs = _plain_chars(spec, data)
    return _narrow(_varlen_lanes(chars, offs.to(torch.int64)), spec.dtype)


def _run_bounds(spec: _ColumnSpec, kind: str) -> list[int]:
    """Where each run of ``kind`` starts and ends among that kind's
    present values: [0, end of the first run, ...]."""
    bounds = [0]
    for k, m in spec.runs:
        if k == kind:
            bounds.append(bounds[-1] + m)
    return bounds


def _interleave(spec: _ColumnSpec, plain, coded):
    """The PLAIN runs' and the dictionary runs' present values (or None
    where the column has no such run) in page order."""
    if coded is None or plain is None:
        return plain if coded is None else coded
    pieces, at = [], {"plain": 0, "dict": 0}
    src = {"plain": plain, "dict": coded}
    for kind, m in spec.runs:
        pieces.append(src[kind][at[kind]:at[kind] + m])
        at[kind] += m
    return torch.cat(pieces)


def _mixed_strings(spec: _ColumnSpec, data: torch.Tensor, idx: torch.Tensor,
                   valid: Optional[torch.Tensor]) -> Column:
    """A string column of PLAIN and dictionary runs → one materialized
    column: B4 strips the PLAIN records' prefixes, B5 → B6 → B2
    materialize the dictionary runs' chars (``DictColumn.materialize``),
    and the runs' chars and lengths concatenate in page order.  One more
    synchronisation reads where the dictionary runs' chars end."""
    dev = data.device
    chars_p, offs_p = _plain_chars(spec, data)
    start, nbytes = spec.dict_values
    dictionary = Column(T.string, data[start:start + nbytes],
                        torch.from_numpy(spec.dict_offsets.astype(np.int32))
                        .to(dev))
    mat = DictColumn(_in_range(idx, spec), dictionary).materialize()
    offs_d = mat.offsets.to(torch.int64)
    ends_d = torch.tensor(_run_bounds(spec, "dict"), dtype=torch.int64,
                          device=dev)
    chars_at = {"plain": spec.plain_char_offsets[_run_bounds(spec, "plain")]
                .tolist(), "dict": offs_d[ends_d].tolist()}
    chars_of = {"plain": chars_p, "dict": mat.data}
    lens_of = {"plain": (offs_p[1:] - offs_p[:-1]).to(torch.int64),
               "dict": offs_d[1:] - offs_d[:-1]}
    chars, lens, run = [], [], {"plain": 0, "dict": 0}
    at = {"plain": 0, "dict": 0}
    for kind, m in spec.runs:
        r = run[kind]
        chars.append(chars_of[kind][chars_at[kind][r]:chars_at[kind][r + 1]])
        lens.append(lens_of[kind][at[kind]:at[kind] + m])
        run[kind] += 1
        at[kind] += m
    chars = torch.cat(chars)
    if chars.shape[0] > _MAX_CHARS:
        raise ValueError(f"column {spec.leaf.path}: string chars "
                         f"({chars.shape[0]} bytes) exceed int32 offsets")
    offs = torch.zeros(spec.n_present + 1, dtype=torch.int64, device=dev)
    torch.cumsum(torch.cat(lens), 0, out=offs[1:])
    return _string_column(spec, chars, offs, valid)


def _decode(spec: _ColumnSpec, data: torch.Tensor, meta: torch.Tensor,
            dict_strings: bool, checks: list) -> Column:
    leaf, dt, n, kind = spec.leaf, spec.dtype, spec.n, spec.kind
    valid = None
    if spec.def_runs is not None:
        levels = RLE.expand(data, _runs(meta, spec.def_runs), n)
        valid = levels == leaf.max_def
    if kind == "bool":
        present = RLE.expand(data, _runs(meta, spec.idx_runs), spec.n_present)
        return Column(dt, _spread(present.to(torch.uint8), valid, n),
                      validity=valid)
    text = leaf.phys == D.PT_BYTE_ARRAY and not dt.is_decimal
    if kind == "plain_str" and text:
        chars, offs = _plain_chars(spec, data)
        return _string_column(spec, chars, offs, valid)
    plain = (_plain_values(spec, data)
             if kind in ("plain", "mixed", "plain_str", "mixed_str")
             and not text else None)
    idx = coded = None
    if kind in ("dict", "mixed", "dict_str", "mixed_str"):
        idx = _codes(spec, data, meta, checks)
    if not text:
        if idx is not None:
            dvals = _dictionary(spec, data)
            coded = (dvals[_in_range(idx, spec).to(torch.int64)]
                     if spec.n_dict else dvals[:0])
        return Column(dt, _spread(_interleave(spec, plain, coded), valid, n),
                      validity=valid)
    if kind == "mixed_str":
        return _mixed_strings(spec, data, idx, valid)
    start, nbytes = spec.dict_values
    dictionary = Column(
        T.string, data[start:start + nbytes].clone(),
        torch.from_numpy(spec.dict_offsets.astype(np.int32)).to(data.device))
    col = DictColumn(_spread(idx, valid, n), dictionary, valid)
    return col if dict_strings else col.materialize()


def _chunk_minmax(chunk, leaf: D.Leaf):
    """(min, max) from a column chunk's footer statistics, or None when
    they are absent or undecodable (the JAX package's ``_chunk_minmax``,
    ``spark_rapids_jni_tpu/parquet/device_scan.py:1000-1067``).  INT32 and
    INT64 decode to ints, the logical ``min_value``/``max_value`` first,
    then the deprecated MIN/MAX pair; BYTE_ARRAY gives the logical bounds
    as raw bytes (unsigned lexicographic, UTF8's order); a FIXED_LEN_BYTE_ARRAY
    DECIMAL decodes its logical bounds, big-endian two's complement, to
    the unscaled int.  BYTE_ARRAY and FLBA never read the deprecated pair,
    whose byte order was signed or undefined; every other type (INT96,
    floats, BOOLEAN) gives None.  Writers may truncate the logical bounds
    (min rounded down, max rounded up): they stay bounds, which is all a
    disjointness test needs."""
    md = chunk.get(D.CC.META_DATA)
    st = md.get(D.CMD.STATISTICS)
    if st is None:
        return None
    phys = leaf.phys
    if phys in (D.PT_INT32, D.PT_INT64):
        fmt, size = ("<i", 4) if phys == D.PT_INT32 else ("<q", 8)

        def dec(v):
            # b"\x00..." is a valid bound: test for None, not falsiness
            if not isinstance(v, (bytes, bytearray)) or len(v) != size:
                return None
            return _struct.unpack(fmt, bytes(v))[0]

        mn = dec(st.get(D.ST.MIN_VALUE))
        if mn is None:
            mn = dec(st.get(D.ST.MIN))
        mx = dec(st.get(D.ST.MAX_VALUE))
        if mx is None:
            mx = dec(st.get(D.ST.MAX))
    elif phys == D.PT_BYTE_ARRAY:
        mn, mx = st.get(D.ST.MIN_VALUE), st.get(D.ST.MAX_VALUE)
        mn = bytes(mn) if isinstance(mn, (bytes, bytearray)) else None
        mx = bytes(mx) if isinstance(mx, (bytes, bytearray)) else None
    elif phys == D.PT_FIXED_LEN_BYTE_ARRAY:
        try:
            if not leaf.logical_dtype().is_decimal:
                return None
        except NotImplementedError:
            return None
        width = leaf.type_len

        def dec(v):
            if not isinstance(v, (bytes, bytearray)) or (
                    width and len(v) != width):
                return None
            return int.from_bytes(bytes(v), "big", signed=True)

        mn = dec(st.get(D.ST.MIN_VALUE))
        mx = dec(st.get(D.ST.MAX_VALUE))
    else:
        return None
    if mn is None or mx is None:
        return None
    return mn, mx


def _group_disjoint(mn, mx, op: str, val) -> bool:
    """True when no value in [mn, mx] satisfies ``column <op> val``: the
    row group holds no matching row.  Nulls need no thought: a predicate
    fails them, and the statistics leave them out."""
    if op == "eq":
        return val < mn or val > mx
    if op == "lt":
        return mn >= val
    if op == "le":
        return mn > val
    if op == "gt":
        return mx <= val
    if op == "ge":
        return mx < val
    return False


def _prune_row_groups(groups_list, leaves: list[D.Leaf], conds) -> list[int]:
    """The indices of the row groups that may hold a row matching every
    ``(column, op, value)`` conjunct (int or bytes values; any one disjoint
    conjunct drops a group).  A group is kept where a column has no usable
    statistics, or where a literal's type does not match its statistic's;
    a conjunct on no column of the file, or with another op, drops nothing
    (the JAX package's ``_prune_row_groups``, ``device_scan.py:1083-1107``)."""
    name_to_idx = {leaf.name: i for i, leaf in enumerate(leaves)}
    kept = []
    for gi, rg in enumerate(groups_list):
        chunks = rg.get(D.RG.COLUMNS).values
        drop = False
        for cname, op, val in conds:
            ci = name_to_idx.get(cname)
            if ci is None:
                continue
            mm = _chunk_minmax(chunks[ci], leaves[ci])
            if mm is None or isinstance(val, bytes) != isinstance(mm[0],
                                                                   bytes):
                continue
            if _group_disjoint(mm[0], mm[1], op, val):
                drop = True
                break
        if not drop:
            kept.append(gi)
    return kept


def _column_indices(leaves: list[D.Leaf], columns) -> list[int]:
    names = [leaf.name for leaf in leaves]
    if columns is None:
        return list(range(len(leaves)))
    missing = [c for c in columns if c not in names]
    if missing:
        raise KeyError(f"no column named {missing} (the file has {names})")
    return [names.index(c) for c in columns]


@traced("parquet_scan_table_device")
def scan_table(file_bytes, columns: Optional[list[str]] = None,
               row_groups: Optional[list[int]] = None,
               dict_strings: bool = True, device=None,
               rowgroup_predicate=None, row_predicate=None) -> Table:
    """Decode a Parquet file held in host memory into a device Table.

    ``columns`` selects leaf columns by name (None: all), ``row_groups``
    selects row groups by index (None: all; file order is kept).
    ``rowgroup_predicate``, a list of ``(column, op, value)`` conjuncts
    (``op`` one of eq, lt, le, gt, ge; int or bytes values), drops the
    row groups whose footer statistics show that no row can match, before
    any page is read; what is left is intersected with ``row_groups``.
    When no group is left, the table has zero rows and each column's
    dtype.  ``row_predicate`` (the same conjunct shape) goes further
    under ``SRJT_FUSED_FILTER`` (on by default): every wanted column is
    walked first, and ``parquet.rowfilter.apply`` evaluates the conjuncts
    it supports on the walked pages and prunes the rows of every wanted
    column before anything is staged; the table's
    ``fused_filter_complete`` is True when it evaluated every conjunct.
    A column decoded on the host (a DELTA page) aborts the prune, as the
    JAX package's host fallback does; so does a column of another shape
    the filter does not rewrite.  With
    ``dict_strings`` (the JAX package's default ``SRJT_DICT_STRINGS=1``)
    a dictionary-encoded string column comes back as a
    :class:`DictColumn`; without it, materialized.  The table lands on
    the GPU unless ``device`` says otherwise.

    The table's ``host_decoded_cols`` counts the selected columns with a
    DELTA page, whose values were decoded on the host (the JAX package's
    ``parquet.host_fallback_cols``).

    Host synchronisations: the wait for the slab's copy, one check that
    every dictionary code names an entry (raises ``ValueError``), and, in
    a string column of PLAIN and dictionary runs, the materialization's
    and one read of where its dictionary runs' chars end."""
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
    if rowgroup_predicate:
        may_match = set(_prune_row_groups(groups_list, leaves,
                                          rowgroup_predicate))
        pruned = sum(g not in may_match for g in kept)
        _count("rowgroups_pruned", pruned)
        kept = [g for g in kept if g in may_match]
        _count("rowgroups_kept", len(kept))
        metrics.profile_op("scan.prune", rowgroups_pruned=pruned,
                           rowgroups_kept=len(kept))
    for i in want:
        if leaves[i].max_rep > 0:
            raise NotImplementedError(
                f"column {leaves[i].path}: repeated (LIST) columns are not "
                "supported by the port's scan")

    slab = Slab()
    complete = False
    # the spans are what tools/torch_profile_scan.py reads (the walk's
    # decompression is parquet.scan.decompress, in decode.decompress; the
    # walk's span also covers the staging, after the row filter's)
    with func_range("parquet.scan.walk"):
        walks = {i: [_walk_chunk(mv, groups_list[g].get(D.RG.COLUMNS)
                                 .values[i], leaves[i]) for g in kept]
                 for i in want}
    host_decoded = sum(any(w.host_decoded for w in walks[i]) for i in want)
    if row_predicate and knobs.get("SRJT_FUSED_FILTER") and not host_decoded:
        with func_range("parquet.scan.rowfilter"):
            pruned = rowfilter.apply(row_predicate, walks, leaves,
                                     [leaf.name for leaf in leaves], want)
        if pruned is not None:
            walks, complete, n_kept = pruned
            _count("rowfilter.scans")
            _count("rowfilter.rows_kept", n_kept)
            _count("rowfilter.complete", complete)
    with func_range("parquet.scan.walk"):
        specs = [_stage_column(walks[i], leaves[i], slab) for i in want]
    with func_range("parquet.scan.upload"):
        data, run_tables = slab.upload(dev)
    checks: list[torch.Tensor] = []
    try:
        with func_range("parquet.scan.decode"):
            cols = [_decode(s, data, run_tables, dict_strings, checks)
                    for s in specs]
            if checks and bool(torch.stack(checks).any()):
                raise ValueError("a dictionary code names no entry of its "
                                 "dictionary")
    finally:
        slab.release()
    out = Table(cols, host_decoded_cols=host_decoded,
                fused_filter_complete=complete)
    metrics.profile_op("scan", rows_out=out.num_rows, cols=len(want),
                       rowgroups=len(kept), fallback_cols=host_decoded)
    return out


# as in the JAX package: callers may name the scan read_table
read_table = scan_table
