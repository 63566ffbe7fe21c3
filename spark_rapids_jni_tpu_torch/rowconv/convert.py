"""Row ↔ column transcode (JCUDF) on the GPU, in PyTorch.

The counterpart of the JAX package's ``rowconv/convert.py``
(``convert_to_rows`` :895-988, ``convert_from_rows`` :1084-1230), and of
the reference's ``row_conversion.cu``.  Output bytes are identical to both.

* Fixed-width tables: each column's little-endian bytes go into its slot
  of a uint8 [n, row_size] matrix, the validity bytes at
  ``validity_offset``, by one launch of kernel B8
  (:func:`.slots.pack_slots`), which writes every byte of the rows;
  reading back is one launch of B9 (:func:`.slots.unpack_slots`).  The JAX
  package's word-compose engines were TPU tuning and are not ported.
* Tables with strings, to rows: the contract of the JAX package's primary
  engine, xpack (``xpack.to_rows_var_x`` :562, ``_to_rows_x_jit``
  :465-523).  Each row is composed zero-padded in place in one dense
  [n, M] matrix a batch, as the JAX package builds its ``dense`` buffer:
  B4 of :mod:`.ragged` writes the chars and zeros everywhere else, B8
  writes the fixed slots and validity into its first columns, and kernel B1
  (:func:`.xpack.pack_windows`) packs the matrix's words at the
  8-byte-aligned row offsets, which stay on the device as words.  B1 packs
  every JCUDF row batch; B2 keeps the byte-granular packs
  (``DictColumn.materialize``, where chars start at any byte).  The rule
  follows from the data, so there is no knob between the two, and their
  launch counts show which one a run took.
* Tables with strings, from rows: modelled on the DMA branch of
  ``convert_from_rows`` (``:1120-1209``), B3 for the fixed region, B9 for
  its columns and one B4 for every column's chars.

Row, slot and char offsets stay on the device.  The host syncs are the
batch geometry on the way in (total bytes, widest row, char total) and, on
the way out, one stacked pull of the per-column char totals and the count
of corrupt slots (``row_conversion.cu:2215``).

A call runs on the device of the tensors it is given.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from .. import types as T
from ..column import Column, DictColumn, Table, as_dict_column, force_column
from ..faultinj.injector import fault_site
from ..utils import hostcache, metrics
from ..utils.tracing import traced
from . import ragged, slots, xpack
from .layout import (BATCH_ROW_MULTIPLE, JCUDF_ROW_ALIGNMENT, MAX_BATCH_BYTES,
                     MAX_ROW_SIZE, RowLayout, build_batches,
                     compute_row_layout)
from .slots import _reinterpret

# width of the dense row matrix is the widest row rounded up to this
# (convert.py:648), which keeps row starts of the matrix 64-byte aligned
_DENSE_ROW_ROUND = 64


@dataclasses.dataclass
class RowBatch:
    """One batch of JCUDF rows (≤ 2 GB): the LIST<INT8> column analog
    (``row_conversion.cu:1869-1889``)."""

    data: torch.Tensor      # uint8 [total_bytes]
    offsets: torch.Tensor   # int32 [num_rows + 1] byte offsets

    @property
    def num_rows(self) -> int:
        return self.offsets.shape[0] - 1

    @property
    def num_bytes(self) -> int:
        return self.data.shape[0]

    @property
    def device(self) -> torch.device:
        return self.data.device

    def host_bytes(self) -> np.ndarray:
        """The JCUDF byte stream as host uint8."""
        # the output boundary: the caller asked for the bytes on the host
        return self.data.cpu().numpy()  # srjt-lint: disable=trace-host-sync


# ---------------------------------------------------------------------------
# column bytes
# ---------------------------------------------------------------------------

def _from_bytes(b: torch.Tensor, dt: T.DType) -> torch.Tensor:
    """uint8 [n, itemsize] → the payload tensor of ``dt``."""
    v = _reinterpret(b, dt.torch_storage)
    return v if dt.id == T.TypeId.DECIMAL128 else v.reshape(-1)


def _fixed_region(layout: RowLayout, table: Table, out: torch.Tensor,
                  lens: Optional[torch.Tensor] = None,
                  offsets: Optional[torch.Tensor] = None) -> None:
    """Writes every byte of ``out``, uint8 [n, >= fixed_plus_validity] (a
    view of the row matrix): every column's slot, the validity bytes, and
    zeros in the gaps and past them (B8).

    ``lens``: int64 [nvar, n] string lengths; a string slot holds
    (fixed_plus_validity + chars of the earlier string columns, length) as
    two uint32 (``convert.py:578-607``).  ``offsets``: int32 [n + 1] that
    B8 also fills with the rows' byte offsets (rows back to back)."""
    if lens is not None:
        offs = layout.fixed_plus_validity + _prefix_over_columns(lens)
        pairs = torch.stack([offs, lens], dim=2).to(torch.int32)
    datas, vi = [], 0
    for col in table.columns:
        if col.dtype.is_variable_width:
            datas.append(pairs[vi])
            vi += 1
        else:
            datas.append(col.data)
    slots.pack_slots(layout, datas, [c.validity for c in table.columns], out,
                     offsets)


def _fixed_extract(layout: RowLayout, rows: torch.Tensor):
    """Inverse of :func:`_fixed_region` on uint8 [n, ≥ fixed_plus_validity]
    (B9): (payloads with None at strings, validity [ncols, n], per string
    column the (offset, length) slots as int64 [n, 2])."""
    payloads, valid = slots.unpack_slots(layout, rows)
    datas, pairs = [], []
    for dt, b in zip(layout.schema, payloads):
        if dt.is_variable_width:
            # the two uint32 of the slot, zero-extended
            pairs.append(_reinterpret(b, torch.int32).to(torch.int64)
                         & 0xFFFFFFFF)
            datas.append(None)
        else:
            datas.append(_from_bytes(b, dt))
    return datas, valid, pairs


def _check_row_size(worst: int) -> None:
    if worst > MAX_ROW_SIZE:
        raise ValueError(
            f"row size {worst} exceeds JCUDF limit {MAX_ROW_SIZE} "
            "(RowConversion.java:98-99)")


def _slice_column(col: Column, lo: int, hi: int) -> Column:
    """Rows [lo, hi) of a column; string offsets are rebased to zero."""
    if lo == 0 and hi == col.num_rows:
        return col
    v = None if col.validity is None else col.validity[lo:hi]
    if col.dtype.is_variable_width:
        # a host-born column's offsets have a host mirror: no copy back
        h = hostcache.peek(col.offsets)
        # one read of the batch's char bounds: the string path's batch
        # split, which no compiled query reaches (its rows go to the host)
        clo, chi = ((int(h[lo]), int(h[hi])) if h is not None
                    else col.offsets[[lo, hi]].tolist())  # srjt-lint: disable=trace-host-sync
        return Column(col.dtype, col.data[clo:chi],
                      col.offsets[lo:hi + 1] - clo, v)
    return Column(col.dtype, col.data[lo:hi], validity=v)


def slice_table(table: Table, lo: int, hi: int) -> Table:
    return Table([_slice_column(c, lo, hi) for c in table.columns])


# ---------------------------------------------------------------------------
# to rows
# ---------------------------------------------------------------------------

def _fixed_boundaries(n: int, stride: int, max_batch_bytes: int) -> list[int]:
    """The reference's split rule for constant-stride rows
    (``row_conversion.cu:1460-1539``, ``convert.py:916-926``): split while
    the rest overflows the cap, rounding a split to 32 rows only when more
    than 32 rows fit; the last batch is never rounded."""
    if stride > max_batch_bytes:
        raise ValueError("a single row exceeds the maximum batch size")
    boundaries = [0]
    while (n - boundaries[-1]) * stride > max_batch_bytes:
        k = max_batch_bytes // stride
        if k > BATCH_ROW_MULTIPLE:
            k = k // BATCH_ROW_MULTIPLE * BATCH_ROW_MULTIPLE
        boundaries.append(boundaries[-1] + k)
    boundaries.append(n)
    return boundaries


def _to_rows_fixed(layout: RowLayout, table: Table,
                   max_batch_bytes: int) -> list[RowBatch]:
    _check_row_size(layout.fixed_row_size)
    stride = layout.fixed_row_size
    n = table.num_rows
    dev = table.device
    bounds = _fixed_boundaries(n, stride, max_batch_bytes)
    out = []
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        sub = slice_table(table, lo, hi)
        # B8 writes every byte of the rows and their offsets: no fill
        rows = torch.empty((hi - lo, stride), dtype=torch.uint8, device=dev)
        offsets = torch.empty(hi - lo + 1, dtype=torch.int32, device=dev)
        _fixed_region(layout, sub, rows, offsets=offsets)
        out.append(RowBatch(rows.reshape(-1), offsets))
    return out


def _string_lengths(layout: RowLayout, table: Table) -> torch.Tensor:
    """int64 [nvar, n]: every string's length in bytes, a row per column."""
    return torch.stack(
        [(table[ci].offsets[1:] - table[ci].offsets[:-1]).to(torch.int64)
         for ci in layout.variable_column_indices])


def _prefix_over_columns(lens: torch.Tensor) -> torch.Tensor:
    """[nvar, n] → each string's char offset among its row's chars: the
    exclusive sum over the earlier string columns (a scan along the outer
    axis, which stays cheap however many rows there are)."""
    return torch.cumsum(lens, 0) - lens


def _row_sizes(layout: RowLayout, lens: torch.Tensor) -> torch.Tensor:
    """fixed+validity plus the row's chars, padded to 8
    (``build_string_row_offsets``, ``row_conversion.cu:216-261``)."""
    a = JCUDF_ROW_ALIGNMENT
    return (layout.fixed_plus_validity + lens.sum(0) + a - 1) // a * a


def _char_rows(layout: RowLayout, sub: Table, lens: torch.Tensor,
               M: int) -> torch.Tensor:
    """uint8 [n, M], the row matrix B1 packs, with each row's chars in
    place: string columns in order from ``fixed_plus_validity``, every
    other byte zero.  One segmented copy (B4) of all the string columns'
    chars, a segment a string, at destination ``r * M + fixed_plus_validity
    + prefix``; B4 writes every byte of its output, gaps included, and
    :func:`_fixed_region` then writes every byte of the fixed region."""
    var_idx = layout.variable_column_indices
    n = sub.num_rows
    datas = [sub[ci].data for ci in var_idx]
    chars = datas[0] if len(datas) == 1 else torch.cat(datas)
    bases = np.concatenate([[0], np.cumsum([d.shape[0] for d in datas])[:-1]])
    src = torch.stack([sub[ci].offsets[:-1].to(torch.int64) + int(base)
                       for ci, base in zip(var_idx, bases)])
    row_base = (torch.arange(n, dtype=torch.int64, device=sub.device) * M
                + layout.fixed_plus_validity)
    dst = row_base + _prefix_over_columns(lens)
    # segments in row order, so that destinations ascend
    src, dst, sizes = (t.t().reshape(-1) for t in (src, dst, lens))
    return ragged.segmented_copy(chars, src, dst, sizes, n * M).view(n, M)


def _to_rows_strings(layout: RowLayout, table: Table,
                     max_batch_bytes: int) -> list[RowBatch]:
    n = table.num_rows
    dev = table.device
    fpv = layout.fixed_plus_validity
    lens = _string_lengths(layout, table)
    sizes = _row_sizes(layout, lens)
    cum = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    torch.cumsum(sizes, 0, out=cum[1:])
    # the geometry sync: total bytes, widest row, total chars
    # (one stacked read at the JNI boundary; string rows are never
    # converted inside a compiled query)
    total, widest, chars = torch.stack(  # srjt-lint: disable=trace-host-sync
        [cum[-1], sizes.max() if n else cum[0], lens.sum()]).tolist()
    _check_row_size(widest)
    if total <= max_batch_bytes:
        parts = [(0, n, total, widest, chars)]
    else:
        # a table past one batch: its row sizes cross to the host once
        # to cut the batches there, as the JNI boundary does
        sizes_h = sizes.cpu().numpy()  # srjt-lint: disable=trace-host-sync
        chars_h = lens.sum(0).cpu().numpy()  # srjt-lint: disable=trace-host-sync
        b = build_batches(sizes_h, max_batch_bytes).row_boundaries
        parts = [(lo, hi, int(sizes_h[lo:hi].sum()),
                  int(sizes_h[lo:hi].max(initial=0)),
                  int(chars_h[lo:hi].sum())) for lo, hi in zip(b[:-1], b[1:])]

    out = []
    for lo, hi, nbytes, widest, nchars in parts:
        rows = hi - lo
        offsets = cum[lo:hi + 1] - cum[lo]
        if rows == 0:
            out.append(RowBatch(torch.zeros(0, dtype=torch.uint8, device=dev),
                                offsets.to(torch.int32)))
            continue
        sub = slice_table(table, lo, hi)
        sub_lens = lens[:, lo:hi]
        M = -(-widest // _DENSE_ROW_ROUND) * _DENSE_ROW_ROUND
        # one row matrix a batch: the chars first, then the fixed region
        # into its first fpv bytes
        if nchars:
            dense = _char_rows(layout, sub, sub_lens, M)
        else:
            dense = torch.zeros((rows, M), dtype=torch.uint8, device=dev)
        _fixed_region(layout, sub, dense[:, :fpv], sub_lens)
        # M is a multiple of 64 and row sizes of 8: the rows are whole
        # words, and B1 packs them at word offsets
        words = xpack.pack_windows(_reinterpret(dense, torch.int32),
                                   offsets // 4, nbytes // 4)
        out.append(RowBatch(_reinterpret(words, torch.uint8),
                            offsets.to(torch.int32)))
    return out


def _eager(col):
    """A column as rows read it: lazy columns forced, dictionary strings
    materialized."""
    col = force_column(col)
    return col.materialize() if isinstance(col, DictColumn) else col


@traced("convert_to_rows")
@fault_site("convert_to_rows")
def convert_to_rows(table: Table,
                    max_batch_bytes: Optional[int] = None) -> list[RowBatch]:
    """Table → JCUDF row batches (``convert_to_rows``,
    ``row_conversion.cu:1902-1960``), each at most ``max_batch_bytes``.

    Rows are the output boundary: a :class:`DictColumn` materializes its
    chars here, as the JAX package's ``.data`` access does."""
    max_batch_bytes = max_batch_bytes or MAX_BATCH_BYTES
    table = Table([_eager(c) for c in table.columns])
    layout = compute_row_layout(table.schema)
    if layout.fixed_width_only:
        out = _to_rows_fixed(layout, table, max_batch_bytes)
    else:
        out = _to_rows_strings(layout, table, max_batch_bytes)
    _record_transcode("rowconv.to_rows", table.num_rows, out)
    return out


def _record_transcode(prefix: str, rows: int, batches) -> None:
    """rows/bytes transcoded counters (shared by both directions), and the
    active plan-node profile's op event."""
    if metrics.recording():
        nbytes = sum(b.num_bytes for b in batches)
        metrics.count(f"{prefix}.rows", rows)
        metrics.count(f"{prefix}.bytes", nbytes)
        metrics.count(f"{prefix}.batches", len(batches))
        metrics.annotate(rows=rows, row_bytes=nbytes)
    if metrics._profile_op_hook is not None:
        metrics.profile_op(prefix, rows=rows,
                           bytes=sum(b.num_bytes for b in batches),
                           batches=len(batches))


def fixed_rows_to_matrix(batch: RowBatch, layout: RowLayout) -> torch.Tensor:
    """JCUDF fixed-width rows of an all-FLOAT32 schema → dense float32
    ``[n, k]`` (the ml/ handoff).

    For an all-FLOAT32 schema the k data slots sit at consecutive 4-byte
    offsets 0, 4, …, 4(k-1), so the matrix is a reinterpretation of the
    row bytes: a ``[n, row_size]`` view, its first ``4k`` bytes, viewed
    as float32.  No gather, no arithmetic, no host sync; the values are
    the source columns' bits."""
    if not layout.fixed_width_only:
        raise ValueError("fixed_rows_to_matrix requires a fixed-width layout")
    if any(dt.id != T.TypeId.FLOAT32 for dt in layout.schema):
        raise ValueError("fixed_rows_to_matrix requires an all-FLOAT32 schema")
    k = len(layout.schema)
    n = batch.num_rows
    rows = batch.data.view(n, layout.fixed_row_size)[:, :4 * k]
    return _reinterpret(rows, torch.float32)


# ---------------------------------------------------------------------------
# from rows
# ---------------------------------------------------------------------------

def _assemble(schema, datas, valid, chars, out_offsets) -> Table:
    """Columns from their parts.  Validity is always materialized, as the
    reference does (``row_conversion.cu:1299-1301``)."""
    cols = []
    vi = 0
    for ci, dt in enumerate(schema):
        if dt.is_variable_width:
            cols.append(Column(dt, chars[vi], out_offsets[vi], valid[ci]))
            vi += 1
        else:
            cols.append(Column(dt, datas[ci], validity=valid[ci]))
    return Table(cols)


def _from_rows_strings(layout: RowLayout, batch: RowBatch):
    """Chars of every string column out of the rows: (fixed payloads,
    validity, chars per column, int32 offsets per column)."""
    n = batch.num_rows
    dev = batch.device
    fpv = layout.fixed_plus_validity
    offs = batch.offsets.to(torch.int64)
    fixed = ragged.unpack_rows(batch.data, offs, fpv)
    datas, valid, pairs = _fixed_extract(layout, fixed)
    soff = torch.stack([s[:, 0] for s in pairs])           # [nvar, n]
    lens = torch.stack([s[:, 1] for s in pairs])
    nvar = lens.shape[0]
    row_sizes = offs[1:] - offs[:-1]
    bad = ((soff < fpv) | (soff + lens > row_sizes)).sum()
    # all columns' chars go out column after column: one scan over the
    # column-major lengths gives every destination offset
    ends = torch.zeros(nvar * n + 1, dtype=torch.int64, device=dev)
    torch.cumsum(lens.reshape(-1), 0, out=ends[1:])
    # the one sync on the way out: where each column's chars end, and the
    # corrupt-slot count
    # corrupt-slot count (the JNI boundary's documented read)
    meta = torch.cat([ends[n::n] if n else ends.new_zeros(nvar),  # srjt-lint: disable=trace-host-sync
                      bad[None]]).tolist()
    if meta[-1]:
        raise ValueError("corrupt row data: string slot outside its row")
    col_ends = [0] + meta[:-1]
    all_chars = ragged.segmented_copy(
        batch.data, (offs[:-1] + soff).reshape(-1), ends[:-1],
        lens.reshape(-1), col_ends[-1])
    chars = [all_chars[lo:hi] for lo, hi in zip(col_ends[:-1], col_ends[1:])]
    out_offs = [(ends[v * n:(v + 1) * n + 1] - col_ends[v]).to(torch.int32)
                for v in range(nvar)]
    return datas, valid, chars, out_offs


@traced("convert_from_rows")
@fault_site("convert_from_rows")
def convert_from_rows(batch: RowBatch, schema: Sequence[T.DType]) -> Table:
    """JCUDF rows → Table (``convert_from_rows``,
    ``row_conversion.cu:2032-2250``).  Takes exactly one batch."""
    schema = list(schema)
    layout = compute_row_layout(schema)
    n = batch.num_rows
    if batch.data.dtype != torch.uint8 or batch.data.dim() != 1:
        raise TypeError("RowBatch.data must be a flat uint8 tensor")
    if layout.fixed_width_only:
        if batch.num_bytes != n * layout.fixed_row_size:
            raise ValueError(
                f"row data holds {batch.num_bytes} bytes but offsets "
                f"describe {n} rows of {layout.fixed_row_size} bytes")
        rows = batch.data.view(n, layout.fixed_row_size)
        datas, valid, _ = _fixed_extract(layout, rows)
        out = _assemble(schema, datas, valid, [], [])
    else:
        out = _assemble(schema, *_from_rows_strings(layout, batch))
    _record_transcode("rowconv.from_rows", n, [batch])
    return out


# The reference keeps a second CUDA path for narrow fixed-width tables and
# tests against it (row_conversion.cu:425-551, 1962-2030); both names run
# the one path here, with the same schema checks.

def convert_to_rows_fixed_width_optimized(table: Table) -> list[RowBatch]:
    if not all(c.dtype.is_fixed_width for c in table.columns):
        raise ValueError("fixed-width-optimized path requires fixed-width schema")
    return convert_to_rows(table)


def convert_from_rows_fixed_width_optimized(batch: RowBatch,
                                            schema: Sequence[T.DType]) -> Table:
    if not all(dt.is_fixed_width for dt in schema):
        raise ValueError("fixed-width-optimized path requires fixed-width schema")
    return convert_from_rows(batch, schema)


# --- dictionary-codes passthrough -------------------------------------------
#
# A DictColumn reaching convert_to_rows materializes its chars, as JCUDF rows
# must carry the strings.  Where both ends speak this engine (a shuffle, a
# spill, a cache), the codes can travel through the fixed-width path
# instead, and the small dictionaries beside the rows (the JAX package's
# ``rowconv/convert.py:1053-1081``).

def dict_encode_for_rows(table: Table) -> tuple[Table, dict[int, Column]]:
    """Every dictionary string column swapped for its int32 codes.

    → ``(codes_table, dicts)``, ``dicts`` mapping a column index to its
    dictionary column.  With every string column dictionary-encoded the
    table is fixed-width only, and :func:`convert_to_rows` takes the
    constant-stride path; :func:`restore_dict_columns` puts the
    dictionaries back after :func:`convert_from_rows`."""
    dicts: dict[int, Column] = {}
    cols: list[Column] = []
    for i, c in enumerate(table.columns):
        d = as_dict_column(c)
        if d is not None:
            dicts[i] = d.dictionary
            cols.append(Column(T.int32, d.codes, validity=d.validity))
        else:
            cols.append(c)
    if dicts:
        metrics.count("rowconv.dict_cols", len(dicts))
    return Table(cols), dicts


def restore_dict_columns(table: Table, dicts: dict[int, Column]) -> Table:
    """The inverse of :func:`dict_encode_for_rows` after a row round
    trip: each codes column becomes a :class:`DictColumn` again."""
    cols = list(table.columns)
    for i, dcol in dicts.items():
        c = force_column(cols[i])
        cols[i] = DictColumn(c.data.to(torch.int32), dcol, c.validity)
    return Table(cols)
