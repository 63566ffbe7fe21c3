"""JCUDF row-layout calculator (pure host).

Re-derives the reference's row layout contract so the produced bytes are
bit-identical to spark-rapids-jni's JCUDF format:

* C-struct-like rows, each fixed-width column aligned to its own size, each
  variable-width (string) column occupying an 8-byte (offset:u32, len:u32)
  slot aligned to 4 — ``row_conversion.cu:1331-1370``
  (``compute_column_information``).
* Validity bytes (1 bit/column, little-endian within the byte) appended
  byte-aligned after the data — ``RowConversion.java:56-58``,
  ``row_conversion.cu:1303-1305``.
* Row padded to 8 bytes (``JCUDF_ROW_ALIGNMENT``, ``row_conversion.cu:62``).
  For string rows, the chars of all variable columns are appended in column
  order starting at the *unaligned* fixed+validity size, and the row is then
  padded to 8 — ``row_conversion.cu:216-261`` (``build_string_row_offsets``),
  ``:852-874`` (``copy_strings_to_rows``).
* Output is split into ≤2GB batches (int32 offset limit) —
  ``row_conversion.cu:64,97-103,1460-1539`` (``build_batches``); batch
  boundaries rounded to 32-row multiples (``:1504-1506``).
* Rows larger than 1KB are rejected (API contract,
  ``RowConversion.java:98-99``).

All of this is static host metadata.  It is a copy of the JAX package's
``rowconv/layout.py``, kept in the port so that the port imports nothing of
that package.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from .. import types as T

JCUDF_ROW_ALIGNMENT = 8
MAX_ROW_SIZE = 1024            # RowConversion.java:98-99
MAX_BATCH_BYTES = 2**31 - 1    # size_type max, row_conversion.cu:64
BATCH_ROW_MULTIPLE = 32        # row_conversion.cu:1504-1506


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


@dataclasses.dataclass(frozen=True)
class RowLayout:
    """Static row-layout metadata for one schema."""

    schema: tuple[T.DType, ...]
    column_starts: tuple[int, ...]      # byte offset of each column's slot
    column_sizes: tuple[int, ...]       # slot size in bytes
    validity_offset: int                # == end of last data slot
    validity_bytes: int                 # ceil(ncols / 8)
    fixed_plus_validity: int            # chars region starts here (strings)
    fixed_row_size: int                 # aligned row stride when fixed-only
    variable_column_indices: tuple[int, ...]

    @property
    def num_columns(self) -> int:
        return len(self.schema)

    @property
    def fixed_width_only(self) -> bool:
        return not self.variable_column_indices


def compute_row_layout(schema: Sequence[T.DType]) -> RowLayout:
    """Equivalent of ``compute_column_information`` (row_conversion.cu:1331-1370)."""
    starts: list[int] = []
    sizes: list[int] = []
    variable: list[int] = []
    offset = 0
    for i, dt in enumerate(schema):
        if dt.is_nested:
            # Same contract as the reference: JCUDF rows carry fixed-width
            # (incl. decimal128, fixed-width in libcudf) + string columns;
            # nested types are rejected at entry (row_conversion.cu:1268-1271
            # is_fixed_width || is_compound).
            raise TypeError(
                f"column {i}: {dt.id.name} is not supported in JCUDF rows")
        size = dt.itemsize
        offset = _round_up(offset, dt.row_alignment)
        if dt.is_variable_width:
            variable.append(i)
        starts.append(offset)
        sizes.append(size)
        offset += size

    validity_offset = offset
    validity_bytes = -(-len(schema) // 8)
    fixed_plus_validity = validity_offset + validity_bytes
    fixed_row_size = _round_up(fixed_plus_validity, JCUDF_ROW_ALIGNMENT)

    if fixed_row_size > MAX_ROW_SIZE and not variable:
        raise ValueError(
            f"row size {fixed_row_size} exceeds JCUDF limit of {MAX_ROW_SIZE} "
            "bytes (RowConversion.java:98-99)")

    return RowLayout(
        schema=tuple(schema),
        column_starts=tuple(starts),
        column_sizes=tuple(sizes),
        validity_offset=validity_offset,
        validity_bytes=validity_bytes,
        fixed_plus_validity=fixed_plus_validity,
        fixed_row_size=fixed_row_size,
        variable_column_indices=tuple(variable),
    )


def row_sizes_with_strings(layout: RowLayout,
                           string_lengths: np.ndarray) -> np.ndarray:
    """Per-row total byte size for a table with string columns.

    ``string_lengths``: int array [num_rows] — summed UTF-8 byte lengths of all
    variable-width columns per row.  Equivalent of ``build_string_row_offsets``
    (row_conversion.cu:216-261): fixed+validity + chars, rounded up to 8.
    """
    sizes = layout.fixed_plus_validity + np.asarray(string_lengths, dtype=np.int64)
    return (sizes + JCUDF_ROW_ALIGNMENT - 1) // JCUDF_ROW_ALIGNMENT * JCUDF_ROW_ALIGNMENT


@dataclasses.dataclass(frozen=True)
class BatchInfo:
    """Output batching decision (``build_batches``, row_conversion.cu:1460-1539)."""

    row_boundaries: tuple[int, ...]     # len nbatches+1, in rows
    batch_bytes: tuple[int, ...]        # total bytes per batch
    row_offsets_within_batch: list[np.ndarray]  # int32 [rows_in_batch + 1]

    @property
    def num_batches(self) -> int:
        return len(self.batch_bytes)


def build_batches(row_sizes: np.ndarray,
                  max_batch_bytes: int = MAX_BATCH_BYTES) -> BatchInfo:
    """Split rows into batches whose byte totals fit an int32 offset column.

    Mirrors the reference algorithm (row_conversion.cu:1460-1539): inclusive
    scan of row sizes, binary-search each ≤2GB boundary, round boundaries down
    to a 32-row multiple, then per-batch exclusive-scan offset columns.
    """
    row_sizes = np.asarray(row_sizes, dtype=np.int64)
    num_rows = row_sizes.shape[0]
    cum = np.concatenate([[0], np.cumsum(row_sizes)])
    total = int(cum[-1])

    boundaries = [0]
    while cum[boundaries[-1]] + max_batch_bytes < total:
        target = cum[boundaries[-1]] + max_batch_bytes
        # last row index whose cumulative end fits within the target
        nxt = int(np.searchsorted(cum, target, side="right")) - 1
        if nxt > boundaries[-1] + BATCH_ROW_MULTIPLE:
            nxt = boundaries[-1] + (nxt - boundaries[-1]) // BATCH_ROW_MULTIPLE * BATCH_ROW_MULTIPLE
        if nxt <= boundaries[-1]:
            raise ValueError("a single row exceeds the maximum batch size")
        boundaries.append(nxt)
    boundaries.append(num_rows)

    batch_bytes = []
    offsets = []
    for lo, hi in zip(boundaries[:-1], boundaries[1:]):
        batch_bytes.append(int(cum[hi] - cum[lo]))
        offsets.append((cum[lo:hi + 1] - cum[lo]).astype(np.int32))
    return BatchInfo(tuple(boundaries), tuple(batch_bytes), offsets)
