"""The benchmark's arithmetic: peaks of the cards and the least bytes a
row conversion moves, computed from the table's shapes alone."""

from __future__ import annotations

import numpy as np

from .reference import jcudf

# published peaks by ``torch.cuda.get_device_name()`` (NVIDIA's data
# sheet, SXM part at its 700 W limit): HBM bytes a second
PEAK_BYTES_PER_S = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
}
OFFSET_BYTES = 4          # an int32 offset of a string column or a batch
CODE_BYTES = 4            # an int32 code of a dictionary string column


def column_bytes(columns: list, dictionaries=None) -> int:
    """Bytes of the columns: each fixed-width value at its width, each
    string column's chars and int32 offsets, a validity bit a row where a
    column has one.  ``dictionaries`` (column index to its entries' byte
    lengths) marks the string columns held as dictionaries: an int32 code
    a row, each entry's chars and an int32 offset an entry."""
    n = jcudf.num_rows(columns)
    dictionaries = dictionaries or {}
    total = 0
    for i, col in enumerate(columns):
        kind, values = col[0], col[1]
        if i in dictionaries:
            entries = np.asarray(dictionaries[i])
            total += (CODE_BYTES * n + int(entries.sum())
                      + OFFSET_BYTES * (entries.shape[0] + 1))
        elif kind == "string":
            chars, _ = values
            total += int(chars.shape[0]) + OFFSET_BYTES * (n + 1)
        else:
            total += n * np.dtype(kind).itemsize
        if len(col) > 2 and col[2] is not None:
            total += -(-n // 8)
    return total


def row_bytes(columns: list) -> int:
    """The JCUDF row bytes of the table."""
    return int(jcudf.row_sizes(columns).sum())


def rows_least_bytes(columns: list, dictionaries=None) -> int:
    """The least bytes a conversion moves: each column byte and each row
    byte and row offset read or written once.  ``dictionaries`` (see
    :func:`column_bytes`) describes the columns as ``convert_to_rows``
    reads them; ``convert_from_rows`` writes every string plainly."""
    n = jcudf.num_rows(columns)
    return (column_bytes(columns, dictionaries) + row_bytes(columns)
            + OFFSET_BYTES * (n + 1))
