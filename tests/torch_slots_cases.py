"""Inputs of the slot kernels B8 and B9 (``rowconv/slots.py``), shared by
the CPU tests (``test_torch_slots.py``) and the card's
(``test_torch_gpu.py``), and a numpy formulation of the fixed region that
both are held against.  numpy and torch only."""

import numpy as np
import torch

from spark_rapids_jni_tpu_torch import types as T
from spark_rapids_jni_tpu_torch.rowconv import slots
from spark_rapids_jni_tpu_torch.rowconv.layout import compute_row_layout

_CYCLE7 = ("INT8", "INT64", "INT16", "DECIMAL128", "INT32", "FLOAT64",
           "BOOL8")
_NARROW = ("INT8", "INT16", "INT32", "INT64")

# schemas by name: every slot width alone (1, 2, 4, 8 and 16 bytes), the
# column counts around a validity byte and past one launch's columns, a
# string slot (8 bytes at a 4-aligned start), and the two benchmark tables
# (TPC-DS store_sales' 7 columns; TPC-H lineitem's 16, as Spark writes it)
SCHEMAS = {
    "w1": ["INT8"] * 3,
    "w2": ["INT16"] * 3,
    "w4": ["INT32"] * 3,
    "w8": ["INT64"] * 3,
    "w16": ["DECIMAL128"] * 3,
    "cols1": ["DECIMAL128"],
    "cols7": list(_CYCLE7),
    "cols8": list(_CYCLE7) + ["INT32"],
    "cols9": ["STRING"] + list(_CYCLE7) + ["STRING"],
    "past_a_launch": [_NARROW[i % 4]
                      for i in range(slots.LAUNCH_COLUMNS + 1)],
    "store_sales": ["INT32"] * 4 + ["INT64"] * 2 + ["FLOAT64"],
    "lineitem": (["INT64"] * 3 + ["INT32"] + ["FLOAT64"] * 4
                 + ["STRING"] * 2 + ["TIMESTAMP_DAYS"] * 3
                 + ["STRING"] * 3),
}
VALIDITY = ("none", "some", "strided")


def schema_of(name: str) -> list:
    return [T.DType(T.TypeId[k]) if k != "DECIMAL128" else T.decimal128(2)
            for k in SCHEMAS[name]]


def make_case(name: str, n: int, validity: str, seed: int, device="cpu"):
    """(layout, datas, valids) on ``device``: each column's payload as the
    wrappers take it (a string column's (offset, length) int32 [n, 2]);
    ``validity`` "none" (no column has nulls), "some" (every other column
    has a bool vector) or "strided" (every column a column view of one
    bool [n, ncols] matrix, as the repartition join hands them)."""
    rng = np.random.default_rng(seed)
    schema = schema_of(name)
    layout = compute_row_layout(schema)
    datas = []
    for dt in schema:
        if dt.is_variable_width:
            datas.append(torch.from_numpy(
                rng.integers(0, 2**31, (n, 2)).astype(np.int32)))
        elif dt.id == T.TypeId.BOOL8:
            datas.append(torch.from_numpy(
                rng.integers(0, 2, n).astype(np.uint8)))
        else:
            raw = np.frombuffer(rng.bytes(n * dt.itemsize), np.uint8).copy()
            wide = dt.id == T.TypeId.DECIMAL128
            datas.append(torch.from_numpy(
                raw.view(np.int64 if wide else dt.storage)
                .reshape((n, 2) if wide else (n,))))
    ncols = len(schema)
    if validity == "none":
        valids = [None] * ncols
    elif validity == "some":
        valids = [torch.from_numpy(rng.random(n) < 0.9) if c % 2 else None
                  for c in range(ncols)]
    else:
        validm = torch.from_numpy(rng.random((n, ncols)) < 0.9).to(device)
        return (layout, [d.to(device) for d in datas],
                [validm[:, c] for c in range(ncols)])
    return (layout, [d.to(device) for d in datas],
            [None if v is None else v.to(device) for v in valids])


def np_pack(layout, datas, valids, width: int) -> np.ndarray:
    """The fixed region of each row, uint8 [n, width], in numpy: every
    slot's bytes, the validity bits (little-endian within a byte), zeros
    elsewhere."""
    n = datas[0].shape[0] if datas else 0
    out = np.zeros((n, width), np.uint8)
    for s, w, d in zip(layout.column_starts, layout.column_sizes, datas):
        out[:, s:s + w] = d.cpu().numpy().view(np.uint8).reshape(n, w)
    vm = np.stack([np.ones(n, bool) if v is None else v.cpu().numpy()
                   for v in valids], axis=1)
    vo = layout.validity_offset
    out[:, vo:vo + layout.validity_bytes] = np.packbits(
        vm, axis=1, bitorder="little")
    return out
