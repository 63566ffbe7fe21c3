"""Kernels B8 and B9, the slots of the fixed region of JCUDF rows, on the CPU.

On CPU tensors ``slots.pack_slots`` and ``slots.unpack_slots`` compute
their plain PyTorch versions.  These cases hold them against a numpy
formulation of the region (``torch_slots_cases.np_pack``) for every slot
width, column counts around a validity byte and past one launch's
columns, validity absent, present and strided, a row matrix wider than the
region, zero rows, the fixed-width path's row offsets, and a table split
across batches; check that the launches' byte ranges tile each row; and
that malformed inputs raise.  The CUDA kernels are held against
the plain versions on the card by ``tests/test_torch_gpu.py``.
"""

import torch_one_thread  # noqa: F401  (first: one intra-op thread)
import numpy as np
import pytest
import torch

import spark_rapids_jni_tpu_torch as pt
from spark_rapids_jni_tpu_torch.column import Column, Table
from spark_rapids_jni_tpu_torch.rowconv import slots
from torch_slots_cases import SCHEMAS, VALIDITY, make_case, np_pack

N = 37   # not a multiple of 8, 16 or a tile


@pytest.mark.parametrize("validity", VALIDITY)
@pytest.mark.parametrize("name", list(SCHEMAS))
def test_pack_slots_matches_numpy(name, validity):
    """Every byte of the rows, tight (the fixed-width path: the padding
    zeroed, and the rows' offsets) and as the first columns of a wider row
    matrix (the string path), whose other bytes stay as they were."""
    layout, datas, valids = make_case(name, N, validity, len(name))
    width = layout.fixed_row_size
    out = torch.full((N, width), 0xAB, dtype=torch.uint8)
    offsets = torch.full((N + 1,), -1, dtype=torch.int32)
    assert slots.pack_slots(layout, datas, valids, out, offsets) is out
    np.testing.assert_array_equal(out.numpy(),
                                  np_pack(layout, datas, valids, width))
    np.testing.assert_array_equal(offsets.numpy(), np.arange(N + 1) * width)

    fpv = layout.fixed_plus_validity
    M = -(-(fpv + 5) // 64) * 64
    big = torch.full((N, M), 0xCD, dtype=torch.uint8)
    slots.pack_slots(layout, datas, valids, big[:, :fpv])
    np.testing.assert_array_equal(big[:, :fpv].numpy(),
                                  np_pack(layout, datas, valids, fpv))
    assert bool((big[:, fpv:] == 0xCD).all())


@pytest.mark.parametrize("validity", VALIDITY)
@pytest.mark.parametrize("name", list(SCHEMAS))
def test_unpack_slots_matches_numpy(name, validity):
    """Each column's bytes back, contiguous, and the validity as bool
    [ncols, n], from rows back to back and from a view of wider rows."""
    layout, datas, valids = make_case(name, N, validity, len(name) + 1)
    rows = np_pack(layout, datas, valids, layout.fixed_row_size)
    wide = np.concatenate([rows, np.full((N, 9), 7, np.uint8)], axis=1)
    for r in (torch.from_numpy(rows), torch.from_numpy(wide)[:, :rows.shape[1]]):
        payloads, valid = slots.unpack_slots(layout, r)
        assert valid.dtype == torch.bool and valid.is_contiguous()
        assert tuple(valid.shape) == (len(datas), N)
        for c, (p, d, v) in enumerate(zip(payloads, datas, valids)):
            assert p.is_contiguous() and p.dtype == torch.uint8
            np.testing.assert_array_equal(
                p.numpy(), d.numpy().view(np.uint8).reshape(N, -1))
            want = np.ones(N, bool) if v is None else v.numpy()
            np.testing.assert_array_equal(valid[c].numpy(), want)


@pytest.mark.parametrize("name", ["w1", "cols9", "past_a_launch"])
def test_zero_rows(name):
    layout, datas, valids = make_case(name, 0, "some", 0)
    out = torch.empty((0, layout.fixed_row_size), dtype=torch.uint8)
    offsets = torch.full((1,), 9, dtype=torch.int32)
    slots.pack_slots(layout, datas, valids, out, offsets)
    assert offsets.tolist() == [0]
    payloads, valid = slots.unpack_slots(layout, out)
    assert [tuple(p.shape) for p in payloads] == [
        (0, w) for w in layout.column_sizes]
    assert tuple(valid.shape) == (len(datas), 0)


@pytest.mark.parametrize("ncols", [1, 7, 8, 9, 128, 129, 257])
def test_launch_groups_tile_each_row(ncols):
    """Launches of at most LAUNCH_COLUMNS columns, starting on a validity
    byte, whose byte ranges cover [0, width) once."""
    schema = [pt.int8 if c % 3 else pt.int16 for c in range(ncols)]
    layout = pt.compute_row_layout(schema)
    width = layout.fixed_row_size
    owner = np.zeros(width, np.int64)
    groups = slots.launch_groups(layout, width)
    assert groups[0][0] == 0 and groups[-1][1] == ncols
    for (c0, c1, (lo, hi), (vlo, vhi)), nxt in zip(groups, groups[1:] + [None]):
        assert c0 % 8 == 0 and 0 < c1 - c0 <= slots.LAUNCH_COLUMNS
        assert nxt is None or nxt[0] == c1
        # its slots lie inside its data range, its validity bits in its bytes
        assert lo <= layout.column_starts[c0]
        assert layout.column_starts[c1 - 1] + layout.column_sizes[c1 - 1] <= hi
        assert vlo == layout.validity_offset + c0 // 8
        assert vhi >= layout.validity_offset + -(-c1 // 8)
        owner[lo:hi] += 1
        owner[vlo:vhi] += 1
    assert (owner == 1).all()
    assert len(groups) == -(-ncols // slots.LAUNCH_COLUMNS)


@pytest.mark.parametrize("name", ["cols7", "store_sales", "past_a_launch"])
def test_split_batches_match_numpy(name):
    """A fixed-width table cut into batches: each batch's rows are the
    numpy region of its slice, and come back column for column."""
    layout, datas, valids = make_case(name, 300, "some", 5)
    table = Table([Column(dt, d, validity=v)
                   for dt, d, v in zip(layout.schema, datas, valids)])
    stride = layout.fixed_row_size
    batches = pt.convert_to_rows(table, max_batch_bytes=64 * stride + 3)
    assert len(batches) > 2
    want = np_pack(layout, datas, valids, stride)
    lo = 0
    for b in batches:
        n = b.num_rows
        np.testing.assert_array_equal(b.data.numpy().reshape(n, stride),
                                      want[lo:lo + n])
        back = pt.convert_from_rows(b, layout.schema)
        for c, col in enumerate(back.columns):
            np.testing.assert_array_equal(
                col.data.numpy().view(np.uint8).reshape(n, -1),
                datas[c][lo:lo + n].numpy().view(np.uint8).reshape(n, -1))
            want_v = (np.ones(n, bool) if valids[c] is None
                      else valids[c][lo:lo + n].numpy())
            np.testing.assert_array_equal(col.validity.numpy(), want_v)
        lo += n
    assert lo == 300


@pytest.mark.parametrize("fault", ["short_column", "narrow_out", "wrong_dtype",
                                   "columns_missing", "short_validity",
                                   "short_offsets", "offsets_of_spaced_rows"])
def test_pack_slots_refuses_malformed_inputs(fault):
    layout, datas, valids = make_case("cols7", N, "some", 3)
    out = torch.empty((N, layout.fixed_row_size), dtype=torch.uint8)
    offsets = None
    if fault == "short_column":
        datas[2] = datas[2][:-1]
    elif fault == "narrow_out":
        out = out[:, :layout.fixed_plus_validity - 1]
    elif fault == "wrong_dtype":
        out = out.to(torch.int16)
    elif fault == "columns_missing":
        datas = datas[:-1]
    elif fault == "short_validity":
        valids[1] = valids[1][:-2]
    elif fault == "short_offsets":
        offsets = torch.empty(N, dtype=torch.int32)
    else:
        out = torch.empty((N, 2 * layout.fixed_row_size),
                          dtype=torch.uint8)[:, :layout.fixed_row_size]
        offsets = torch.empty(N + 1, dtype=torch.int32)
    with pytest.raises((TypeError, ValueError)):
        slots.pack_slots(layout, datas, valids, out, offsets)
