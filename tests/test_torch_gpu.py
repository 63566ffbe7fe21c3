"""The port's CUDA kernels and its row conversion on the card.

Marked ``gpu``; each test asks a fixture for the card and skips without
one.  This file imports the port, torch and numpy only, so it runs on a
machine without JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q

(``--noconftest``: the suite's conftest sets up JAX for the other tests.)
"""

import numpy as np
import pytest
import torch

import spark_rapids_jni_tpu_torch as pt
from spark_rapids_jni_tpu_torch import interop
from spark_rapids_jni_tpu_torch.rowconv import ragged
from spark_rapids_jni_tpu_torch.rowconv import reference


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _ragged_inputs(rng, n, M, aligned):
    sizes = (rng.integers(1, M // 8 + 1, n) * 8 if aligned
             else rng.integers(0, M + 1, n))
    offs = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(sizes, out=offs[1:])
    dense = rng.integers(0, 256, (n, M)).astype(np.uint8)
    dense[np.arange(M) >= sizes[:, None]] = 0
    return torch.from_numpy(dense), torch.from_numpy(offs)


@pytest.mark.gpu
@pytest.mark.parametrize("n,M,aligned", [(4099, 64, True), (3001, 37, False),
                                         (1, 512, False), (20000, 8, False)])
def test_kernels_match_plain(cuda, n, M, aligned):
    rng = np.random.default_rng(n)
    dense, offs = (t.to(cuda) for t in _ragged_inputs(rng, n, M, aligned))
    total = int(offs[-1])
    before = ragged.launch_counts()

    flat = ragged.pack_rows(dense, offs, total)
    assert torch.equal(flat, ragged.pack_rows_plain(dense, offs, total))
    for width in (M, max(M // 3, 1), M + 13):      # whole rows, prefix, pad
        got = ragged.unpack_rows(flat, offs, width)
        assert torch.equal(got, ragged.unpack_rows_plain(flat, offs, width))

    # gappy, byte-granular segments out of the packed rows
    sizes = (offs[1:] - offs[:-1]) // 2
    dst = torch.cumsum(sizes + 3, 0) - sizes - 3
    dst_size = int(dst[-1] + sizes[-1]) + 5
    args = (flat, offs[:-1] + 1, dst, sizes, dst_size)
    got = ragged.segmented_copy(*args)
    assert torch.equal(got, ragged.segmented_copy_plain(*args))
    torch.cuda.synchronize()

    after = ragged.launch_counts()
    assert after["pack_rows"] == before["pack_rows"] + 1
    assert after["unpack_rows"] == before["unpack_rows"] + 3
    assert after["segmented_copy"] == before["segmented_copy"] + 1


@pytest.mark.gpu
def test_round_trip_matches_cpu_and_oracle(cuda):
    rng = np.random.default_rng(1)
    n = 5000
    cols = []
    for i in range(8):
        valid = rng.random(n) > 0.1
        if i % 3 == 0:
            lens = rng.integers(0, 30, n)
            offs = np.zeros(n + 1, np.int32)
            np.cumsum(lens, out=offs[1:])
            chars = rng.integers(32, 127, int(offs[-1])).astype(np.uint8)
            cols.append((int(pt.TypeId.STRING), 0, chars, offs, valid))
        else:
            cols.append((int(pt.TypeId.INT64), 0,
                         rng.integers(-99, 99, n), None, valid))
    gpu = interop.table_from_numpy(cols, device=cuda)
    rows = pt.convert_to_rows(gpu)[0]
    cpu_rows = pt.convert_to_rows(interop.table_from_numpy(cols, "cpu"))[0]
    want, _ = reference.to_rows_np(gpu)
    np.testing.assert_array_equal(rows.host_bytes(), cpu_rows.host_bytes())
    np.testing.assert_array_equal(rows.host_bytes(), want)
    back = interop.table_to_numpy(pt.convert_from_rows(rows, gpu.schema))
    for a, b in zip(cols, back):
        np.testing.assert_array_equal(a[2], b[2])
        np.testing.assert_array_equal(a[4], b[4])
        if a[3] is not None:
            np.testing.assert_array_equal(a[3], b[3])


@pytest.mark.gpu
def test_multi_batch_and_corrupt_slot(cuda):
    """Several batches on the card equal the CPU's; a string slot outside
    its row raises there too."""
    rng = np.random.default_rng(2)
    n = 3000
    lens = rng.integers(0, 40, n)
    offs = np.zeros(n + 1, np.int32)
    np.cumsum(lens, out=offs[1:])
    cols = [(int(pt.TypeId.STRING), 0,
             rng.integers(32, 127, int(offs[-1])).astype(np.uint8), offs,
             None),
            (int(pt.TypeId.INT16), 0, rng.integers(0, 9, n).astype(np.int16),
             None, rng.random(n) > 0.5)]
    gpu = pt.convert_to_rows(interop.table_from_numpy(cols, cuda),
                             max_batch_bytes=16384)
    cpu = pt.convert_to_rows(interop.table_from_numpy(cols, "cpu"),
                             max_batch_bytes=16384)
    assert len(gpu) == len(cpu) > 2
    for g, c in zip(gpu, cpu):
        np.testing.assert_array_equal(g.host_bytes(), c.host_bytes())
        np.testing.assert_array_equal(g.offsets.cpu().numpy(),
                                      c.offsets.numpy())
    schema = [pt.string, pt.int16]
    raw = gpu[0].data.clone()
    raw[4:8] = torch.tensor([0, 0, 1, 0], dtype=torch.uint8)   # length 65536
    with pytest.raises(ValueError, match="corrupt row"):
        pt.convert_from_rows(pt.RowBatch(raw, gpu[0].offsets), schema)
