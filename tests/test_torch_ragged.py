"""The port's three ragged kernels (pack, unpack, segmented copy) on the CPU.

On a CPU tensor each wrapper computes its plain PyTorch version; these
cases hold that version against the JAX package's XLA twins
(``ragged.pack_rows_xla``, ``unpack_rows_xla``, ``segmented_copy_xla``),
which are the CPU reference of the Pallas kernels (those have no interpret
mode), and against a direct numpy loop.  Exact byte equality throughout.
The CUDA kernels themselves are held against the same plain versions on
the card by ``tests/test_torch_gpu.py`` and ``chip_smoke.py``.
"""

import torch_one_thread  # noqa: F401  (first: one intra-op thread)
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from spark_rapids_jni_tpu.rowconv import ragged as jragged

from benchmarks.ragged_data import random_ragged
from spark_rapids_jni_tpu_torch.rowconv import ragged
from torch_ragged_cases import (SEGCOPY_EDGE_CASES, UNPACK_EDGE_CASES,
                                segcopy_loop, unpack_loop)


def _t(a, dtype=None):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=dtype))


# (rows, M, aligned): 8-byte rows like JCUDF, byte-granular rows, rows of
# one byte width, a single row, and empty rows
PACK_CASES = [(64, 48, True), (301, 64, False), (257, 33, False),
              (40, 8, False), (1, 16, False), (97, 1, False)]


@pytest.mark.parametrize("n,M,aligned", PACK_CASES)
def test_pack_rows_matches_xla(n, M, aligned):
    dense, offs, flat = random_ragged(np.random.default_rng(n), n, M, aligned)
    want = np.asarray(jragged.pack_rows_xla(jnp.asarray(dense), offs))
    np.testing.assert_array_equal(want, flat)
    got = ragged.pack_rows(_t(dense), _t(offs, np.int64), int(offs[-1]))
    np.testing.assert_array_equal(got.numpy(), want)


def _sized_rows(rng, sizes, M):
    """Random rows [n, M] zero past each row's size (at most M), their
    int64 offsets [n+1] and the packed bytes."""
    sizes = np.asarray(sizes, np.int64)
    offs = np.zeros(sizes.shape[0] + 1, np.int64)
    np.cumsum(sizes, out=offs[1:])
    dense = rng.integers(1, 256, (sizes.shape[0], M)).astype(np.uint8)
    dense[np.arange(M) >= sizes[:, None]] = 0
    return dense, offs, dense[np.arange(M) < sizes[:, None]]


# (M, sizes from a seeded generator): the edges of the pack kernel, whose
# CTAs take runs of up to 16 KiB / M rows (at most 1,024) and build their
# output ranges in 16-byte chunks, the partial chunks at either end shared
# with the neighbouring CTA
PACK_EDGE_CASES = {
    # rows of 0 and 1 byte at the materialized width of a CHAR(1) string
    "zero_one_byte": (16, lambda rng: rng.integers(0, 2, 6000)),
    # an all-null column: every row empty, nothing to pack
    "all_null": (16, lambda rng: np.zeros(3000, np.int64)),
    # rows of exactly M bytes
    "full_rows": (24, lambda rng: np.full(700, 24)),
    # M over 4 KiB and not a multiple of 16: three rows a CTA, read byte
    # by byte
    "wide": (5000, lambda rng: rng.integers(3000, 5001, 7)),
    # M over a CTA's 16 KiB: one row a CTA, some too long for its buffer
    "wider_than_a_cta": (20000, lambda rng: rng.integers(15000, 20001, 5)),
    # 10,000 one-byte rows: runs of 1,024 rows, 1 KiB of output each
    "one_byte_rows": (16, lambda rng: np.ones(10000, np.int64)),
    # one-byte rows among many empty ones
    "sparse_one_byte": (16, lambda rng: (rng.random(20000) < 0.3)
                        .astype(np.int64)),
    # SF1 l_shipinstruct's shape: entries of 17, 11, 4 and 16 bytes in
    # rows padded to 32
    "shipinstruct": (32, lambda rng: np.array([17, 11, 4, 16])
                     [rng.integers(0, 4, 5000)]),
}


@pytest.mark.parametrize("case", list(PACK_EDGE_CASES))
def test_pack_rows_kernel_edges_match_xla(case):
    M, sizes = PACK_EDGE_CASES[case]
    rng = np.random.default_rng(len(case))
    dense, offs, flat = _sized_rows(rng, sizes(rng), M)
    want = np.asarray(jragged.pack_rows_xla(jnp.asarray(dense), offs))
    np.testing.assert_array_equal(want, flat)
    got = ragged.pack_rows(_t(dense), _t(offs, np.int64), int(offs[-1]))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n,M,aligned", PACK_CASES)
def test_unpack_rows_matches_xla(n, M, aligned):
    dense, offs, flat = random_ragged(np.random.default_rng(n + 1), n, M,
                                      aligned)
    want = np.asarray(jragged.unpack_rows_xla(jnp.asarray(flat), offs, M))
    np.testing.assert_array_equal(want, dense)
    got = ragged.unpack_rows(_t(flat), _t(offs, np.int64), M)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("cut", [1, 7, 24])
def test_unpack_rows_prefix(cut):
    """Rows longer than M yield their first M bytes: the fixed region of
    JCUDF rows is pulled out this way."""
    n, M = 83, 40
    dense, offs, flat = random_ragged(np.random.default_rng(cut), n, M)
    want = np.asarray(jragged.unpack_rows_xla(jnp.asarray(flat), offs, cut))
    np.testing.assert_array_equal(
        want, np.where(np.arange(cut) < np.diff(offs)[:, None],
                       dense[:, :cut], 0))
    got = ragged.unpack_rows(_t(flat), _t(offs, np.int64), cut)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("case", list(UNPACK_EDGE_CASES))
def test_unpack_rows_kernel_edges_match_xla(case):
    """The edges of the unpack kernel's runs of rows and its windows, and
    SF1's shapes (``tests/torch_ragged_cases.py``)."""
    flat, offs, M = UNPACK_EDGE_CASES[case](np.random.default_rng(len(case)))
    want = np.asarray(jragged.unpack_rows_xla(jnp.asarray(flat), offs, M))
    np.testing.assert_array_equal(want, unpack_loop(flat, offs, M))
    got = ragged.unpack_rows(_t(flat), _t(offs, np.int64), M)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("case", list(SEGCOPY_EDGE_CASES))
def test_segmented_copy_kernel_edges_match_xla(case):
    """The edges of the segmented copy's runs of segments and its windows,
    and SF1's shapes: to_rows, from_rows and the PLAIN prefix strip."""
    src, so, do, sz, dst_size = SEGCOPY_EDGE_CASES[case](
        np.random.default_rng(len(case)))
    want = np.asarray(jragged.segmented_copy_xla(jnp.asarray(src), so, do, sz,
                                                 dst_size))
    np.testing.assert_array_equal(want, segcopy_loop(src, so, do, sz,
                                                     dst_size))
    got = ragged.segmented_copy(_t(src), _t(so, np.int64), _t(do, np.int64),
                                _t(sz, np.int64), dst_size)
    np.testing.assert_array_equal(got.numpy(), want)


def _segments(rng, S, k, max_size, max_gap):
    sizes = rng.integers(0, max_size, k)
    gaps = rng.integers(0, max_gap, k)
    src_offs = np.cumsum(sizes + gaps) - (sizes + gaps)
    dst_gaps = rng.integers(0, 5, k)
    dst_offs = np.cumsum(sizes + dst_gaps) - sizes
    src = rng.integers(1, 256, max(S, int(src_offs[-1] + sizes[-1]))
                       ).astype(np.uint8)
    return src, src_offs, dst_offs, sizes, int(dst_offs[-1] + sizes[-1])


def _segcopy_loop(src, src_offs, dst_offs, sizes, dst_size):
    out = np.zeros(dst_size, np.uint8)
    for so, do, sz in zip(src_offs, dst_offs, sizes):
        out[do:do + sz] = src[so:so + sz]
    return out


@pytest.mark.parametrize("seed,k,max_size,max_gap", [
    (7, 300, 60, 50),      # gappy source and destination
    (8, 1000, 3, 2),       # many tiny, often empty, segments
    (9, 17, 700, 9),       # long segments
])
def test_segmented_copy_matches_xla(seed, k, max_size, max_gap):
    src, so, do, sz, dst_size = _segments(np.random.default_rng(seed), 50000,
                                          k, max_size, max_gap)
    want = np.asarray(jragged.segmented_copy_xla(jnp.asarray(src), so, do, sz,
                                                 dst_size))
    np.testing.assert_array_equal(want, _segcopy_loop(src, so, do, sz,
                                                      dst_size))
    got = ragged.segmented_copy(_t(src), _t(so, np.int64), _t(do, np.int64),
                                _t(sz, np.int64), dst_size)
    np.testing.assert_array_equal(got.numpy(), want)


def test_segmented_copy_sources_out_of_order():
    """Sources may lie anywhere (the from_rows chars of several columns are
    gathered column after column from interleaved rows)."""
    rng = np.random.default_rng(12)
    src = rng.integers(0, 256, 4000).astype(np.uint8)
    sizes = rng.integers(0, 30, 64)
    so = rng.integers(0, 4000 - 30, 64)
    do = np.cumsum(sizes) - sizes
    dst_size = int(sizes.sum()) + 11
    got = ragged.segmented_copy(_t(src), _t(so, np.int64), _t(do, np.int64),
                                _t(sizes, np.int64), dst_size)
    np.testing.assert_array_equal(
        got.numpy(), _segcopy_loop(src, so, do, sizes, dst_size))


@pytest.mark.parametrize("dst_size,k", [(0, 0), (16, 0), (0, 3)])
def test_segmented_copy_empty(dst_size, k):
    z = torch.zeros(k, dtype=torch.int64)
    got = ragged.segmented_copy(torch.arange(8, dtype=torch.uint8), z, z,
                                z, dst_size)
    assert got.dtype == torch.uint8 and got.shape == (dst_size,)
    assert not got.any()


def test_zero_rows_and_empty_payloads():
    empty = ragged.pack_rows(torch.zeros((0, 8), dtype=torch.uint8),
                             torch.zeros(1, dtype=torch.int64), 0)
    assert empty.shape == (0,)
    rows = ragged.unpack_rows(torch.zeros(0, dtype=torch.uint8),
                              torch.zeros(4, dtype=torch.int64), 5)
    assert rows.shape == (3, 5) and not rows.any()


def test_cpu_tensors_take_the_plain_version_and_count_nothing():
    dense, offs, flat = random_ragged(np.random.default_rng(3), 20, 16)
    before = ragged.launch_counts()
    o = _t(offs, np.int64)
    packed = ragged.pack_rows(_t(dense), o, int(offs[-1]))
    assert torch.equal(packed, ragged.pack_rows_plain(_t(dense), o,
                                                      int(offs[-1])))
    ragged.unpack_rows(packed, o, 16)
    ragged.segmented_copy(packed, o[:-1], o[:-1], o[1:] - o[:-1],
                          int(offs[-1]))
    assert ragged.launch_counts() == before
    assert set(before) == {"pack_rows", "unpack_rows", "segmented_copy"}


@pytest.mark.parametrize("bad", ["dtype", "ndim", "contiguity", "length",
                                 "device"])
def test_wrappers_check_their_inputs(bad):
    dense = torch.zeros((4, 8), dtype=torch.uint8)
    offs = torch.arange(5, dtype=torch.int64) * 8
    if bad == "dtype":
        offs = offs.to(torch.int32)
    elif bad == "ndim":
        dense = dense.reshape(-1)
    elif bad == "contiguity":
        dense = torch.zeros((8, 4), dtype=torch.uint8).t()
    elif bad == "length":
        offs = offs[:-1]
    else:
        dense = torch.zeros((4, 8), dtype=torch.uint8, device="meta")
    with pytest.raises((TypeError, ValueError)):
        ragged.pack_rows(dense, offs, 32)
