"""The port's CUDA kernels and its row conversion on the card.

Marked ``gpu``; each test asks a fixture for the card and skips without
one.  This file imports the port, torch and numpy only, so it runs on a
machine without JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q

(``--noconftest``: the suite's conftest sets up JAX for the other tests.)
"""

import torch_one_thread  # noqa: F401  (first: one intra-op thread)
import numpy as np
import pytest
import torch

import spark_rapids_jni_tpu_torch as pt
from spark_rapids_jni_tpu_torch import _native, interop
from spark_rapids_jni_tpu_torch.rowconv import bytepath, ragged, slots, xpack
from spark_rapids_jni_tpu_torch.rowconv import reference
from torch_jni_env import (Jni, MockEnv, assert_same_batches,
                           assert_same_tables, jni_table, row_batches,
                           seeded_columns, table_columns, table_handle)
from torch_ragged_cases import (SEGCOPY_EDGE_CASES, SF1_SEGCOPY_CASES,
                                SF1_UNPACK_CASES, UNPACK_EDGE_CASES,
                                dictionary_to_rows, unpack_case)
from torch_slots_cases import SCHEMAS, VALIDITY, make_case, np_pack


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


def _launches_delta(before: dict, after: dict) -> dict:
    return {k: after[k] - before[k] for k in after}


@pytest.mark.gpu
@pytest.mark.parametrize("D,M,max_len", [(24, 32, 17), (1, 4, 4), (3000, 64, 90),
                                         (7, 21, 21), (500, 16, 0)])
def test_extract_and_gather_match_plain(cuda, D, M, max_len):
    """B5 on short, long (cut to M), empty and odd-width rows; B6 on word
    and 16-byte-vector widths, including a 1-row dictionary."""
    rng = np.random.default_rng(D + M)
    lens = rng.integers(0, max_len + 1, D)
    offs = np.zeros(D + 1, np.int64)
    np.cumsum(lens, out=offs[1:])
    flat = torch.from_numpy(rng.integers(0, 256, int(offs[-1]) + 3)
                            .astype(np.uint8)).to(cuda)
    before = bytepath.launch_counts()
    mat = bytepath.extract_rows(flat, offs, M)
    assert torch.equal(mat, bytepath.extract_rows_plain(flat, offs, M))
    idx = torch.from_numpy(rng.integers(0, D, 20011).astype(np.int32)).to(cuda)
    got = bytepath.gather_rows(mat, idx)
    assert torch.equal(got, bytepath.gather_rows_plain(mat, idx))
    torch.cuda.synchronize()
    delta = _launches_delta(before, bytepath.launch_counts())
    assert delta["extract_rows"] == 1 and delta["gather_rows"] == 1
    with pytest.raises(IndexError):
        bytepath.gather_rows(mat, torch.full((5,), D, dtype=torch.int32,
                                             device=cuda))


@pytest.mark.gpu
@pytest.mark.parametrize("start", [0, 1, 2, 3, 4, 5, 4093])
@pytest.mark.parametrize("n_words", [0, 1, 7, 100003])
def test_u8_to_u32_matches_plain_any_start(cuda, start, n_words):
    rng = np.random.default_rng(start * 7 + n_words)
    src = torch.from_numpy(rng.integers(0, 256, start + 4 * n_words + 5)
                           .astype(np.uint8)).to(cuda)
    got = bytepath.u8_to_u32(src, start, n_words)
    want = bytepath.u8_to_u32_plain(src, start, n_words)
    assert torch.equal(got, want)
    # the exact tail of the source: no byte after the last word
    tight = src[:start + 4 * n_words].clone()
    assert torch.equal(bytepath.u8_to_u32(tight, start, n_words), want)
    host = src.cpu().numpy()[start:start + 4 * n_words].view("<u4")
    np.testing.assert_array_equal(got.cpu().numpy().view(np.uint32), host)


@pytest.mark.gpu
@pytest.mark.parametrize("start", range(16))
def test_u8_to_u32_every_start_tight_source(cuda, start):
    """Every start % 16 (the vectors' alignment) with n_words % 4 of 0-3,
    small and large, on a source that ends exactly at its tensor's end."""
    rng = np.random.default_rng(start)
    before = bytepath.u8_to_u32.launches
    sizes = [1, 2, 3, 4, 5, 6, 7, 8, 9, 4096, 4097, 4098, 4099,
             1 << 20, (1 << 20) + 3]
    for n_words in sizes:
        src = torch.from_numpy(rng.integers(0, 256, start + 4 * n_words)
                               .astype(np.uint8)).to(cuda)
        got = bytepath.u8_to_u32(src, start, n_words)
        assert torch.equal(got, bytepath.u8_to_u32_plain(src, start,
                                                         n_words))
    torch.cuda.synchronize()
    assert bytepath.u8_to_u32.launches == before + len(sizes)


def _b2_sizes(case, rng):
    """(M, row sizes) of B2's edge cases (tests/test_torch_ragged.py) and
    of SF1's l_shipinstruct, as materialize hands it to B2."""
    if case == "zero_one_byte":
        return 16, rng.integers(0, 2, 6000)
    if case == "all_null":
        return 16, np.zeros(3000, np.int64)
    if case == "full_rows":
        return 24, np.full(700, 24)
    if case == "wide":
        return 5000, rng.integers(3000, 5001, 7)
    if case == "wider_than_a_cta":
        return 20000, rng.integers(15000, 20001, 5)
    if case == "one_byte_rows":
        return 16, np.ones(10000, np.int64)
    if case == "sparse_one_byte":
        return 16, (rng.random(20000) < 0.3).astype(np.int64)
    if case == "past_m":
        # rows longer than M: the bytes past M are zeros
        return 8, rng.integers(0, 40, 5000)
    return 32, np.array([17, 11, 4, 16])[rng.integers(0, 4, 6_001_215)]


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["zero_one_byte", "all_null", "full_rows",
                                  "wide", "wider_than_a_cta", "one_byte_rows",
                                  "sparse_one_byte", "past_m",
                                  "sf1_shipinstruct"])
def test_pack_rows_kernel_edges_match_plain(cuda, case):
    rng = np.random.default_rng(len(case))
    M, sizes = _b2_sizes(case, rng)
    sizes = torch.from_numpy(np.asarray(sizes, np.int64)).to(cuda)
    n = sizes.shape[0]
    offs = torch.zeros(n + 1, dtype=torch.int64, device=cuda)
    torch.cumsum(sizes, 0, out=offs[1:])
    dense = torch.randint(1, 256, (n, M), dtype=torch.uint8, device=cuda)
    dense[torch.arange(M, device=cuda) >= sizes[:, None]] = 0
    total = int(offs[-1])
    before = ragged.pack_rows.launches
    got = ragged.pack_rows(dense, offs, total)
    want = ragged.pack_rows_plain(dense, offs, total)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert ragged.pack_rows.launches == before + (1 if total else 0)


@pytest.mark.gpu
def test_pack_rows_byte_offsets_past_2gib(cuda):
    """Three rows whose byte offsets pass 2^31, the third at an odd one
    (rows longer than M pack as their M bytes and zeros): about 2 GiB of
    output."""
    M = 64
    sizes = [(1 << 30) + 5, (1 << 30) + 4, 10]
    offs = torch.tensor([0, sizes[0], sizes[0] + sizes[1], sum(sizes)],
                        dtype=torch.int64, device=cuda)
    dense = torch.randint(1, 256, (3, M), dtype=torch.uint8, device=cuda)
    dense[2, 10:] = 0
    total = sum(sizes)
    o1, o2 = int(offs[1]), int(offs[2])
    assert o2 > 2**31 and o2 % 2 == 1
    got = ragged.pack_rows(dense, offs, total)
    torch.cuda.synchronize()
    assert torch.equal(got[:M], dense[0])
    assert torch.equal(got[o1:o1 + M], dense[1])
    assert torch.equal(got[o2:], dense[2, :10])
    assert int(torch.count_nonzero(got)) == int(torch.count_nonzero(dense))
    del got
    torch.cuda.empty_cache()


def _on(device, flat, *offsets):
    """A uint8 buffer and int64 offset arrays (numpy) on ``device``."""
    return (torch.from_numpy(flat).to(device),
            *(torch.from_numpy(np.asarray(o, np.int64)).to(device)
              for o in offsets))


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(UNPACK_EDGE_CASES)
                         + list(SF1_UNPACK_CASES))
def test_unpack_rows_kernel_edges_match_plain(cuda, case):
    make = {**UNPACK_EDGE_CASES, **SF1_UNPACK_CASES}[case]
    flat, offs, M = make(np.random.default_rng(len(case)))
    flat, offs = _on(cuda, flat, offs)
    before = ragged.unpack_rows.launches
    got = ragged.unpack_rows(flat, offs, M)
    want = ragged.unpack_rows_plain(flat, offs, M)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert ragged.unpack_rows.launches == before + 1


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(SEGCOPY_EDGE_CASES)
                         + list(SF1_SEGCOPY_CASES))
def test_segmented_copy_kernel_edges_match_plain(cuda, case):
    make = {**SEGCOPY_EDGE_CASES, **SF1_SEGCOPY_CASES}[case]
    src, so, do, sz, dst_size = make(np.random.default_rng(len(case)))
    args = (*_on(cuda, src, so, do, sz), dst_size)
    before = ragged.segmented_copy.launches
    got = ragged.segmented_copy(*args)
    want = ragged.segmented_copy_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert ragged.segmented_copy.launches == before + 1


@pytest.mark.gpu
def test_ragged_copies_write_every_byte(cuda):
    """B4's wrapper allocates with torch.empty: a block the caching
    allocator hands back full of 0xFF must come out equal to the plain
    version, gaps and all; B3's likewise."""
    rng = np.random.default_rng(5)
    src, so, do, sz, dst_size = dictionary_to_rows(rng, 1 << 20)
    args = (*_on(cuda, src, so, do, sz), dst_size)
    junk = torch.full((dst_size,), 0xFF, dtype=torch.uint8, device=cuda)
    ptr = junk.data_ptr()
    del junk
    got = ragged.segmented_copy(*args)
    assert got.data_ptr() == ptr          # the 0xFF block came back
    assert torch.equal(got, ragged.segmented_copy_plain(*args))
    del got

    flat, offs, M = unpack_case(rng, 47, rng.integers(6, 18, 1 << 20) * 8)
    flat, offs = _on(cuda, flat, offs)
    junk = torch.full((offs.shape[0] - 1, M), 0xFF, dtype=torch.uint8,
                      device=cuda)
    ptr = junk.data_ptr()
    del junk
    got = ragged.unpack_rows(flat, offs, M)
    assert got.data_ptr() == ptr
    assert torch.equal(got, ragged.unpack_rows_plain(flat, offs, M))


@pytest.mark.gpu
def test_ragged_copies_broken_offsets_do_not_fault(cuda):
    """Offsets that break the contract (negative, past either end, out of
    order, negative sizes) must not make either kernel fault.  B3 turns
    such rows to zeros, as its plain version does; B4's bytes are then
    unspecified but it still covers dst."""
    rng = np.random.default_rng(11)
    src = torch.from_numpy(rng.integers(0, 256, 1000, dtype=np.uint8)
                           ).to(cuda)
    for trial in range(20):
        k = int(rng.integers(1, 5000))
        so, do, sz = (torch.from_numpy(rng.integers(lo, hi, k)).to(cuda)
                      for lo, hi in ((-100, 1200), (-100, 3000), (-10, 80)))
        out = ragged.segmented_copy(src, so, do, sz, 2500)
        offs = torch.from_numpy(rng.integers(-50, 1100, k + 1)).to(cuda)
        rows = ragged.unpack_rows(src, offs, 37)
        torch.cuda.synchronize()
        assert out.shape == (2500,)
        assert torch.equal(rows, ragged.unpack_rows_plain(src, offs, 37))
    # the context is sound: a good call still gives the right bytes
    so = torch.arange(0, 1000, 10, device=cuda)
    sz = torch.full_like(so, 5)
    do = torch.arange(0, 500, 5, device=cuda)
    got = ragged.segmented_copy(src, so, do, sz, 500)
    assert torch.equal(got, ragged.segmented_copy_plain(src, so, do, sz, 500))


@pytest.mark.gpu
def test_unpack_rows_byte_offsets_past_2gib(cuda):
    """Rows whose byte offsets pass 2^31, the third at an odd one: about
    2 GiB of source, each row's first M bytes out."""
    M = 64
    sizes = [(1 << 30) + 5, (1 << 30) + 4, 10]
    total = sum(sizes)
    flat = torch.randint(0, 256, (total,), dtype=torch.uint8, device=cuda)
    offs = torch.tensor([0, sizes[0], sizes[0] + sizes[1], total],
                        dtype=torch.int64, device=cuda)
    o1, o2 = int(offs[1]), int(offs[2])
    assert o2 > 2**31 and o2 % 2 == 1
    got = ragged.unpack_rows(flat, offs, M)
    torch.cuda.synchronize()
    assert torch.equal(got[0], flat[:M])
    assert torch.equal(got[1], flat[o1:o1 + M])
    assert torch.equal(got[2, :10], flat[o2:])
    assert not got[2, 10:].any()
    del flat, got
    torch.cuda.empty_cache()


@pytest.mark.gpu
def test_segmented_copy_byte_offsets_past_2gib(cuda):
    """Sources and destinations past 2^31 bytes, at odd offsets, with a
    2 GiB gap of zeros between two segments."""
    big = (1 << 31) + 100
    src = torch.randint(0, 256, (big,), dtype=torch.uint8, device=cuda)
    so = [5, (1 << 31) + 7, (1 << 31) + 51]
    do = [0, 3, (1 << 31) + 1]
    sz = [3, 40, 20]
    dst_size = (1 << 31) + 40
    args = [torch.tensor(v, dtype=torch.int64, device=cuda)
            for v in (so, do, sz)]
    got = ragged.segmented_copy(src, *args, dst_size)
    torch.cuda.synchronize()
    nonzero = 0
    for s, d, n in zip(so, do, sz):
        assert torch.equal(got[d:d + n], src[s:s + n])
        nonzero += int(torch.count_nonzero(src[s:s + n]))
    assert int(torch.count_nonzero(got)) == nonzero
    del src, got
    torch.cuda.empty_cache()


def _word_rows(rng, n, Mw, sizes, device):
    dense = rng.integers(-2**31, 2**31, (n, Mw), dtype=np.int64)
    dense = dense.astype(np.int32)
    dense[np.arange(Mw) >= np.minimum(sizes, Mw)[:, None]] = 0
    dst = np.zeros(n + 1, np.int64)
    np.cumsum(sizes, out=dst[1:])
    return torch.from_numpy(dense).to(device), torch.from_numpy(dst).to(device)


@pytest.mark.gpu
@pytest.mark.parametrize("n,Mw,lo,hi,extra", [
    (1 << 20, 24, 4, 24, 0),       # the 12-column table's shape
    (4099, 16, 2, 16, 3),          # many rows a block, trailing words
    (7, 2100, 1500, 2100, 0),      # rows wider than a block
    (3001, 40, 0, 40, 1030),       # empty rows, a block past the rows
    (1, 8, 8, 8, 0)])              # one row
def test_pack_windows_matches_plain(cuda, n, Mw, lo, hi, extra):
    rng = np.random.default_rng(n + Mw)
    sizes = rng.integers(lo // 2, hi // 2 + 1, n) * 2
    dense, dst = _word_rows(rng, n, Mw, sizes, cuda)
    total_w = int(dst[-1]) + extra
    before = xpack.pack_windows.launches
    got = xpack.pack_windows(dense, dst, total_w)
    want = xpack.pack_windows_plain(dense, dst, total_w)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert xpack.pack_windows.launches == before + 1


@pytest.mark.gpu
@pytest.mark.parametrize("Mw,shift", [(9, 0), (16, 0), (16, 1)])
def test_pack_windows_word_offsets_and_pointers(cuda, Mw, shift):
    """Offsets of any word (not pairs), an odd row width, and rows that
    start 4 bytes past an 8-byte boundary: the kernel's word-by-word
    path."""
    rng = np.random.default_rng(Mw + shift)
    n = 1500
    sizes = rng.integers(1, Mw + 1, n)
    dense, dst = _word_rows(rng, n, Mw, sizes, cuda)
    if shift:
        buf = torch.empty(n * Mw + shift, dtype=torch.int32, device=cuda)
        buf[shift:] = dense.reshape(-1)
        dense = buf[shift:].view(n, Mw)
        assert dense.data_ptr() % 8 == 4
    total_w = int(dst[-1]) + 5
    got = xpack.pack_windows(dense, dst, total_w)
    want = xpack.pack_windows_plain(dense, dst, total_w)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.gpu
def test_pack_windows_byte_offsets_past_2gib(cuda):
    """Three rows whose byte offsets pass 2^31 (word offsets stay int64 up
    to the kernel): about 2 GiB of output."""
    sizes = np.array([1 << 28, (1 << 28) + 2, 10])
    dense, dst = _word_rows(np.random.default_rng(3), 3, 64, sizes, cuda)
    total_w = int(dst[-1])
    assert 4 * int(dst[2]) > 2**31
    got = xpack.pack_windows(dense, dst, total_w)
    torch.cuda.synchronize()
    assert torch.equal(got[int(dst[2]):], dense[2, :10])
    assert torch.equal(got[:64], dense[0])
    assert torch.equal(got[int(dst[1]):int(dst[1]) + 64], dense[1])
    assert int(torch.count_nonzero(got)) == int(torch.count_nonzero(dense))
    del got
    torch.cuda.empty_cache()


# SF1 lineitem's 16 columns as to_rows hands them to B1: 118 fixed bytes,
# l_returnflag and l_linestatus, the dictionary strings l_shipinstruct and
# l_shipmode, and l_comment of 10-43 chars, rows padded to 8 bytes, M = 192
SF1_FIXED, SF1_M = 118, 192


def _sf1_row_words(rng, n):
    chars = (2 + np.array([17, 11, 4, 16])[rng.integers(0, 4, n)]
             + np.array([7, 3, 4, 4, 5, 4, 3])[rng.integers(0, 7, n)]
             + rng.integers(10, 44, n))
    return (SF1_FIXED + chars + 7) // 8 * 2


def _b1_case(case, rng):
    """(n, Mw, row sizes in words, words past the last row) of B1's edge
    cases; the sizes are any word count where the contract allows it."""
    if case == "zero_word_rows":
        return 5000, 16, rng.integers(0, 5, 5000) * 2 * (rng.random(5000)
                                                          < 0.5), 0
    if case == "longer_than_mw":
        return 5000, 8, rng.integers(0, 40, 5000), 3
    if case == "mw_3000":
        return 7, 3000, rng.integers(2000, 3001, 7), 0
    if case == "mw_3000_longer":
        return 5, 3000, rng.integers(3000, 9000, 5), 11
    if case == "wider_than_tile":
        return 5, 5000, rng.integers(3000, 5001, 5), 0
    if case == "one_row":
        return 1, 48, np.array([40]), 0
    if case == "odd_starts":
        return 20000, 32, rng.integers(1, 33, 20000), 1
    if case == "odd_width":
        return 3000, 45, rng.integers(0, 46, 3000), 2
    return 6_001_215, SF1_M // 4, _sf1_row_words(rng, 6_001_215), 0


def _b1_inputs(case, rng, device):
    n, Mw, sizes, extra = _b1_case(case, rng)
    sizes = torch.from_numpy(np.asarray(sizes, np.int64)).to(device)
    dst = torch.zeros(n + 1, dtype=torch.int64, device=device)
    torch.cumsum(sizes, 0, out=dst[1:])
    dense = torch.randint(-2**31, 2**31 - 1, (n, Mw), dtype=torch.int32,
                          device=device)
    dense[torch.arange(Mw, device=device) >= sizes[:, None]] = 0
    return dense, dst, int(dst[-1]) + extra


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["zero_word_rows", "longer_than_mw",
                                  "mw_3000", "mw_3000_longer",
                                  "wider_than_tile", "one_row",
                                  "odd_starts", "odd_width", "sf1_shape"])
def test_pack_windows_kernel_edges_match_plain(cuda, case):
    """Rows of 0 words, rows longer than Mw (zeros past Mw), rows wider
    than a CTA's tile, one row, rows at odd word offsets (word stores), an
    odd width (the word path) and SF1's 16-column rows; one launch a
    call."""
    dense, dst, total_w = _b1_inputs(case, np.random.default_rng(len(case)),
                                     cuda)
    before = xpack.pack_windows.launches
    got = xpack.pack_windows(dense, dst, total_w)
    torch.cuda.synchronize()
    assert xpack.pack_windows.launches == before + 1
    want = xpack.pack_windows_plain(dense, dst, total_w)
    assert torch.equal(got, want)


@pytest.mark.gpu
def test_pack_windows_writes_every_word(cuda):
    """The wrapper allocates with torch.empty: a block the caching
    allocator hands back full of 0xFF must come out equal to the plain
    version, the zeros past Mw and past the last row included."""
    dense, dst, total_w = _b1_inputs("longer_than_mw",
                                     np.random.default_rng(8), cuda)
    total_w += 1000
    junk = torch.full((total_w,), -1, dtype=torch.int32, device=cuda)
    ptr = junk.data_ptr()
    del junk
    got = xpack.pack_windows(dense, dst, total_w)
    assert got.data_ptr() == ptr          # the 0xFF block came back
    assert torch.equal(got, xpack.pack_windows_plain(dense, dst, total_w))


@pytest.mark.gpu
def test_pack_windows_broken_offsets_do_not_fault(cuda):
    """Offsets that break the contract (negative, decreasing, past
    total_w) give unspecified words but never a fault."""
    rng = np.random.default_rng(12)
    dense = torch.randint(-2**31, 2**31 - 1, (4000, 16), dtype=torch.int32,
                          device=cuda)
    for trial in range(20):
        dst = torch.from_numpy(rng.integers(-200, 70000, 4001)).to(cuda)
        if trial % 2:
            dst = torch.sort(dst).values
        out = xpack.pack_windows(dense, dst, 60000)
        torch.cuda.synchronize()
        assert out.shape == (60000,)
    # the context is sound: a good call still gives the right words
    dense, dst, total_w = _b1_inputs("one_row", rng, cuda)
    assert torch.equal(xpack.pack_windows(dense, dst, total_w),
                       xpack.pack_windows_plain(dense, dst, total_w))


@pytest.mark.gpu
@pytest.mark.parametrize("D,M,max_len", [(3000, 48, 43), (1, 4, 9),
                                         (700, 21, 30)])
def test_extract_rows_device_offsets(cuda, D, M, max_len):
    """B5 given its offsets as a tensor on the card (no copy) gives the
    words of host offsets and of its plain version."""
    rng = np.random.default_rng(D)
    lens = rng.integers(0, max_len + 1, D)
    offs = np.zeros(D + 1, np.int64)
    np.cumsum(lens, out=offs[1:])
    flat = torch.from_numpy(rng.integers(0, 256, int(offs[-1]) + 3)
                            .astype(np.uint8)).to(cuda)
    before = bytepath.extract_rows.launches
    got = bytepath.extract_rows(flat, torch.from_numpy(offs).to(cuda), M)
    host = bytepath.extract_rows(flat, offs, M)
    torch.cuda.synchronize()
    assert bytepath.extract_rows.launches == before + 2
    assert torch.equal(got, host)
    assert torch.equal(got, bytepath.extract_rows_plain(flat, offs, M))
    with pytest.raises(ValueError, match="is on"):
        bytepath.extract_rows(flat, torch.from_numpy(offs), M)


@pytest.mark.gpu
def test_to_rows_routes_through_b1(cuda):
    """A plain string table: B1 packs the batch, B2 does not run."""
    rng = np.random.default_rng(4)
    n = 20000
    lens = rng.integers(0, 50, n)
    offs = np.zeros(n + 1, np.int32)
    np.cumsum(lens, out=offs[1:])
    cols = [(int(pt.TypeId.STRING), 0,
             rng.integers(32, 127, int(offs[-1])).astype(np.uint8), offs,
             rng.random(n) > 0.1),
            (int(pt.TypeId.INT32), 0, rng.integers(0, 9, n).astype(np.int32),
             None, None)]
    table = interop.table_from_numpy(cols, cuda)
    b1, b2 = xpack.pack_windows.launches, ragged.pack_rows.launches
    rows = pt.convert_to_rows(table)[0]
    torch.cuda.synchronize()
    assert xpack.pack_windows.launches == b1 + 1
    assert ragged.pack_rows.launches == b2
    want, _ = reference.to_rows_np(table)
    np.testing.assert_array_equal(rows.host_bytes(), want)


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


# the benchmark tables' shapes at a reduced row count (seed 0), and every
# other schema of the slot cases at a few thousand rows
SLOT_ROWS = {"lineitem": 600_011, "store_sales": 1_000_003}


@pytest.mark.gpu
@pytest.mark.parametrize("validity", VALIDITY)
@pytest.mark.parametrize("name", list(SCHEMAS))
def test_slot_kernels_match_plain(cuda, name, validity):
    """B8 writes the bytes its plain version writes, into rows back to
    back and into the first columns of a wider row matrix (whose other
    bytes it leaves); B9 reads back what its plain version reads; one
    launch a group of columns each."""
    n = SLOT_ROWS.get(name, 5003)
    seed = 0 if name in SLOT_ROWS else len(name)
    layout, datas, valids = make_case(name, n, validity, seed, cuda)
    groups = len(slots.launch_groups(layout, layout.fixed_row_size))
    width, fpv = layout.fixed_row_size, layout.fixed_plus_validity
    before = slots.launch_counts()
    offsets = torch.full((n + 1,), -1, dtype=torch.int32, device=cuda)
    got = slots.pack_slots(layout, datas, valids, torch.full(
        (n, width), 0xAB, dtype=torch.uint8, device=cuda), offsets)
    want_offsets = torch.empty_like(offsets)
    want = slots.pack_slots_plain(layout, datas, valids, torch.empty_like(got),
                                  want_offsets)
    assert torch.equal(got, want)
    assert torch.equal(offsets, want_offsets)
    M = -(-(fpv + 5) // 64) * 64
    big = torch.full((n, M), 0xCD, dtype=torch.uint8, device=cuda)
    slots.pack_slots(layout, datas, valids, big[:, :fpv])
    assert torch.equal(big[:, :fpv], want[:, :fpv])
    assert bool((big[:, fpv:] == 0xCD).all())
    payloads, valid = slots.unpack_slots(layout, got)
    want_p, want_v = slots.unpack_slots_plain(layout, got)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(payloads, want_p))
    assert torch.equal(valid, want_v)
    delta = _launches_delta(before, slots.launch_counts())
    assert delta == {"pack_slots": 2 * groups, "unpack_slots": groups}
    if n <= 5003:
        np.testing.assert_array_equal(got.cpu().numpy(), np_pack(
            layout, datas, valids, width))


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["store_sales", "lineitem", "past_a_launch"])
def test_slot_kernels_under_graph_capture(cuda, name):
    """A CUDA graph captures both kernels' launches (descriptors by value,
    nothing copied from the host) and its replays give the same bytes on
    new column values."""
    layout, datas, valids = make_case(name, 70_001, "some", 7, cuda)
    rows = torch.empty((70_001, layout.fixed_row_size), dtype=torch.uint8,
                       device=cuda)
    slots.pack_slots(layout, datas, valids, rows)        # builds, warms up
    slots.unpack_slots(layout, rows)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        slots.pack_slots(layout, datas, valids, rows)
        payloads, valid = slots.unpack_slots(layout, rows)
    for step in range(2):
        for d in datas:
            d.copy_(torch.randint_like(d, 0, 100))
        for v in valids:
            if v is not None:
                v.copy_(torch.rand(v.shape, device=cuda) < 0.5)
        graph.replay()
        want = slots.pack_slots_plain(layout, datas, valids,
                                      torch.empty_like(rows))
        want_p, want_v = slots.unpack_slots_plain(layout, want)
        torch.cuda.synchronize()
        assert torch.equal(rows, want), step
        assert all(torch.equal(a, b) for a, b in zip(payloads, want_p))
        assert torch.equal(valid, want_v)


@pytest.mark.gpu
def test_rows_on_card_never_take_the_plain_slots(cuda, monkeypatch):
    """On the card every batch's fixed region goes through B8 and B9, one
    launch a batch and direction for each group of columns: the fixed
    path (a table of more columns than one launch takes, split into
    batches), the string path and the repartition join's rows."""
    def refuse(*args):
        raise AssertionError("a CUDA tensor reached a plain slot version")
    for name, n, cap in (("past_a_launch", 4000, 100_000),
                         ("cols9", 3000, 20_000), ("store_sales", 5000, None)):
        layout, datas, valids = make_case(name, n, "some", 11, cuda)
        cols = []
        for dt, d, v in zip(layout.schema, datas, valids):
            if dt.is_variable_width:
                lens = torch.randint(0, 9, (n,), device=cuda)
                offs = torch.zeros(n + 1, dtype=torch.int32, device=cuda)
                offs[1:] = torch.cumsum(lens, 0)
                chars = torch.randint(32, 127, (int(offs[-1]),),
                                      dtype=torch.uint8, device=cuda)
                cols.append(pt.Column(dt, chars, offs, v))
            else:
                cols.append(pt.Column(dt, d, validity=v))
        table = pt.Table(cols)
        groups = len(slots.launch_groups(layout, layout.fixed_row_size))
        before = slots.launch_counts()
        with monkeypatch.context() as m:
            m.setattr(slots, "pack_slots_plain", refuse)
            m.setattr(slots, "unpack_slots_plain", refuse)
            batches = pt.convert_to_rows(table, max_batch_bytes=cap)
            backs = [pt.convert_from_rows(b, table.schema) for b in batches]
            torch.cuda.synchronize()
        delta = _launches_delta(before, slots.launch_counts())
        assert delta == {"pack_slots": len(batches) * groups,
                         "unpack_slots": len(batches) * groups}, name
        assert len(batches) > (1 if cap else 0)
        cpu = pt.convert_to_rows(interop.table_from_numpy(
            interop.table_to_numpy(table), "cpu"), max_batch_bytes=cap)
        for g, c in zip(batches, cpu):
            assert torch.equal(g.data.cpu(), c.data)
        lo = 0
        for back in backs:
            k = back.num_rows
            for a, b in zip(table.columns, back.columns):
                assert torch.equal(a.validity_or_true()[lo:lo + k],
                                   b.validity_or_true())
                if not a.dtype.is_variable_width:
                    assert torch.equal(
                        a.data[lo:lo + k].contiguous().view(torch.uint8),
                        b.data.contiguous().view(torch.uint8))
            lo += k


def _lineitem_writer():
    import pathlib
    import sys
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent
                           / "tools"))
    import torch_lineitem_parquet
    return torch_lineitem_parquet


@pytest.mark.gpu
@pytest.mark.parametrize("null_fraction", [0.0, 0.1])
def test_scan_on_card_matches_cpu(cuda, null_fraction):
    """The device scan (16 columns, PLAIN l_comment among them),
    DictColumn materialization, Q6 and rows of the scanned table on the
    card equal the same calls on the CPU."""
    from spark_rapids_jni_tpu_torch.models import q6
    from spark_rapids_jni_tpu_torch.parquet import device_scan
    W = _lineitem_writer()
    raw, _, _ = W.lineitem_parquet(50000, 9, row_group_rows=12000,
                                   null_fraction=null_fraction,
                                   pages_per_chunk=3)
    before = bytepath.launch_counts()
    b4 = ragged.segmented_copy.launches
    gpu = device_scan.scan_table(raw, device=cuda)
    cpu = device_scan.scan_table(raw, device="cpu")
    # l_comment is PLAIN: its prefixes go in one B4 launch
    assert ragged.segmented_copy.launches == b4 + 1
    assert gpu[15].dtype == pt.string and not isinstance(gpu[15],
                                                         pt.DictColumn)
    for g, c in zip(gpu.columns, cpu.columns):
        assert type(g) is type(c)
        if isinstance(g, pt.DictColumn):
            assert torch.equal(g.codes.cpu(), c.codes)
            assert torch.equal(g.dictionary.data.cpu(), c.dictionary.data)
            assert torch.equal(g.dictionary.offsets.cpu(), c.dictionary.offsets)
        assert torch.equal(g.validity_or_true().cpu(), c.validity_or_true())
        assert torch.equal(g.data.cpu(), c.data)          # materializes
        if g.dtype.is_variable_width:
            assert torch.equal(g.offsets.cpu(), c.offsets)
    torch.cuda.synchronize()
    delta = _launches_delta(before, bytepath.launch_counts())
    assert all(v > 0 for v in delta.values()), delta
    rows_g = pt.convert_to_rows(gpu)[0]
    rows_c = pt.convert_to_rows(cpu)[0]
    np.testing.assert_array_equal(rows_g.host_bytes(), rows_c.host_bytes())
    lo, hi = 8766, 9131
    rev_g, n_g = q6.run(raw, lo, hi, device=cuda)
    rev_c, n_c = q6.run(raw, lo, hi, device="cpu")
    assert n_g == n_c > 0
    # the same float64 products summed in another order: a few ulps
    assert rev_g == pytest.approx(rev_c, rel=1e-12, abs=0)


@pytest.mark.gpu
@pytest.mark.parametrize("null_fraction", [0.0, 0.1])
def test_q1_on_card_matches_cpu(cuda, null_fraction):
    """TPC-H Q1 at 20,000 rows (FLBA decimals, dictionary-string flags) on
    the card equals the port on the CPU: keys, counts and the decimal sums
    exactly, the means to a relative 1e-12; B3 and B4 launch."""
    from spark_rapids_jni_tpu_torch.models import tpch_q1
    W = _lineitem_writer()
    raw, _, _ = W.lineitem_parquet(20000, 9, row_group_rows=6000,
                                   null_fraction=null_fraction,
                                   pages_per_chunk=2, columns=W.LINEITEM_Q1)
    b3, b4 = ragged.unpack_rows.launches, ragged.segmented_copy.launches
    gpu = tpch_q1.run(raw, 10561 - 90, device=cuda)
    assert ragged.unpack_rows.launches > b3
    assert ragged.segmented_copy.launches > b4
    cpu = tpch_q1.run(raw, 10561 - 90, device="cpu")
    assert gpu.schema == cpu.schema and gpu.num_rows == cpu.num_rows > 0
    for ci, (g, c) in enumerate(zip(gpu.columns, cpu.columns)):
        if ci in (6, 7, 8):
            np.testing.assert_allclose(g.to_numpy(), c.to_numpy(),
                                       rtol=1e-12, atol=0)
        else:
            assert g.to_pylist() == c.to_pylist()
    empty = tpch_q1.run(raw, -10**6, device=cuda)
    assert empty.num_rows == 0 and empty.schema == cpu.schema
    assert empty[4].data.shape == (0, 2)


@pytest.mark.gpu
def test_decimal128_and_hashing_on_card_match_cpu(cuda):
    """decimal128 mul, rescale, segmented_sum and to_float64, and the
    murmur3 hashes, on the card equal the CPU's bits, the extremes of the
    128-bit range among the values."""
    from spark_rapids_jni_tpu_torch.ops import decimal128 as d128, hashing
    rng = np.random.default_rng(3)
    ext = [(1 << 127) - 1, -(1 << 127), -1, 0, 1]
    vals = ext + [int(v) * int(w) for v, w in
                  zip(rng.integers(-2**62, 2**62, 300),
                      rng.integers(-2**40, 2**40, 300))]
    other = vals[::-1]
    a_c = d128.from_pyints(vals, -2, device="cpu")
    b_c = d128.from_pyints(other, -3, device="cpu")
    a_g = d128.from_pyints(vals, -2, device=cuda)
    b_g = d128.from_pyints(other, -3, device=cuda)
    seg = torch.from_numpy(rng.integers(0, 7, len(vals)))
    for g, c in ((d128.mul(a_g, b_g), d128.mul(a_c, b_c)),
                 (d128.rescale(a_g, -9), d128.rescale(a_c, -9)),
                 (d128.rescale(a_g, 3), d128.rescale(a_c, 3)),
                 (d128.segmented_sum(a_g, seg.to(cuda), 7),
                  d128.segmented_sum(a_c, seg, 7))):
        assert torch.equal(g.data.cpu(), c.data)
    assert torch.equal(d128.to_float64(a_g).data.cpu(),
                       d128.to_float64(a_c).data)
    for dtype in (torch.int32, torch.int64, torch.int8, torch.float32):
        x = torch.from_numpy(rng.integers(-2**31, 2**31, 1000)).to(dtype)
        assert torch.equal(hashing.murmur3_32(x.to(cuda)).cpu(),
                           hashing.murmur3_32(x))
    lanes = [torch.from_numpy(rng.integers(-2**62, 2**62, 1000))
             for _ in range(3)]
    assert torch.equal(
        hashing.fingerprint64([x.to(cuda) for x in lanes]).cpu(),
        hashing.fingerprint64(lanes))


@pytest.mark.gpu
def test_string_keys_launch_b3_b4_and_match_plain(cuda):
    """``strings.byte_matrix`` launches B3 and a STRING gather B4; each
    equals its plain version on the same inputs, and the CPU's result."""
    from spark_rapids_jni_tpu_torch.ops import filter as F, strings
    rng = np.random.default_rng(4)
    words = [("w" * int(k)) + str(k) for k in rng.integers(0, 40, 5000)]
    words[::7] = [None] * len(words[::7])
    col_c = pt.Column.strings_from_list(words, device="cpu")
    col_g = pt.Column.strings_from_list(words, device=cuda)
    b3 = ragged.unpack_rows.launches
    mat, lens = strings.byte_matrix(col_g)
    assert ragged.unpack_rows.launches == b3 + 1
    offs = col_g.offsets.to(torch.int64)
    assert torch.equal(mat, ragged.unpack_rows_plain(col_g.data, offs,
                                                     mat.shape[1]))
    assert torch.equal(mat.cpu(), strings.byte_matrix(col_c)[0])
    idx = torch.from_numpy(rng.integers(0, len(words), 3000))
    b4 = ragged.segmented_copy.launches
    got = F._gather_column(col_g, idx.to(cuda))
    assert ragged.segmented_copy.launches == b4 + 1
    want = F._gather_column(col_c, idx)
    assert torch.equal(got.data.cpu(), want.data)
    assert torch.equal(got.offsets.cpu(), want.offsets)
    assert got.to_pylist() == [words[i] for i in idx.tolist()]
    o = offs[:-1][idx.to(cuda)]
    lens = (offs[1:] - offs[:-1])[idx.to(cuda)]
    dst = torch.cumsum(lens, 0) - lens
    assert torch.equal(got.data, ragged.segmented_copy_plain(
        col_g.data, o, dst, lens, int(lens.sum())))
    codes, uniq = strings.dictionary_encode(col_g)
    codes_c, uniq_c = strings.dictionary_encode(col_c)
    assert torch.equal(codes.data.cpu(), codes_c.data)
    assert uniq.to_pylist() == uniq_c.to_pylist()


def _same_scans(gpu, cpu):
    assert gpu.num_columns == cpu.num_columns
    for g, c in zip(gpu.columns, cpu.columns):
        assert type(g) is type(c) and g.dtype == c.dtype
        assert torch.equal(g.validity_or_true().cpu(), c.validity_or_true())
        assert torch.equal(g.data.cpu(), c.data)          # materializes
        if g.dtype.is_variable_width:
            assert torch.equal(g.offsets.cpu(), c.offsets)


@pytest.mark.gpu
@pytest.mark.parametrize("page_version", [1, 2])
def test_spark_file_on_card_matches_cpu(cuda, page_version):
    """A lineitem file as Spark writes it (SNAPPY, dictionary fallback to
    PLAIN; with the v2 writer GZIP, DataPageV2, DELTA fallbacks and INT96
    dates, 10% nulls) scans the same on the card as on the CPU; its mixed
    string chunk launches B4 for the PLAIN runs and B5, B6 and B2 for the
    dictionary runs."""
    from spark_rapids_jni_tpu_torch.parquet import device_scan
    W = _lineitem_writer()
    kw = dict(W.SPARK_DEFAULTS, dict_page_bytes=8192, page_row_limit=200)
    if page_version == 2:
        kw.update(codec="GZIP", page_version=2, int96_dates=True)
    raw, _, _ = W.lineitem_parquet(20000, 9, row_group_rows=6000,
                                   null_fraction=0.1 * (page_version - 1),
                                   **kw)
    before = bytepath.launch_counts()
    b4 = ragged.segmented_copy.launches
    b2 = ragged.pack_rows.launches
    gpu = device_scan.scan_table(raw, device=cuda)
    assert ragged.segmented_copy.launches > b4
    assert ragged.pack_rows.launches > b2
    delta = _launches_delta(before, bytepath.launch_counts())
    assert all(v > 0 for v in delta.values()), delta
    assert not isinstance(gpu[15], pt.DictColumn)        # mixed l_comment
    cpu = device_scan.scan_table(raw, device="cpu")
    assert gpu.host_decoded_cols == cpu.host_decoded_cols
    if page_version == 2:
        assert gpu[10].dtype == pt.timestamp_ns and gpu.host_decoded_cols > 0
    _same_scans(gpu, cpu)


@pytest.mark.gpu
def test_pruned_scan_on_card_matches_cpu(cuda):
    """Row-group pruning on the sorted l_orderkey, and a predicate that
    prunes every group, on the card and on the CPU."""
    from spark_rapids_jni_tpu_torch.parquet import device_scan
    W = _lineitem_writer()
    raw, data, _ = W.lineitem_parquet(20000, 9, row_group_rows=4000,
                                      **W.SPARK_DEFAULTS)
    keys = data["l_orderkey"]
    lo, hi = int(keys[5000]), int(keys[13000])
    conds = [("l_orderkey", "ge", lo), ("l_orderkey", "le", hi)]
    gpu = device_scan.scan_table(raw, rowgroup_predicate=conds, device=cuda)
    cpu = device_scan.scan_table(raw, rowgroup_predicate=conds, device="cpu")
    assert gpu.num_rows == 12000                 # groups 1, 2 and 3
    _same_scans(gpu, cpu)
    none = [("l_orderkey", "lt", 0)]
    gpu = device_scan.scan_table(raw, rowgroup_predicate=none, device=cuda)
    cpu = device_scan.scan_table(raw, rowgroup_predicate=none, device="cpu")
    assert gpu.num_rows == 0 and gpu.schema == cpu.schema
    _same_scans(gpu, cpu)


# ---------------------------------------------------------------------------
# the JNI/C surface on the card (csrc/jni_bridge.cpp, device_bridge.cpp)
# ---------------------------------------------------------------------------

def _schema_arrays(cols):
    return (np.asarray([c[0] for c in cols], np.int32),
            np.asarray([c[1] for c in cols], np.int32))


def _row_kernel_counts() -> dict:
    return {**xpack.launch_counts(), **ragged.launch_counts()}


@pytest.mark.gpu
def test_c_entry_points_on_card_match_host_engine(cuda):
    """srjt_to_rows_device / srjt_from_rows_device on the card, through B1,
    B3 and B4, equal the host C++ engine byte for byte."""
    lib = _native.jni_library()
    cols = seeded_columns("mixed", 4099, 3)
    tids, scales = _schema_arrays(cols)
    t = table_handle(lib, cols)
    before = _row_kernel_counts()
    rows = lib.srjt_to_rows_device(t)
    assert rows, lib.srjt_device_last_error()
    host = lib.srjt_to_rows(t)
    assert_same_batches(row_batches(lib, rows), row_batches(lib, host))
    back = lib.srjt_from_rows_device(rows, 0, tids.ctypes.data,
                                     scales.ctypes.data, len(cols))
    assert back, lib.srjt_device_last_error()
    torch.cuda.synchronize()
    delta = _launches_delta(before, _row_kernel_counts())
    for name in ("pack_windows", "unpack_rows", "segmented_copy"):
        assert delta[name] > 0, delta
    hback = lib.srjt_from_rows(host, 0, tids.ctypes.data, scales.ctypes.data,
                               len(cols))
    assert_same_tables(table_columns(lib, back), table_columns(lib, hback))
    for h in (t, back, hback):
        lib.srjt_table_free(h)
    for h in (rows, host):
        lib.srjt_rows_free(h)


@pytest.mark.gpu
def test_jni_natives_on_card_match_host_engine(cuda):
    lib = _native.jni_library()
    jni, env = Jni(lib), MockEnv()
    cols = seeded_columns("mixed", 3001, 4)
    tids, scales = _schema_arrays(cols)
    t = jni_table(jni, env, cols)
    before = _row_kernel_counts()
    rows = jni.RowConversion_convertToRows(env, t)
    assert rows and env.thrown is None
    back = jni.RowConversion_convertFromRows(
        env, rows, 0, env.int_array(tids), env.int_array(scales))
    assert back and env.thrown is None
    torch.cuda.synchronize()
    delta = _launches_delta(before, _row_kernel_counts())
    for name in ("pack_windows", "unpack_rows", "segmented_copy"):
        assert delta[name] > 0, delta
    host = lib.srjt_to_rows(t)
    assert_same_batches(row_batches(lib, rows), row_batches(lib, host))
    hback = lib.srjt_from_rows(host, 0, tids.ctypes.data, scales.ctypes.data,
                               len(cols))
    assert_same_tables(table_columns(lib, back), table_columns(lib, hback))
    lib.srjt_rows_free(host)
    lib.srjt_table_free(hback)
    jni.RowConversion_freeRows(env, rows)
    for h in (t, back):
        jni.HostTable_close(env, h)


@pytest.mark.gpu
def test_failed_launch_throws_java_exception(cuda, monkeypatch):
    """A kernel launch that reports a CUDA error surfaces as the Java
    exception, with the error's text; no host engine runs instead."""
    lib = _native.jni_library()
    jni, env = Jni(lib), MockEnv()
    cols = seeded_columns("mixed", 2000, 5)
    tids, scales = _schema_arrays(cols)
    t = jni_table(jni, env, cols)
    host = lib.srjt_to_rows(t)

    def failed_launch(name, fn, device, *args):
        _native.check(_native.library(name), 719, fn)   # as the C side reports

    monkeypatch.setattr(_native, "launch", failed_launch)
    assert jni.RowConversion_convertToRows(env, t) == 0
    assert env.thrown[0] == "java/lang/IllegalArgumentException"
    assert "CUDA error 719" in env.thrown[1], env.thrown
    env.thrown = None
    assert jni.RowConversion_convertFromRows(
        env, host, 0, env.int_array(tids), env.int_array(scales)) == 0
    assert "CUDA error 719" in env.thrown[1], env.thrown
    lib.srjt_rows_free(host)
    jni.HostTable_close(env, t)


def _join_keys(rng, kind):
    """(left keys, right keys) on the CPU for the join tests on the card."""
    def col(v, valid=None):
        return pt.Column.from_numpy(v, validity=valid, device="cpu")
    if kind == "dup_nulls":
        return (col(rng.integers(0, 300, 20000).astype(np.int32),
                    rng.random(20000) < 0.9),
                col(rng.integers(0, 300, 900).astype(np.int32),
                    rng.random(900) < 0.9))
    if kind == "unique":
        rk = rng.permutation(np.arange(5000, 9000, dtype=np.int64))[:3000]
        return (col(np.where(rng.random(50000) < 0.7,
                             rk[rng.integers(0, 3000, 50000)],
                             rng.integers(0, 20000, 50000))), col(rk))
    if kind == "composite":
        return ([col(rng.integers(0, 90, 30000)),
                 col(rng.integers(0, 40, 30000).astype(np.int32))],
                [col(rng.integers(0, 90, 2000)),
                 col(rng.integers(0, 40, 2000).astype(np.int32))])
    if kind == "fingerprint":
        base = rng.integers(-2**61, 2**61, 200)
        return ([col(base[rng.integers(0, 200, 8000)]),
                 col(base[rng.integers(0, 200, 8000)])],
                [col(base[rng.integers(0, 200, 900)]),
                 col(base[rng.integers(0, 200, 900)])])
    pool = np.array([-0.0, 0.0, np.nan, 1.5, -2.5, np.inf, 3.25])
    return (col(rng.choice(pool, 5000), rng.random(5000) < 0.9),
            col(rng.choice(pool, 300)))


def _cols_on(c, dev):
    if isinstance(c, list):
        return [_cols_on(x, dev) for x in c]
    return pt.Column(c.dtype, c.data.to(dev),
                     None if c.offsets is None else c.offsets.to(dev),
                     None if c.validity is None else c.validity.to(dev))


@pytest.mark.gpu
@pytest.mark.parametrize("engine", ["dense", "sorted"])
@pytest.mark.parametrize("how", ["inner", "left", "semi", "anti"])
@pytest.mark.parametrize("kind", ["dup_nulls", "unique", "composite",
                                  "fingerprint", "float"])
def test_join_indices_on_card_match_cpu(cuda, kind, how, engine):
    from spark_rapids_jni_tpu_torch.ops import join_plan
    from spark_rapids_jni_tpu_torch.ops.join import join_indices
    lk, rk = _join_keys(np.random.default_rng(len(kind)), kind)
    with join_plan.force_engine(engine):
        want = join_indices(lk, rk, how)
        got = join_indices(_cols_on(lk, cuda), _cols_on(rk, cuda), how)
    torch.cuda.synchronize()
    if how in ("semi", "anti"):
        got, want = (got,), (want,)
    for g, w in zip(got, want):
        assert g.device.type == "cuda"
        assert torch.equal(g.cpu(), w)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["right_join", "full_outer_join"])
def test_outer_table_joins_on_card_match_cpu(cuda, kind):
    from spark_rapids_jni_tpu_torch import ops
    rng = np.random.default_rng(3)
    cols = [pt.Column.from_numpy(rng.integers(0, 500, 4000), device="cpu"),
            pt.Column.strings_from_list([f"v{i}" for i in range(4000)],
                                        device="cpu")]
    rcols = [pt.Column.from_numpy(rng.integers(0, 500, 700), device="cpu"),
             pt.Column.from_numpy(rng.random(700), device="cpu")]
    want = getattr(ops, kind)(pt.Table(cols), pt.Table(rcols), 0, 0)
    got = getattr(ops, kind)(pt.Table(_cols_on(cols, cuda)),
                             pt.Table(_cols_on(rcols, cuda)), 0, 0)
    assert got.num_rows == want.num_rows
    for g, w in zip(got.columns, want.columns):
        assert torch.equal(g.validity_or_true().cpu(), w.validity_or_true())
        assert torch.equal(g.data.cpu(), w.data)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["q3", "q_channel_day", "q67_rank",
                                  "q_lag_growth", "q36_rollup", "q27_cube",
                                  "q_like_brands", "q_nunique_items"])
def test_tpcds_on_card_matches_oracle(cuda, name):
    import pathlib
    import sys
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent
                           / "tools"))
    import torch_tpcds_oracle as O
    import torch_tpcds_parquet as TW
    from spark_rapids_jni_tpu_torch.models import tpcds
    files, arrays = TW.tpcds_parquet(n_sales=200_000, n_items=2000, seed=7)
    params = O.query_params(arrays)[name]
    tables = tpcds.load_tables(files, device=cuda)
    before = ragged.launch_counts()
    out = tpcds.QUERIES[name](tables, **params)
    torch.cuda.synchronize()
    assert all(c.device.type == "cuda" for c in out.columns)
    O.check(name, out, O.answer(name, arrays, params))
    if name not in ("q_lag_growth", "q_nunique_items"):
        # the string keys' byte matrix is B3's on the card
        assert ragged.launch_counts()["unpack_rows"] > before["unpack_rows"]


def _same_columns(got, want, rtol=None):
    """A card column equals a CPU column: type, validity, payload on the
    valid rows (floats within ``rtol`` where given)."""
    assert got.dtype == want.dtype
    gv = got.validity_or_true().cpu()
    assert torch.equal(gv, want.validity_or_true())
    if got.dtype.is_variable_width:
        assert got.to_pylist() == want.to_pylist()
        return
    g, w = got.data.cpu()[gv], want.data[gv]
    if rtol is not None and g.is_floating_point():
        torch.testing.assert_close(g, w, rtol=rtol, atol=0, equal_nan=True)
    else:
        assert torch.equal(g, w)


def _window_tables(rng, n=20000):
    words = [f"part{int(k)}" for k in rng.integers(0, 300, n)]
    words[::11] = [None] * len(words[::11])
    valid = rng.random(n) > 0.1
    cols = [pt.Column.strings_from_list(words, device="cpu"),
            pt.Column.from_numpy(rng.integers(0, 50, n), device="cpu"),
            pt.Column.from_numpy(rng.integers(-400, 400, n) / 4.0,
                                 validity=valid, device="cpu"),
            pt.Column.from_numpy(rng.integers(-10**9, 10**9, n),
                                 validity=valid, device="cpu")]
    return pt.Table(cols), pt.Table(_cols_on(cols, "cuda"))


@pytest.mark.gpu
def test_window_functions_on_card_match_cpu(cuda):
    """Every window function over STRING partitions (B3 codes them) on
    the card equals the CPU's; float running sums to a relative 1e-12."""
    from spark_rapids_jni_tpu_torch.ops import scan, window as W
    cpu_t, gpu_t = _window_tables(np.random.default_rng(12))
    b3 = ragged.unpack_rows.launches
    spec_g = W.WindowSpec(gpu_t, [0], [1], [False])
    assert ragged.unpack_rows.launches > b3
    spec_c = W.WindowSpec(cpu_t, [0], [1], [False])
    _same_columns(W.row_number(spec_g), W.row_number(spec_c))
    _same_columns(W.rank(spec_g, [1]), W.rank(spec_c, [1]))
    _same_columns(W.dense_rank(spec_g, [1]), W.dense_rank(spec_c, [1]))
    for vi in (2, 3):
        for off in (1, 3):
            _same_columns(W.lag(spec_g, vi, off), W.lag(spec_c, vi, off))
            _same_columns(W.lead(spec_g, vi, off), W.lead(spec_c, vi, off))
        for name in ("running_sum", "running_count", "running_max",
                     "running_min"):
            _same_columns(getattr(W, name)(spec_g, vi),
                          getattr(W, name)(spec_c, vi), rtol=1e-12)
        for name in ("cumulative_sum", "cumulative_min", "cumulative_max",
                     "cumulative_count"):
            _same_columns(getattr(scan, name)(gpu_t[vi]),
                          getattr(scan, name)(cpu_t[vi]), rtol=1e-12)
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_grouping_functions_on_card_match_cpu(cuda):
    """ROLLUP, CUBE, GROUPING SETS and COUNT(DISTINCT) over a STRING and
    an int key on the card equal the CPU's (B3 codes the strings, B4
    gathers the key heads)."""
    from spark_rapids_jni_tpu_torch import ops
    cpu_t, gpu_t = _window_tables(np.random.default_rng(13))
    aggs = [(2, "sum"), (2, "mean"), (3, "min"), (3, "count")]
    b4 = ragged.segmented_copy.launches
    for fn, args in (("groupby_rollup", ([0, 1], aggs)),
                     ("groupby_cube", ([0, 1], aggs)),
                     ("groupby_grouping_sets", ([0, 1], [[1], [0], []],
                                                aggs)),
                     ("groupby_nunique", ([0], 1))):
        got = getattr(ops, fn)(gpu_t, *args)
        want = getattr(ops, fn)(cpu_t, *args)
        assert got.num_rows == want.num_rows
        for g, w in zip(got.columns, want.columns):
            _same_columns(g, w, rtol=1e-12)
    assert ragged.segmented_copy.launches > b4
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_matchers_on_card_launch_b3_and_match_cpu(cuda):
    """contains, starts_with, ends_with and LIKE on a plain STRING column
    read B3's byte matrix on the card and equal the CPU's."""
    from spark_rapids_jni_tpu_torch.ops import strings
    rng = np.random.default_rng(14)
    words = [f"brand#{int(b)}" for b in rng.integers(1, 130, 30000)]
    words[::13] = [None] * len(words[::13])
    col_c = pt.Column.strings_from_list(words, device="cpu")
    col_g = pt.Column.strings_from_list(words, device=cuda)
    b3 = ragged.unpack_rows.launches
    for fn, pat in (("contains", "#1"), ("starts_with", "brand#9"),
                    ("ends_with", "7"), ("like", "%#1_"),
                    ("like", "b%#%1"), ("like", "brand#1%"),
                    ("like", "%"), ("like", "")):
        got = getattr(strings, fn)(col_g, pat)
        _same_columns(got, getattr(strings, fn)(col_c, pat))
    assert ragged.unpack_rows.launches > b3
    torch.cuda.synchronize()


def _dict_words(words, device):
    """A DictColumn of ``words`` (None: null) over its distinct words."""
    uniq = sorted({w for w in words if w is not None})
    codes = torch.tensor([0 if w is None else uniq.index(w) for w in words],
                         dtype=torch.int32, device=device)
    valid = torch.tensor([w is not None for w in words], device=device)
    return pt.DictColumn(codes, pt.Column.strings_from_list(uniq,
                                                            device=device),
                         valid)


@pytest.mark.gpu
@pytest.mark.parametrize("dictionary", [False, True], ids=["plain", "dict"])
def test_parsers_on_card_match_cpu(cuda, dictionary):
    """to_int64, to_decimal, to_date and to_bool read B3's byte matrix on
    the card (a DictColumn materialized first by B5, B6 and B2) and equal
    the CPU's."""
    from spark_rapids_jni_tpu_torch.ops import strings
    rng = np.random.default_rng(21)
    n = 20000
    days = rng.integers(-30000, 40000, n)
    dates = (np.datetime64("1970-01-01") + days).astype("datetime64[D]")
    pools = {
        "int": [str(v) for v in rng.integers(-10**12, 10**12, 300)]
        + ["", " 7 ", "+3", "9x", "12345678901234567890", "-0"],
        "dec": [f"{v:.{int(rng.integers(0, 6))}f}"
                for v in rng.uniform(-1e5, 1e5, 300)] + ["1.2.3", ".5", ""],
        "iso": [str(d) for d in dates[:300]] + ["2021-02-31", "2020-1-01"],
        "mdy": [f"{d.astype(object).month:02d}/{d.astype(object).day:02d}/"
                f"{d.astype(object).year:04d}" for d in dates[:300]]
        + ["13/01/2020", "02-29-2020"],
        "bool": ["true", "False", " y ", "0", "n", "yes ", "x", ""],
    }
    calls = (("int", strings.to_int64, ()), ("dec", strings.to_decimal, (-2,)),
             ("dec", strings.to_decimal, (1,)), ("iso", strings.to_date, ()),
             ("mdy", strings.to_date, ("%m/%d/%Y",)),
             ("bool", strings.to_bool, ()))
    before = {**ragged.launch_counts(), **bytepath.launch_counts()}
    for pool, fn, args in calls:
        words = [pools[pool][int(k)] for k in
                 rng.integers(0, len(pools[pool]), n)]
        words[::17] = [None] * len(words[::17])
        make = (_dict_words if dictionary else
                lambda w, d: pt.Column.strings_from_list(w, device=d))
        got = fn(make(words, cuda), *args)
        assert got.data.device.type == "cuda"
        _same_columns(got, fn(make(words, "cpu"), *args))
    torch.cuda.synchronize()
    after = {**ragged.launch_counts(), **bytepath.launch_counts()}
    assert after["unpack_rows"] > before["unpack_rows"]
    if dictionary:
        for name in ("extract_rows", "gather_rows", "pack_rows"):
            assert after[name] > before[name], name


@pytest.mark.gpu
def test_formatters_and_transforms_on_card_match_cpu(cuda):
    """The formatters (INT64_MIN, uint64 from 2^63, decimals of both scale
    signs, pre-1970 days), case, substrings, concatenation and cast on
    the card equal the CPU's."""
    from spark_rapids_jni_tpu_torch import types as T
    from spark_rapids_jni_tpu_torch.ops import cast, strings
    rng = np.random.default_rng(22)
    n = 30000
    valid = rng.random(n) >= 0.1
    i64 = rng.integers(-2**63, 2**63 - 1, n, dtype=np.int64, endpoint=True)
    i64[:3] = [-(2**63), 2**63 - 1, 0]
    u64 = rng.integers(0, 2**64 - 1, n, dtype=np.uint64, endpoint=True)
    u64[:2] = [2**63, 2**64 - 1]
    days = rng.integers(-800000, 3000000, n).astype(np.int32)
    cases = [(strings.format_int64, i64, T.int64, ()),
             (strings.format_int64, u64, T.uint64, ()),
             (strings.format_decimal, i64, T.decimal64(-2), ()),
             (strings.format_decimal, i64, T.decimal64(3), ()),
             (strings.format_date, days, T.timestamp_days, ()),
             (strings.format_bool, (i64 & 1).astype(np.uint8), T.bool8, ()),
             (cast, i64 % 1000, T.int64, (T.string,)),
             (cast, i64 % 10**6, T.decimal64(-3), (T.decimal64(-1),)),
             (cast, i64 % 10**6, T.decimal64(-3), (T.float64,))]
    for fn, vals, dt, args in cases:
        cols = [pt.Column.from_numpy(vals, dt, valid, device=d)
                for d in (cuda, "cpu")]
        got = fn(cols[0], *args)
        assert got.data.device.type == "cuda"
        _same_columns(got, fn(cols[1], *args))
    words = [None if k % 9 == 0 else f"Word{int(k)}-x"
             for k in rng.integers(0, 500, n)]
    for dictionary in (False, True):
        make = (_dict_words if dictionary else
                lambda w, d: pt.Column.strings_from_list(w, device=d))
        a_g, a_c = make(words, cuda), make(words, "cpu")
        for fn, args in ((strings.upper, ()), (strings.lower, ()),
                         (strings.substring, (2, 5)),
                         (strings.substring, (3,))):
            _same_columns(fn(a_g, *args), fn(a_c, *args))
        b_g = pt.Column.strings_from_list(words[::-1], device=cuda)
        b_c = pt.Column.strings_from_list(words[::-1], device="cpu")
        _same_columns(strings.concat(a_g, b_g), strings.concat(a_c, b_c))
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_mortgage_etl_on_card_matches_cpu_and_oracle(cuda):
    """The Mortgage ETL on the writer's files: the card's feature table
    equals the CPU's and the numpy oracle's; its scan and parsers launch
    B2-B7."""
    import pathlib
    import sys
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent
                           / "tools"))
    import torch_mortgage_oracle as MO
    import torch_mortgage_parquet as MW
    from spark_rapids_jni_tpu_torch.models import mortgage
    files, arrays = MW.mortgage_parquet(n_loans=20000, periods_per_loan=12,
                                        seed=11)
    before = {**ragged.launch_counts(), **bytepath.launch_counts()}
    out = mortgage.etl(files, device=cuda)
    torch.cuda.synchronize()
    after = {**ragged.launch_counts(), **bytepath.launch_counts()}
    assert all(c.data.device.type == "cuda" for c in out.columns)
    MO.check(out, MO.features(arrays))
    want = mortgage.etl(files, device="cpu")
    for k, name in enumerate(mortgage.FEATURE_COLS):
        _same_columns(out[k], want[k], 1e-12 if name == "mean_upb" else None)
    for name in ("pack_rows", "unpack_rows", "segmented_copy",
                 "extract_rows", "gather_rows", "u8_to_u32"):
        assert after[name] > before[name], name
    ids, mat = mortgage.feature_matrix(files, device=cuda)
    assert mat.device.type == "cuda" and mat.dtype == torch.float32
    assert tuple(mat.shape) == (20000, len(mortgage.FEATURE_COLS) - 1)


def _tpcds_case(cuda, seed=7, n_sales=200_000):
    """The writer's TPC-DS files on the card and the CPU, with the
    oracle's parameters and arrays."""
    import pathlib
    import sys
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent
                           / "tools"))
    import torch_tpcds_oracle as O
    import torch_tpcds_parquet as TW
    from spark_rapids_jni_tpu_torch.models import tpcds
    files, arrays = TW.tpcds_parquet(n_sales=n_sales, n_items=2000,
                                     seed=seed)
    return (tpcds.load_tables(files, device=cuda),
            tpcds.load_tables(files, device="cpu"), arrays,
            O.query_params(arrays))


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["q3", "q36_rollup"])
def test_compiled_query_on_card_matches_cpu(cuda, name):
    """A query captured as one CUDA graph: its checked and unchecked
    replays equal the CPU's compiled result and the oracle; the unchecked
    replay makes no host synchronisation; its graph holds B3 and B4."""
    import functools
    from spark_rapids_jni_tpu_torch.models import compiled, tpcds
    from spark_rapids_jni_tpu_torch.utils import syncs
    tables, cpu_tables, arrays, params = _tpcds_case(cuda)
    import torch_tpcds_oracle as O
    qfn = functools.partial(tpcds.QUERIES[name], **params[name])
    cq = compiled.compile_query(qfn, tables)
    want = compiled.compile_query(qfn, cpu_tables).run(cpu_tables)
    assert cq.tape == compiled.compile_query(qfn, cpu_tables).tape
    assert cq.graph_launches["unpack_rows"] > 0
    assert cq.graph_launches["segmented_copy"] > 0
    got = cq.run(tables)
    # float sums, each within 1e-12 of the exact one (the oracle's bound)
    for g, w in zip(got.columns, want.columns):
        _same_columns(g, w, 2e-12)
    O.check(name, got, O.answer(name, arrays, params[name]))
    before = syncs.sync_count()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        again = cq.run_unchecked(tables)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert syncs.sync_count() == before
    for g, w in zip(again.columns, want.columns):
        _same_columns(g, w, 2e-12)


@pytest.mark.gpu
def test_compiled_stale_tape_on_card_raises(cuda):
    """q3 compiled on seed 7's tables, run on seed 77's (the same shapes,
    other sizes): StaleTapeError, no device fault; compiled again there,
    it equals the oracle."""
    import functools
    from spark_rapids_jni_tpu_torch.models import compiled, tpcds
    tables, _, _, params = _tpcds_case(cuda)
    import torch_tpcds_oracle as O
    tables2, _, arrays2, _ = _tpcds_case(cuda, seed=77)
    qfn = functools.partial(tpcds.QUERIES["q3"], **params["q3"])
    cq = compiled.compile_query(qfn, tables)
    with pytest.raises(compiled.StaleTapeError):
        cq.run(tables2)
    torch.cuda.synchronize()
    fresh = compiled.compile_query(qfn, tables2)
    O.check("q3", fresh.run(tables2), O.answer("q3", arrays2, params["q3"]))


@pytest.mark.gpu
def test_sql_query_on_card_bit_equal_to_hand_fused(cuda):
    """q7 as SQL text through ``sql.compile_sql`` on the card: bit-equal
    to the hand-fused ``tpcds.q7`` (its means divide exact integer sums,
    so the card's atomics cannot reorder them), with the same tape and
    the same kernel launches; equal to the oracle."""
    from spark_rapids_jni_tpu_torch import sql
    from spark_rapids_jni_tpu_torch.models import tpcds
    from spark_rapids_jni_tpu_torch.models import tpcds_sql as TS
    from spark_rapids_jni_tpu_torch.utils import syncs
    tables, _, arrays, params = _tpcds_case(cuda)
    import torch_tpcds_oracle as O
    qfn = sql.compile_sql(TS.SQL["q7"], TS.TABLE_SCHEMAS, params["q7"])
    before = ragged.launch_counts()
    got_tape, want_tape = [], []
    with syncs.capture(got_tape):
        got = qfn(tables)
    mid = ragged.launch_counts()
    with syncs.capture(want_tape):
        want = tpcds.q7(tables, **params["q7"])
    after = ragged.launch_counts()
    assert sorted(got_tape) == sorted(want_tape)
    assert ({k: mid[k] - before[k] for k in mid}
            == {k: after[k] - mid[k] for k in mid})
    assert got.num_rows == want.num_rows > 0
    for g, w in zip(got.columns, want.columns):
        g, w = pt.force_column(g), pt.force_column(w)
        assert g.data.device.type == "cuda"
        assert torch.equal(g.validity_or_true(), w.validity_or_true())
        assert torch.equal(g.data, w.data)
    O.check("q7", got, O.answer("q7", arrays, params["q7"]))


@pytest.mark.gpu
def test_file_catalog_query_on_card_bit_equal_to_hand_fused(cuda):
    """q7's plan tree over a ``FileCatalog`` of the files: the scans read
    only the query's columns, the fused row filter prunes date_dim's rows
    completely (no mask after it), B7 runs in the scans, and the result is
    bit-equal to the hand-fused query on the loaded tables."""
    import pathlib
    import sys
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent
                           / "tools"))
    import torch_tpcds_oracle as O
    import torch_tpcds_parquet as TW
    from spark_rapids_jni_tpu_torch import plan as P
    from spark_rapids_jni_tpu_torch.models import tpcds, tpcds_plans
    from spark_rapids_jni_tpu_torch.parquet import device_scan
    from spark_rapids_jni_tpu_torch.plan import lower
    files, arrays = TW.tpcds_parquet(n_sales=200_000, n_items=2000, seed=7)
    params = O.query_params(arrays)["q7"]
    tables = tpcds.load_tables(files, device=cuda)
    tree = tpcds_plans.optimized("q7", **params).tree
    device_scan.reset_counts()
    lower.reset_counts()
    before = bytepath.launch_counts()["u8_to_u32"]
    got = P.execute(tree, P.FileCatalog(files), record_stats=False)
    assert bytepath.launch_counts()["u8_to_u32"] > before
    assert lower.COUNTS["scan.filter_fused"] == 1
    assert device_scan.COUNTS["rowfilter.complete"] == 1
    want = tpcds.q7(tables, **params)
    assert got.num_rows == want.num_rows > 0
    for g, w in zip(got.columns, want.columns):
        g, w = pt.force_column(g), pt.force_column(w)
        assert g.data.device.type == "cuda"
        assert torch.equal(g.validity_or_true(), w.validity_or_true())
        assert torch.equal(g.data, w.data)


def _bit_equal_tables(got, want):
    assert got.num_columns == want.num_columns
    assert got.num_rows == want.num_rows
    for g, w in zip(got.columns, want.columns):
        g, w = pt.force_column(g), pt.force_column(w)
        assert g.dtype == w.dtype and g.data.device.type == "cuda"
        assert torch.equal(g.validity_or_true(), w.validity_or_true())
        if g.dtype.is_variable_width:
            assert torch.equal(g.offsets, w.offsets)
        gd, wd = g.data, w.data
        if gd.dtype == torch.float64:
            gd, wd = gd.view(torch.int64), wd.view(torch.int64)
        assert torch.equal(gd, wd)


@pytest.mark.gpu
def test_mortgage_etl_compiles_to_one_graph_on_card(cuda):
    """``etl_tables`` on dictionary-string tables captures as one CUDA
    graph (B6's bounds check reads the tape, the parsers' constant tables
    are built before the capture), equal to the eager run: every column
    exact, ``mean_upb`` within a relative 1e-12 (atomics add in any
    order)."""
    import pathlib
    import sys
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent
                           / "tools"))
    import torch_mortgage_parquet as MW
    from spark_rapids_jni_tpu_torch.models import compiled, mortgage
    files, _ = MW.mortgage_parquet(n_loans=20000, periods_per_loan=12,
                                   seed=11)
    tables = mortgage.load_tables(files, device=cuda)
    want = mortgage.etl_tables(tables)
    captures = compiled.COUNTS["graph_capture"]
    cq = compiled.compile_query(mortgage.etl_tables, tables)
    assert compiled.COUNTS["graph_capture"] == captures + 1
    assert cq.graph_launches["gather_rows"] > 0
    for got in (cq.run(tables), cq.run_unchecked(tables)):
        assert got.num_rows == want.num_rows
        for k, name in enumerate(mortgage.FEATURE_COLS):
            g, w = pt.force_column(got[k]), pt.force_column(want[k])
            assert g.dtype == w.dtype
            assert torch.equal(g.validity_or_true(), w.validity_or_true())
            if name == "mean_upb":
                torch.testing.assert_close(g.data, w.data, rtol=1e-12,
                                           atol=0, equal_nan=True)
            else:
                assert torch.equal(g.data, w.data), name


def _served(sched, qfn, tables, clients=4, per_client=2):
    import threading
    tickets, errors = [], []

    def client():
        try:
            for _ in range(per_client):
                tickets.append(sched.submit("q", qfn, tables))
        except Exception as e:
            errors.append(e)
    threads = [threading.Thread(target=client) for _ in range(clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    return [tk.result(timeout=300) for tk in tickets]


@pytest.mark.gpu
def test_scheduler_serves_q7_from_four_clients_on_card(cuda):
    """q7 from 4 client threads through ``QueryScheduler(workers=4)`` on
    the card: every result bit-equal to the hand-fused eager run, one
    graph captured, the repeats served from the plan cache."""
    import functools
    from spark_rapids_jni_tpu_torch import exec as xc
    from spark_rapids_jni_tpu_torch.models import compiled, tpcds
    tables, _, _, params = _tpcds_case(cuda)
    qfn = functools.partial(tpcds.QUERIES["q7"], **params["q7"])
    want = qfn(tables)
    torch.cuda.synchronize()
    captures = compiled.COUNTS["graph_capture"]
    with xc.QueryScheduler(workers=4) as sched:
        assert sched.replicas[0].name == "cuda:0"
        outs = _served(sched, qfn, tables)
        stats = sched.plans.stats()
    with compiled.device_work():
        for out in outs:
            _bit_equal_tables(out, want)
    assert compiled.COUNTS["graph_capture"] == captures + 1
    assert len(outs) == 8 and stats["entries"] == 1


@pytest.mark.gpu
def test_capture_on_one_worker_beside_replays_on_another(cuda):
    """One thread replays a warm plan in a loop while another compiles (a
    capture run, then a graph capture) a second plan: both results are
    right, and the capture holds the device lock exclusively."""
    import functools
    import threading
    from spark_rapids_jni_tpu_torch import exec as xc
    from spark_rapids_jni_tpu_torch.models import compiled, tpcds
    tables, _, arrays, params = _tpcds_case(cuda)
    import torch_tpcds_oracle as O
    q3 = functools.partial(tpcds.QUERIES["q3"], **params["q3"])
    q36 = functools.partial(tpcds.QUERIES["q36_rollup"],
                            **params["q36_rollup"])
    plans = xc.PlanCache()
    plans.run("q3", q3, tables)
    plans.run("q3", q3, tables)                  # warm and verified
    stop = threading.Event()
    replays, errors = [], []

    def replayer():
        try:
            while not stop.is_set():
                replays.append(plans.run("q3", q3, tables))
        except Exception as e:
            errors.append(e)

    t = threading.Thread(target=replayer)
    t.start()
    try:
        while not replays and not errors:
            t.join(0.01)
        cq = compiled.compile_query(q36, tables)
        got = cq.run(tables)
    finally:
        stop.set()
        t.join()
    assert not errors, errors
    assert len(replays) > 1
    with compiled.device_work():
        O.check("q36_rollup", got,
                O.answer("q36_rollup", arrays, params["q36_rollup"]))
        want = O.answer("q3", arrays, params["q3"])
        for out in replays:
            O.check("q3", out, want)


@pytest.mark.gpu
def test_device_error_quarantines_and_recovers_on_card(cuda):
    """An injected device error at ``exec.dispatch`` quarantines the one
    replica; the request is relocated, the recovery probe's canary runs
    on the card and re-admits it, and both the relocated request and the
    next are right."""
    import functools
    from spark_rapids_jni_tpu_torch import exec as xc
    from spark_rapids_jni_tpu_torch.faultinj import injector as finj
    from spark_rapids_jni_tpu_torch.models import compiled, tpcds
    tables, _, arrays, params = _tpcds_case(cuda)
    import torch_tpcds_oracle as O
    qfn = functools.partial(tpcds.QUERIES["q3"], **params["q3"])
    want = O.answer("q3", arrays, params["q3"])
    inj = finj.get_injector()
    with xc.QueryScheduler(workers=1, probe_base_s=0.02) as sched:
        try:
            inj.load_dict({"seed": 1, "sites": {"exec.dispatch": {
                "percent": 100, "injectionType": "device_error",
                "maxHits": 1}}})
            inj.enable()
            tk = sched.submit("q3", qfn, tables)
            out = tk.result(timeout=300)
            nxt = sched.run("q3", qfn, tables)
        finally:
            inj.disable()
        rep = sched.replicas[0]
        assert tk.relocations == 1
        assert rep.resilient.fatal_count == 1
        assert rep.resilient.recovery_count == 1 and rep.serving()
    with compiled.device_work():
        O.check("q3", out, want)
        O.check("q3", nxt, want)


@pytest.mark.gpu
def test_query_dying_inside_a_capture_leaves_the_capture_intact(cuda):
    """A compiled query freed by the garbage collector while another
    query's graph is being captured (on the capturing thread itself) has
    its graph destroyed later, outside the capture: the capture holds and
    its result equals the oracle."""
    import functools
    import gc
    from spark_rapids_jni_tpu_torch.models import compiled, tpcds
    tables, _, arrays, params = _tpcds_case(cuda)
    import torch_tpcds_oracle as O
    q3 = functools.partial(tpcds.QUERIES["q3"], **params["q3"])
    dead = compiled.compile_query(q3, tables)
    dead.cycle = dead                  # only the collector can free it
    holder = [dead]
    del dead
    collected = []

    def q3_collecting(t):
        if torch.cuda.is_current_stream_capturing() and holder:
            holder.clear()
            collected.append(gc.collect())
        return q3(t)

    cq = compiled.compile_query(q3_collecting, tables)
    assert collected and collected[0] > 0
    with compiled.device_work():
        O.check("q3", cq.run(tables), O.answer("q3", arrays, params["q3"]))
    assert not compiled._GRAVE


def _ml_pipe(cuda, shuffle, n=20_000, k=6, seed=3, batch=256):
    from spark_rapids_jni_tpu_torch import ml
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, k)).astype(np.float32)
    y = (X @ rng.normal(size=k).astype(np.float32) > 0).astype(np.float32)
    fb = ml.FeatureBatch(torch.from_numpy(X).to(cuda),
                         torch.from_numpy(y).to(cuda))
    return ml.BatchPipeline(fb, batch_size=batch, seed=seed,
                            shuffle=shuffle), X, y


@pytest.mark.gpu
@pytest.mark.parametrize("shuffle", ["feistel", "sort"])
def test_epoch_graph_replays_without_sync(cuda, shuffle):
    """A fused epoch is one CUDA-graph replay: the first epoch captures,
    the later ones make no host synchronisation, and the result equals
    the eager step loop on the same batches (the plain version) and the
    pipeline's permutation the host's."""
    from spark_rapids_jni_tpu_torch import ml
    from spark_rapids_jni_tpu_torch.ml import prng
    from spark_rapids_jni_tpu_torch.ml.pipeline import feistel_permutation
    pipe, X, y = _ml_pipe(cuda, shuffle)
    tr = ml.Trainer(ml.logistic_regression(), ml.adam(lr=0.01))
    res = tr.fit(pipe, 1)                      # captures the graph
    assert tr.graph_captures == 1
    params, ostate = tr.init(pipe.k, cuda)
    g = tr._graph
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        losses = [g.run(*pipe.epoch_arrays(e), params, ostate, e == 0)
                  for e in range(3)]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    got = torch.stack(losses).cpu().numpy()
    eager = ml.Trainer(ml.logistic_regression(), ml.adam(lr=0.01),
                       fuse=False)
    ep, eo = eager.init(pipe.k, cuda)
    want = []
    for e in range(3):
        Xb, yb = pipe.epoch_arrays(e)
        want.append(float(torch.stack([eager.train_step(ep, eo, Xb[i], yb[i])
                                       for i in range(pipe.num_batches)]
                                      ).mean()))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    np.testing.assert_allclose(g.params["w"].cpu().numpy(),
                               ep["w"].cpu().numpy(), rtol=1e-4, atol=1e-6)
    assert tr.graph_captures == 1
    assert np.isfinite(res.losses).all()
    if shuffle == "feistel":
        key = prng.fold_in(pipe._key, 2)
        host = feistel_permutation(prng.bits(key, 4), pipe.n, pipe._m,
                                   "cpu")
        assert torch.equal(pipe.permutation(2).cpu(), host)


@pytest.mark.gpu
def test_feature_view_repacks_on_the_card(cuda):
    """A FeatureView over an incremental view on the card repacks after
    each refresh, equal to a from-scratch pack of a full recompute."""
    from spark_rapids_jni_tpu_torch import ml
    from spark_rapids_jni_tpu_torch.plan import ir, lower
    from spark_rapids_jni_tpu_torch.stream import DeltaTable, ViewRegistry

    W = _lineitem_writer()

    def blob(n, start=0):
        rows = np.arange(start, start + n)
        return W.write_parquet(
            [W.ParquetColumn("k", "INT32", (rows % 97).astype(np.int32),
                             "plain"),
             W.ParquetColumn("v", "INT64", (rows * 3).astype(np.int64),
                             "plain")], 1000, codec="SNAPPY")

    delta = DeltaTable("f", files=[blob(5000)])
    reg = ViewRegistry(delta, {}, {})
    plan = ir.Aggregate(ir.Scan("f"), ("k",),
                        (("v", "sum", "sv"), ("v", "count", "nv")))
    spec = ml.FeatureSpec.of([ml.Feature("k"), ml.Feature("sv")],
                             label="nv")
    fv = ml.FeatureView(reg, plan, spec)
    try:
        assert fv.view.kind == "incremental"
        fv.current()
        for start in (10_000, 20_000):
            delta.append_file(blob(3000, start))
            fb = fv.refresh()
            assert fb.X.device.type == "cuda"
            full = lower.execute(
                fv.view.tree,
                lower.TableCatalog({"f": delta.scan()}, reg.schemas),
                record_stats=False)
            want = spec.pack(full, fv.names)
            assert torch.equal(fb.X, want.X) and torch.equal(fb.y, want.y)
        assert fv.repacks == 3
    finally:
        fv.close()


# --- slice 17: AQE, parallel/, the arena, the shim, batches, Arrow -----------


def _same_result(a, b):
    """Two port tables hold the same columns, byte for byte."""
    ca, cb = interop.table_to_numpy(a), interop.table_to_numpy(b)
    assert len(ca) == len(cb)
    for x, y in zip(ca, cb):
        assert x[:2] == y[:2]
        for u, v in zip(x[2:], y[2:]):
            assert (u is None) == (v is None)
            if u is not None:
                assert u.tobytes() == v.tobytes()


def _star(cuda):
    from spark_rapids_jni_tpu_torch.column import Column, Table
    rng = np.random.default_rng(21)
    n = 6000

    def col(a):
        return Column.from_numpy(np.asarray(a), device=cuda)
    tables = {
        "fact": Table([col(rng.integers(0, 900, n)),
                       col(rng.integers(0, 400, n)),
                       col(rng.integers(1, 9, n))]),
        "dim_big": Table([col(np.arange(900)),
                          col((np.arange(900) % 11).astype(np.int32))]),
        "dim_small": Table([col(np.arange(24)),
                            col((np.arange(24) % 3).astype(np.int32))])}
    schemas = {"fact": ["f_big_sk", "f_small_sk", "f_qty"],
               "dim_big": ["big_sk", "b_tag"],
               "dim_small": ["small_sk", "s_tag"]}
    return tables, schemas


@pytest.mark.gpu
def test_adaptive_plan_compiles_to_one_graph_on_card(cuda, monkeypatch):
    """The replanned star chain: adaptive equals static, and its compiled
    graph replays with the capture's decisions, without a sync."""
    from spark_rapids_jni_tpu_torch.models import compiled
    from spark_rapids_jni_tpu_torch.plan import ir, lower
    tables, schemas = _star(cuda)
    tree = ir.FusedJoinAggregate(
        ir.Join(ir.Scan("fact"), ir.Scan("dim_big"), ("f_big_sk",),
                ("big_sk",)),
        ir.Scan("dim_small"), ("f_small_sk",), ("small_sk",), ("b_tag",),
        (("f_qty", "sum", "total"), ("f_qty", "count", "cnt")))
    monkeypatch.setenv("SRJT_AQE", "0")
    static = lower.compile_plan(tree, schemas)(tables)
    monkeypatch.setenv("SRJT_AQE", "1")
    qfn = lower.compile_plan(tree, schemas)
    cq = compiled.compile_query(qfn, tables)
    assert [d.kind for d in qfn.last_report.decisions()] == ["replan"]
    got = cq.run(tables)
    torch.cuda.set_sync_debug_mode("error")
    try:
        again = cq.run_unchecked(tables)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    for t in (got, again):
        _same_result(t, static)


@pytest.mark.gpu
def test_repartition_join_on_shards_of_one_card(cuda):
    from spark_rapids_jni_tpu_torch.parallel import Mesh
    from spark_rapids_jni_tpu_torch.parallel import repartition_join as rj
    rng = np.random.default_rng(3)
    n, nb, G = 1 << 16, 512, 9
    fk = rng.integers(0, nb + 50, n)
    fv = rng.integers(-50, 50, n)
    bk = rng.permutation(nb)
    bg = rng.integers(0, G, nb).astype(np.int32)
    on = (lambda a: torch.from_numpy(np.asarray(a)).to(cuda))
    s, c, d = rj.repartition_join_agg_auto(
        Mesh([cuda] * 4), (pt.int64, pt.int64), (pt.int64, pt.int32),
        0, 0, 1, 1, G, (on(fk), on(fv)), torch.ones((n, 2), dtype=torch.bool,
                                                    device=cuda),
        (on(bk), on(bg)), torch.ones((nb, 2), dtype=torch.bool, device=cuda))
    ok = fk < nb
    grp = np.zeros(nb, np.int64)
    grp[bk] = bg
    want = np.zeros(G, np.int64)
    np.add.at(want, grp[fk[ok]], fv[ok])
    assert int(d) == 0
    assert np.array_equal(s.cpu().numpy(), want)
    assert int(c.sum()) == int(ok.sum())


@pytest.mark.gpu
def test_run_vmapped_is_one_launch_of_k_members(cuda):
    from spark_rapids_jni_tpu_torch.column import Column, Table
    from spark_rapids_jni_tpu_torch.models import compiled
    from spark_rapids_jni_tpu_torch.ops import groupby_aggregate

    def q(t):
        return groupby_aggregate(t["t"], [1], [(0, "sum"), (0, "count")])
    sets = []
    for i in range(4):
        rng = np.random.default_rng(i)
        sets.append({"t": Table([
            Column.from_numpy(rng.integers(-9, 9, 5000), device=cuda),
            Column.from_numpy(rng.permutation(np.arange(5000) % 7).astype(
                np.int32), device=cuda)])})
    cq = compiled.compile_query(q, sets[0])
    want = [cq.run(t) for t in sets]
    outs = cq.run_vmapped(sets)
    assert len(outs) == 4 and 4 in cq._batches
    for o, w in zip(outs, want):
        _same_result(o, w)


@pytest.mark.gpu
def test_torch_shim_faults_kernel_launches_on_card(cuda):
    """An injected ``torch.launch`` fault raises before the kernel runs;
    the retry then launches it, and the result is right."""
    from spark_rapids_jni_tpu_torch.faultinj import injector, torch_shim
    from spark_rapids_jni_tpu_torch.faultinj.resilience import (
        ResilientExecutor)
    rng = np.random.default_rng(5)
    dense, offs = (t.to(cuda) for t in _ragged_inputs(rng, 300, 64, True))
    total = int(offs[-1])
    torch_shim.install()
    try:
        injector.get_injector().load_dict({"seed": 1, "sites": {
            "torch.launch": {"percent": 100, "interceptionCount": 2,
                             "injectionType": "oom"}}})
        injector.enable()
        ex = ResilientExecutor(max_retries=3)
        got = ex.submit(lambda: ragged.pack_rows(dense, offs, total))
    finally:
        injector.disable()
        torch_shim.uninstall()
    assert ex.retry_count == 2
    assert torch.equal(got, ragged.pack_rows_plain(dense, offs, total))


@pytest.mark.gpu
def test_arena_zeros_and_arrow_buffers_on_card(cuda, monkeypatch):
    from spark_rapids_jni_tpu_torch.column import Column, Table
    from spark_rapids_jni_tpu_torch.memory import arena, budget
    from spark_rapids_jni_tpu_torch.ops.join import left_join
    from spark_rapids_jni_tpu_torch.utils import arrow
    monkeypatch.setenv("SRJT_HBM_ARENA", "1")
    budget.set_enabled(None)
    try:
        left = Table([Column.from_numpy(np.arange(100), device=cuda)])
        right = Table([Column.from_numpy(np.zeros(0, np.int64), device=cuda),
                       Column.from_numpy(np.zeros(0, np.int32), device=cuda)])
        out = left_join(left, right, 0, 0)
        pooled = arena.pooled_zeros()
        versions = [p._version for p in pooled]
        assert pooled and all(p.device.type == "cuda" for p in pooled)
        back = arrow.from_arrow_buffers(arrow.to_arrow_buffers(out[2]),
                                        device=cuda)
        assert back.validity is not None and not bool(back.validity.any())
        assert [p._version for p in pooled] == versions
    finally:
        arena.reset()
        budget.set_enabled(None)


@pytest.mark.gpu
def test_batch_graph_widths_background_capture_and_spill(cuda, monkeypatch):
    """Three sets run on the width-4 graph (the spare member repeats the
    last set); in the background mode the first call returns None while a
    thread captures it; with the budget on the graph is a spill resident
    whose bytes the budget holds, and reclaiming drops it."""
    from spark_rapids_jni_tpu_torch.column import Column, Table
    from spark_rapids_jni_tpu_torch.memory import budget, spill
    from spark_rapids_jni_tpu_torch.models import compiled
    from spark_rapids_jni_tpu_torch.ops import groupby_aggregate

    def q(t):
        return groupby_aggregate(t["t"], [1], [(0, "sum"), (0, "count")])
    sets = []
    for i in range(3):
        rng = np.random.default_rng(30 + i)
        sets.append({"t": Table([
            Column.from_numpy(rng.integers(-9, 9, 5000), device=cuda),
            Column.from_numpy(rng.permutation(np.arange(5000) % 7).astype(
                np.int32), device=cuda)])})
    monkeypatch.setenv("SRJT_HBM_ARENA", "1")
    budget.set_enabled(None)
    spill.reset()
    budget.reset()
    try:
        cq = compiled.compile_query(q, sets[0])
        want = [cq.run(t) for t in sets]
        compiled.reset_counts()
        assert cq.run_vmapped(sets, background=True) is None
        assert compiled.COUNTS["batch_deferred"] == 1
        assert compiled.wait_batch_captures() <= 1
        outs = cq.run_vmapped(sets, background=True)
        assert len(outs) == 3 and sorted(cq._batches) == [4]
        assert compiled.COUNTS["batch_capture"] == 1
        for o, w in zip(outs, want):
            _same_result(o, w)
        assert cq.batch_bytes > 0
        assert spill.registered_bytes() == cq.batch_bytes
        assert budget.in_use() >= cq.batch_bytes
        nbytes = cq.batch_bytes
        assert spill.reclaim(1) == nbytes
        assert not cq._batches and cq.batch_bytes == 0
        assert spill.registered_bytes() == 0
        outs = cq.run_vmapped(sets)                  # captured again
        assert sorted(cq._batches) == [4]
        for o, w in zip(outs, want):
            _same_result(o, w)
    finally:
        spill.reset()
        budget.reset()
        budget.set_enabled(None)


@pytest.mark.gpu
def test_table_spill_reuses_strings_mirror_on_card(cuda, monkeypatch):
    """A STRING column born on the host keeps an int64 host mirror of its
    int32 offsets: spilling its table copies them from that mirror, not
    from the card, and fault-back restores every byte."""
    from spark_rapids_jni_tpu_torch.column import Column, Table
    from spark_rapids_jni_tpu_torch.memory import budget, spill
    from spark_rapids_jni_tpu_torch.utils import metrics
    rng = np.random.default_rng(3)
    lens = rng.integers(0, 12, 2000)
    offsets = np.zeros(2001, np.int32)
    np.cumsum(lens, out=offsets[1:])
    chars = rng.integers(97, 123, int(offsets[-1])).astype(np.uint8)
    col = Column.strings_from_arrays(chars, offsets, device=cuda)
    table = Table([col])
    want = col.to_pylist()
    monkeypatch.setenv("SRJT_HBM_ARENA", "1")
    budget.set_enabled(None)
    metrics.set_enabled(True)
    try:
        st = spill.SpillableTable(table, "test.strings")
        before = metrics.counter_value("arena.spill.mirror_reuse")
        assert st.spill() > 0
        assert metrics.counter_value("arena.spill.mirror_reuse") > before
        assert table[0].offsets.device.type == "cpu"
        assert st.faultback() > 0
        assert table[0].offsets.device.type == "cuda"
        assert table[0].offsets.dtype == torch.int32
        assert np.array_equal(table[0].offsets.cpu().numpy(), offsets)
        assert table[0].to_pylist() == want
    finally:
        metrics.set_enabled(None)
        budget.set_enabled(None)


@pytest.mark.gpu
@pytest.mark.parametrize("null_fraction", [0.0, 0.1])
def test_staged_pipelined_scan_equals_per_range_scan(cuda, monkeypatch,
                                                     null_fraction):
    """The scan's staging tier on the card: the capped slab waves with
    the walk/stage pipeline and donation give the bytes of the per-range
    uploads (SRJT_STAGE_SLABS=0), in more than one wave."""
    from spark_rapids_jni_tpu_torch.parquet import device_scan, staging
    W = _lineitem_writer()
    raw, _, _ = W.lineitem_parquet(50000, 9, row_group_rows=12000,
                                   null_fraction=null_fraction,
                                   pages_per_chunk=3, codec="SNAPPY")
    made = []

    class Spy(staging.SlabStager):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            made.append(self)
    monkeypatch.setattr(device_scan, "SlabStager", Spy)
    monkeypatch.setattr(staging, "MIN_SLAB_BYTES", 1)
    monkeypatch.setenv("SRJT_STAGE_SLABS", "0")
    per_range = device_scan.scan_table(raw, device=cuda)
    monkeypatch.setenv("SRJT_STAGE_SLABS", "1")
    monkeypatch.setenv("SRJT_STAGE_PIPELINE", "1")
    monkeypatch.setenv("SRJT_STAGE_SLAB_BYTES", "256k")
    monkeypatch.setenv("SRJT_SCAN_DONATE", "1")
    staged = device_scan.scan_table(raw, device=cuda)
    torch.cuda.synchronize()
    assert made[0].transfers > 16 and made[1].transfers > 1
    assert made[1].dropped and made[1].dropped_bytes == sum(
        made[1].wave_bytes)
    for g, c in zip(staged.columns, per_range.columns):
        assert type(g) is type(c)
        assert torch.equal(g.validity_or_true(), c.validity_or_true())
        assert torch.equal(g.data, c.data)                # materializes
        if g.dtype.is_variable_width:
            assert torch.equal(g.offsets, c.offsets)
