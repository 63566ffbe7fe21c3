"""Edge cases of the port's unpack (B3) and segmented-copy (B4) kernels.

Shared by ``tests/test_torch_ragged.py`` (the plain versions against the
JAX package's XLA twins, on the CPU) and ``tests/test_torch_gpu.py`` (the
kernels against their plain versions, on the card); numpy only, so the GPU
tests stay free of JAX.

Both kernels give a CTA a run of consecutive items: B3 about 16 KiB of
output rows (at most 1,024 rows), B4 segments whose destinations span
about 12 KiB (at most 512).  The CTA builds its destination range in a
shared-memory window of 16 KiB and 16 bytes and stores it in 16-byte
chunks, the partial chunk at either end shared with the neighbouring CTA;
a longer range takes several windows.  The cases sit on those edges and
on the shapes TPC-H SF1 lineitem hands the kernels.

Each case is a function of a numpy generator returning the kernel's
arguments as numpy arrays: ``(flat, offsets, M)`` for unpack,
``(src, src_offs, dst_offs, sizes, dst_size)`` for the segmented copy.
"""

import numpy as np


def _bytes(rng, n):
    return rng.integers(1, 256, int(n), dtype=np.uint8)


def _starts(sizes, gaps=0, lead=0):
    """Start of each of ``sizes`` laid out in order with ``gaps`` after
    each, from ``lead``."""
    step = np.asarray(sizes, np.int64) + gaps
    return lead + np.cumsum(step) - step


def unpack_case(rng, M, sizes, lead=0, tail=0):
    sizes = np.asarray(sizes, np.int64)
    offs = np.zeros(sizes.shape[0] + 1, np.int64)
    np.cumsum(sizes, out=offs[1:])
    offs += lead
    return _bytes(rng, offs[-1] + tail), offs, M


UNPACK_EDGE_CASES = {
    # every row empty: the output is all zeros
    "empty_rows": lambda rng: unpack_case(rng, 16, np.zeros(3000)),
    # rows of 0 and 1 byte
    "zero_one_byte": lambda rng: unpack_case(rng, 16,
                                             rng.integers(0, 2, 6000)),
    # 10,000 one-byte rows at M = 1: runs of 1,024 rows, 1 KiB of output
    "one_byte_rows": lambda rng: unpack_case(rng, 1, np.ones(10000)),
    # bytes before the first row and after the last
    "gaps_before_and_after": lambda rng: unpack_case(
        rng, 24, rng.integers(0, 30, 2000), lead=37, tail=53),
    # M over a 16 KiB window: one row a CTA, built in two windows, rows
    # longer and shorter than M
    "wider_than_a_tile": lambda rng: unpack_case(
        rng, 20000, rng.integers(15000, 25001, 5)),
    # the fixed region of JCUDF rows: M = 47 (not a multiple of 8 or 16)
    # out of 8-byte rows of 48-136 bytes
    "fixed_region": lambda rng: unpack_case(
        rng, 47, rng.integers(6, 18, 3000) * 8),
    # M = 33: 496 rows a CTA, whose 16,368 bytes end mid-chunk
    "run_ends_mid_chunk": lambda rng: unpack_case(
        rng, 33, rng.integers(0, 34, 1500)),
    # a 13-byte prefix of rows up to 200 bytes
    "prefix_of_long_rows": lambda rng: unpack_case(
        rng, 13, rng.integers(0, 200, 4000)),
    # one dictionary string column of 1-17 bytes into 32-byte rows (the
    # one-string to_rows)
    "dictionary_strings": lambda rng: unpack_case(
        rng, 32, rng.integers(1, 18, 5000)),
}


def _segments(rng, sizes, dst_gaps=0, src_gaps=0, dst_lead=0, src_lead=0,
              dst_tail=0):
    sizes = np.asarray(sizes, np.int64)
    so = _starts(sizes, src_gaps, src_lead)
    do = _starts(sizes, dst_gaps, dst_lead)
    src = _bytes(rng, (so[-1] + sizes[-1] + 7) if sizes.size else 8)
    dst_size = int(do[-1] + sizes[-1]) + dst_tail if sizes.size else dst_tail
    return src, so, do, sizes, dst_size


def dictionary_to_rows(rng, n=3000, ncols=4, width=80):
    """The to_rows chars of ``ncols`` dictionary string columns of 1-17
    bytes: segments in row order into rows of ``width`` bytes, sources
    column after column in one buffer (``convert._char_region``)."""
    lens = rng.integers(1, 18, (ncols, n))
    col_base = np.concatenate([[0], np.cumsum(lens.sum(1))[:-1]])
    so = np.stack([_starts(lens[c]) + col_base[c] for c in range(ncols)])
    do = np.arange(n)[None, :] * width + np.cumsum(lens, 0) - lens
    src = _bytes(rng, lens.sum())
    return (src, so.T.reshape(-1), do.T.reshape(-1), lens.T.reshape(-1),
            n * width)


def l_comment_strip(rng, n=6000):
    """SF1 l_comment's PLAIN records, 10-43 chars each behind a 4-byte
    length prefix, stripped into one contiguous buffer
    (``device_scan._plain_strings``)."""
    lens = rng.integers(10, 44, n)
    return _segments(rng, lens, src_gaps=4, src_lead=4 + 9)


def _from_rows_column_major(rng, n=2000, fpv=21):
    """The from_rows chars of two string columns out of 8-byte JCUDF rows
    (fixed region ``fpv`` bytes, then each row's chars): sources spread
    over the rows, one column after the other; destinations contiguous
    (``convert._from_rows_strings``)."""
    lens = rng.integers(0, 40, (2, n))
    row_sizes = (fpv + lens.sum(0) + 7) // 8 * 8
    row_start = _starts(row_sizes)
    soff = fpv + np.cumsum(lens, 0) - lens
    so = (row_start[None, :] + soff).reshape(-1)
    sizes = lens.reshape(-1)
    return (_bytes(rng, row_sizes.sum()), so, _starts(sizes), sizes,
            int(sizes.sum()))


SEGCOPY_EDGE_CASES = {
    # every segment empty: the output is all zeros
    "empty_segments": lambda rng: (_bytes(rng, 64), rng.integers(0, 64, 500),
                                   np.zeros(500, np.int64),
                                   np.zeros(500, np.int64), 100),
    # segments of 0 and 1 byte, back to back
    "zero_one_byte": lambda rng: _segments(rng, rng.integers(0, 2, 10000)),
    # 10,000 one-byte segments with gaps on both sides
    "one_byte_segments": lambda rng: _segments(
        rng, np.ones(10000), dst_gaps=rng.integers(0, 4, 10000),
        src_gaps=rng.integers(0, 3, 10000)),
    # zeros before the first segment and after the last
    "gaps_before_and_after": lambda rng: _segments(
        rng, rng.integers(0, 30, 1500), dst_lead=41, dst_tail=29,
        src_lead=3),
    # segments longer than a 16 KiB window, at odd source offsets
    "longer_than_a_tile": lambda rng: _segments(
        rng, rng.integers(16385, 40000, 4), dst_gaps=rng.integers(0, 9, 4),
        src_gaps=5, src_lead=1),
    # mostly short segments with a few of 5,000 bytes: some CTAs' ranges
    # outgrow their window
    "ranges_past_a_window": lambda rng: _segments(
        rng, np.where(rng.random(3000) < 0.02, 5000,
                      rng.integers(0, 20, 3000)),
        dst_gaps=rng.integers(0, 3, 3000)),
    "dictionary_strings_to_rows": dictionary_to_rows,
    "l_comment_strip": l_comment_strip,
    "from_rows_column_major": _from_rows_column_major,
}


# the same shapes at SF1 lineitem's size (6,001,215 rows), for the card:
# the fixed region of its 16-column rows (M = 110 of 112-232 bytes), the
# l_comment strip, and four dictionary strings into rows (1,048,576 rows)
SF1_UNPACK_CASES = {
    "sf1_fixed_region": lambda rng: unpack_case(
        rng, 110, rng.integers(14, 30, 6_001_215) * 8),
}
SF1_SEGCOPY_CASES = {
    "sf1_l_comment_strip": lambda rng: l_comment_strip(rng, 6_001_215),
    "sf1_dictionary_strings_to_rows": lambda rng: dictionary_to_rows(
        rng, 1 << 20),
}


def unpack_loop(flat, offs, M):
    """The unpack, one row at a time in numpy."""
    out = np.zeros((offs.shape[0] - 1, M), np.uint8)
    for r, (lo, hi) in enumerate(zip(offs[:-1], offs[1:])):
        m = min(hi - lo, M)
        out[r, :m] = flat[lo:lo + m]
    return out


def segcopy_loop(src, src_offs, dst_offs, sizes, dst_size):
    """The segmented copy, one segment at a time in numpy."""
    out = np.zeros(dst_size, np.uint8)
    for so, do, sz in zip(src_offs, dst_offs, sizes):
        out[do:do + sz] = src[so:so + sz]
    return out
