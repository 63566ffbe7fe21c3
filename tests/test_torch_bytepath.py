"""Kernels B5–B7 of the port (``rowconv/bytepath.py``) against the JAX
package's Pallas kernels, on the CPU.

On CPU tensors each wrapper runs its plain PyTorch version; the JAX side
runs ``xpallas.try_*`` in Pallas interpret mode, as
``tests/test_bytepath.py:128-167`` does.  Both get the same numpy inputs
and must give the same words (exact: these functions move bytes).  The
kernels themselves are held against these plain versions on the card
(``tests/test_torch_gpu.py``, ``chip_smoke.py``).
"""

import torch_one_thread  # noqa: F401  (first: one intra-op thread)
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from spark_rapids_jni_tpu.rowconv import xpallas

from spark_rapids_jni_tpu_torch.rowconv import bytepath


def _u32(t: torch.Tensor) -> np.ndarray:
    return np.ascontiguousarray(t.numpy()).view(np.uint32)


def _no_launches(fn):
    before = bytepath.launch_counts()
    out = fn()
    assert bytepath.launch_counts() == before      # CPU: the plain version
    return out


# ---------------------------------------------------------------------------
# B7 u8 → u32
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("start", [0, 1, 2, 3, 5, 513])
def test_u8_to_u32_matches_pallas(monkeypatch, start):
    monkeypatch.setenv("SRJT_PALLAS_TRANSPOSE", "interpret")
    rng = np.random.default_rng(start)
    n_words = 512 * 3
    raw = rng.integers(0, 256, start + 4 * n_words + 7, dtype=np.int64) \
        .astype(np.uint8)
    # the Pallas kernel takes an aligned [4N] block; the port takes the
    # same bytes at any offset of a larger buffer
    want = np.asarray(xpallas.try_u8_to_u32(
        jnp.asarray(raw[start:start + 4 * n_words])))
    got = _no_launches(lambda: bytepath.u8_to_u32(
        torch.from_numpy(raw), start, n_words))
    assert got.dtype == torch.int32 and got.shape == (n_words,)
    np.testing.assert_array_equal(_u32(got), want)
    np.testing.assert_array_equal(
        _u32(got), raw[start:start + 4 * n_words].view("<u4"))


# B7's geometry: every start % 16 (its vectors' alignment) with whole
# 16-byte units and 1-3 words left over, single words and none
B7_PAD_BYTES = 4096          # one Pallas block shape for every case


@pytest.mark.parametrize("n_words", [0, 1, 3, 4, 5, 4 * 200 + 3])
@pytest.mark.parametrize("start", range(16))
def test_u8_to_u32_every_start_matches_pallas(monkeypatch, start, n_words):
    monkeypatch.setenv("SRJT_PALLAS_TRANSPOSE", "interpret")
    rng = np.random.default_rng(16 * start + n_words)
    # the source ends exactly at the tensor's end
    raw = rng.integers(0, 256, start + 4 * n_words, dtype=np.int64) \
        .astype(np.uint8)
    # the Pallas kernel takes whole 512-byte blocks: the same bytes,
    # zero-padded, and the first n_words of its words
    block = np.zeros(B7_PAD_BYTES, np.uint8)
    block[:4 * n_words] = raw[start:]
    want = np.asarray(xpallas.try_u8_to_u32(jnp.asarray(block)))[:n_words]
    got = _no_launches(lambda: bytepath.u8_to_u32(
        torch.from_numpy(raw), start, n_words))
    assert got.dtype == torch.int32 and got.shape == (n_words,)
    np.testing.assert_array_equal(_u32(got), want)
    np.testing.assert_array_equal(_u32(got), raw[start:].view("<u4"))


def test_u8_to_u32_owns_its_words_and_checks_bounds():
    src = torch.arange(40, dtype=torch.uint8)
    got = bytepath.u8_to_u32(src, 3, 9)
    src.zero_()
    assert int(got[0]) == 3 | (4 << 8) | (5 << 16) | (6 << 24)
    assert bytepath.u8_to_u32(src, 40, 0).shape == (0,)
    with pytest.raises(ValueError, match="outside"):
        bytepath.u8_to_u32(src, 5, 9)
    with pytest.raises(TypeError):
        bytepath.u8_to_u32(src.to(torch.int32), 0, 1)


def test_u8_to_u32_sign_bit_words():
    raw = np.array([0xFF, 0xFF, 0xFF, 0xFF, 0x00, 0x00, 0x00, 0x80, 0x01],
                   np.uint8)
    got = bytepath.u8_to_u32(torch.from_numpy(raw), 1, 2)
    np.testing.assert_array_equal(_u32(got), raw[1:9].view("<u4"))


# ---------------------------------------------------------------------------
# B5 extract rows
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rows,M,max_len", [(50, 48, 40), (50, 16, 40),
                                            (1, 8, 30), (200, 64, 5),
                                            (33, 32, 0)])
def test_extract_rows_matches_pallas(monkeypatch, rows, M, max_len):
    """Rows shorter than M, longer than M (cut to their first M bytes),
    empty rows and a one-row dictionary."""
    monkeypatch.setenv("SRJT_PALLAS_EXTRACT", "interpret")
    rng = np.random.default_rng(rows * M)
    lens = rng.integers(0, max_len + 1, rows)
    offs = np.zeros(rows + 1, np.int64)
    offs[1:] = np.cumsum(lens)
    payload = rng.integers(0, 256, int(offs[-1]) + 3, dtype=np.int64) \
        .astype(np.uint8)
    got = _no_launches(lambda: bytepath.extract_rows(
        torch.from_numpy(payload), offs, M))
    assert got.dtype == torch.int32 and got.shape == (rows, M // 4)
    dense = _u32(got).view(np.uint8).reshape(rows, M)
    for j in range(rows):
        ln = min(int(lens[j]), M)
        np.testing.assert_array_equal(dense[j, :ln],
                                      payload[offs[j]:offs[j] + ln])
        assert not dense[j, ln:].any()
    if int(offs[-1]):
        want = np.asarray(xpallas.try_extract_rows(
            jnp.asarray(payload[:int(offs[-1])]), offs, M))
        np.testing.assert_array_equal(dense, want)


@pytest.mark.parametrize("rows,M,max_len", [(50, 48, 40), (50, 16, 40),
                                            (1, 8, 30), (200, 64, 5),
                                            (33, 32, 0)])
def test_extract_rows_device_offsets_match_host_and_pallas(monkeypatch, rows,
                                                           M, max_len):
    """Offsets handed as an int64 tensor on the data's device (as
    ``DictColumn.materialize`` now hands them, with no copy) give the same
    words as host offsets, and both the JAX package's Pallas kernel's."""
    monkeypatch.setenv("SRJT_PALLAS_EXTRACT", "interpret")
    rng = np.random.default_rng(rows * M + 1)
    lens = rng.integers(0, max_len + 1, rows)
    offs = np.zeros(rows + 1, np.int64)
    offs[1:] = np.cumsum(lens)
    payload = rng.integers(0, 256, int(offs[-1]) + 3, dtype=np.int64) \
        .astype(np.uint8)
    flat = torch.from_numpy(payload)
    got = _no_launches(lambda: bytepath.extract_rows(
        flat, torch.from_numpy(offs), M))
    host = bytepath.extract_rows(flat, offs, M)
    assert torch.equal(got, host)
    if int(offs[-1]):
        want = np.asarray(xpallas.try_extract_rows(
            jnp.asarray(payload[:int(offs[-1])]), offs, M))
        np.testing.assert_array_equal(_u32(got).view(np.uint8)
                                      .reshape(rows, M), want)
    else:
        assert not got.any()
    with pytest.raises(TypeError, match="int64"):
        bytepath.extract_rows(flat, torch.from_numpy(offs).to(torch.int32), M)


def test_extract_rows_odd_width_and_empty():
    flat = torch.arange(1, 11, dtype=torch.uint8)
    got = bytepath.extract_rows(flat, [0, 3, 10], 5)       # 2 words a row
    dense = _u32(got).view(np.uint8).reshape(2, 8)
    np.testing.assert_array_equal(dense[0], [1, 2, 3, 0, 0, 0, 0, 0])
    np.testing.assert_array_equal(dense[1], [4, 5, 6, 7, 8, 0, 0, 0])
    assert bytepath.extract_rows(flat, [0], 8).shape == (0, 2)
    assert bytepath.extract_rows(torch.zeros(0, dtype=torch.uint8),
                                 [0, 0, 0], 4).abs().sum() == 0


# ---------------------------------------------------------------------------
# B6 gather rows
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("D,W,n", [(77, 19, 999), (1, 4, 300), (5, 1, 64),
                                   (300, 8, 4097)])
def test_gather_rows_matches_pallas(monkeypatch, D, W, n):
    monkeypatch.setenv("SRJT_PALLAS_DICT_GATHER", "interpret")
    rng = np.random.default_rng(D * W)
    mat = rng.integers(0, 2**32, (D, W), dtype=np.int64).astype(np.uint32)
    idx = rng.integers(0, D, n).astype(np.int32)
    want = np.asarray(xpallas.try_gather_rows(jnp.asarray(mat),
                                              jnp.asarray(idx)))
    got = _no_launches(lambda: bytepath.gather_rows(
        torch.from_numpy(mat.view(np.int32)), torch.from_numpy(idx)))
    np.testing.assert_array_equal(_u32(got), want)
    np.testing.assert_array_equal(_u32(got), mat[idx])


def test_gather_rows_checks_codes():
    mat = torch.zeros((3, 4), dtype=torch.int32)
    with pytest.raises(IndexError, match="outside"):
        bytepath.gather_rows(mat, torch.tensor([0, 3], dtype=torch.int32))
    with pytest.raises(IndexError):
        bytepath.gather_rows(mat, torch.tensor([-1], dtype=torch.int32))
    with pytest.raises(TypeError):
        bytepath.gather_rows(mat, torch.tensor([0], dtype=torch.int64))
    assert bytepath.gather_rows(mat, torch.zeros(0, dtype=torch.int32)) \
        .shape == (0, 4)
    with pytest.raises(ValueError, match="no kernel"):
        bytepath.gather_rows(mat.to("meta"),
                             torch.zeros(1, dtype=torch.int32, device="meta"))


def test_b5_b6_b2_chain_is_the_dictionary_gather():
    """extract → gather → pack gives each code's entry bytes back to back:
    the materialization DictColumn runs."""
    from spark_rapids_jni_tpu_torch.rowconv import ragged
    entries = [b"AIR", b"REG AIR", b"", b"DELIVER IN PERSON"]
    offs = np.cumsum([0] + [len(e) for e in entries])
    flat = torch.frombuffer(bytearray(b"".join(entries)), dtype=torch.uint8)
    mat = bytepath.extract_rows(flat, offs, 32)
    codes = torch.tensor([3, 0, 2, 1, 1, 3], dtype=torch.int32)
    rows = bytepath.gather_rows(mat, codes)
    lens = torch.tensor([len(entries[c]) for c in codes.tolist()])
    dst = torch.zeros(7, dtype=torch.int64)
    torch.cumsum(lens, 0, out=dst[1:])
    chars = ragged.pack_rows(rows.view(torch.uint8), dst, int(dst[-1]))
    assert bytes(chars.numpy()) == b"".join(entries[c] for c in codes.tolist())
