"""Byte-path kernels of the device Parquet scan: dictionary row extraction,
dictionary row gather, and the byte → word transcode.

The port's counterpart of the JAX package's ``rowconv/xpallas.py`` (kernels
B5–B7 of the kernel table).  It keeps what each Pallas kernel computes and
drops the rest: no knob, no envelope check, no ``None`` return.  Each
wrapper checks its tensors and then, by the device they lie on:

* CUDA: launches its hand-written kernel (B6 and B7 from
  ``csrc/bytepath.cu``; B5 B3's from ``csrc/ragged.cu``, which computes the
  same bytes) on the current stream and adds one to its ``launches``
  count, or raises;
* CPU: computes the same words with its plain PyTorch version.

Words are int32 tensors, bit for bit the uint32 words of the JAX package
(``torch.uint32`` has few operators).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _native
from ..utils import syncs
from .ragged import _check, _route


def _launch(fn: str, device: torch.device, *args) -> None:
    _native.launch("bytepath", fn, device, *args)


def _words_from_bytes(b: torch.Tensor) -> torch.Tensor:
    """uint8 [..., 4k] → int32 [..., k], little-endian, by arithmetic (so
    it runs on any device and any tensor, empty ones included)."""
    q = b.reshape(*b.shape[:-1], -1, 4).to(torch.int64)
    w = q[..., 0] | (q[..., 1] << 8) | (q[..., 2] << 16) | (q[..., 3] << 24)
    return (w - ((w >> 31) << 32)).to(torch.int32)


# ---------------------------------------------------------------------------
# B5 extract: flat chars at offsets → zero-padded word rows
# (xpallas._extract_call, xpallas.py:312)
# ---------------------------------------------------------------------------

def _offsets_on(offsets, device: torch.device) -> torch.Tensor:
    """B5's offsets as int64 [D+1] on ``device``: a tensor as it is (it
    must lie there already), host values copied there."""
    if isinstance(offsets, torch.Tensor):
        _check(offsets, "offsets", torch.int64, 1, device)
        offs = offsets
    else:
        offs = torch.from_numpy(np.ascontiguousarray(
            offsets, dtype=np.int64).reshape(-1)).to(device)
    if offs.shape[0] < 1:
        raise ValueError("extract_rows needs D+1 >= 1 offsets")
    return offs


def extract_rows_plain(flat: torch.Tensor, offsets, M: int) -> torch.Tensor:
    """Plain version of :func:`extract_rows`: an index matrix and a mask."""
    offs = _offsets_on(offsets, flat.device)
    D = offs.shape[0] - 1
    Mw = -(-M // 4)
    size = flat.shape[0]
    if D == 0 or Mw == 0 or size == 0:
        return torch.zeros((D, Mw), dtype=torch.int32, device=flat.device)
    lo = offs[:-1, None]
    j = torch.arange(Mw * 4, dtype=torch.int64, device=flat.device)
    idx = lo + j
    keep = ((j < (offs[1:, None] - lo).clamp(max=M)) & (idx < size)
            & (lo >= 0))
    vals = flat[idx.clamp(0, size - 1)]
    return _words_from_bytes(torch.where(keep, vals, torch.zeros_like(vals)))


def extract_rows(flat: torch.Tensor, offsets, M: int) -> torch.Tensor:
    """Cut a flat byte buffer at ``offsets`` (int64 [D+1]) into rows of
    ``M`` bytes, zero-padded (a longer row yields its first M bytes), as
    little-endian words: int32 [D, ceil(M/4)].

    ``offsets`` is an int64 tensor on the data's device, which costs the
    call no copy, or host values (a list or numpy array), which it copies
    there.  This builds the padded dictionary-string matrix that
    :func:`gather_rows` reads.  On the card it launches B3's kernel
    (``csrc/ragged.cu`` ``unpack_rows_kernel``), which computes the same
    bytes; a width M that is not whole words is padded after it."""
    dev = flat.device
    _check(flat, "flat", torch.uint8, 1, dev)
    if M < 0:
        raise ValueError("extract_rows needs M >= 0")
    offs = _offsets_on(offsets, dev)
    if _route(dev) == "plain":
        return extract_rows_plain(flat, offs, M)
    D = offs.shape[0] - 1
    Mw = -(-M // 4)
    if D == 0 or Mw == 0:
        return torch.zeros((D, Mw), dtype=torch.int32, device=dev)
    # B3's kernel computes these bytes: rows cut to M bytes and zero-padded,
    # every byte written; rows of whole words are the words themselves
    rows = torch.empty((D, M), dtype=torch.uint8, device=dev)
    _native.launch("ragged", "srjt_unpack_rows", dev, flat.data_ptr(),
                   flat.shape[0], offs.data_ptr(), D, M, rows.data_ptr())
    extract_rows.launches += 1
    if M % 4:
        rows = torch.nn.functional.pad(rows, (0, 4 * Mw - M))
    return rows.view(torch.int32)


extract_rows.launches = 0


# ---------------------------------------------------------------------------
# B6 gather: out[i] = mat[idx[i]] over word rows (xpallas._gather_call, :405)
# ---------------------------------------------------------------------------

def gather_rows_plain(mat: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`gather_rows`: one flat word gather."""
    D, W = mat.shape
    n = idx.shape[0]
    if n == 0 or W == 0:
        return torch.zeros((n, W), dtype=torch.int32, device=mat.device)
    cols = torch.arange(W, dtype=torch.int64, device=mat.device)
    flat_idx = idx.to(torch.int64)[:, None] * W + cols
    return mat.reshape(-1)[flat_idx]


def check_codes(idx: torch.Tensor, D: int) -> None:
    """Raise unless every code of the non-empty ``idx`` lies in [0, D).
    The least and greatest go through ``utils.syncs.scalar``: two tape
    entries, in this order."""
    lo_t, hi_t = torch.aminmax(idx)
    lo, hi = syncs.scalar(lo_t), syncs.scalar(hi_t)
    if lo < 0 or hi >= D:
        raise IndexError(f"gather_rows: codes span [{lo}, {hi}], "
                         f"outside the {D} rows of the matrix")


def gather_rows(mat: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Dictionary row gather: ``out[i] = mat[idx[i]]`` for int32 word rows
    ``mat`` [D, W] and int32 codes ``idx`` [n]; returns int32 [n, W].

    Every code must lie in [0, D): the wrapper checks that and raises
    otherwise.  The codes' least and greatest go through the sync funnel
    (``utils.syncs.scalar``), so that a compiled query reads them from
    its tape and the check holds them against the data afterwards; under
    a replay the codes are clamped into [0, D), so that a stale tape
    never reads outside the matrix."""
    dev = mat.device
    _check(mat, "mat", torch.int32, 2, dev)
    _check(idx, "idx", torch.int32, 1, dev)
    D, W = mat.shape
    n = idx.shape[0]
    route = _route(dev)
    if n > 0:
        check_codes(idx, D)
        if syncs.mode() == "replay":
            idx = idx.clamp(0, max(D - 1, 0))
    if route == "plain":
        return gather_rows_plain(mat, idx)
    out = torch.empty((n, W), dtype=torch.int32, device=dev)
    if n > 0 and W > 0:
        _launch("srjt_gather_rows", dev, mat.data_ptr(), D, W,
                idx.data_ptr(), n, out.data_ptr())
        gather_rows.launches += 1
    return out


gather_rows.launches = 0


# ---------------------------------------------------------------------------
# B7 u8 → u32: bytes at any offset → owned little-endian words
# (xpallas._transpose_call, :486)
# ---------------------------------------------------------------------------

def u8_to_u32_plain(src: torch.Tensor, start: int,
                    n_words: int) -> torch.Tensor:
    """Plain version of :func:`u8_to_u32`."""
    return _words_from_bytes(src[start:start + 4 * n_words])


def u8_to_u32(src: torch.Tensor, start: int, n_words: int) -> torch.Tensor:
    """``n_words`` little-endian words from the bytes of ``src`` (uint8
    [S]) at ``start``, any byte offset, into a new int32 [n_words] tensor
    that owns its storage (``src`` may be freed afterwards)."""
    dev = src.device
    _check(src, "src", torch.uint8, 1, dev)
    if start < 0 or n_words < 0 or start + 4 * n_words > src.shape[0]:
        raise ValueError(f"u8_to_u32: bytes [{start}, {start + 4 * n_words})"
                         f" lie outside a source of {src.shape[0]}")
    if _route(dev) == "plain":
        return u8_to_u32_plain(src, start, n_words)
    out = torch.empty(n_words, dtype=torch.int32, device=dev)
    if n_words > 0:
        _launch("srjt_u8_to_u32", dev, src.data_ptr() + start, n_words,
                out.data_ptr())
        u8_to_u32.launches += 1
    return out


u8_to_u32.launches = 0

# every kernel wrapper of this module, in the order of the kernel table
KERNELS = (extract_rows, gather_rows, u8_to_u32)


def reset_launches() -> None:
    for fn in KERNELS:
        fn.launches = 0


def launch_counts() -> dict[str, int]:
    return {fn.__name__: fn.launches for fn in KERNELS}
