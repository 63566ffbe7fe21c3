"""Pack windows: the last step of to_rows for tables with strings (B1).

The port's counterpart of the JAX package's ``rowconv/xpack.py``
``pack_windows`` (:207-221) and its Pallas kernel
``xpallas._packwin_call`` (``xpallas.py:186``).  Zero-padded rows of 32-bit
words are packed into one flat word stream at word offsets that stay on
the device, so no host synchronisation is needed to place them.  JCUDF
rows are 8-byte aligned, so every row is whole words.

The wrapper checks its tensors and then, by the device they lie on:

* CUDA: launches the hand-written kernel from ``csrc/xpack.cu`` on the
  current stream, one launch a call, and adds one to its ``launches``
  count, or raises;
* CPU: computes the same words with its plain PyTorch version.

The JAX package's slab gathers, byte rolls, shape buckets and the row-width
cap of its engine (``xpack.py:533``) were TPU work-arounds and are not
carried over.  Words are int32 tensors, bit for bit the uint32 words of the
JAX package.
"""

from __future__ import annotations

import torch

from .. import _native
from .ragged import _check, _route


def pack_windows_plain(dense_w: torch.Tensor, dst_w: torch.Tensor,
                       total_w: int) -> torch.Tensor:
    """Plain version of :func:`pack_windows`: every output word finds its
    row by a sorted search over ``dst_w``, then one gather."""
    n, Mw = dense_w.shape
    dev = dense_w.device
    if total_w == 0 or n == 0 or Mw == 0:
        return torch.zeros(total_w, dtype=torch.int32, device=dev)
    w = torch.arange(total_w, dtype=torch.int64, device=dev)
    r = torch.searchsorted(dst_w, w, right=True) - 1
    live = (r >= 0) & (r < n)
    r = r.clamp(0, n - 1)
    k = w - dst_w[r]
    keep = live & (k < Mw) & (k < dst_w[r + 1] - dst_w[r])
    vals = dense_w.reshape(-1)[r * Mw + k.clamp(0, Mw - 1)]
    return torch.where(keep, vals, torch.zeros_like(vals))


def pack_windows(dense_w: torch.Tensor, dst_w: torch.Tensor,
                 total_w: int) -> torch.Tensor:
    """Pack zero-padded word rows into one flat word stream.

    ``dense_w``: int32 [n, Mw]; row r's payload is its first
    ``dst_w[r+1] - dst_w[r]`` words (at most Mw).  ``dst_w``: int64 [n+1]
    word offsets on the data's device, non-decreasing from 0.
    ``total_w``: the output length, which the caller already knows on the
    host (words past ``dst_w[n]`` are zero).  Returns int32 [total_w]."""
    dev = dense_w.device
    _check(dense_w, "dense_w", torch.int32, 2, dev)
    _check(dst_w, "dst_w", torch.int64, 1, dev)
    n, Mw = dense_w.shape
    if dst_w.shape[0] != n + 1:
        raise ValueError(f"dst_w has {dst_w.shape[0]} entries, expected {n + 1}")
    if total_w < 0:
        raise ValueError(f"total_w must be >= 0, got {total_w}")
    if _route(dev) == "plain":
        return pack_windows_plain(dense_w, dst_w, total_w)
    if n == 0 or Mw == 0:
        return torch.zeros(total_w, dtype=torch.int32, device=dev)
    # the kernel writes every word of out: no fill
    out = torch.empty(total_w, dtype=torch.int32, device=dev)
    if total_w > 0:
        _native.launch("xpack", "srjt_pack_windows", dev, dense_w.data_ptr(),
                       n, Mw, dst_w.data_ptr(), out.data_ptr(), total_w)
        pack_windows.launches += 1
    return out


pack_windows.launches = 0

# every kernel wrapper of this module, in the order of the kernel table
KERNELS = (pack_windows,)


def reset_launches() -> None:
    for fn in KERNELS:
        fn.launches = 0


def launch_counts() -> dict[str, int]:
    return {fn.__name__: fn.launches for fn in KERNELS}
