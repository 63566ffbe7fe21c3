"""Ragged ↔ dense byte movement: the three kernels of the JCUDF string path.

Each wrapper checks its tensors and then, by the device they lie on:

* CUDA: launches its hand-written kernel from ``csrc/ragged.cu`` on the
  current stream and adds one to its ``launches`` count, or raises;
* CPU: computes the same bytes with its plain PyTorch version.

There is no other route: no knob or fallback sends a CUDA tensor to the
plain version.  The plain versions follow the gather formulation of the JAX
package's XLA twins (``spark_rapids_jni_tpu/rowconv/ragged.py:632-704``) and
run on any device, which is how the kernels are held against them.

Offsets are int64 tensors on the data's device; sizes the caller already
knows on the host (output lengths) are passed as Python ints, so no wrapper
synchronises with the device or copies from the host, and a CUDA graph can
capture each launch.  Offsets that break the contract, as those of a query
replayed under a stale tape (``models/compiled.py``) do, make no access
outside the buffers: B3 cuts each row at the end of its source and zeroes a
row that starts outside it, B4 clamps each CTA's range to the destination
and each read to the source (``csrc/ragged.cu``), and the plain versions
clamp likewise.
"""

from __future__ import annotations

import torch

from .. import _native


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int,
           device: torch.device) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(t).__name__}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dimension(s), got shape "
                         f"{tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _route(device: torch.device) -> str:
    if device.type == "cpu":
        return "plain"
    if device.type == "cuda":
        return "kernel"
    raise ValueError(f"no kernel for device {device}")


def _launch(fn: str, device: torch.device, *args) -> None:
    _native.launch("ragged", fn, device, *args)


# ---------------------------------------------------------------------------
# B2 pack: dense [n, M] rows → flat bytes (ragged._pack_call, ragged.py:291)
# ---------------------------------------------------------------------------

def pack_rows_plain(dense: torch.Tensor, offsets: torch.Tensor,
                    total: int) -> torch.Tensor:
    """Plain version of :func:`pack_rows`: every output byte gathers its
    source.  Its row comes from a marker cumsum over the row starts."""
    n, M = dense.shape
    dev = dense.device
    if total == 0 or n == 0 or M == 0:
        return torch.zeros(total, dtype=torch.uint8, device=dev)
    markers = torch.zeros(total + 1, dtype=torch.int64, device=dev)
    markers.index_add_(0, offsets[1:-1].clamp(0, total),
                       torch.ones(n - 1, dtype=torch.int64, device=dev))
    row_of = torch.cumsum(markers[:total], 0)
    w = torch.arange(total, dtype=torch.int64, device=dev) - offsets[row_of]
    vals = dense.reshape(-1)[row_of * M + w.clamp(0, M - 1)]
    return torch.where(w < M, vals, torch.zeros_like(vals))


def pack_rows(dense: torch.Tensor, offsets: torch.Tensor,
              total: int) -> torch.Tensor:
    """Pack zero-padded rows into one flat byte buffer.

    ``dense``: uint8 [n, M]; row r's payload is its first
    ``offsets[r+1] - offsets[r]`` bytes (at most M).  ``offsets``: int64
    [n+1], non-decreasing, from 0 to ``total``, byte-granular.
    Returns uint8 [total].
    """
    dev = dense.device
    _check(dense, "dense", torch.uint8, 2, dev)
    _check(offsets, "offsets", torch.int64, 1, dev)
    n, M = dense.shape
    if offsets.shape[0] != n + 1:
        raise ValueError(f"offsets has {offsets.shape[0]} entries, expected {n + 1}")
    if _route(dev) == "plain":
        return pack_rows_plain(dense, offsets, total)
    out = torch.empty(total, dtype=torch.uint8, device=dev)
    if n > 0 and total > 0:
        _launch("srjt_pack_rows", dev, dense.data_ptr(), n, M,
                offsets.data_ptr(), out.data_ptr(), total)
        pack_rows.launches += 1
    return out


pack_rows.launches = 0


# ---------------------------------------------------------------------------
# B3 unpack: flat bytes → dense [n, M] rows (ragged._unpack_call, :417)
# ---------------------------------------------------------------------------

def unpack_rows_plain(flat: torch.Tensor, offsets: torch.Tensor,
                      M: int) -> torch.Tensor:
    """Plain version of :func:`unpack_rows`: an index matrix and a mask."""
    n = offsets.shape[0] - 1
    dev = flat.device
    size = flat.shape[0]
    if n == 0 or M == 0 or size == 0:
        return torch.zeros((n, M), dtype=torch.uint8, device=dev)
    lo = offsets[:-1, None]
    j = torch.arange(M, dtype=torch.int64, device=dev)
    idx = lo + j
    keep = (j < offsets[1:, None] - lo) & (idx < size) & (lo >= 0)
    vals = flat[idx.clamp(0, size - 1)]
    return torch.where(keep, vals, torch.zeros_like(vals))


def unpack_rows(flat: torch.Tensor, offsets: torch.Tensor,
                M: int) -> torch.Tensor:
    """Split a flat byte buffer at ``offsets`` (int64 [n+1]) into
    zero-padded rows uint8 [n, M].  A row longer than M yields its first M
    bytes, which is how the fixed region of JCUDF rows is pulled out."""
    dev = flat.device
    _check(flat, "flat", torch.uint8, 1, dev)
    _check(offsets, "offsets", torch.int64, 1, dev)
    if offsets.shape[0] < 1 or M < 0:
        raise ValueError("unpack_rows needs n+1 >= 1 offsets and M >= 0")
    if _route(dev) == "plain":
        return unpack_rows_plain(flat, offsets, M)
    n = offsets.shape[0] - 1
    out = torch.empty((n, M), dtype=torch.uint8, device=dev)
    if n > 0 and M > 0:
        _launch("srjt_unpack_rows", dev, flat.data_ptr(), flat.shape[0],
                offsets.data_ptr(), n, M, out.data_ptr())
        unpack_rows.launches += 1
    return out


unpack_rows.launches = 0


# ---------------------------------------------------------------------------
# B4 segmented copy (ragged._segcopy_call, :559)
# ---------------------------------------------------------------------------

def segmented_copy_plain(src: torch.Tensor, src_offs: torch.Tensor,
                         dst_offs: torch.Tensor, sizes: torch.Tensor,
                         dst_size: int) -> torch.Tensor:
    """Plain version of :func:`segmented_copy`: each destination byte finds
    its segment by a sorted search over the segment ends."""
    dev = src.device
    k = sizes.shape[0]
    S = src.shape[0]
    if dst_size == 0 or k == 0 or S == 0:
        return torch.zeros(dst_size, dtype=torch.uint8, device=dev)
    o = torch.arange(dst_size, dtype=torch.int64, device=dev)
    seg = torch.searchsorted(dst_offs + sizes, o, right=True).clamp(max=k - 1)
    d0 = dst_offs[seg]
    s0 = src_offs[seg]
    within = o - d0
    pos = s0 + within
    keep = ((within >= 0) & (within < sizes[seg]) & (d0 >= 0) & (s0 >= 0)
            & (pos < S))
    vals = src[pos.clamp(0, S - 1)]
    return torch.where(keep, vals, torch.zeros_like(vals))


def segmented_copy(src: torch.Tensor, src_offs: torch.Tensor,
                   dst_offs: torch.Tensor, sizes: torch.Tensor,
                   dst_size: int) -> torch.Tensor:
    """``dst[dst_offs[k]:+sizes[k]] = src[src_offs[k]:+sizes[k]]`` for
    every k into a zeroed uint8 [dst_size].

    The three int64 [k] arrays are byte-granular.  Destination segments
    are in order and do not overlap; sources may lie anywhere in ``src``.
    """
    dev = src.device
    _check(src, "src", torch.uint8, 1, dev)
    for name, t in (("src_offs", src_offs), ("dst_offs", dst_offs),
                    ("sizes", sizes)):
        _check(t, name, torch.int64, 1, dev)
    k = sizes.shape[0]
    if src_offs.shape[0] != k or dst_offs.shape[0] != k:
        raise ValueError("src_offs, dst_offs and sizes must have one length")
    if _route(dev) == "plain":
        return segmented_copy_plain(src, src_offs, dst_offs, sizes, dst_size)
    if k == 0 or dst_size == 0 or src.shape[0] == 0:
        return torch.zeros(dst_size, dtype=torch.uint8, device=dev)
    # the kernel writes every byte of dst, gaps included
    out = torch.empty(dst_size, dtype=torch.uint8, device=dev)
    _launch("srjt_segmented_copy", dev, src.data_ptr(), src.shape[0],
            src_offs.data_ptr(), dst_offs.data_ptr(), sizes.data_ptr(),
            k, out.data_ptr(), dst_size)
    segmented_copy.launches += 1
    return out


segmented_copy.launches = 0

# every kernel wrapper of this module, in the order of the kernel table
KERNELS = (pack_rows, unpack_rows, segmented_copy)


def reset_launches() -> None:
    for fn in KERNELS:
        fn.launches = 0


def launch_counts() -> dict[str, int]:
    return {fn.__name__: fn.launches for fn in KERNELS}
