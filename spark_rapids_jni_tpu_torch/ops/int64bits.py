"""The int64 bit conventions the ops share.

32-bit values (limbs, hash words, sort lanes) live in int64 tensors masked
with ``MASK32``; ``TOPBIT`` flipped maps uint64's order onto int64's; min
and max reduce in a widened domain (:func:`widened`) from the identity
the JAX package fills null slots with (:func:`identity`).
"""

from __future__ import annotations

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
TOPBIT = -0x8000000000000000          # 1 << 63 as an int64 bit pattern


def widened(data: torch.Tensor) -> tuple[torch.Tensor, object]:
    """Storage → (int64 or float64 in the same order, the inverse map):
    min and max reduce there, whatever the storage width."""
    if data.is_floating_point():
        return data.to(torch.float64), lambda r: r.to(data.dtype)
    if data.dtype == torch.uint64:
        return (data.view(torch.int64) ^ TOPBIT,
                lambda r: (r ^ TOPBIT).view(torch.uint64))
    return data.to(torch.int64), lambda r: r.to(data.dtype)


def identity(storage: np.dtype, agg: str):
    """The identity of min or max in the widened domain, at the storage's
    extreme, as the JAX package fills it."""
    if storage.kind == "f":
        return np.inf if agg == "min" else -np.inf
    info = np.iinfo(storage)
    ident = int(info.max if agg == "min" else info.min)
    if storage == np.uint64:
        ident = (ident - (1 << 64) if ident >= (1 << 63) else ident) ^ TOPBIT
    return ident
