"""Murmur3 x86_32, Spark-compatible, on whole columns.

The port's counterpart of the JAX package's ``ops/hashing.py``.  Spark's
shuffle partitioner hashes with Murmur3 x86_32 and seed 42, an int as one
4-byte block and a long as two (low word first).  The 32-bit arithmetic
runs in int64 tensors masked to 32 bits after every multiply and shift
(torch's uint32 lacks those operators on some backends); a product of two
32-bit values wraps mod 2^64 in int64, and its low 32 bits, the only ones
kept, are exact.  Hashes come back as int64 tensors holding the JAX
package's uint32 values.
"""

from __future__ import annotations

import torch

from .int64bits import MASK32

DEFAULT_SEED = 42             # Spark's Murmur3Hash seed

_C1 = 0xCC9E2D51
_C2 = 0x1B873593
# second chain's seed for 64-bit fingerprints, far from Spark's 42
_FP_SEED_HI = 0x9E3779B9


def _rotl32(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK32


def _mix_k(k: torch.Tensor) -> torch.Tensor:
    k = (k * _C1) & MASK32
    k = _rotl32(k, 15)
    return (k * _C2) & MASK32


def _mix_h(h: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    h = h ^ _mix_k(k)
    h = _rotl32(h, 13)
    return (h * 5 + 0xE6546B64) & MASK32


def _fmix(h: torch.Tensor) -> torch.Tensor:
    h = h ^ (h >> 16)
    h = (h * 0x85EBCA6B) & MASK32
    h = h ^ (h >> 13)
    h = (h * 0xC2B2AE35) & MASK32
    return h ^ (h >> 16)


def murmur3_32(values: torch.Tensor, seed=DEFAULT_SEED) -> torch.Tensor:
    """Hash every element; int64 [n] of 32-bit hashes.

    8-, 16- and 32-bit integers and booleans hash as one 4-byte block
    (sign-extended to 32 bits, as Spark does); 64-bit integers as two,
    the low word first; float32 by its bits, -0.0 as 0.0 and every NaN as
    0x7FC00000.  ``seed`` is an int or a tensor of seeds, one a row (a
    chain over several columns)."""
    dt = values.dtype
    if dt == torch.float64:
        raise TypeError("murmur3_32: float64 keys are not hashable, as in "
                        "the JAX package; cast or hash on the host")
    if dt == torch.float32:
        v = torch.where(values == 0.0, 0.0, values)
        bits = v.view(torch.int32).to(torch.int64) & MASK32
        block = torch.where(torch.isnan(v), 0x7FC00000, bits)
        wide = False
    elif dt in (torch.int64, torch.uint64):
        wide = True
        v = values.view(torch.int64)
    elif dt == torch.bool or not dt.is_floating_point:
        block = values.to(torch.int64) & MASK32
        wide = False
    else:
        raise TypeError(f"murmur3_32: unsupported key dtype {dt}")
    if isinstance(seed, torch.Tensor):
        h = (seed.to(torch.int64) & MASK32).expand(values.shape).clone()
    else:
        h = torch.full(values.shape, int(seed) & MASK32, dtype=torch.int64,
                       device=values.device)
    if wide:
        h = _mix_h(h, v & MASK32)
        h = _mix_h(h, (v >> 32) & MASK32)
        length = 8
    else:
        h = _mix_h(h, block)
        length = 4
    return _fmix(h ^ length)


def fingerprint64(lanes) -> torch.Tensor:
    """Order-sensitive 64-bit fingerprint of a key tuple, int64 [n]: two
    murmur3 chains in Spark's multi-column shape (each column's hash seeds
    the next) from two seeds, the low and high words.  Collisions are
    possible: a fingerprint is a probe, not a proof of equality."""
    if not lanes:
        raise ValueError("fingerprint64: at least one key lane required")
    lo = hi = None
    for lane in lanes:
        lo = murmur3_32(lane, DEFAULT_SEED if lo is None else lo)
        hi = murmur3_32(lane, _FP_SEED_HI if hi is None else hi)
    return lo | (hi << 32)


def hash_partition(hashes: torch.Tensor, num_partitions: int) -> torch.Tensor:
    """Spark's non-negative modulo partitioning: int32 [n] in [0, P) of
    each hash read as a signed 32-bit int."""
    signed = ((hashes.to(torch.int64) & MASK32) ^ 0x80000000) - 0x80000000
    return torch.remainder(signed, num_partitions).to(torch.int32)
