"""The JAX package's PRNG, on the host in numpy: threefry2x32 and the
key operations its ``ml/pipeline.py`` draws its epoch shuffles from.

The card's machine runs no JAX, yet the port's shuffles must be the JAX
package's bit for bit (a pipeline is a pure function of (seed, epoch)).
So this module carries ``jax.random``'s default implementation as
installed with JAX 0.9.0, under ``jax_threefry_partitionable=True`` (its
default) and 64-bit seeds (the JAX package enables x64):

* :func:`threefry2x32` — the Threefry-2x32 block cipher, 20 rounds;
* :func:`prng_key` — ``jax.random.PRNGKey(seed)``: the seed's two 32-bit
  halves, high first;
* :func:`fold_in` — ``jax.random.fold_in(key, data)``: the cipher of the
  counter pair ``(0, data)`` under ``key``;
* :func:`split` — ``jax.random.split(key, num)``: counter pairs
  ``(0, i)``, one key each;
* :func:`bits` — ``jax.random.bits(key, (n,), uint32)``: the two cipher
  words of counter ``(0, i)`` XORed;
* :func:`permutation` — ``jax.random.permutation(key, n)``: rounds of a
  stable sort of ``arange(n)`` by fresh 32-bit keys.

Keys are pairs of Python ints; words are uint32 values held in uint64
arrays (every sum and shift masked), so no operation overflows.  All of
it runs on the host: a pipeline's per-epoch round keys are four words,
which cost the card no synchronisation.
"""

from __future__ import annotations

import math

import numpy as np

_MASK = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x: np.ndarray, d: int) -> np.ndarray:
    return ((x << np.uint64(d)) | (x >> np.uint64(32 - d))) & np.uint64(_MASK)


def threefry2x32(key, x0, x1) -> tuple[np.ndarray, np.ndarray]:
    """The Threefry-2x32 hash of the counter words ``(x0, x1)`` (arrays of
    one shape) under ``key`` (two ints)."""
    m = np.uint64(_MASK)
    k0, k1 = int(key[0]) & _MASK, int(key[1]) & _MASK
    ks = [np.uint64(k0), np.uint64(k1), np.uint64(k0 ^ k1 ^ _PARITY)]
    a = (np.asarray(x0, dtype=np.uint64) + ks[0]) & m
    b = (np.asarray(x1, dtype=np.uint64) + ks[1]) & m
    for i in range(5):
        for r in _ROT[i % 2]:
            a = (a + b) & m
            b = _rotl(b, r) ^ a
        a = (a + ks[(i + 1) % 3]) & m
        b = (b + ks[(i + 2) % 3] + np.uint64(i + 1)) & m
    return a, b


def prng_key(seed: int) -> tuple[int, int]:
    """``jax.random.PRNGKey(seed)`` for a 64-bit seed."""
    s = int(seed) & 0xFFFFFFFFFFFFFFFF
    return (s >> 32, s & _MASK)


def fold_in(key, data: int) -> tuple[int, int]:
    """``jax.random.fold_in(key, data)`` (``data`` taken as uint32)."""
    a, b = threefry2x32(key, [0], [int(data) & _MASK])
    return (int(a[0]), int(b[0]))


def split(key, num: int = 2) -> list[tuple[int, int]]:
    """``jax.random.split(key, num)``."""
    a, b = threefry2x32(key, np.zeros(num, np.uint64),
                        np.arange(num, dtype=np.uint64))
    return [(int(x), int(y)) for x, y in zip(a, b)]


def bits(key, n: int) -> np.ndarray:
    """``jax.random.bits(key, (n,), uint32)`` as uint32."""
    a, b = threefry2x32(key, np.zeros(n, np.uint64),
                        np.arange(n, dtype=np.uint64))
    return (a ^ b).astype(np.uint32)


def permutation(key, n: int) -> np.ndarray:
    """``jax.random.permutation(key, n)`` as int64: ``ceil(3 ln n /
    ln(2^32 - 1))`` rounds, each a stable sort of the current order by
    32-bit keys drawn from a fresh subkey."""
    x = np.arange(n, dtype=np.int64)
    rounds = int(np.ceil(3 * math.log(max(1, n)) / math.log(_MASK)))
    for _ in range(rounds):
        key, sub = split(key)
        x = x[np.argsort(bits(sub, n), kind="stable")]
    return x
