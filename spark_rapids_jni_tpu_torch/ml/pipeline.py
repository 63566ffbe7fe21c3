"""Epoch/batch iterator over a packed FeatureBatch — no steady-state syncs.

The port's counterpart of the JAX package's ``ml/pipeline.py``.  Each
epoch shuffles and re-slices the whole matrix on the card:
``permutation(seed, epoch) → gather → reshape`` to
``[num_batches, batch, k]``.  The shuffle is a pure function of (seed,
epoch), bit-identical to the JAX package's: any replica reproduces the
exact batch sequence from the two integers.

Two shuffle engines (``SRJT_ML_SHUFFLE``):

* ``feistel`` (default) — a 4-round Feistel bijection over ``[0, 2^m)``
  (``2^m`` the next even-bit power of two ≥ n) followed by a cumsum
  compaction to ``[0, n)``, as elementwise 32-bit arithmetic on the card
  (int64 tensors masked to 32 bits; a 32-bit product is taken in 16-bit
  halves so that no int64 overflows).  Its four round keys are
  ``bits(fold_in(PRNGKey(seed), epoch), 4)``, computed on the host
  (:mod:`.prng`) and copied up from pinned memory without a wait.
* ``sort`` — ``jax.random.permutation``'s sorting rounds, on the host
  (:func:`.prng.permutation`), kept as the cross-check; the permutation
  goes up the same way.

The steady-state contract (``tests/test_torch_gpu.py``): an epoch's
arrays come with ZERO host synchronisations.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..utils import knobs, metrics
from . import prng
from .features import FeatureBatch

_FEISTEL_ROUNDS = 4
_M32 = 0xFFFFFFFF


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """``(a * c) mod 2^32`` for int64 ``a`` in [0, 2^32) and a 32-bit
    constant ``c``, in 16-bit halves of ``c`` (no product reaches
    2^63)."""
    lo = a * (c & 0xFFFF)
    hi = ((a * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _to_device(host: np.ndarray, device) -> torch.Tensor:
    """A host array on ``device``: on a card, by a copy from pinned memory
    that does not wait for the card."""
    t = torch.from_numpy(host)
    if torch.device(device).type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def feistel_permutation(round_keys, n: int, m: int,
                        device) -> torch.Tensor:
    """The JAX package's sort-free permutation of ``[0, n)`` (int64), on
    ``device``, for its four 32-bit ``round_keys`` (a host array) and the
    even bit width ``m`` (``2^m ≥ n``)."""
    h = m // 2
    lo_mask = (1 << h) - 1
    rk = _to_device(np.asarray(round_keys, dtype=np.int64), device)
    idx = torch.arange(1 << m, dtype=torch.int64, device=device)
    left, right = idx >> h, idx & lo_mask
    for r in range(_FEISTEL_ROUNDS):
        f = _mul32(right ^ rk[r], 0x9E3779B9)
        f = _mul32(f ^ (f >> 13), 0x85EBCA6B)
        f = (f ^ (f >> 16)) & lo_mask
        left, right = right, left ^ f
    perm = (left << h) | right
    keep = perm < n
    pos = torch.cumsum(keep.to(torch.int64), 0) - 1
    out = torch.zeros(n + 1, dtype=torch.int64, device=device)
    out.scatter_(0, torch.where(keep, pos, n), perm)
    return out[:n]


class BatchPipeline:
    """Deterministic minibatcher over a :class:`FeatureBatch` on its
    device."""

    def __init__(self, batch: FeatureBatch, *,
                 batch_size: Optional[int] = None,
                 seed: Optional[int] = None,
                 shuffle: Optional[str] = None):
        if batch.y is None:
            raise ValueError("BatchPipeline needs a label vector — pack the "
                             "FeatureSpec with a label (serving paths call "
                             "predict on the matrix directly)")
        self.X, self.y = batch.X, batch.y
        self.n, self.k = int(self.X.shape[0]), int(self.X.shape[1])
        if self.n == 0:
            raise ValueError("cannot batch an empty feature matrix")
        b = batch_size if batch_size is not None else knobs.get("SRJT_ML_BATCH")
        self.batch_size = max(1, min(int(b), self.n))
        self.num_batches = self.n // self.batch_size
        # rows beyond the last full batch are dropped THIS epoch but re-enter
        # the shuffle every epoch, so no row is systematically excluded
        self.rows_per_epoch = self.num_batches * self.batch_size
        self.seed = seed if seed is not None else knobs.get("SRJT_ML_SEED")
        self._key = prng.prng_key(self.seed)
        self.shuffle = (shuffle if shuffle is not None
                        else knobs.get("SRJT_ML_SHUFFLE"))
        if self.shuffle not in ("feistel", "sort"):
            raise ValueError(f"SRJT_ML_SHUFFLE={self.shuffle!r}: "
                             "want feistel|sort")
        m = max(2, (self.n - 1).bit_length())
        self._m = m + (m & 1)            # balanced halves need an even width

    def permutation(self, epoch: int) -> torch.Tensor:
        """The epoch's permutation of the rows (int64, on the device)."""
        key = prng.fold_in(self._key, epoch)
        if self.shuffle == "sort":
            return _to_device(prng.permutation(key, self.n), self.X.device)
        return feistel_permutation(prng.bits(key, _FEISTEL_ROUNDS), self.n,
                                   self._m, self.X.device)

    def epoch_arrays(self, epoch: int):
        """``(Xb [nb, b, k], yb [nb, b])`` for one epoch — device work
        only, fresh tensors every call."""
        if metrics.recording():
            metrics.count("ml.pipeline.epochs")
        nb, bs = self.num_batches, self.batch_size
        take = self.permutation(epoch)[:nb * bs]
        return (self.X[take].reshape(nb, bs, self.k),
                self.y[take].reshape(nb, bs))

    def batches(self, epoch: int):
        """Yield ``(xb, yb)`` slices for one epoch (the unfused path)."""
        Xb, yb = self.epoch_arrays(epoch)
        for i in range(self.num_batches):
            yield Xb[i], yb[i]
