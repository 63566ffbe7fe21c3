"""128-bit decimal arithmetic on int64 lane pairs.

The port's counterpart of the JAX package's ``ops/decimal128.py``.  A
DECIMAL128 column stores ``data`` int64 [n, 2]: lane 0 the low 64 bits
(a uint64 bit pattern), lane 1 the sign-carrying high 64 bits.  The
arithmetic is elementwise limb arithmetic on four 32-bit limbs held in
int64 tensors, the JAX package's formulation operation for operation, so
that both give the same bits:

* add and mul are computed mod 2^128 on unsigned limbs, which is exact for
  two's-complement values;
* a product of two 32-bit limbs can pass 2^63: torch's int64 multiply
  wraps mod 2^64 on the CPU and on CUDA, and the low and high 32 bits of
  the wrapped product are the true ones, which is all the code keeps;
* ``>>`` on int64 is arithmetic; every carry chain masks with
  ``& 0xFFFFFFFF`` after it, as the JAX package's does.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import types as T
from ..column import Column, resolve_device
from .int64bits import MASK32, TOPBIT


# -- host construction -------------------------------------------------------

def from_pyints(values, scale: int = 0, device=None) -> Column:
    """A DECIMAL128 column from Python ints (None ⇒ null), two's
    complement mod 2^128."""
    n = len(values)
    lanes = np.zeros((n, 2), dtype=np.int64)
    valid = np.ones(n, dtype=bool)
    for i, v in enumerate(values):
        if v is None:
            valid[i] = False
            continue
        u = int(v) & ((1 << 128) - 1)
        for k, word in enumerate((u & ((1 << 64) - 1), u >> 64)):
            lanes[i, k] = word - (1 << 64) if word >= (1 << 63) else word
    return Column.from_numpy(lanes, T.decimal128(scale),
                             None if valid.all() else valid,
                             device=resolve_device(device))


# -- limb decomposition ------------------------------------------------------

def _limbs(lanes: torch.Tensor) -> list[torch.Tensor]:
    """[n, 2] int64 lanes → four 32-bit limbs in int64, low first."""
    lo, hi = lanes[:, 0], lanes[:, 1]
    return [lo & MASK32, (lo >> 32) & MASK32,
            hi & MASK32, (hi >> 32) & MASK32]


def _from_limbs(l0, l1, l2, l3) -> torch.Tensor:
    """Carry-propagate int64 limb accumulators → [n, 2] lanes (mod 2^128)."""
    c = l0 >> 32
    l0 = l0 & MASK32
    l1 = l1 + c
    c = l1 >> 32
    l1 = l1 & MASK32
    l2 = l2 + c
    c = l2 >> 32
    l2 = l2 & MASK32
    l3 = (l3 + c) & MASK32
    return torch.stack([l0 | (l1 << 32), l2 | (l3 << 32)], dim=1)


def _combine_validity(a: Column, b: Column):
    if a.validity is None:
        return b.validity
    if b.validity is None:
        return a.validity
    return a.validity & b.validity


# -- arithmetic --------------------------------------------------------------

def add(a: Column, b: Column) -> Column:
    """a + b (mod 2^128); the scales must match (rescale first)."""
    if a.dtype.scale != b.dtype.scale:
        raise ValueError("decimal128 add requires equal scales")
    out = _from_limbs(*(x + y for x, y in zip(_limbs(a.data),
                                              _limbs(b.data))))
    return Column(a.dtype, out, validity=_combine_validity(a, b))


def _negate_lanes(lanes: torch.Tensor) -> torch.Tensor:
    l0, l1, l2, l3 = [(~x) & MASK32 for x in _limbs(lanes)]
    return _from_limbs(l0 + 1, l1, l2, l3)


def negate(a: Column) -> Column:
    return Column(a.dtype, _negate_lanes(a.data), validity=a.validity)


def sub(a: Column, b: Column) -> Column:
    return add(a, negate(b))


def _mul_lanes(a_lanes: torch.Tensor,
               b_limbs: list[torch.Tensor]) -> torch.Tensor:
    """The 4×4 limb product, keeping the low four limbs (mod 2^128).  Each
    partial product wraps in int64; its low and high 32 bits are exact."""
    al = _limbs(a_lanes)
    acc = [torch.zeros_like(al[0]) for _ in range(4)]
    for i in range(4):
        for j in range(4 - i):
            p = al[i] * b_limbs[j]
            acc[i + j] = acc[i + j] + (p & MASK32)
            if i + j + 1 < 4:
                acc[i + j + 1] = acc[i + j + 1] + ((p >> 32) & MASK32)
            # propagate at once so that no accumulator nears 2^63
            carry = acc[i + j] >> 32
            acc[i + j] = acc[i + j] & MASK32
            if i + j + 1 < 4:
                acc[i + j + 1] = acc[i + j + 1] + carry
    return _from_limbs(*acc)


def _int64_limbs_signext(v: torch.Tensor) -> list[torch.Tensor]:
    """int64 [n] → four sign-extended 32-bit limbs (two's complement)."""
    sign = torch.where(v < 0, MASK32, 0)
    return [v & MASK32, (v >> 32) & MASK32, sign, sign]


def mul_int(a: Column, b: Column, result_scale: int | None = None) -> Column:
    """decimal128 × an integer column, elementwise, mod 2^128."""
    out = _mul_lanes(a.data, _int64_limbs_signext(b.data.to(torch.int64)))
    scale = a.dtype.scale if result_scale is None else result_scale
    return Column(T.decimal128(scale), out, validity=_combine_validity(a, b))


def mul(a: Column, b: Column) -> Column:
    """decimal128 × decimal128 (mod 2^128); the result's scale is the sum
    of the scales."""
    out = _mul_lanes(a.data, _limbs(b.data))
    return Column(T.decimal128(a.dtype.scale + b.dtype.scale), out,
                  validity=_combine_validity(a, b))


def _add_const(lanes: torch.Tensor, c: int) -> torch.Tensor:
    """lanes + a Python-int constant (mod 2^128)."""
    u = c & ((1 << 128) - 1)
    return _from_limbs(*(x + ((u >> (32 * i)) & MASK32)
                         for i, x in enumerate(_limbs(lanes))))


def _div_small(lanes: torch.Tensor, d: int) -> torch.Tensor:
    """Truncating divide of a non-negative 128-bit value by d < 2^31:
    long division over the limbs, high to low (the partial dividend
    r·2^32 + limb stays below 2^62)."""
    limbs = _limbs(lanes)
    q = [None] * 4
    r = torch.zeros_like(limbs[0])
    for i in (3, 2, 1, 0):
        cur = (r << 32) | limbs[i]
        q[i] = torch.div(cur, d, rounding_mode="floor")
        r = cur - q[i] * d
    return _from_limbs(*q)


def rescale(a: Column, new_scale: int) -> Column:
    """Change the scale: ×10^k toward finer scales, ÷10^k rounding half
    away from zero (Spark's rescale) toward coarser ones."""
    k = a.dtype.scale - new_scale
    lanes = a.data
    if k >= 0:
        while k > 0:                          # 10^9 < 2^32: one limb a step
            step = min(9, k)
            ten = torch.full_like(lanes[:, 0], 10 ** step)
            lanes = _mul_lanes(lanes, _int64_limbs_signext(ten))
            k -= step
        return Column(T.decimal128(new_scale), lanes, validity=a.validity)
    k = -k
    neg = lanes[:, 1] < 0
    mag = torch.where(neg[:, None], _negate_lanes(lanes), lanes)
    mag = _add_const(mag, 10 ** k // 2)       # round half away from zero
    while k > 0:            # ⌊⌊x/a⌋/b⌋ = ⌊x/(ab)⌋ for x ≥ 0
        step = min(9, k)
        mag = _div_small(mag, 10 ** step)
        k -= step
    out = torch.where(neg[:, None], _negate_lanes(mag), mag)
    return Column(T.decimal128(new_scale), out, validity=a.validity)


# -- comparison and sort lanes -----------------------------------------------

def sort_key_lanes(a: Column, descending: bool = False) -> list[torch.Tensor]:
    """int64 lanes in increasing priority (low first, high last), each
    compared as signed: flipping the low lane's top bit maps its unsigned
    order onto int64 order."""
    lo = a.data[:, 0] ^ TOPBIT
    hi = a.data[:, 1]
    if descending:
        lo, hi = ~lo, ~hi
    return [lo, hi]


def less_than(a: Column, b: Column) -> Column:
    hi_lt = a.data[:, 1] < b.data[:, 1]
    hi_eq = a.data[:, 1] == b.data[:, 1]
    lo_lt = (a.data[:, 0] ^ TOPBIT) < (b.data[:, 0] ^ TOPBIT)
    out = (hi_lt | (hi_eq & lo_lt)).to(torch.uint8)
    return Column(T.bool8, out, validity=_combine_validity(a, b))


def equal_to(a: Column, b: Column) -> Column:
    out = ((a.data[:, 0] == b.data[:, 0])
           & (a.data[:, 1] == b.data[:, 1])).to(torch.uint8)
    return Column(T.bool8, out, validity=_combine_validity(a, b))


# -- reductions --------------------------------------------------------------

def _kept_limbs(a: Column) -> list[torch.Tensor]:
    limbs = _limbs(a.data)
    if a.validity is not None:
        keep = a.validity.to(torch.int64)
        limbs = [x * keep for x in limbs]
    return limbs


def sum_(a: Column) -> Column:
    """The column's sum (mod 2^128), nulls skipped, as a 1-row column.
    32-bit limbs summed in int64 are exact below 2^31 rows."""
    sums = [x.sum().reshape(1) for x in _kept_limbs(a)]
    return Column(a.dtype, _from_limbs(*sums))


def segmented_sum(a: Column, segment_ids: torch.Tensor,
                  num_segments: int) -> Column:
    """Per-segment sums (mod 2^128): the groupby's decimal128 sum.  The
    limb sums are int64 ``index_add_``, exact in any order."""
    idx = segment_ids.to(torch.int64)
    sums = []
    for x in _kept_limbs(a):
        s = torch.zeros(num_segments, dtype=torch.int64, device=x.device)
        sums.append(s.index_add_(0, idx, x))
    return Column(a.dtype, _from_limbs(*sums))


# -- casts -------------------------------------------------------------------

def _as_int64(data: torch.Tensor) -> torch.Tensor:
    """A column's integer storage as int64: values, except uint64, whose
    bit pattern is kept."""
    if data.dtype == torch.uint64:
        return data.view(torch.int64)
    return data.to(torch.int64)


def widen(a: Column, scale: int | None = None) -> Column:
    """decimal32/64 (or integer) column → decimal128.  Signed sources
    sign-extend into the high lane; unsigned ones zero-extend (a UINT64 at
    or above 2^63 keeps its bit pattern in the low lane, high lane 0)."""
    v = _as_int64(a.data)
    if a.dtype.is_fixed_width and a.dtype.storage.kind == "u":
        hi = torch.zeros_like(v)
    else:
        hi = torch.where(v < 0, -1, 0)
    if scale is None:
        scale = a.dtype.scale if a.dtype.is_decimal else 0
    return Column(T.decimal128(scale), torch.stack([v, hi], dim=1),
                  validity=a.validity)


def narrow(a: Column, to: T.DType) -> Column:
    """decimal128 → decimal64/32 (values must fit; truncates like a C
    cast)."""
    return Column(to, a.data[:, 0].to(to.torch_storage).contiguous(),
                  validity=a.validity)


def to_float64(a: Column) -> Column:
    """decimal128 → float64 (approximate above 2^53): the magnitude is
    converted and the sign put back, as in the JAX package."""
    neg = a.data[:, 1] < 0
    mag = torch.where(neg[:, None], _negate_lanes(a.data), a.data)
    lo, hi = mag[:, 0], mag[:, 1]
    loval = lo.to(torch.float64) + torch.where(lo < 0, 2.0 ** 64, 0.0)
    hival = hi.to(torch.float64) + torch.where(hi < 0, 2.0 ** 64, 0.0)
    val = hival * (2.0 ** 64) + loval
    val = torch.where(neg, -val, val) * (10.0 ** a.dtype.scale)
    return Column(T.float64, val, validity=a.validity)
