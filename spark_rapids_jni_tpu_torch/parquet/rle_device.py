"""RLE/bit-packed hybrid streams (definition levels and dictionary codes):
run headers on the host, value expansion on the device.

The port's counterpart of the JAX package's ``parquet/rle_device.py``.  The
headers of a hybrid stream, a handful of varints per page, are walked on
the host like page headers (:func:`parse_runs`, the same walk as the JAX
package's), and :func:`level_counts` counts a stream's values from them.
The bit-packed payload, which holds the data volume, goes to the device in
the scan's slab, and :func:`expand` turns the runs of a whole column into
values there with plain torch ops: each value finds its run, gathers the
five bytes that hold its bits, and shifts them out.  The JAX
package does the same with jnp ops; there is no Pallas kernel on this
path.

A column's runs travel as one int64 table [R, 5] of (count, bit width,
RLE value, first bit in the slab, addend).  Bit width 0 marks an RLE run;
the addend rebases the codes of a row group onto a merged dictionary.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

# a value's bits start within its first byte and span at most 32 bits, so
# five bytes hold them
MAX_BIT_WIDTH = 32
RUN_FIELDS = 5


@dataclasses.dataclass(frozen=True)
class RunPlan:
    """Host header walk of one hybrid stream (payload left raw)."""

    n: int                   # total output values
    bw: int                  # bit width
    counts: np.ndarray       # int64 [R] values per run
    is_bp: np.ndarray        # bool  [R] bit-packed (vs RLE) run
    rle_vals: np.ndarray     # int32 [R] value for RLE runs (0 for BP)
    bp_bit_base: np.ndarray  # int64 [R] run's first bit in the payload
    payload: bytes           # concatenated BIT-PACKED payload bytes only


def parse_runs(buf, bw: int, n: int) -> RunPlan:
    """Header-only walk of a hybrid stream that yields ``n`` values.
    Raises ``ValueError`` on a malformed stream."""
    if bw > MAX_BIT_WIDTH:
        raise ValueError(f"RLE bit width {bw} exceeds {MAX_BIT_WIDTH}")
    if n <= 0:
        return RunPlan(0, bw, np.zeros(0, np.int64), np.zeros(0, bool),
                       np.zeros(0, np.int32), np.zeros(0, np.int64), b"")
    if bw == 0:
        return RunPlan(n, 0, np.array([n], np.int64),
                       np.array([False]), np.zeros(1, np.int32),
                       np.zeros(1, np.int64), b"")
    pos = 0
    out = 0
    vbytes = (bw + 7) // 8
    counts, is_bp, vals, bases, pl = [], [], [], [], []
    plbits = 0
    L = len(buf)
    while out < n and pos < L:
        h = 0
        sh = 0
        while True:
            if pos >= L:
                raise ValueError("RLE stream ends inside a run header")
            byte = buf[pos]
            pos += 1
            h |= (byte & 0x7F) << sh
            sh += 7
            if not byte & 0x80:
                break
        if h & 1:
            groups = h >> 1
            nb = groups * bw
            if groups == 0 or pos + nb > L:
                raise ValueError("bit-packed run runs past its stream")
            counts.append(min(groups * 8, n - out))
            is_bp.append(True)
            vals.append(0)
            bases.append(plbits)
            pl.append(bytes(buf[pos:pos + nb]))
            plbits += nb * 8
            pos += nb
        else:
            cnt = h >> 1
            if cnt == 0 or pos + vbytes > L:
                raise ValueError("malformed RLE run")
            counts.append(min(cnt, n - out))
            is_bp.append(False)
            vals.append(int.from_bytes(buf[pos:pos + vbytes], "little"))
            bases.append(0)
            pos += vbytes
        out += counts[-1]
    if out < n:
        raise ValueError(f"RLE stream holds {out} values, expected {n}")
    return RunPlan(n, bw, np.asarray(counts, np.int64),
                   np.asarray(is_bp, bool), np.asarray(vals, np.int32),
                   np.asarray(bases, np.int64), b"".join(pl))


def bit_packed_plan(payload, n: int) -> RunPlan:
    """One bit-packed run of ``n`` values of bit width 1 over ``payload``
    (LSB first): a PLAIN BOOLEAN page's values, expanded like any run."""
    return RunPlan(n, 1, np.array([n], np.int64), np.array([True]),
                   np.zeros(1, np.int32), np.zeros(1, np.int64), payload)


def _bp_values(plan: RunPlan, r: int) -> np.ndarray:
    cnt = int(plan.counts[r])
    bits = np.unpackbits(
        np.frombuffer(plan.payload, np.uint8,
                      offset=int(plan.bp_bit_base[r]) // 8,
                      count=-(-cnt * plan.bw // 8)),
        bitorder="little")
    vals = np.zeros(cnt, np.int64)
    for b in range(plan.bw):
        vals |= bits[b::plan.bw][:cnt].astype(np.int64) << b
    return vals


def present_count(plan: RunPlan, target: int) -> int:
    """How many decoded values equal ``target``, from the headers and one
    unpack of all the bit-packed payloads: the host needs this count to cut
    a page's PLAIN payload before anything reaches the device."""
    return int(level_counts(plan, target + 1)[target])


def level_counts(plan: RunPlan, size: int) -> np.ndarray:
    """int64 [size]: how many decoded values equal each of 0..size-1 (the
    levels of a page, which the scan of a LIST column counts on the host
    to size its rows, elements and present values), from the headers and
    one unpack of all the bit-packed payloads.  Values of ``size`` or more
    are counted nowhere."""
    rle = ~plan.is_bp
    out = np.bincount(np.minimum(plan.rle_vals[rle], size),
                      weights=plan.counts[rle],
                      minlength=size + 1)[:size].astype(np.int64)
    n_bp = int(plan.counts[plan.is_bp].sum())
    if n_bp:
        # each bit-packed run holds whole groups of 8, and only the last run
        # of a stream is cut short, so the payload's first n_bp values are
        # exactly the bit-packed runs' values
        bits = np.unpackbits(np.frombuffer(plan.payload, np.uint8),
                             bitorder="little")[:n_bp * plan.bw]
        vals = np.zeros(n_bp, np.int64)
        for b in range(plan.bw):
            vals |= bits[b::plan.bw].astype(np.int64) << b
        out += np.bincount(np.minimum(vals, size), minlength=size + 1)[:size]
    return out


def expand_np(plan: RunPlan) -> np.ndarray:
    """Host expansion (numpy), the oracle the tests hold :func:`expand`
    against."""
    parts = []
    for r in range(len(plan.counts)):
        if not plan.is_bp[r]:
            parts.append(np.full(int(plan.counts[r]), int(plan.rle_vals[r]),
                                 np.int64))
        else:
            parts.append(_bp_values(plan, r))
    return (np.concatenate(parts) if parts
            else np.zeros(0, np.int64)).astype(np.int32)


def run_table(plan: RunPlan, payload_offset: int, addend: int = 0
              ) -> np.ndarray:
    """The int64 [R, 5] run rows of one stream whose bit-packed payload
    sits at byte ``payload_offset`` of the slab."""
    rows = np.zeros((len(plan.counts), RUN_FIELDS), np.int64)
    rows[:, 0] = plan.counts
    rows[:, 1] = np.where(plan.is_bp, plan.bw, 0)
    rows[:, 2] = plan.rle_vals
    rows[:, 3] = np.where(plan.is_bp, payload_offset * 8 + plan.bp_bit_base,
                          0)
    rows[:, 4] = addend
    return rows


def constant_run(n: int, value: int) -> np.ndarray:
    """One RLE run row: ``n`` copies of ``value``."""
    return np.array([[n, 0, value, 0, 0]], np.int64)


def expand(slab: torch.Tensor, runs: torch.Tensor, n: int) -> torch.Tensor:
    """Expand a run table (int64 [R, 5] on the slab's device, counts summing
    to ``n``) against the bit-packed payloads in ``slab`` (uint8): int32
    [n], each value plus its run's addend.  No synchronisation."""
    dev = slab.device
    if n == 0:
        return torch.zeros(0, dtype=torch.int32, device=dev)
    counts, bw, rle, base, add = runs.unbind(1)
    rid = torch.repeat_interleave(
        torch.arange(runs.shape[0], device=dev), counts, output_size=n)
    first = torch.cumsum(counts, 0) - counts
    width = bw[rid]
    bitpos = base[rid] + (torch.arange(n, device=dev) - first[rid]) * width
    byte = bitpos >> 3
    last = max(slab.shape[0] - 1, 0)
    word = torch.zeros(n, dtype=torch.int64, device=dev)
    if slab.shape[0]:
        for k in range(5):
            word |= slab[(byte + k).clamp(max=last)].to(torch.int64) << (8 * k)
    bits = (word >> (bitpos & 7)) & ((1 << width) - 1)
    vals = torch.where(width > 0, bits, rle[rid]) + add[rid]
    return vals.to(torch.int32)
