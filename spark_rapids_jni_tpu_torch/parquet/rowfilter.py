"""Fused scan→filter: prune rows on the walked pages, before staging.

The port's counterpart of the JAX package's ``parquet/rowfilter.py``.
Without it the scan decodes every selected row group in full and the
planner then masks and gathers on the card: strings and wide columns are
staged, copied and decoded for rows the filter drops at once.  With it
(``SRJT_FUSED_FILTER``, on by default) ``device_scan.scan_table`` walks
every wanted column's pages first, and :func:`apply` evaluates the
planner's ``(column, op, literal)`` conjuncts on the host, on what the
walk kept (``device_scan._ChunkWalk``, one per column chunk):

* PLAIN INT32/INT64 values compare as ``np.frombuffer`` views — one
  vectorized compare per conjunct;
* dictionary-encoded columns evaluate the conjunct ONCE PER DICTIONARY
  ENTRY, and the entries' verdicts are gathered by the codes (numeric
  conjuncts, and string equality);
* PLAIN string equality compares lengths, then the literal's bytes over
  the rows whose length matches (no per-row Python loop).

Null rows FAIL every conjunct, as in ``plan.lower.eval_mask``.  Each
wanted column's walks are then rewritten to hold only the kept rows:
PLAIN values selected, PLAIN strings rebuilt as records, dictionary codes
and definition levels re-packed as one bit-packed run each; the
dictionaries stay.  The staged decode that follows sees a smaller file
and gives the table scan-then-filter would, bit for bit.

Conjuncts the host cannot evaluate (float literals, ordered string
compares, a column of mixed PLAIN and dictionary pages) are left to the
planner's mask; :func:`apply` says whether the pruned rows are
*complete* (every conjunct handled), so that ``plan.lower`` can skip its
mask.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from . import decode as D
from . import rle_device as RLE

# the fixed widths of PLAIN values this module selects rows of (the JAX
# package's device_scan._PLAIN_PHYS); FIXED_LEN_BYTE_ARRAY uses its
# type_len, and INT96 is left alone, as the JAX package's walk leaves it
_PLAIN_PHYS = {D.PT_INT32: 4, D.PT_INT64: 8, D.PT_FLOAT: 4, D.PT_DOUBLE: 8}
_INT_PHYS = (D.PT_INT32, D.PT_INT64)
_INT_NP = {D.PT_INT32: np.int32, D.PT_INT64: np.int64}
# a fixed width's values selected as whole words (a void dtype selects
# byte by byte, several times slower)
_WORD_NP = {1: np.uint8, 2: np.uint16, 4: np.uint32, 8: np.uint64}


def _bytes_of(pieces) -> np.ndarray:
    """Byte ranges back to back as one uint8 array (no copy for one)."""
    arrs = [np.frombuffer(p, np.uint8) for p in pieces]
    if not arrs:
        return np.zeros(0, np.uint8)
    return arrs[0] if len(arrs) == 1 else np.concatenate(arrs)


def _cmp(op: str, a, v):
    if op == "eq":
        return a == v
    if op == "lt":
        return a < v
    if op == "le":
        return a <= v
    if op == "gt":
        return a > v
    if op == "ge":
        return a >= v
    return None


def _kind(walk) -> Optional[str]:
    """"plain" or "dict" for a walk of one kind of page; None for a
    chunk of mixed PLAIN and dictionary pages."""
    kinds = {k for k, _ in walk.runs}
    if len(kinds) > 1:
        return None
    return kinds.pop() if kinds else "plain"


def _valid_np(walk, leaf) -> Optional[np.ndarray]:
    """A walk's row validity as a host bool array (None = all valid)."""
    if all(plan is None for plan, _ in walk.def_plans):
        return None
    return np.concatenate(
        [np.ones(k, bool) if plan is None
         else RLE.expand_np(plan) == leaf.max_def
         for plan, k in walk.def_plans])


def _codes_np(walk) -> np.ndarray:
    """The dictionary codes of a walk's present values, int64."""
    if not walk.idx_plans:
        return np.zeros(0, np.int64)
    return np.concatenate([RLE.expand_np(p) for p in walk.idx_plans]
                          ).astype(np.int64)


def _plain_strings(walk) -> tuple:
    """A walk's PLAIN string records as (payload uint8, char starts,
    lengths), int64, over the pages back to back."""
    payload = _bytes_of(walk.values)
    starts, lens, base = [], [], 0
    for recs, offs in zip(walk.values, walk.str_offsets):
        o = np.asarray(offs, np.int64)
        k = o.shape[0] - 1
        starts.append(base + o[:-1] + 4 * np.arange(1, k + 1))
        lens.append(o[1:] - o[:-1])
        base += len(recs)
    if not starts:
        return payload, np.zeros(0, np.int64), np.zeros(0, np.int64)
    return payload, np.concatenate(starts), np.concatenate(lens)


def _bytes_eq(chars: np.ndarray, starts: np.ndarray, lens: np.ndarray,
              val: bytes) -> np.ndarray:
    """Per value: its chars equal ``val`` (lengths first, then the
    literal's bytes over the candidates)."""
    m = lens == len(val)
    if len(val) and m.any():
        lit = np.frombuffer(val, np.uint8)
        cand = np.flatnonzero(m)
        sub = np.ones(cand.shape[0], bool)
        base = starts[cand]
        for k in range(len(val)):
            sub &= chars[base + k] == lit[k]
        m = np.zeros(m.shape[0], bool)
        m[cand] = sub
    return m


def _walk_mask(walk, leaf, op: str, val) -> Optional[np.ndarray]:
    """Row mask [walk.n] for one conjunct over one walked chunk, or None
    (a shape the host does not evaluate)."""
    kind, phys = _kind(walk), leaf.phys
    is_str = phys == D.PT_BYTE_ARRAY
    pm = None
    if kind == "plain" and isinstance(val, int) and phys in _INT_PHYS:
        pm = _cmp(op, _bytes_of(walk.values).view(_INT_NP[phys]), val)
    elif (kind == "dict" and isinstance(val, int) and phys in _INT_PHYS
          and walk.dictionary is not None):
        entries = np.frombuffer(walk.dictionary, _INT_NP[phys],
                                count=walk.n_dict)
        codes = _codes_np(walk)
        if codes.size and (codes.min() < 0 or codes.max() >= walk.n_dict):
            return None                # the scan's own check raises
        em = _cmp(op, entries, val)
        if em is not None:
            pm = em[codes]
    elif (kind == "dict" and is_str and isinstance(val, bytes)
          and op == "eq" and walk.dictionary is not None):
        chars, offs = walk.dictionary
        offs = np.asarray(offs, np.int64)
        codes = _codes_np(walk)
        if codes.size and (codes.min() < 0 or codes.max() >= walk.n_dict):
            return None
        pm = _bytes_eq(np.asarray(chars, np.uint8), offs[:-1],
                       offs[1:] - offs[:-1], val)[codes]
    elif kind == "plain" and is_str and isinstance(val, bytes) and op == "eq":
        pm = _bytes_eq(*_plain_strings(walk), val)
    if pm is None:
        return None
    valid = _valid_np(walk, leaf)
    if valid is None:
        return np.asarray(pm, bool)
    m = np.zeros(walk.n, bool)
    m[valid] = pm                      # null rows fail, like eval_mask
    return m


def _column_mask(walks, leaf, op: str, val) -> Optional[np.ndarray]:
    masks = []
    for w in walks:
        m = _walk_mask(w, leaf, op, val)
        if m is None:
            return None
        masks.append(m)
    return np.concatenate(masks) if masks else np.zeros(0, bool)


def _packed_plan(vals: np.ndarray, bw: int) -> RLE.RunPlan:
    """``vals`` as one bit-packed run of width ``bw`` (LSB first)."""
    n = vals.shape[0]
    bits = ((vals.astype(np.int64)[:, None] >> np.arange(bw)) & 1
            ).astype(np.uint8).reshape(-1)
    return RLE.RunPlan(n, bw, np.array([n], np.int64), np.array([True]),
                       np.zeros(1, np.int32), np.zeros(1, np.int64),
                       np.packbits(bits, bitorder="little").tobytes())


def _prune_walk(walk, leaf, keep: np.ndarray, kept: np.ndarray):
    """``walk`` with only the ``keep`` rows (``kept``: their positions),
    or None (a shape this module does not rewrite)."""
    kind, phys = _kind(walk), leaf.phys
    if kind is None or walk.host_decoded:
        return None
    valid = _valid_np(walk, leaf)
    # the kept present values' positions among the present values
    kept_present = kept if valid is None else np.flatnonzero(keep[valid])
    n_new = kept.shape[0]
    n_present = kept_present.shape[0]
    def_plans = [(None, n_new)]
    if valid is not None:
        # levels stay even where every kept row is valid: the column keeps
        # its validity, as a mask over the unpruned scan keeps it
        levels = np.where(valid[keep], leaf.max_def, 0)
        def_plans = [(_packed_plan(levels, D.bit_width(leaf.max_def)),
                      n_new)]
    out = dict(n=n_new, runs=[[kind, n_present]], def_plans=def_plans)
    if phys == D.PT_BOOLEAN and kind == "plain":
        bits = _codes_np(walk)[kept_present].astype(np.uint8)
        out["idx_plans"] = [RLE.bit_packed_plan(
            np.packbits(bits, bitorder="little").tobytes(), n_present)]
        out["plan_kinds"] = ["plain"]
    elif kind == "dict":
        codes = _codes_np(walk)[kept_present]
        bw = max(1, int(codes.max()).bit_length()) if codes.size else 1
        out["idx_plans"] = [_packed_plan(codes, bw)] if codes.size else []
        if phys == D.PT_BOOLEAN:
            out["plan_kinds"] = ["dict"] * len(out["idx_plans"])
    elif phys == D.PT_BYTE_ARRAY:
        payload, starts, lens = _plain_strings(walk)
        starts, lens = starts[kept_present], lens[kept_present]
        src = (np.repeat(starts, lens)
               + np.arange(int(lens.sum()), dtype=np.int64)
               - np.repeat(np.cumsum(lens) - lens, lens))
        offs = np.zeros(n_present + 1, np.int64)
        np.cumsum(lens, out=offs[1:])
        out["values"] = [D.plain_records(payload[src], lens)]
        out["str_offsets"] = [offs.astype(np.int32)]
    else:
        width = (leaf.type_len if phys == D.PT_FIXED_LEN_BYTE_ARRAY
                 else _PLAIN_PHYS.get(phys))
        if not width:
            return None
        raw = _bytes_of(walk.values)
        vals = (raw.view(_WORD_NP[width]) if width in _WORD_NP
                else raw.reshape(-1, width))
        out["values"] = [np.take(vals, kept_present, axis=0).tobytes()]
    return dataclasses.replace(walk, **out)


def apply(conds, walks: dict, leaves, names, want):
    """Evaluate the supported ``(column, op, literal)`` conjuncts over the
    walked chunks (``walks``: column index → one ``_ChunkWalk`` per row
    group) and prune every wanted column's rows.

    → ``(pruned_walks, complete, n_kept)``, or None when no conjunct is
    evaluable on this file, or a wanted column is of a shape this module
    does not rewrite (the caller stages the original walks and the
    planner's mask runs as before).  ``complete`` is True when EVERY
    conjunct was evaluated here — the planner may then skip its mask if
    the conjunct list covers the whole predicate."""
    name_to_idx = {n: i for i, n in enumerate(names)}
    first = walks.get(want[0]) if want else None
    if not first:
        return None
    n_rows = int(sum(w.n for w in first))
    if n_rows == 0:
        return None
    keep = np.ones(n_rows, bool)
    handled = 0
    for cname, op, val in conds:
        ci = name_to_idx.get(cname)
        m = None
        if ci is not None and walks.get(ci) is not None:
            m = _column_mask(walks[ci], leaves[ci], op, val)
        if m is None:
            continue
        keep &= m
        handled += 1
    if handled == 0:
        return None
    complete = handled == len(conds)
    n_kept = int(keep.sum())
    if n_kept == n_rows:
        # nothing to prune — skip the rewrite; ``complete`` still lets
        # the planner drop its (all-True) mask
        return walks, complete, n_kept
    # each row group's slice of the mask and its kept positions, shared
    # by the columns
    cuts = np.cumsum([0] + [w.n for w in first])
    slices = [keep[a:b] for a, b in zip(cuts[:-1], cuts[1:])]
    kepts = [np.flatnonzero(k) for k in slices]
    out = {}
    for i in want:
        newwalks = []
        for w, k, kp in zip(walks[i], slices, kepts):
            pruned = _prune_walk(w, leaves[i], k, kp)
            if pruned is None:
                return None
            newwalks.append(pruned)
        out[i] = newwalks
    return out, complete, n_kept
