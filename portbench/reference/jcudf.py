"""JCUDF rows in plain NumPy: an encoder and a decoder from the layout rules.

Spark's row format as spark-rapids-jni's ``RowConversion`` writes it:

* Each fixed-width column takes a slot of its own width, aligned to that
  width; each string column an 8-byte slot (uint32 offset of its chars
  from the row's start, uint32 length) aligned to 4.  Slots follow in
  column order.
* One validity bit a column (bit ``i % 8`` of byte ``i // 8``, set when the
  value is present) in bytes right after the last slot.
* With strings, each row's chars of every string column follow, in
  column order, from the first byte after the validity bytes; a null
  string has no chars.
* Each row is padded with zeros to a multiple of 8 bytes.

Columns are ``(kind, values)`` or ``(kind, values, validity)``: ``kind``
is ``int8`` .. ``int64``, ``float32``, ``float64`` (a numpy dtype name) or
``string``, whose values are ``(chars uint8, int64 offsets [n+1])``.
Null slots of fixed-width columns hold whatever ``values`` holds there.
Rows are built a block at a time: a zero matrix as wide as the widest row,
the slots and chars placed, then the matrix's leading bytes of each row
kept.
"""

from __future__ import annotations

import numpy as np

ROW_ALIGNMENT = 8
STRING_SLOT = 8
STRING_SLOT_ALIGN = 4
BLOCK_ROWS = 1 << 18


def _round_up(x, m):
    return (x + m - 1) // m * m


def layout(kinds: list) -> dict:
    """Slot starts and widths, the validity bytes' start and count, and
    where chars begin (the fixed row size for fixed-width tables)."""
    starts, widths = [], []
    at = 0
    for kind in kinds:
        if kind == "string":
            width, align = STRING_SLOT, STRING_SLOT_ALIGN
        else:
            width = align = np.dtype(kind).itemsize
        at = _round_up(at, align)
        starts.append(at)
        widths.append(width)
        at += width
    nvalid = -(-len(kinds) // 8)
    return {"starts": starts, "widths": widths, "validity_at": at,
            "validity_bytes": nvalid, "chars_at": at + nvalid,
            "fixed_row": _round_up(at + nvalid, ROW_ALIGNMENT),
            "strings": [i for i, k in enumerate(kinds) if k == "string"]}


def _parts(col):
    kind, values = col[0], col[1]
    valid = col[2] if len(col) > 2 else None
    return kind, values, valid


def _string_lengths(values, valid):
    chars, offs = values
    lens = np.diff(np.asarray(offs, np.int64))
    if valid is not None:
        lens = np.where(valid, lens, 0)
    return lens


def row_sizes(columns: list) -> np.ndarray:
    """Each row's size in bytes, int64 [n]."""
    kinds = [c[0] for c in columns]
    lay = layout(kinds)
    n = num_rows(columns)
    if not lay["strings"]:
        return np.full(n, lay["fixed_row"], np.int64)
    total = np.zeros(n, np.int64)
    for i in lay["strings"]:
        _, values, valid = _parts(columns[i])
        total += _string_lengths(values, valid)
    return _round_up(lay["chars_at"] + total, ROW_ALIGNMENT)


def num_rows(columns: list) -> int:
    kind, values, _ = _parts(columns[0])
    return (values[1].shape[0] - 1) if kind == "string" else values.shape[0]


def _fixed_bytes(kind, values, r0, r1) -> np.ndarray:
    v = np.ascontiguousarray(values[r0:r1], np.dtype(kind).newbyteorder("<"))
    return v.view(np.uint8).reshape(r1 - r0, -1)


def _validity_bytes(columns, r0, r1) -> np.ndarray:
    n = r1 - r0
    bits = np.zeros((n, _round_up(len(columns), 8)), np.uint8)
    for i, col in enumerate(columns):
        _, _, valid = _parts(col)
        bits[:, i] = 1 if valid is None else valid[r0:r1]
    return np.packbits(bits, axis=1, bitorder="little")


def encode(columns: list) -> tuple:
    """(row bytes uint8, int64 row offsets [n+1]) of the table."""
    kinds = [c[0] for c in columns]
    lay = layout(kinds)
    n = num_rows(columns)
    sizes = row_sizes(columns)
    offsets = np.zeros(n + 1, np.int64)
    np.cumsum(sizes, out=offsets[1:])
    out = np.empty(int(offsets[-1]), np.uint8)
    lens = {i: _string_lengths(*_parts(columns[i])[1:])
            for i in lay["strings"]}
    for r0 in range(0, n, BLOCK_ROWS):
        r1 = min(n, r0 + BLOCK_ROWS)
        bsz = sizes[r0:r1]
        width = int(bsz.max())
        mat = np.zeros((r1 - r0, width), np.uint8)
        pos = np.full(r1 - r0, lay["chars_at"], np.int64)
        for i, col in enumerate(columns):
            kind, values, valid = _parts(col)
            s = lay["starts"][i]
            if kind != "string":
                mat[:, s:s + lay["widths"][i]] = _fixed_bytes(kind, values,
                                                              r0, r1)
                continue
            chars, offs = values
            ln = lens[i][r0:r1]
            slot = np.stack([pos, ln], axis=1).astype("<u4")
            mat[:, s:s + STRING_SLOT] = slot.view(np.uint8).reshape(-1, 8)
            # the chars of the rows of each length at once
            dst = np.arange(r1 - r0, dtype=np.int64) * width + pos
            src = np.asarray(offs[r0:r1], np.int64)
            flat = mat.reshape(-1)
            order = np.argsort(ln, kind="stable")
            cuts = np.flatnonzero(np.diff(ln[order])) + 1
            for rows in np.split(order, cuts):
                k = int(ln[rows[0]]) if rows.shape[0] else 0
                if k:
                    at = np.arange(k, dtype=np.int64)
                    flat[dst[rows][:, None] + at] = chars[src[rows][:, None]
                                                          + at]
            pos = pos + ln
        v0 = lay["validity_at"]
        mat[:, v0:v0 + lay["validity_bytes"]] = _validity_bytes(columns,
                                                                r0, r1)
        # rows are whole words: compact the matrix a word at a time
        keep = np.arange(width // 8)[None, :] < (bsz // 8)[:, None]
        out[offsets[r0]:offsets[r1]] = mat.view(np.uint64)[keep].view(
            np.uint8)
    return out, offsets


def decode(data: np.ndarray, offsets: np.ndarray, kinds: list) -> list:
    """The columns of JCUDF rows, as :func:`encode` takes them, each with
    its validity."""
    lay = layout(kinds)
    data = np.asarray(data, np.uint8)
    offsets = np.asarray(offsets, np.int64)
    n = offsets.shape[0] - 1
    fixed = {i: [] for i, k in enumerate(kinds) if k != "string"}
    strs = {i: ([], []) for i in lay["strings"]}
    valids = []
    for r0 in range(0, max(n, 1), BLOCK_ROWS):
        r1 = min(n, r0 + BLOCK_ROWS)
        if r1 <= r0:
            break
        bsz = np.diff(offsets[r0:r1 + 1])
        width = int(bsz.max())
        mat = np.zeros((r1 - r0, width), np.uint8)
        keep = np.arange(width // 8)[None, :] < (bsz // 8)[:, None]
        mat.view(np.uint64)[keep] = data[offsets[r0]:offsets[r1]].view(
            np.uint64)
        v0 = lay["validity_at"]
        bits = np.unpackbits(mat[:, v0:v0 + lay["validity_bytes"]], axis=1,
                             bitorder="little")[:, :len(kinds)]
        valids.append(bits.astype(bool))
        for i, kind in enumerate(kinds):
            s = lay["starts"][i]
            raw = np.ascontiguousarray(mat[:, s:s + lay["widths"][i]])
            if kind != "string":
                fixed[i].append(raw.view(np.dtype(kind).newbyteorder("<"))
                                .reshape(-1).astype(kind))
                continue
            slot = raw.view("<u4").reshape(-1, 2).astype(np.int64)
            ln = slot[:, 1]
            total = int(ln.sum())
            run = np.arange(total, dtype=np.int64) - np.repeat(
                np.cumsum(ln) - ln, ln)
            src = np.repeat(np.arange(r1 - r0, dtype=np.int64) * width
                            + slot[:, 0], ln) + run
            strs[i][0].append(mat.reshape(-1)[src])
            strs[i][1].append(ln)
    valid = (np.concatenate(valids) if valids
             else np.zeros((0, len(kinds)), bool))
    out = []
    for i, kind in enumerate(kinds):
        if kind != "string":
            vals = (np.concatenate(fixed[i]) if fixed[i]
                    else np.zeros(0, kind))
        else:
            chars = (np.concatenate(strs[i][0]) if strs[i][0]
                     else np.zeros(0, np.uint8))
            ln = (np.concatenate(strs[i][1]) if strs[i][1]
                  else np.zeros(0, np.int64))
            offs = np.zeros(ln.shape[0] + 1, np.int64)
            np.cumsum(ln, out=offs[1:])
            vals = (chars, offs)
        out.append((kind, vals, valid[:, i].copy()))
    return out


def in_float32(columns: list) -> list:
    """The columns with every float64 value rounded through float32: the
    control, the reference one precision below the configuration's."""
    out = []
    for col in columns:
        kind, values, valid = _parts(col)
        if kind == "float64":
            values = values.astype(np.float32).astype(np.float64)
        out.append((kind, values) if valid is None
                   else (kind, values, valid))
    return out


def byte_mismatches(got: np.ndarray, want: np.ndarray) -> int:
    """Bytes that differ, a length difference counting every byte past
    the shorter."""
    got = np.asarray(got, np.uint8)
    want = np.asarray(want, np.uint8)
    k = min(got.shape[0], want.shape[0])
    return int(np.count_nonzero(got[:k] != want[:k])) + abs(
        got.shape[0] - want.shape[0])


def value_mismatches(got: list, want: list) -> int:
    """Rows whose value or validity differs, over every column, a column
    or row count that differs counting every row of the longer."""
    bad = abs(len(got) - len(want)) * max(num_rows(want), 1)
    for g, w in zip(got, want):
        gk, gv, gvalid = _parts(g)
        wk, wv, wvalid = _parts(w)
        n = (wv[1].shape[0] - 1) if wk == "string" else wv.shape[0]
        gn = (gv[1].shape[0] - 1) if gk == "string" else gv.shape[0]
        if gn != n or gk != wk:
            bad += max(n, gn)
            continue
        gvalid = np.ones(n, bool) if gvalid is None else np.asarray(gvalid)
        wvalid = np.ones(n, bool) if wvalid is None else np.asarray(wvalid)
        wrong = gvalid != wvalid
        if wk == "string" and np.array_equal(gv[1], wv[1]) and \
                np.array_equal(gv[0], wv[0]):
            bad += int(np.count_nonzero(wrong))
            continue
        if wk == "string":
            gl = np.diff(np.asarray(gv[1], np.int64))
            wl = np.diff(np.asarray(wv[1], np.int64))
            same_len = gl == wl
            rows = np.flatnonzero(same_len & wvalid)
            diff_rows = np.zeros(n, bool)
            if rows.shape[0]:
                ln = wl[rows]
                run = np.arange(int(ln.sum()), dtype=np.int64) - np.repeat(
                    np.cumsum(ln) - ln, ln)
                gc = np.asarray(gv[0])[np.repeat(
                    np.asarray(gv[1], np.int64)[rows], ln) + run]
                wc = np.asarray(wv[0])[np.repeat(
                    np.asarray(wv[1], np.int64)[rows], ln) + run]
                owner = np.repeat(rows, ln)
                diff_rows[owner[gc != wc]] = True
            wrong |= (~same_len & wvalid) | diff_rows
        else:
            a = np.asarray(gv).view(np.uint8).reshape(n, -1)
            b = np.asarray(wv, gv.dtype).view(np.uint8).reshape(n, -1)
            wrong |= (a != b).any(axis=1) & wvalid
        bad += int(np.count_nonzero(wrong))
    return bad
