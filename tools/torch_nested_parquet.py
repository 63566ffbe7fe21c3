#!/usr/bin/env python3
"""A numpy-only Parquet writer of nested columns, and its event table.

    python3 tools/torch_nested_parquet.py --rows 8388608 --seed 18 \\
        --out events.parquet

Test data for the PyTorch port's scan of LIST and STRUCT columns, for
machines without pyarrow.  The table looks like an event table as
Spark's ``collect_list`` leaves it:

* ``id``: INT64, REQUIRED, the row number;
* ``items``: LIST<INT64>, 0-8 elements (uniform), 10% null lists and 5%
  null elements, PLAIN;
* ``tags``: LIST<STRING>, 0-6 elements drawn from 64 distinct words of
  3-12 chars, dictionary-encoded;
* ``notes``: LIST<STRING>, 0-3 elements of 0-40 chars cut from a text
  pool (``torch_lineitem_parquet.text_pool``), PLAIN;
* ``geo``: an OPTIONAL struct (10% null) of two REQUIRED DOUBLE leaves,
  ``geo.lat`` and ``geo.lon``;
* ``flag``: BOOLEAN, dictionary-encoded;
* ``uuid``: FIXED_LEN_BYTE_ARRAY(16), PLAIN.

Lists are written with the 3-level LIST annotation (``optional group
name (LIST) { repeated group list { optional <type> element; } }``),
their repetition and definition levels as RLE/bit-packed hybrid streams
(bit-packed runs, as ``torch_lineitem_parquet.bit_packed_runs`` writes
them) in v1 data pages.  Pages hold about 1 MiB of values and start at a
row; row groups hold 1,048,576 rows; every page is SNAPPY through
``tools/torch_snappy_compress.cpp``.  Dictionaries are in first-occurrence
order per row group.  The footer has no statistics.  Every array comes
from streams spawned from ``np.random.default_rng(seed)``.

:func:`nested_arrays` gives the columns as arrays (a LIST as
:class:`ListArrays`), :func:`write_nested` the file, and
:func:`expected_pylists` each column as Python values, which the tests
hold the readers against.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import dataclasses
import os
import struct
import sys
from typing import Optional

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_lineitem_parquet as W  # noqa: E402
from torch_lineitem_parquet import (  # noqa: E402
    Field, ListValue, TType, _i32, _i64, _struct, _thrift)

ROW_GROUP_ROWS = 1 << 20
PAGE_BYTES = 1 << 20
CODEC = "SNAPPY"
REQUIRED, OPTIONAL, REPEATED = 0, 1, 2
CT_UTF8, CT_LIST = 0, 3
# the scanned columns' names, in the file's order
COLUMNS = ("id", "items", "tags", "notes", "geo.lat", "geo.lon", "flag",
           "uuid")
TAG_WORDS = 64
TAG_LEN = (3, 12)
NOTE_LEN = (0, 40)


@dataclasses.dataclass
class ListArrays:
    """A LIST column: ``offsets`` int64 [n+1] into the elements, ``valid``
    bool [n] (None: no null list; a null list has no elements).  Elements
    are ``values`` (numbers), or strings as ``chars`` with int64
    ``char_offsets`` [k+1], or dictionary ``codes`` into ``vocab``;
    ``elem_valid`` bool [k] (None: no null element)."""

    offsets: np.ndarray
    valid: Optional[np.ndarray] = None
    values: Optional[np.ndarray] = None
    elem_valid: Optional[np.ndarray] = None
    chars: Optional[np.ndarray] = None
    char_offsets: Optional[np.ndarray] = None
    codes: Optional[np.ndarray] = None
    vocab: Optional[list] = None


def _lengths(rng, n: int, hi: int, valid=None) -> np.ndarray:
    lens = rng.integers(0, hi + 1, n)
    if valid is not None:
        lens[~valid] = 0
    offs = np.zeros(n + 1, np.int64)
    np.cumsum(lens, out=offs[1:])
    return offs


def _tag_vocab(rng) -> list:
    """``TAG_WORDS`` distinct lowercase words of ``TAG_LEN`` chars."""
    words: dict = {}
    while len(words) < TAG_WORDS:
        k = int(rng.integers(TAG_LEN[0], TAG_LEN[1] + 1))
        w = bytes(rng.integers(ord("a"), ord("z") + 1, k).astype(np.uint8))
        words.setdefault(w, None)
    return list(words)


def segment_index(starts: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """The source index of every byte of segments ``starts[i]`` of
    ``lens[i]`` bytes laid back to back: a running sum of steps of one
    that jump at each segment's first byte (int32 where it fits)."""
    total = int(lens.sum())
    wide = total >= 1 << 31 or (starts.size and int(starts.max()) +
                                int(lens.max()) >= 1 << 31)
    idx = np.ones(total, np.int64 if wide else np.int32)
    if total:
        nz = lens > 0
        s, ln = starts[nz], lens[nz]
        first = np.zeros(s.shape[0], np.int64)
        np.cumsum(ln[:-1], out=first[1:])
        ends = s + ln - 1
        idx[first] = s - np.concatenate([[0], ends[:-1]])
        np.cumsum(idx, out=idx)
    return idx


def _text(rng, k: int) -> tuple[np.ndarray, np.ndarray]:
    """``k`` strings of ``NOTE_LEN`` chars, substrings of a text pool, cut
    in blocks of strings on threads."""
    pool = W.text_pool(rng, 1 << 20)
    lens = rng.integers(NOTE_LEN[0], NOTE_LEN[1] + 1, k)
    starts = rng.integers(0, pool.shape[0] - lens + 1)
    offs = np.zeros(k + 1, np.int64)
    np.cumsum(lens, out=offs[1:])
    chars = np.empty(int(offs[-1]), np.uint8)
    cuts = np.linspace(0, k, (os.cpu_count() or 1) + 1).astype(np.int64)

    def block(a: int, b: int) -> None:
        chars[offs[a]:offs[b]] = pool[segment_index(starts[a:b], lens[a:b])]

    with concurrent.futures.ThreadPoolExecutor(len(cuts) - 1) as ex:
        list(ex.map(block, cuts[:-1], cuts[1:]))
    return chars, offs


def _items(rng, n_rows: int) -> ListArrays:
    valid = rng.random(n_rows) >= 0.10
    offs = _lengths(rng, n_rows, 8, valid)
    k = int(offs[-1])
    return ListArrays(offs, valid,
                      rng.integers(-(1 << 62), 1 << 62, k, dtype=np.int64),
                      rng.random(k) >= 0.05)


def _tags(rng, n_rows: int) -> ListArrays:
    vocab = _tag_vocab(rng)
    offs = _lengths(rng, n_rows, 6)
    return ListArrays(offs, codes=rng.integers(0, TAG_WORDS, int(offs[-1])),
                      vocab=vocab)


def _notes(rng, n_rows: int) -> ListArrays:
    offs = _lengths(rng, n_rows, 3)
    chars, coffs = _text(rng, int(offs[-1]))
    return ListArrays(offs, chars=chars, char_offsets=coffs)


def _flat(rng, n_rows: int) -> dict:
    return {"geo": (rng.uniform(-90, 90, n_rows),
                    rng.uniform(-180, 180, n_rows),
                    rng.random(n_rows) >= 0.10),
            "flag": (rng.random(n_rows) < 0.3).astype(np.uint8),
            "uuid": np.frombuffer(bytearray(rng.bytes(16 * n_rows)),
                                  np.uint8).reshape(n_rows, 16)}


def nested_arrays(n_rows: int, seed: int) -> dict:
    """The event table's columns: numpy arrays, :class:`ListArrays` for
    the lists, ``geo`` as (lat, lon, valid).  Each group of columns draws
    from a stream of its own, spawned from ``seed``, on a thread of its
    own (numpy's generators release the GIL while they fill)."""
    streams = np.random.default_rng(seed).spawn(4)
    parts = (_items, _tags, _notes, _flat)
    with concurrent.futures.ThreadPoolExecutor(len(parts)) as ex:
        items, tags, notes, flat = ex.map(
            lambda job: job[0](job[1], n_rows), zip(parts, streams))
    return {"id": np.arange(n_rows, dtype=np.int64), "items": items,
            "tags": tags, "notes": notes, **flat}


# ---------------------------------------------------------------------------
# leaves: levels and present values
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _Leaf:
    """One leaf column as the writer cuts it: per row its first level slot
    (``slot_of`` [n+1]), per slot its levels, and its present values
    (those at ``max_def``) with each value's bytes for page cutting."""

    path: tuple
    phys: str
    encoding: str                      # plain | dict
    max_def: int
    max_rep: int
    slot_of: np.ndarray
    defs: Optional[np.ndarray]
    reps: Optional[np.ndarray]
    present: object                    # values, codes, or (chars, offsets)
    value_bytes: np.ndarray            # bytes each present value takes
    vocab: Optional[list] = None       # dict: entries as bytes or ints
    type_length: int = 0


def _list_leaf(path, phys, lst: ListArrays, encoding: str) -> _Leaf:
    """Levels of a 3-level optional list of optional elements: a null
    list 0, an empty list 1, a null element 2, an element 3."""
    n = lst.offsets.shape[0] - 1
    lens = np.diff(lst.offsets)
    valid = np.ones(n, bool) if lst.valid is None else lst.valid
    slots = np.maximum(lens, 1)
    slot_of = np.zeros(n + 1, np.int64)
    np.cumsum(slots, out=slot_of[1:])
    total = int(slot_of[-1])
    reps = np.ones(total, np.uint8)
    reps[slot_of[:-1]] = 0
    defs = np.empty(total, np.uint8)
    is_elem = np.repeat(lens > 0, slots)
    row_def = np.where(valid, 1, 0).astype(np.uint8)
    defs[~is_elem] = row_def[lens == 0]
    ev = (np.ones(int(lens.sum()), bool) if lst.elem_valid is None
          else lst.elem_valid)
    defs[is_elem] = np.where(ev, 3, 2)
    if lst.codes is not None:
        present = lst.codes[ev]
        value_bytes = np.ones(present.shape[0], np.int64)
    elif lst.chars is not None:
        co = lst.char_offsets
        rows = np.flatnonzero(ev)
        present = (lst.chars, co, rows)
        value_bytes = 4 + co[rows + 1] - co[rows]
    else:
        present = lst.values[ev]
        value_bytes = np.full(present.shape[0], present.itemsize, np.int64)
    return _Leaf(path, phys, encoding, 3, 1, slot_of, defs, reps, present,
                 value_bytes, lst.vocab)


def _flat_leaf(path, phys, values, encoding="plain", valid=None,
               max_def=0, type_length=0) -> _Leaf:
    n = values.shape[0]
    present = values if valid is None else values[valid]
    width = type_length or present.dtype.itemsize
    defs = None if valid is None else valid.astype(np.uint8)
    return _Leaf(path, phys, encoding, max_def, 0,
                 np.arange(n + 1, dtype=np.int64), defs, None, present,
                 np.full(present.shape[0], 1 if encoding == "dict" else width,
                         np.int64), type_length=type_length)


def _leaves(arrays: dict, ex) -> list[_Leaf]:
    """The leaves, the lists' levels built on ``ex``'s threads."""
    lat, lon, gvalid = arrays["geo"]
    lists = list(ex.map(lambda a: _list_leaf(*a), [
        (("items", "list", "element"), "INT64", arrays["items"], "plain"),
        (("tags", "list", "element"), "BYTE_ARRAY", arrays["tags"], "dict"),
        (("notes", "list", "element"), "BYTE_ARRAY", arrays["notes"],
         "plain")]))
    return [
        _flat_leaf(("id",), "INT64", arrays["id"]),
        *lists,
        _flat_leaf(("geo", "lat"), "DOUBLE", lat, valid=gvalid, max_def=1),
        _flat_leaf(("geo", "lon"), "DOUBLE", lon, valid=gvalid, max_def=1),
        _flat_leaf(("flag",), "BOOLEAN", arrays["flag"], "dict"),
        _flat_leaf(("uuid",), "FIXED_LEN_BYTE_ARRAY", arrays["uuid"],
                   type_length=16),
    ]


def _schema(arrays: dict) -> list:
    """The SchemaElements, depth first."""

    def el(name, rep, phys=None, n_children=None, converted=None,
           type_length=None):
        return _struct(_i32(1, None if phys is None else
                            (0 if phys == "BOOLEAN" else W.PHYS[phys])),
                       _i32(2, type_length), _i32(3, rep),
                       (4, TType.BINARY, name.encode()),
                       _i32(5, n_children), _i32(6, converted))

    def lst(name, phys, converted=None):
        return [el(name, OPTIONAL, n_children=1, converted=CT_LIST),
                el("list", REPEATED, n_children=1),
                el("element", OPTIONAL, phys, converted=converted)]

    return ([el("schema", REQUIRED, n_children=7),
             el("id", REQUIRED, "INT64")]
            + lst("items", "INT64") + lst("tags", "BYTE_ARRAY", CT_UTF8)
            + lst("notes", "BYTE_ARRAY", CT_UTF8)
            + [el("geo", OPTIONAL, n_children=2),
               el("lat", REQUIRED, "DOUBLE"), el("lon", REQUIRED, "DOUBLE"),
               el("flag", REQUIRED, "BOOLEAN"),
               el("uuid", REQUIRED, "FIXED_LEN_BYTE_ARRAY",
                  type_length=16)])


# ---------------------------------------------------------------------------
# pages and chunks
# ---------------------------------------------------------------------------

def _present_bytes(leaf: _Leaf, a: int, b: int) -> bytes:
    """PLAIN bytes of present values ``a:b``."""
    if leaf.phys == "BYTE_ARRAY":
        chars, co, rows = leaf.present
        return W._plain_records(chars, co, rows[a:b])
    if leaf.phys == "BOOLEAN":
        return np.packbits(leaf.present[a:b].astype(np.uint8),
                           bitorder="little").tobytes()
    return np.ascontiguousarray(leaf.present[a:b]).tobytes()


def _dictionary_bytes(leaf: _Leaf, entries: np.ndarray) -> bytes:
    if leaf.phys == "BOOLEAN":
        return np.packbits(entries.astype(np.uint8),
                           bitorder="little").tobytes()
    return b"".join(struct.pack("<I", len(leaf.vocab[e])) + leaf.vocab[e]
                    for e in entries)


def _levels(values: np.ndarray, max_level: int) -> bytes:
    """A v1 page's level stream: its byte length, then the hybrid runs."""
    body = W.bit_packed_runs(values, int(max_level).bit_length())
    return struct.pack("<I", len(body)) + body


def _write_chunk(leaf: _Leaf, lo: int, hi: int, p0: int) -> tuple:
    """The chunk of rows ``lo:hi`` of ``leaf``, whose present values start
    at ``p0``: (its bytes, a function of the chunk's file offset giving
    its ColumnChunk)."""
    out = bytearray()
    start = 0
    s0, s1 = int(leaf.slot_of[lo]), int(leaf.slot_of[hi])
    defs = None if leaf.defs is None else leaf.defs[s0:s1]
    n_present = (s1 - s0 if defs is None
                 else int((defs == leaf.max_def).sum()))
    codes = None
    used = {W.ENC_RLE}
    usize = 0
    dict_off = None
    if leaf.encoding == "dict":
        entries, codes = W._first_occurrence(
            np.asarray(leaf.present[p0:p0 + n_present]))
        bw = max(1, int(len(entries) - 1).bit_length())
        dict_off = len(out)
        page, size = W._page(
            W.PAGE_DICTIONARY, _dictionary_bytes(leaf, entries),
            (7, TType.STRUCT, _struct(_i32(1, len(entries)),
                                      _i32(2, W.ENC_PLAIN))), CODEC)
        out += page
        usize += size
        used |= {W.ENC_PLAIN, W.ENC_RLE_DICTIONARY}
    else:
        used.add(W.ENC_PLAIN)
    # pages of about PAGE_BYTES of values, each starting at a row
    present_of_slot = (np.arange(s0, s1 + 1) - s0 if defs is None else
                       np.concatenate([[0], np.cumsum(defs == leaf.max_def)]))
    row_present = present_of_slot[leaf.slot_of[lo:hi + 1] - s0]
    vb = np.concatenate([[0], np.cumsum(leaf.value_bytes[p0:p0 + n_present])])
    row_bytes = vb[row_present]
    cuts = np.unique(np.concatenate([
        [0], np.searchsorted(row_bytes, np.arange(
            PAGE_BYTES, int(row_bytes[-1]) + 1, PAGE_BYTES)), [hi - lo]]))
    data_off = len(out)
    for r0, r1 in zip(cuts[:-1].tolist(), cuts[1:].tolist()):
        if r1 <= r0:
            continue
        a0 = int(leaf.slot_of[lo + r0]) - s0
        a1 = int(leaf.slot_of[lo + r1]) - s0
        b0, b1 = int(row_present[r0]), int(row_present[r1])
        body = b""
        if leaf.max_rep:
            body += _levels(leaf.reps[s0 + a0:s0 + a1], leaf.max_rep)
        if leaf.max_def:
            body += _levels(defs[a0:a1], leaf.max_def)
        if codes is not None:
            body += bytes([bw]) + W.bit_packed_runs(codes[b0:b1], bw)
            enc = W.ENC_RLE_DICTIONARY
        else:
            body += _present_bytes(leaf, p0 + b0, p0 + b1)
            enc = W.ENC_PLAIN
        page, size = W._page(W.PAGE_DATA, body, (
            5, TType.STRUCT, _struct(_i32(1, a1 - a0), _i32(2, enc),
                                     _i32(3, W.ENC_RLE), _i32(4, W.ENC_RLE))),
            CODEC)
        out += page
        usize += size
    md = _struct(
        _i32(1, 0 if leaf.phys == "BOOLEAN" else W.PHYS[leaf.phys]),
        (2, TType.LIST, ListValue(TType.I32, sorted(used))),
        (3, TType.LIST, ListValue(TType.BINARY,
                                  [p.encode() for p in leaf.path])),
        _i32(4, W.CODECS[CODEC]),
        _i64(5, s1 - s0), _i64(6, usize), _i64(7, len(out) - start))

    def column_chunk(base: int):
        md.fields += [Field(9, TType.I64, base + data_off)] + (
            [] if dict_off is None else
            [Field(11, TType.I64, base + dict_off)])
        return _struct(_i64(2, base), (3, TType.STRUCT, md))
    return bytes(out), column_chunk


def _first_present(leaf: _Leaf, bounds) -> np.ndarray:
    """Each row group's first present value of ``leaf``."""
    slots = leaf.slot_of[[lo for lo, _ in bounds]]
    if leaf.defs is None:
        return slots
    if not leaf.defs.size:
        return np.zeros(len(bounds), np.int64)
    counts = np.add.reduceat(leaf.defs == leaf.max_def, slots)
    return np.concatenate([[0], np.cumsum(counts[:-1])])


def write_nested(arrays: dict, row_group_rows: int = ROW_GROUP_ROWS) -> bytes:
    """The Parquet file of :func:`nested_arrays`' columns."""
    n = arrays["id"].shape[0]
    bounds = [(lo, min(n, lo + row_group_rows))
              for lo in range(0, max(n, 1), row_group_rows)]
    # the leaves' levels and the chunks encode on threads (numpy and the
    # compressor release the GIL), then join in file order
    with concurrent.futures.ThreadPoolExecutor(os.cpu_count() or 1) as ex:
        leaves = _leaves(arrays, ex)
        firsts = [_first_present(leaf, bounds) for leaf in leaves]
        written = list(ex.map(lambda job: _write_chunk(*job), [
            (leaf, lo, hi, int(first[g]))
            for g, (lo, hi) in enumerate(bounds)
            for leaf, first in zip(leaves, firsts)]))
    out = bytearray(W.MAGIC)
    groups = []
    for g, (lo, hi) in enumerate(bounds):
        first = len(out)
        chunks = []
        for raw, column_chunk in written[g * len(leaves):
                                         (g + 1) * len(leaves)]:
            chunks.append(column_chunk(len(out)))
            out += raw
        size = len(out) - first
        groups.append(_struct(
            (1, TType.LIST, ListValue(TType.STRUCT, chunks)),
            _i64(2, size), _i64(3, hi - lo), _i64(5, first), _i64(6, size)))
    meta = _struct(
        _i32(1, 1),
        (2, TType.LIST, ListValue(TType.STRUCT, _schema(arrays))),
        _i64(3, n),
        (4, TType.LIST, ListValue(TType.STRUCT, groups)),
        (6, TType.BINARY, b"spark_rapids_jni_tpu_torch nested writer"))
    footer = _thrift(meta)
    out += footer + struct.pack("<I", len(footer)) + W.MAGIC
    return bytes(out)


def nested_parquet(n_rows: int, seed: int,
                   row_group_rows: int = ROW_GROUP_ROWS) -> tuple:
    """(file bytes, arrays) of the event table."""
    arrays = nested_arrays(n_rows, seed)
    return write_nested(arrays, row_group_rows), arrays


# ---------------------------------------------------------------------------
# the expected values (small tables: tests)
# ---------------------------------------------------------------------------

def _list_pylist(lst: ListArrays, element) -> list:
    valid = (np.ones(lst.offsets.shape[0] - 1, bool) if lst.valid is None
             else lst.valid)
    ev = lst.elem_valid
    out = []
    for i in range(lst.offsets.shape[0] - 1):
        if not valid[i]:
            out.append(None)
            continue
        a, b = int(lst.offsets[i]), int(lst.offsets[i + 1])
        out.append([element(j) if ev is None or ev[j] else None
                    for j in range(a, b)])
    return out


def expected_pylists(arrays: dict) -> dict:
    """Each column as Python values (a LIST row a list, None a null;
    ``uuid`` as 16-byte ``bytes``; ``flag`` as bool)."""
    items, tags, notes = arrays["items"], arrays["tags"], arrays["notes"]
    lat, lon, gvalid = arrays["geo"]
    co = notes.char_offsets
    return {
        "id": arrays["id"].tolist(),
        "items": _list_pylist(items, lambda j: int(items.values[j])),
        "tags": _list_pylist(tags,
                             lambda j: tags.vocab[tags.codes[j]].decode()),
        "notes": _list_pylist(notes, lambda j: notes.chars[
            co[j]:co[j + 1]].tobytes().decode()),
        "geo.lat": [float(v) if ok else None for v, ok in zip(lat, gvalid)],
        "geo.lon": [float(v) if ok else None for v, ok in zip(lon, gvalid)],
        "flag": arrays["flag"].astype(bool).tolist(),
        "uuid": [bytes(r) for r in arrays["uuid"]],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=8 * ROW_GROUP_ROWS)
    ap.add_argument("--seed", type=int, default=18)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    raw, _ = nested_parquet(args.rows, args.seed)
    with open(args.out, "wb") as f:
        f.write(raw)
    print(f"{args.out}: {args.rows} rows, {len(raw)} bytes")
    return 0


if __name__ == "__main__":
    sys.exit(main())
