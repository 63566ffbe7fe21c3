"""TPC-H lineitem from a seed, written as Parquet and scanned onto the card.

The benchmark's copy of ``tools/torch_lineitem_parquet.py``'s generator:
TPC-H v3.0.1 §4.2.3's 16 columns (keys INT64, orderkey sparse as dbgen
makes it; linenumber INT32; the measures DOUBLE; the dates DATE; four
dictionary string columns; ``l_comment`` text of 10-43 chars cut from a
pool of the grammar's words, §4.2.2.10).  Its numbers come from numpy's
generator, not dbgen's, so the rows differ from dbgen's while their
distributions match.

:func:`reference` makes the host arrays from the seed; :func:`prepare`
writes the file of them with Spark's dictionary fallback and page
sizes (every column dictionary-encoded, falling back to PLAIN past 1 MiB
of dictionary) and scans it with the port's ``scan_table``; the table
stays on the card as the scan leaves it (the four flag columns as
dictionary strings, ``l_comment`` materialized after its fallback).
"""

from __future__ import annotations

import numpy as np

from . import parquet as W

SF1_ROWS = 6_001_215
EPOCH = np.datetime64("1970-01-01", "D")
START_DATE = int((np.datetime64("1992-01-01", "D") - EPOCH).astype(int))
END_DATE = int((np.datetime64("1998-12-31", "D") - EPOCH).astype(int))
CURRENT_DATE = int((np.datetime64("1995-06-17", "D") - EPOCH).astype(int))
VOCAB = {
    "l_returnflag": [b"A", b"N", b"R"],
    "l_linestatus": [b"F", b"O"],
    "l_shipinstruct": [b"DELIVER IN PERSON", b"COLLECT COD", b"NONE",
                       b"TAKE BACK RETURN"],
    "l_shipmode": [b"REG AIR", b"AIR", b"RAIL", b"SHIP", b"TRUCK", b"MAIL",
                   b"FOB"],
}
# (name, physical type, converted type, kind for the row reference)
LINEITEM = (
    ("l_orderkey", "INT64", None, "int64"),
    ("l_partkey", "INT64", None, "int64"),
    ("l_suppkey", "INT64", None, "int64"),
    ("l_linenumber", "INT32", None, "int32"),
    ("l_quantity", "DOUBLE", None, "float64"),
    ("l_extendedprice", "DOUBLE", None, "float64"),
    ("l_discount", "DOUBLE", None, "float64"),
    ("l_tax", "DOUBLE", None, "float64"),
    ("l_returnflag", "BYTE_ARRAY", "UTF8", "string"),
    ("l_linestatus", "BYTE_ARRAY", "UTF8", "string"),
    ("l_shipdate", "INT32", "DATE", "int32"),
    ("l_commitdate", "INT32", "DATE", "int32"),
    ("l_receiptdate", "INT32", "DATE", "int32"),
    ("l_shipinstruct", "BYTE_ARRAY", "UTF8", "string"),
    ("l_shipmode", "BYTE_ARRAY", "UTF8", "string"),
    ("l_comment", "BYTE_ARRAY", "UTF8", "string"),
)
COMMENT_LEN = (10, 43)
COMMENT_WORDS = tuple("""
foxes ideas theodolites pinto beans instructions dependencies excuses
platelets asymptotes courts dolphins multipliers sauternes warthogs frets
dinos attainments somas Tiresias patterns forges braids hockey players
frays warhorses dugouts notornis epitaphs pearls tithes waters orbits gifts
sheaves depths sentiments decoys realms pains grouches escapades
sleep wake are cajole haggle nag use boost affix detect integrate maintain
nod was lose sublate solve thrash promise engage hinder print x-ray breach
eat grow impress mold poach serve run dazzle snooze doze unwind kindle play
hang believe doubt
furious sly careful blithe quick fluffy slow quiet ruthless thin close
dogged daring brave stealthy permanent enticing idle busy regular final
ironic even bold silent
sometimes always never furiously slyly carefully blithely quickly fluffily
slowly quietly ruthlessly thinly closely doggedly daringly bravely
stealthily permanently enticingly idly busily regularly finally ironically
evenly boldly silently
about above across after against along among around at atop before behind
beneath beside besides between beyond by despite during except for from
inside into near of on outside over past since through throughout to toward
under until up upon without with within
""".split())
TEXT_POOL_BYTES = 1 << 22
COMMENT_BLOCK_ROWS = 1 << 20


def generate_lineitem(n_rows: int, seed: int) -> dict:
    """The 15 columns before ``l_comment`` as numpy arrays (strings as
    int8 codes into ``VOCAB``)."""
    rng = np.random.default_rng(seed)
    sf = n_rows / SF1_ROWS
    n_orders = max(1, -(-n_rows // 4))
    lines = rng.integers(1, 8, n_orders)
    diff = n_rows - int(lines.sum())
    while diff:
        can = (np.flatnonzero(lines < 7) if diff > 0
               else np.flatnonzero(lines > 1))
        pick = rng.choice(can, min(abs(diff), can.shape[0]), replace=False)
        lines[pick] += 1 if diff > 0 else -1
        diff = n_rows - int(lines.sum())
    order = np.repeat(np.arange(n_orders, dtype=np.int64), lines)
    first = np.cumsum(lines) - lines
    linenumber = (np.arange(n_rows) - first[order] + 1).astype(np.int32)
    okey = np.arange(1, n_orders + 1, dtype=np.int64)
    orderkey = ((okey >> 3) << 5) | (okey & 7)          # dbgen's MK_SPARSE
    orderdate = rng.integers(START_DATE, END_DATE - 151 + 1, n_orders)
    n_parts = max(1, int(round(200_000 * sf)))
    n_supp = max(1, int(round(10_000 * sf)))
    partkey = rng.integers(1, n_parts + 1, n_rows).astype(np.int64)
    corr = rng.integers(0, 4, n_rows)
    suppkey = ((partkey + corr * (n_supp // 4 + (partkey - 1) // n_supp))
               % n_supp + 1).astype(np.int64)
    quantity = rng.integers(1, 51, n_rows)
    retail_cents = 90000 + (partkey // 10) % 20001 + 100 * (partkey % 1000)
    ship = orderdate[order] + rng.integers(1, 122, n_rows)
    commit = orderdate[order] + rng.integers(30, 91, n_rows)
    receipt = ship + rng.integers(1, 31, n_rows)
    returnflag = np.where(receipt <= CURRENT_DATE,
                          np.where(rng.random(n_rows) < 0.5, 2, 0), 1)
    discount = rng.integers(0, 11, n_rows)
    tax = rng.integers(0, 9, n_rows)
    return {
        "l_orderkey": orderkey[order],
        "l_partkey": partkey,
        "l_suppkey": suppkey,
        "l_linenumber": linenumber,
        "l_quantity": quantity.astype(np.float64),
        "l_extendedprice": (quantity * retail_cents) / 100.0,
        "l_discount": discount / 100.0,
        "l_tax": tax / 100.0,
        "l_returnflag": returnflag.astype(np.int8),
        "l_linestatus": (ship > CURRENT_DATE).astype(np.int8),
        "l_shipdate": ship.astype(np.int32),
        "l_commitdate": commit.astype(np.int32),
        "l_receiptdate": receipt.astype(np.int32),
        "l_shipinstruct": rng.integers(0, 4, n_rows).astype(np.int8),
        "l_shipmode": rng.integers(0, 7, n_rows).astype(np.int8),
    }


def text_pool(rng: np.random.Generator, size: int = TEXT_POOL_BYTES):
    """``size`` bytes of the grammar's words, each followed by a space."""
    words = [w.encode() + b" " for w in COMMENT_WORDS]
    wlen = np.array([len(w) for w in words], np.int64)
    wstart = np.concatenate([[0], np.cumsum(wlen)[:-1]])
    table = np.frombuffer(b"".join(words), np.uint8)
    pick = rng.integers(0, len(words), -(-size // int(wlen.min())))
    lens = wlen[pick]
    dst = np.concatenate([[0], np.cumsum(lens)[:-1]])
    within = np.arange(int(lens.sum()), dtype=np.int64)
    pool = table[np.repeat(wstart[pick] - dst, lens) + within]
    return pool[:size]


def generate_comments(n_rows: int, seed: int) -> tuple:
    """``l_comment`` as (chars uint8, int64 offsets [n+1])."""
    rng = np.random.default_rng([seed, len(LINEITEM)])
    pool = text_pool(rng)
    lo, hi = COMMENT_LEN
    lens = rng.integers(lo, hi + 1, n_rows)
    starts = rng.integers(0, pool.shape[0] - lens + 1)
    offs = np.zeros(n_rows + 1, np.int64)
    np.cumsum(lens, out=offs[1:])
    chars = np.empty(int(offs[-1]), np.uint8)
    for r0 in range(0, n_rows, COMMENT_BLOCK_ROWS):
        r1 = min(n_rows, r0 + COMMENT_BLOCK_ROWS)
        c0, c1 = int(offs[r0]), int(offs[r1])
        within = np.arange(c1 - c0, dtype=np.int64)
        chars[c0:c1] = pool[np.repeat(starts[r0:r1] - offs[r0:r1] + c0,
                                      lens[r0:r1]) + within]
    return chars, offs


def vocab_strings(name: str, codes: np.ndarray) -> tuple:
    """A dictionary column's strings as (chars, int64 offsets)."""
    vocab = VOCAB[name]
    vlen = np.array([len(v) for v in vocab], np.int64)
    vstart = np.concatenate([[0], np.cumsum(vlen)[:-1]])
    table = np.frombuffer(b"".join(vocab), np.uint8)
    lens = vlen[codes]
    offs = np.zeros(codes.shape[0] + 1, np.int64)
    np.cumsum(lens, out=offs[1:])
    within = np.arange(int(offs[-1]), dtype=np.int64)
    chars = table[np.repeat(vstart[codes] - offs[:-1], lens) + within]
    return chars, offs


def parquet_columns(data: dict) -> list:
    """Every column dictionary-encoded, as parquet-mr encodes them."""
    out = []
    for name, phys, conv, _ in LINEITEM:
        if name == "l_comment":
            col = W.plain_strings_column(name, *data[name])
        else:
            col = W.ParquetColumn(name, phys, data[name], "plain", conv,
                                  VOCAB.get(name))
        col.encoding = "dict"
        out.append(col)
    return out


def reference_columns(data: dict) -> list:
    """The table's columns in order as the row reference takes them:
    ``(kind, values)`` with strings as (chars, offsets)."""
    cols = []
    for name, _, _, kind in LINEITEM:
        if kind != "string":
            cols.append((kind, data[name]))
        elif name == "l_comment":
            cols.append((kind, data[name]))
        else:
            cols.append((kind, vocab_strings(name, data[name])))
    return cols


def reference(config: dict, seed: int) -> dict:
    """The config's lineitem on the host, from the seed alone: its
    columns as the writer takes them (``columns``), as the row reference
    takes them (``reference``), and the entry lengths of the dictionaries
    that stay resident (``dictionaries``: column index to the byte
    lengths of the entries the column uses)."""
    n_rows = int(config["rows"])
    data = generate_lineitem(n_rows, seed)
    data["l_comment"] = generate_comments(n_rows, seed)
    dicts = {}
    for i, (name, _, _, _) in enumerate(LINEITEM):
        if name in VOCAB:
            used = np.unique(data[name])
            dicts[i] = np.array([len(VOCAB[name][u]) for u in used], np.int64)
    return {"columns": data,
            "reference": {"lineitem": reference_columns(data)},
            "dictionaries": {"lineitem": dicts}}


def prepare(config: dict, seed: int, device) -> dict:
    """:func:`reference`, and the table the port's scan puts on
    ``device`` from the file written of it."""
    from spark_rapids_jni_tpu_torch.parquet import device_scan
    host = reference(config, seed)
    w = config["writer"]
    raw = W.write_parquet(parquet_columns(host.pop("columns")),
                          int(w["row_group_rows"]),
                          data_page_bytes=int(w["data_page_bytes"]),
                          dict_page_bytes=int(w["dict_page_bytes"]),
                          page_row_limit=int(w["page_row_limit"]))
    host["tables"] = {"lineitem": device_scan.scan_table(raw, device=device)}
    return host
