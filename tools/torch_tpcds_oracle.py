#!/usr/bin/env python3
"""A numpy oracle for the port's 16 TPC-DS join queries.

    python3 tools/torch_tpcds_oracle.py --n-sales 100000 --n-items 2000

Answers each query of ``spark_rapids_jni_tpu_torch.models.tpcds.QUERIES``
from ``tools/torch_tpcds_parquet.py``'s arrays, independently of both
packages: a dimension lookup is an array indexed by surrogate key, a
group is a row of ``np.unique(..., return_inverse=True)`` over the keys'
ranks (so groups come out in key order, a null key first), and a sum of
``ss_ext_sales_price`` is exact: the integer cents products summed, then
divided by 100.  :func:`query_params` picks each query's parameters from
the data (the most common ``i_manufact_id`` and ``i_manager_id``, as the
JAX package's tests pick them; the median sales of an item for the semi
join).  :func:`check` holds a query's result table against the oracle:
keys, counts and decimals exactly, float sums and means within a relative
``FLOAT_RTOL``.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

FLOAT_RTOL = 1e-12


class Result:
    """An oracle's answer: one numpy array a column, with a validity
    array (True = present) or None."""

    def __init__(self, cols, valid=None, floats=()):
        self.cols = [np.asarray(c) for c in cols]
        self.valid = list(valid) if valid else [None] * len(self.cols)
        self.floats = set(floats)        # columns compared to FLOAT_RTOL

    @property
    def num_rows(self) -> int:
        return len(self.cols[0]) if self.cols else 0


def _mode(values: np.ndarray) -> int:
    """The most common value, the smallest among ties (pandas' mode()[0])."""
    vals, counts = np.unique(values, return_counts=True)
    return int(vals[np.argmax(counts)])


def query_params(a: dict) -> dict:
    """Each query's keyword arguments, chosen from the data."""
    item, store, ss = a["item"], a["store"], a["store_sales"]
    mid = _mode(item["i_manager_id"])
    per_item = np.bincount(ss["ss_item_sk"])[1:]
    states, counts = np.unique(store["s_state"], return_counts=True)
    return {
        "q3": dict(manufact_id=_mode(item["i_manufact_id"]), moy=11),
        "q42": dict(manager_id=mid, year=2000, moy=11),
        "q52": dict(moy=12, year=2001),
        "q55": dict(manager_id=mid),
        "q_state_rollup": dict(state=str(states[np.argmax(counts)])),
        "q7": dict(year=2000),
        "q19": dict(year=1999, moy=11, manager_lo=1, manager_hi=50),
        "q62": dict(year=2000, qty_lo=10, qty_hi=60),
        "q52_topn": dict(moy=12, year=2001, n=5),
        "q_brand_rev_left": dict(manager_id=mid),
        "q23_semi": dict(min_sales=int(np.median(per_item))),
        "q16_anti": {},
        "q78_outer": {},
        "q25_two_fact": dict(year=2000),
        "q_channel_day": {},
        "q_web_also_qty": {},
    }


# -- groups -------------------------------------------------------------


def _rank(values: np.ndarray) -> np.ndarray:
    """Order-preserving dense ranks (strings by their bytes)."""
    return np.unique(values, return_inverse=True)[1].astype(np.int64)


def _groups(keys, valid=None):
    """(group of each row, rows of each group's first row) for key arrays
    (the first the most significant); a null key (``valid`` False) is its
    own group, ordered first."""
    comp = np.zeros(len(keys[0]), np.int64)
    for i, k in enumerate(keys):
        r = _rank(k)
        if valid is not None and i == 0:
            r = np.where(valid, r + 1, 0)
        comp = comp * (int(r.max(initial=0)) + 1) + r
    uniq, first, inv = np.unique(comp, return_index=True, return_inverse=True)
    return inv.reshape(-1), first, len(uniq)


def _isum(inv, n, vals) -> np.ndarray:
    """Exact int64 sums by group: float64 weights are exact integers, and
    so is every partial sum below 2^53."""
    vals = np.asarray(vals, np.int64)
    if np.abs(vals).sum(dtype=np.int64) >= 2 ** 53:
        raise ValueError("sums past 2^53 are not exact in float64")
    out = np.bincount(inv, weights=vals.astype(np.float64), minlength=n)
    return out.astype(np.int64)


def _cents_to_float(cents: np.ndarray) -> np.ndarray:
    # int64 cents below 2^53 convert exactly; the division rounds once
    if np.abs(cents).max(initial=0) >= 2 ** 53:
        raise ValueError("cents past 2^53 do not convert exactly")
    return cents.astype(np.float64) / 100.0


def _keyed_sum(keys, cents):
    """Rows grouped by ``keys``: (the keys' group heads, exact float
    sums)."""
    inv, first, n = _groups(keys)
    return [k[first] for k in keys], _cents_to_float(_isum(inv, n, cents))


# -- the queries ---------------------------------------------------------


def _dims(a):
    """Each dimension's columns as arrays indexed by surrogate key; a
    string column as its values' ranks, with the sorted distinct values
    in ``NAMES`` (so that rows group on integers)."""
    item, dd, store = a["item"], a["date_dim"], a["store"]

    def by_sk(sk, v):
        if v.dtype == object:
            v = _rank(v)
        out = np.zeros(int(sk.max()) + 1, dtype=v.dtype)
        out[sk] = v
        return out

    return ({c: by_sk(item["i_item_sk"], v) for c, v in item.items()},
            {c: by_sk(dd["d_date_sk"], v) for c, v in dd.items()},
            {c: by_sk(store["s_store_sk"], v) for c, v in store.items()})


def _decode(a, table: str, col: str, codes: np.ndarray) -> np.ndarray:
    """Rank codes of a string dimension column back to its strings."""
    return np.unique(a[table][col])[codes]


def _star(a, item_ok, date_ok, key_cols):
    """store_sales ⋈ item ⋈ date_dim where both filters hold, grouped by
    ``key_cols`` (names of item or date columns), the exact sum."""
    it, dd, _ = _dims(a)
    ss = a["store_sales"]
    i, d = ss["ss_item_sk"], ss["ss_sold_date_sk"]
    m = item_ok[i] & date_ok[d]
    keys = [(dd if c.startswith("d_") else it)[c][(d if c.startswith("d_")
                                                    else i)[m]]
            for c in key_cols]
    heads, sums = _keyed_sum(keys, ss["ss_ext_cents"][m])
    heads = [_decode(a, "item", c, h) if a["item"].get(c) is not None
             and a["item"][c].dtype == object else h
             for c, h in zip(key_cols, heads)]
    return Result(heads + [sums], floats=[len(heads)])


def q3(a, manufact_id, moy):
    it, dd, _ = _dims(a)
    return _star(a, it["i_manufact_id"] == manufact_id, dd["d_moy"] == moy,
                 ["d_year", "i_brand_id", "i_brand"])


def q42(a, manager_id, year, moy):
    it, dd, _ = _dims(a)
    return _star(a, it["i_manager_id"] == manager_id,
                 (dd["d_moy"] == moy) & (dd["d_year"] == year),
                 ["d_year", "i_category_id", "i_category"])


def q52(a, moy, year):
    it, dd, _ = _dims(a)
    return _star(a, np.ones(len(it["i_item_sk"]), bool),
                 (dd["d_moy"] == moy) & (dd["d_year"] == year),
                 ["d_year", "i_brand_id", "i_brand"])


def q55(a, manager_id):
    it, dd, _ = _dims(a)
    return _star(a, it["i_manager_id"] == manager_id,
                 np.ones(len(dd["d_date_sk"]), bool), ["i_brand_id", "i_brand"])


def q19(a, year, moy, manager_lo, manager_hi):
    it, dd, _ = _dims(a)
    mg = it["i_manager_id"]
    return _star(a, (mg >= manager_lo) & (mg <= manager_hi),
                 (dd["d_moy"] == moy) & (dd["d_year"] == year),
                 ["i_brand_id", "i_brand", "i_manufact_id"])


def q52_topn(a, moy, year, n):
    r = q52(a, moy, year)
    year_, bid, brand, s = r.cols
    order = np.lexsort((bid, -s))[:n]
    return Result([year_[order], bid[order], brand[order], s[order]],
                  floats=[3])


def q_state_rollup(a, state):
    ss = a["store_sales"]
    st = a["store"]
    in_state = np.zeros(int(st["s_store_sk"].max()) + 1, bool)
    in_state[st["s_store_sk"][st["s_state"] == state]] = True
    m = in_state[ss["ss_store_sk"]]
    if not m.any():
        return Result([np.array([], object), np.array([], np.int64),
                       np.array([], np.float64), np.array([], np.int64)],
                      floats=[2])
    qty = ss["ss_quantity"][m].astype(np.int64)
    return Result([np.array([state], object),
                   np.array([int(ss["ss_sales_price_cents"][m].sum())]),
                   np.array([qty.sum() / len(qty)]),
                   np.array([len(qty)])], floats=[2])


def q7(a, year):
    it, dd, _ = _dims(a)
    ss = a["store_sales"]
    m = dd["d_year"][ss["ss_sold_date_sk"]] == year
    ids = it["i_item_id"][ss["ss_item_sk"][m]]
    inv, first, n = _groups([ids])
    cnt = np.bincount(inv, minlength=n)
    cols = [_decode(a, "item", "i_item_id", ids[first])]
    for c in ("ss_quantity", "ss_list_price_cents", "ss_sales_price_cents"):
        cols.append(_isum(inv, n, ss[c][m]).astype(np.float64) / cnt)
    return Result(cols, floats=[1, 2, 3])


def q62(a, year, qty_lo, qty_hi):
    _, dd, _ = _dims(a)
    ss = a["store_sales"]
    q = ss["ss_quantity"]
    d = ss["ss_sold_date_sk"]
    m = (q >= qty_lo) & (q <= qty_hi) & (dd["d_year"][d] == year)
    moy = dd["d_moy"][d[m]]
    inv, first, n = _groups([moy])
    return Result([moy[first], np.bincount(inv, minlength=n)])


def q_brand_rev_left(a, manager_id):
    it, _, _ = _dims(a)
    ss = a["store_sales"]
    i = ss["ss_item_sk"]
    hit = it["i_manager_id"][i] == manager_id
    bid = np.where(hit, it["i_brand_id"][i], 0)
    inv, first, n = _groups([bid], valid=hit)
    sums = _cents_to_float(_isum(inv, n, ss["ss_ext_cents"]))
    return Result([bid[first], sums, np.bincount(inv, minlength=n)],
                  valid=[hit[first], None, None], floats=[1])


def q23_semi(a, min_sales):
    ss = a["store_sales"]
    i = ss["ss_item_sk"]
    per_item = np.bincount(i)
    m = per_item[i] > min_sales
    return Result([_cents_to_float(np.array([ss["ss_ext_cents"][m].sum()])),
                   np.array([int(m.sum())])], floats=[0])


def q16_anti(a):
    it = a["item"]
    sold = np.zeros(int(it["i_item_sk"].max()) + 1, bool)
    sold[a["store_sales"]["ss_item_sk"]] = True
    keep = ~sold[it["i_item_sk"]]
    order = np.argsort(it["i_item_sk"][keep], kind="stable")
    return Result([it["i_item_sk"][keep][order],
                   it["i_manufact_id"][keep][order]])


def _web_cents(ws):
    return np.where(ws["ws_ext_sales_price_valid"], ws["ws_ext_cents"], 0)


def _per_item(items, cents, n_items):
    """Exact float sums by item over the items that occur."""
    sums = _isum(items, n_items + 1, cents)
    seen = np.zeros(n_items + 1, bool)
    seen[items] = True
    return seen, sums


def q78_outer(a):
    ss, ws = a["store_sales"], a["web_sales"]
    n = int(a["item"]["i_item_sk"].max())
    s_seen, s_sum = _per_item(ss["ss_item_sk"], ss["ss_ext_cents"], n)
    w_seen, w_sum = _per_item(ws["ws_item_sk"], _web_cents(ws), n)
    keys = np.flatnonzero(s_seen | w_seen)
    return Result([keys, _cents_to_float(s_sum[keys]),
                   _cents_to_float(w_sum[keys])], floats=[1, 2])


def q25_two_fact(a, year):
    _, dd, _ = _dims(a)
    ss, ws = a["store_sales"], a["web_sales"]
    n = int(a["item"]["i_item_sk"].max())
    ms = dd["d_year"][ss["ss_sold_date_sk"]] == year
    mw = dd["d_year"][ws["ws_sold_date_sk"]] == year
    s_seen, s_sum = _per_item(ss["ss_item_sk"][ms], ss["ss_ext_cents"][ms], n)
    w_seen, w_sum = _per_item(ws["ws_item_sk"][mw], _web_cents(ws)[mw], n)
    keys = np.flatnonzero(s_seen & w_seen)
    return Result([keys, _cents_to_float(s_sum[keys]),
                   _cents_to_float(w_sum[keys])], floats=[1, 2])


def _tuples(items, dates, n_dates):
    return items.astype(np.int64) * (n_dates + 1) + dates


def q_channel_day(a):
    it, _, _ = _dims(a)
    ss, ws = a["store_sales"], a["web_sales"]
    nd = int(a["date_dim"]["d_date_sk"].max())
    ts = _tuples(ss["ss_item_sk"], ss["ss_sold_date_sk"], nd)
    tw = _tuples(ws["ws_item_sk"], ws["ws_sold_date_sk"], nd)
    us, inv_s = np.unique(ts, return_inverse=True)
    uw, inv_w = np.unique(tw, return_inverse=True)
    s_sum = _isum(inv_s.reshape(-1), len(us), ss["ss_ext_cents"])
    w_sum = _isum(inv_w.reshape(-1), len(uw), _web_cents(ws))
    both, si, wi = np.intersect1d(us, uw, assume_unique=True,
                                  return_indices=True)
    cat = it["i_category"][both // (nd + 1)]
    inv, first, n = _groups([cat])
    return Result([_decode(a, "item", "i_category", cat[first]), _cents_to_float(_isum(inv, n, s_sum[si])),
                   _cents_to_float(_isum(inv, n, w_sum[wi]))], floats=[1, 2])


def q_web_also_qty(a):
    ss, ws = a["store_sales"], a["web_sales"]
    nd = int(a["date_dim"]["d_date_sk"].max())
    web = np.unique(_tuples(ws["ws_item_sk"], ws["ws_sold_date_sk"], nd))
    m = np.isin(_tuples(ss["ss_item_sk"], ss["ss_sold_date_sk"], nd), web)
    st = ss["ss_store_sk"][m]
    inv, first, n = _groups([st])
    return Result([st[first], _isum(inv, n, ss["ss_quantity"][m])])


ORACLES = {"q3": q3, "q42": q42, "q52": q52, "q55": q55,
           "q_state_rollup": q_state_rollup, "q7": q7, "q19": q19,
           "q62": q62, "q52_topn": q52_topn,
           "q_brand_rev_left": q_brand_rev_left, "q23_semi": q23_semi,
           "q16_anti": q16_anti, "q78_outer": q78_outer,
           "q25_two_fact": q25_two_fact, "q_channel_day": q_channel_day,
           "q_web_also_qty": q_web_also_qty}


def answer(name: str, arrays: dict, params: dict) -> Result:
    return ORACLES[name](arrays, **params)


# -- holding a result table against the oracle ---------------------------


def _column_values(col):
    """(values, validity) of a result column: numpy, strings as a list."""
    valid = col.validity_or_true().cpu().numpy()
    if col.dtype.id.name == "STRING":
        return np.array(col.to_pylist(), dtype=object), valid
    return col.data.cpu().numpy(), valid


def check(name: str, table, want: Result) -> float:
    """Raises AssertionError where ``table`` (the port's result) differs
    from ``want``; returns the float columns' largest relative error."""
    assert table.num_columns == len(want.cols), \
        f"{name}: {table.num_columns} columns, the oracle has " \
        f"{len(want.cols)}"
    assert table.num_rows == want.num_rows, \
        f"{name}: {table.num_rows} rows, the oracle has {want.num_rows}"
    worst = 0.0
    for ci, (col, exp, ev) in enumerate(zip(table.columns, want.cols,
                                            want.valid)):
        got, gv = _column_values(col)
        ev = np.ones(want.num_rows, bool) if ev is None else ev
        assert np.array_equal(gv, ev), f"{name}: column {ci} validity"
        if ci in want.floats:
            g = got[ev].astype(np.float64)
            e = exp[ev].astype(np.float64)
            rel = np.abs(g - e) / np.maximum(np.abs(e), 1e-300)
            assert bool((rel <= FLOAT_RTOL).all()), \
                f"{name}: column {ci} off by a relative {rel.max():.3e}"
            worst = max(worst, float(rel.max(initial=0.0)))
        else:
            assert got[ev].tolist() == exp[ev].tolist(), \
                f"{name}: column {ci} {got[ev][:5]} != {exp[ev][:5]}"
    return worst


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n-sales", type=int, default=100_000)
    ap.add_argument("--n-items", type=int, default=2000)
    ap.add_argument("--n-stores", type=int, default=12)
    ap.add_argument("--seed", type=int, default=42)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch_tpcds_parquet as TW
    arrays = TW.tpcds_arrays(args.n_sales, args.n_items,
                             n_stores=args.n_stores, seed=args.seed)
    for name, params in query_params(arrays).items():
        r = answer(name, arrays, params)
        print(f"{name} {params}: {r.num_rows} rows")
    return 0


if __name__ == "__main__":
    sys.exit(main())
