"""A numpy oracle for the port's 50 TPC-DS queries.

A frozen copy of ``tools/torch_tpcds_oracle.py``, kept with the
benchmark so that later changes to the program's tools cannot move it.
It answers each query of ``spark_rapids_jni_tpu_torch.models.tpcds.QUERIES``
from ``portbench.data.tpcds_star``'s arrays, independently of both
packages: a dimension lookup is an array indexed by surrogate key, a
group is a row of a mixed-radix code over the keys' values or ranks (so
groups come out in key order, a null key first), and a sum of
``ss_ext_sales_price`` is exact: the integer cents products summed, then
divided by 100.  Ranks and windows order by those exact sums; grouping
sets concatenate their sets in ``grouping_id`` order.  :func:`query_params`
picks each query's parameters from the data (the most common
``i_manufact_id`` and ``i_manager_id``, as the JAX package's tests pick
them; the median sales of an item for the semi join; the most common
states).  :func:`readings` holds a query's result, as host arrays, against the
oracle: keys, counts, ranks and decimals exactly (the rows and values
that differ are counted); float sums and means by their relative error
to the exact values, deviations and ratios of two float sums by theirs
over ``DERIVED_RTOL / FLOAT_RTOL``, a difference or a running sum of
float sums relative to the magnitude it is computed through (the two
operands, or the global prefix a segmented scan subtracts).
"""

from __future__ import annotations

import numpy as np

FLOAT_RTOL = 1e-12
# a standard deviation, or a ratio of two float sums
DERIVED_RTOL = 1e-11


class Result:
    """An oracle's answer: one numpy array a column, with a validity
    array (True = present) or None."""

    def __init__(self, cols, valid=None, floats=(), rtol=None, scale=None):
        self.cols = [np.asarray(c) for c in cols]
        self.valid = list(valid) if valid else [None] * len(self.cols)
        self.floats = set(floats)        # columns compared to a tolerance
        self.rtol = dict(rtol or {})     # column → its tolerance
        # column → the magnitude its error is relative to (default |want|)
        self.scale = dict(scale or {})

    @property
    def num_rows(self) -> int:
        return len(self.cols[0]) if self.cols else 0


def _mode(values: np.ndarray) -> int:
    """The most common value, the smallest among ties (pandas' mode()[0])."""
    vals, counts = np.unique(values, return_counts=True)
    return int(vals[np.argmax(counts)])


def query_params(a: dict) -> dict:
    """Each query's keyword arguments, chosen from the data, in the order
    of ``QUERIES``."""
    item, store, ss = a["item"], a["store"], a["store_sales"]
    mid = _mode(item["i_manager_id"])
    per_item = np.bincount(ss["ss_item_sk"])[1:]
    states, counts = np.unique(store["s_state"], return_counts=True)
    common = states[np.argsort(-counts, kind="stable")]
    p = {
        "q3": dict(manufact_id=_mode(item["i_manufact_id"]), moy=11),
        "q42": dict(manager_id=mid, year=2000, moy=11),
        "q52": dict(moy=12, year=2001),
        "q55": dict(manager_id=mid),
        "q_state_rollup": dict(state=str(states[np.argmax(counts)])),
        "q7": dict(year=2000),
        "q19": dict(year=1999, moy=11, manager_lo=1, manager_hi=50),
        "q62": dict(year=2000, qty_lo=10, qty_hi=60),
        "q52_topn": dict(moy=12, year=2001, n=5),
        "q65": dict(frac=0.9),
        "q67_rank": dict(top_n=3),
        "q_like_brands": dict(pat="#1", cat_prefix="S"),
        "q_running_share": dict(year=2000),
        "q_having": dict(min_total=1000.0),
        "q_case_when": dict(qty_cut=50),
        "q_isin_states": dict(states=tuple(str(s) for s in common[:2])),
        "q25_two_fact": dict(year=2000),
        "q96_count": dict(year=2000, qty_min=80),
        "q_rownum_dedup": dict(keep=2),
        "q_dense_rank_cat": dict(top_n=2),
        "q34_baskets": dict(qty_min=60),
        "q_brand_rev_left": dict(manager_id=mid),
        "q23_semi": dict(min_sales=int(np.median(per_item))),
    }
    return {name: p.get(name, {}) for name in ORACLES}


# -- groups -------------------------------------------------------------


def _rank(values: np.ndarray) -> np.ndarray:
    """Order-preserving dense ranks (strings by their bytes)."""
    return np.unique(values, return_inverse=True)[1].astype(np.int64)


def _groups(keys, valid=None):
    """Rows grouped by integer keys (ranks, months, surrogate keys), the
    first key the most significant, groups in key order: a mixed-radix
    code counted by ``np.bincount`` where its range allows, else
    ``np.unique``.  Returns (group of each row, each group's key values,
    group count), and with ``valid`` each group's validity: a null first
    key (``valid`` False) is its own group, ordered first, its value 0."""
    n = len(keys[0])
    comp = np.zeros(n, np.int64)
    lows, spans = [], []
    for i, k in enumerate(keys):
        k = np.asarray(k, np.int64)
        if i == 0 and valid is not None:
            k = np.where(valid, k, 0)
        lo = int(k.min(initial=0))
        span = int(k.max(initial=0)) - lo + 1
        if i == 0 and valid is not None:
            span += 1
            k = np.where(valid, k - lo + 1, 0) + lo
        comp = comp * span + (k - lo)
        lows.append(lo)
        spans.append(span)
    total = int(np.prod(spans, dtype=np.float64))
    if total <= 1 << 26:
        present = np.bincount(comp, minlength=total) > 0
        uniq = np.flatnonzero(present)
        inv = (np.cumsum(present) - 1)[comp]
    else:
        uniq, inv = np.unique(comp, return_inverse=True)
        inv = inv.reshape(-1)
    heads, rem = [], uniq
    for lo, span in reversed(list(zip(lows, spans))):
        heads.append(rem % span + lo)
        rem = rem // span
    heads.reverse()
    if valid is not None:
        ok = heads[0] != lows[0]
        heads[0] = np.where(ok, heads[0] - 1, 0)
        return inv, heads, len(uniq), ok
    return inv, heads, len(uniq)


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
    inv, heads, n = _groups(keys)
    return heads, _cents_to_float(_isum(inv, n, cents))


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
    inv, (uid,), n = _groups([ids])
    cnt = np.bincount(inv, minlength=n)
    cols = [_decode(a, "item", "i_item_id", uid)]
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
    inv, (umoy,), n = _groups([moy])
    return Result([umoy, np.bincount(inv, minlength=n)])


def q_brand_rev_left(a, manager_id):
    it, _, _ = _dims(a)
    ss = a["store_sales"]
    i = ss["ss_item_sk"]
    hit = it["i_manager_id"][i] == manager_id
    bid = np.where(hit, it["i_brand_id"][i], 0)
    inv, (ubid,), n, ok = _groups([bid], valid=hit)
    sums = _cents_to_float(_isum(inv, n, ss["ss_ext_cents"]))
    return Result([ubid, sums, np.bincount(inv, minlength=n)],
                  valid=[ok, None, None], floats=[1])


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
    inv, (ucat,), n = _groups([cat])
    return Result([_decode(a, "item", "i_category", ucat),
                   _cents_to_float(_isum(inv, n, s_sum[si])),
                   _cents_to_float(_isum(inv, n, w_sum[wi]))], floats=[1, 2])


def q_web_also_qty(a):
    ss, ws = a["store_sales"], a["web_sales"]
    nd = int(a["date_dim"]["d_date_sk"].max())
    web = np.unique(_tuples(ws["ws_item_sk"], ws["ws_sold_date_sk"], nd))
    m = np.isin(_tuples(ss["ss_item_sk"], ss["ss_sold_date_sk"], nd), web)
    st = ss["ss_store_sk"][m]
    inv, (ust,), n = _groups([st])
    return Result([ust, _isum(inv, n, ss["ss_quantity"][m])])


# -- the other 34 queries -----------------------------------------------


def _ss_dims(a, *names):
    """The item, date and store attributes ``names`` of each store sale
    (strings as ranks), by name."""
    it, dd, st = _dims(a)
    ss = a["store_sales"]
    out = {}
    for c in names:
        dim, sk = ((dd, "ss_sold_date_sk") if c.startswith("d_") else
                   (st, "ss_store_sk") if c.startswith("s_") else
                   (it, "ss_item_sk"))
        out[c] = dim[c][ss[sk]]
    return out


def _names(a, table: str, col: str, codes) -> np.ndarray:
    return _decode(a, table, col, np.asarray(codes, np.int64))


def q65(a, frac):
    f = _ss_dims(a, "i_brand_id")
    inv, (bid,), n = _groups([f["i_brand_id"]])
    sums = _cents_to_float(_isum(inv, n, a["store_sales"]["ss_ext_cents"]))
    keep = sums < sums.mean() * frac
    return Result([bid[keep], sums[keep]], floats=[1])


def q_store_counts(a):
    st = a["store"]
    order = np.argsort(st["s_store_sk"], kind="stable")
    sk = st["s_store_sk"][order]
    cnt = np.bincount(a["store_sales"]["ss_store_sk"],
                      minlength=int(sk.max()) + 1)
    return Result([sk, st["s_state"][order], cnt[sk]])


def _top_per(part, key_desc_cents, tie_asc, limit, dense=False):
    """Rows of (part, exact cents, tiebreak) tuples ranked within their
    partition by the cents descending, then the tiebreak ascending: the
    rank of each (rank(), or dense_rank() over the cents), and the rows
    whose rank is at most ``limit``."""
    order = np.lexsort((tie_asc, -key_desc_cents, part))
    p, c = part[order], key_desc_cents[order]
    n = len(order)
    pos = np.arange(n)
    head = np.ones(n, bool)
    head[1:] = p[1:] != p[:-1]
    start = np.maximum.accumulate(np.where(head, pos, 0))
    if dense:
        change = head.copy()
        change[1:] |= c[1:] != c[:-1]
        cum = np.cumsum(change)
        rk = cum - cum[start] + 1
    else:
        rk = pos - start + 1
    rank = np.empty(n, np.int64)
    rank[order] = rk
    return rank, rank <= limit


def q67_rank(a, top_n):
    f = _ss_dims(a, "i_category", "i_brand_id")
    inv, (cat, bid), n = _groups([f["i_category"], f["i_brand_id"]])
    cents = _isum(inv, n, a["store_sales"]["ss_ext_cents"])
    rank, keep = _top_per(cat, cents, bid, top_n)
    order = np.lexsort((bid[keep], rank[keep], cat[keep]))
    return Result([_names(a, "item", "i_category", cat[keep][order]),
                   bid[keep][order], _cents_to_float(cents[keep][order]),
                   rank[keep][order]], floats=[2])


def q_like_brands(a, pat, cat_prefix):
    item = a["item"]
    ok = np.array([pat in b for b in item["i_brand"]]) & np.array(
        [c.startswith(cat_prefix) for c in item["i_category"]])
    it, _, _ = _dims(a)
    sel = np.zeros(len(it["i_item_sk"]), bool)
    sel[item["i_item_sk"][ok]] = True
    f = _ss_dims(a, "i_category")
    m = sel[a["store_sales"]["ss_item_sk"]]
    inv, (cat,), n = _groups([f["i_category"][m]])
    sums = _isum(inv, n, a["store_sales"]["ss_ext_cents"][m])
    return Result([_names(a, "item", "i_category", cat),
                   _cents_to_float(sums)], floats=[1])


def q_union_channels(a):
    it, _, _ = _dims(a)
    ss, ws = a["store_sales"], a["web_sales"]
    cat = np.concatenate([it["i_category"][ss["ss_item_sk"]],
                          it["i_category"][ws["ws_item_sk"]]])
    cents = np.concatenate([ss["ss_ext_cents"], _web_cents(ws)])
    inv, (c,), n = _groups([cat])
    return Result([_names(a, "item", "i_category", c),
                   _cents_to_float(_isum(inv, n, cents))], floats=[1])


def q_lag_growth(a):
    f = _ss_dims(a, "d_year", "d_moy")
    inv, (st, yr, mo), n = _groups([a["store_sales"]["ss_store_sk"],
                                          f["d_year"], f["d_moy"]])
    sums = _cents_to_float(_isum(inv, n, a["store_sales"]["ss_ext_cents"]))
    first = np.ones(n, bool)
    first[1:] = st[1:] != st[:-1]
    prev = np.zeros(n)
    prev[1:] = sums[:-1]
    prev[first] = 0.0
    return Result([st, yr, mo, sums, sums - prev],
                  valid=[None, None, None, None, ~first], floats=[3, 4],
                  scale={4: np.abs(sums) + np.abs(prev)})


def q_running_share(a, year):
    f = _ss_dims(a, "d_year", "d_moy")
    m = f["d_year"] == year
    inv, (st, mo), n = _groups([a["store_sales"]["ss_store_sk"][m],
                                      f["d_moy"][m]])
    cents = _isum(inv, n, a["store_sales"]["ss_ext_cents"][m])
    head = np.ones(n, bool)
    head[1:] = st[1:] != st[:-1]
    glob = np.cumsum(cents)
    base = np.where(head, glob - cents, 0)
    base = np.maximum.accumulate(base)    # each store's starting prefix
    sums = _cents_to_float(cents)
    # the port's running sum is a global prefix less the store's base
    return Result([st, mo, sums, _cents_to_float(glob - base)],
                  floats=[2, 3], scale={3: _cents_to_float(glob)})


def q_nunique_items(a):
    ss = a["store_sales"]
    inv, (st, _it), n = _groups([ss["ss_store_sk"], ss["ss_item_sk"]])
    inv2, (st2,), n2 = _groups([st])
    return Result([st2, np.bincount(inv2, minlength=n2)])


def q_having(a, min_total):
    f = _ss_dims(a, "i_brand_id")
    inv, (bid,), n = _groups([f["i_brand_id"]])
    sums = _cents_to_float(_isum(inv, n, a["store_sales"]["ss_ext_cents"]))
    keep = sums > min_total
    return Result([bid[keep], sums[keep]], floats=[1])


def q_case_when(a, qty_cut):
    f = _ss_dims(a, "i_category")
    ss = a["store_sales"]
    bulk = ss["ss_quantity"] > qty_cut
    inv, (cat,), n = _groups([f["i_category"]])
    cents = ss["ss_ext_cents"]
    return Result([_names(a, "item", "i_category", cat),
                   _cents_to_float(_isum(inv, n, np.where(bulk, cents, 0))),
                   _cents_to_float(_isum(inv, n, np.where(bulk, 0, cents)))],
                  floats=[1, 2])


def q_distinct_pairs(a):
    item = a["item"]
    _, (b, c), _ = _groups([item["i_brand_id"], item["i_category_id"]])
    return Result([b, c])


def q_isin_states(a, states):
    f = _ss_dims(a, "s_state")
    names = np.unique(a["store"]["s_state"])
    codes = [int(np.searchsorted(names, s)) for s in states
             if s in set(names)]
    m = np.isin(f["s_state"], codes)
    inv, (st,), n = _groups([f["s_state"][m]])
    sums = _isum(inv, n, a["store_sales"]["ss_ext_cents"][m])
    return Result([_names(a, "store", "s_state", st), _cents_to_float(sums)],
                  floats=[1])


def _grouping_sets(keys, sets, measures, decoders):
    """GROUPING SETS over integer ``keys`` (ranks where strings), sets
    concatenated in ``grouping_id`` order.  ``measures``: functions of
    (group of each row, group count) → one output array each, with its
    float-ness.  ``decoders`` maps a key position to the function that
    turns its codes back into values.  Returns a Result: the keys (null
    where a set drops them), the measures, the grouping_id."""
    nk = len(keys)
    cols = [[] for _ in range(nk + len(measures) + 1)]
    valid = [[] for _ in range(nk)]
    for s in sets:
        inc = sorted(s)
        if inc:
            inv, heads, n = _groups([keys[k] for k in inc])
        else:
            inv, heads, n = np.zeros(len(keys[0]), np.int64), [], 1
        gid = 0
        for k in range(nk):
            if k in inc:
                h = heads[inc.index(k)]
                cols[k].append(decoders.get(k, lambda x: x)(h))
                valid[k].append(np.ones(n, bool))
            else:
                gid |= 1 << (nk - 1 - k)
                proto = decoders.get(k, lambda x: x)(
                    np.zeros(1, np.int64))
                cols[k].append(np.repeat(proto, n))
                valid[k].append(np.zeros(n, bool))
        for j, (fn, _) in enumerate(measures):
            cols[nk + j].append(fn(inv, n))
        cols[-1].append(np.full(n, gid, np.int64))
    floats = [nk + j for j, (_, fl) in enumerate(measures) if fl]
    return Result([np.concatenate(c) for c in cols],
                  valid=[np.concatenate(v) for v in valid]
                  + [None] * (len(measures) + 1), floats=floats)


def _cents_measure(cents):
    return (lambda inv, n: _cents_to_float(_isum(inv, n, cents)), True)


def q36_rollup(a):
    f = _ss_dims(a, "i_category", "i_brand")
    dec = {0: lambda c: _names(a, "item", "i_category", c),
           1: lambda c: _names(a, "item", "i_brand", c)}
    return _grouping_sets([f["i_category"], f["i_brand"]],
                          [[0, 1], [0], []],
                          [_cents_measure(a["store_sales"]["ss_ext_cents"])],
                          dec)


def q86_rollup(a):
    f = _ss_dims(a, "d_year", "d_moy")
    return _grouping_sets([f["d_year"], f["d_moy"]], [[0, 1], [0], []],
                          [_cents_measure(a["store_sales"]["ss_ext_cents"])],
                          {})


def q27_cube(a):
    f = _ss_dims(a, "i_category", "s_state")
    qty = a["store_sales"]["ss_quantity"]

    def mean_qty(inv, n):
        return (_isum(inv, n, qty).astype(np.float64)
                / np.bincount(inv, minlength=n))

    dec = {0: lambda c: _names(a, "item", "i_category", c),
           1: lambda c: _names(a, "store", "s_state", c)}
    return _grouping_sets([f["i_category"], f["s_state"]],
                          [[0, 1], [0], [1], []],
                          [(mean_qty, True),
                           _cents_measure(a["store_sales"]["ss_ext_cents"])],
                          dec)


def q5_grouping_sets(a):
    it, _, _ = _dims(a)
    ss, ws = a["store_sales"], a["web_sales"]
    chan = np.concatenate([np.zeros(len(ss["ss_item_sk"]), np.int64),
                           np.ones(len(ws["ws_item_sk"]), np.int64)])
    cat = np.concatenate([it["i_category"][ss["ss_item_sk"]],
                          it["i_category"][ws["ws_item_sk"]]])
    cents = np.concatenate([ss["ss_ext_cents"], _web_cents(ws)])
    return _grouping_sets([chan, cat], [[0, 1], [0], []],
                          [_cents_measure(cents)],
                          {1: lambda c: _names(a, "item", "i_category", c)})


def q88_counts(a):
    q = a["store_sales"]["ss_quantity"]
    return Result([np.array([int(((q >= lo) & (q <= hi)).sum())])
                   for lo, hi in [(1, 25), (26, 50), (51, 75), (76, 100)]])


def q90_ratio(a):
    f = _ss_dims(a, "d_moy")
    am, pm = int((f["d_moy"] <= 6).sum()), int((f["d_moy"] > 6).sum())
    return Result([np.array([am]), np.array([pm]),
                   np.array([am / max(pm, 1)])], floats=[2])


def q29_minmax(a):
    f = _ss_dims(a, "i_brand_id")
    q = a["store_sales"]["ss_quantity"]
    inv, (bid,), n = _groups([f["i_brand_id"]])
    lo = np.full(n, np.iinfo(np.int32).max, np.int64)
    hi = np.full(n, np.iinfo(np.int32).min, np.int64)
    np.minimum.at(lo, inv, q)
    np.maximum.at(hi, inv, q)
    mean = _isum(inv, n, q).astype(np.float64) / np.bincount(inv,
                                                            minlength=n)
    return Result([bid, lo, hi, mean], floats=[3])


def q48_bands(a):
    f = _ss_dims(a, "s_state")
    ss = a["store_sales"]
    q, p = ss["ss_quantity"], ss["ss_sales_price_cents"]
    m = (((q >= 1) & (q <= 20) & (p < 50_00))
         | ((q >= 41) & (q <= 60) & (p > 150_00)))
    inv, (st,), n = _groups([f["s_state"][m]])
    return Result([_names(a, "store", "s_state", st), _isum(inv, n, q[m])])


def q13_avg_bands(a):
    ss = a["store_sales"]
    q, p = ss["ss_quantity"], ss["ss_sales_price_cents"]
    cols = []
    for lo, hi in [(1, 33), (34, 66), (67, 100)]:
        m = (q >= lo) & (q <= hi)
        s = float(int(p[m].sum()))           # exact below 2^53
        cols.append(np.array([s / max(int(m.sum()), 1) / 100.0]))
    return Result(cols, floats=[0, 1, 2])


def q96_count(a, year, qty_min):
    f = _ss_dims(a, "d_year")
    q = a["store_sales"]["ss_quantity"]
    m = (q >= qty_min) & (f["d_year"] == year)
    return Result([np.array([int(m.sum())]),
                   np.array([int(q[m].astype(np.int64).sum())])])


def q_minmax_price(a):
    item = a["item"]
    cat = _rank(item["i_category"])
    inv, (c,), n = _groups([cat])
    p = item["i_current_price"]
    lo = np.full(n, np.iinfo(np.int64).max, np.int64)
    hi = np.full(n, np.iinfo(np.int64).min, np.int64)
    np.minimum.at(lo, inv, p)
    np.maximum.at(hi, inv, p)
    return Result([_names(a, "item", "i_category", c), lo, hi])


def q_multi_measure(a):
    ss = a["store_sales"]
    inv, (st,), n = _groups([ss["ss_store_sk"]])
    cnt = np.bincount(inv, minlength=n)
    return Result([st, _isum(inv, n, ss["ss_quantity"]),
                   _isum(inv, n, ss["ss_sales_price_cents"]),
                   _isum(inv, n, ss["ss_list_price_cents"]).astype(np.float64)
                   / cnt], floats=[3])


def q_rollup3(a):
    f = _ss_dims(a, "d_year", "d_moy", "s_state")
    return _grouping_sets(
        [f["d_year"], f["d_moy"], f["s_state"]], [[0, 1, 2], [0, 1], [0], []],
        [_cents_measure(a["store_sales"]["ss_ext_cents"])],
        {2: lambda c: _names(a, "store", "s_state", c)})


def q_first_last(a):
    ss = a["store_sales"]
    order = np.argsort(ss["ss_sold_date_sk"], kind="stable")
    item = ss["ss_item_sk"][order]
    price = ss["ss_sales_price_cents"][order]
    inv, (it,), n = _groups([item])
    pos = np.arange(len(order))
    first = np.full(n, len(order), np.int64)
    last = np.full(n, -1, np.int64)
    np.minimum.at(first, inv, pos)
    np.maximum.at(last, inv, pos)
    return Result([it, price[first], price[last]])


def q_rownum_dedup(a, keep):
    f = _ss_dims(a, "d_moy")
    ss = a["store_sales"]
    inv, (st, mo), n = _groups([ss["ss_store_sk"], f["d_moy"]])
    cents = _isum(inv, n, ss["ss_ext_cents"])
    rn, ok = _top_per(st, cents, mo, keep)
    order = np.lexsort((rn[ok], st[ok]))
    return Result([st[ok][order], mo[ok][order],
                   _cents_to_float(cents[ok][order]), rn[ok][order]],
                  floats=[2])


def q_cross_ratio(a):
    it, _, _ = _dims(a)
    ss, ws = a["store_sales"], a["web_sales"]
    nc = int(it["i_category"].max()) + 1
    s_cat = it["i_category"][ss["ss_item_sk"]]
    w_cat = it["i_category"][ws["ws_item_sk"]]
    s_sum = _isum(s_cat, nc, ss["ss_ext_cents"])
    w_sum = _isum(w_cat, nc, _web_cents(ws))
    both = (np.bincount(s_cat, minlength=nc) > 0) & (
        np.bincount(w_cat, minlength=nc) > 0)
    c = np.flatnonzero(both)
    sf, wf = _cents_to_float(s_sum[c]), _cents_to_float(w_sum[c])
    return Result([_names(a, "item", "i_category", c), sf, wf,
                   w_sum[c] / s_sum[c]], floats=[1, 2, 3],
                  rtol={3: DERIVED_RTOL})


def q_null_share(a):
    it, _, _ = _dims(a)
    ws = a["web_sales"]
    inv, (c,), n = _groups([it["i_category"][ws["ws_item_sk"]]])
    valid = ws["ws_ext_sales_price_valid"]
    return Result([_names(a, "item", "i_category", c),
                   np.bincount(inv, minlength=n), _isum(inv, n, valid),
                   _cents_to_float(_isum(inv, n, _web_cents(ws)))],
                  floats=[3])


def q17_stats(a):
    import math
    f = _ss_dims(a, "s_state")
    q = a["store_sales"]["ss_quantity"].astype(np.int64)
    inv, (st,), n = _groups([f["s_state"]])
    cnt = np.bincount(inv, minlength=n)
    s1, s2 = _isum(inv, n, q), _isum(inv, n, q * q)
    mean = s1.astype(np.float64) / cnt
    # the sample deviation from exact integers: one rounding, one sqrt
    std = np.array([math.sqrt((int(k) * int(b) - int(s) * int(s))
                              / (int(k) * (int(k) - 1))) if k > 1 else 0.0
                    for k, s, b in zip(cnt, s1, s2)])
    return Result([_names(a, "store", "s_state", st), mean, std, cnt],
                  valid=[None, None, cnt >= 2, None], floats=[1, 2],
                  rtol={2: DERIVED_RTOL})


def _sold_in(a, col):
    """The distinct values of item column ``col`` sold in store and on
    the web."""
    it, _, _ = _dims(a)
    return (np.unique(it[col][a["store_sales"]["ss_item_sk"]]),
            np.unique(it[col][a["web_sales"]["ws_item_sk"]]))


def q8_intersect(a):
    s, w = _sold_in(a, "i_category_id")
    return Result([np.intersect1d(s, w)])


def q87_except(a):
    s, w = _sold_in(a, "i_brand_id")
    return Result([np.setdiff1d(s, w)])


def q_dense_rank_cat(a, top_n):
    f = _ss_dims(a, "i_category", "d_moy")
    inv, (cat, mo), n = _groups([f["i_category"], f["d_moy"]])
    cents = _isum(inv, n, a["store_sales"]["ss_ext_cents"])
    dr, ok = _top_per(cat, cents, mo, top_n, dense=True)
    order = np.lexsort((mo[ok], dr[ok], cat[ok]))
    return Result([_names(a, "item", "i_category", cat[ok][order]),
                   mo[ok][order], _cents_to_float(cents[ok][order]),
                   dr[ok][order]], floats=[2])


def q34_baskets(a, qty_min):
    ss = a["store_sales"]
    inv, (st, _it), n = _groups([ss["ss_store_sk"], ss["ss_item_sk"]])
    big = _isum(inv, n, ss["ss_quantity"]) >= qty_min
    inv2, (st2,), n2 = _groups([st[big]])
    return Result([st2, np.bincount(inv2, minlength=n2)])



ORACLES = {"q3": q3, "q42": q42, "q52": q52, "q55": q55,
           "q_state_rollup": q_state_rollup, "q7": q7, "q19": q19,
           "q62": q62, "q52_topn": q52_topn, "q65": q65,
           "q_store_counts": q_store_counts,
           "q67_rank": q67_rank, "q_like_brands": q_like_brands,
           "q_union_channels": q_union_channels, "q_lag_growth": q_lag_growth,
           "q_running_share": q_running_share,
           "q_nunique_items": q_nunique_items, "q_having": q_having,
           "q_case_when": q_case_when, "q_distinct_pairs": q_distinct_pairs,
           "q_isin_states": q_isin_states,
           "q36_rollup": q36_rollup, "q86_rollup": q86_rollup,
           "q27_cube": q27_cube, "q5_grouping_sets": q5_grouping_sets,
           "q78_outer": q78_outer, "q25_two_fact": q25_two_fact,
           "q88_counts": q88_counts, "q90_ratio": q90_ratio,
           "q29_minmax": q29_minmax, "q48_bands": q48_bands,
           "q13_avg_bands": q13_avg_bands, "q96_count": q96_count,
           "q23_semi": q23_semi, "q16_anti": q16_anti,
           "q_minmax_price": q_minmax_price,
           "q_multi_measure": q_multi_measure, "q_rollup3": q_rollup3,
           "q_first_last": q_first_last, "q_rownum_dedup": q_rownum_dedup,
           "q_cross_ratio": q_cross_ratio, "q_null_share": q_null_share,
           "q17_stats": q17_stats, "q8_intersect": q8_intersect,
           "q87_except": q87_except, "q_dense_rank_cat": q_dense_rank_cat,
           "q34_baskets": q34_baskets,
           "q_channel_day": q_channel_day, "q_web_also_qty": q_web_also_qty,
           "q_brand_rev_left": q_brand_rev_left}


def answer(name: str, arrays: dict, params: dict) -> Result:
    return ORACLES[name](arrays, **params)


# -- holding a result against the oracle ---------------------------------


def float32_answer(want: Result) -> Result:
    """``want`` with its float columns rounded to float32: the control,
    the oracle's answer one precision below the configuration's."""
    cols = [c.astype(np.float32).astype(np.float64) if ci in want.floats
            else c for ci, c in enumerate(want.cols)]
    return Result(cols, valid=want.valid, floats=want.floats,
                  rtol=want.rtol, scale=want.scale)


def readings(cols: list, valid: list, want: Result) -> tuple:
    """(exact mismatches, float error) of a result given as host arrays
    (one a column; strings as object arrays) with their validity (True =
    present).  The mismatches count the result's columns and rows that
    differ in number from the oracle's (each as every row of the
    longer), and the rows whose validity or exact value differs.  The
    float error is the largest relative error of a float column, divided
    by the column's tolerance over ``FLOAT_RTOL``, so that every column
    reads against one scale."""
    n = want.num_rows
    if len(cols) != len(want.cols):
        return max(n, 1) * (abs(len(cols) - len(want.cols)) + 1), 0.0
    got_n = len(cols[0]) if cols else 0
    if got_n != n:
        return max(n, got_n, 1), 0.0
    bad, worst = 0, 0.0
    for ci, (got, gv, exp, ev) in enumerate(zip(cols, valid, want.cols,
                                                want.valid)):
        ev = np.ones(n, bool) if ev is None else np.asarray(ev, bool)
        gv = np.asarray(gv, bool)
        wrong = gv != ev
        both = gv & ev
        if ci in want.floats:
            g = np.asarray(got)[both].astype(np.float64)
            e = np.asarray(exp)[both].astype(np.float64)
            mag = np.abs(np.asarray(want.scale.get(ci, exp), np.float64))
            mag = mag[both] if mag.ndim else np.full(g.shape, float(mag))
            rel = np.abs(g - e) / np.maximum(mag, 1e-300)
            scale = want.rtol.get(ci, FLOAT_RTOL) / FLOAT_RTOL
            err = float(rel.max(initial=0.0)) / scale
            worst = max(worst, err if np.isfinite(err) else np.inf)
        else:
            g = np.asarray(got).tolist()
            e = np.asarray(exp).tolist()
            wrong |= both & np.array([a != b for a, b in zip(g, e)], bool)
        bad += int(np.count_nonzero(wrong))
    return bad, worst
