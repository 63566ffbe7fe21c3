"""TPC-DS join queries (BASELINE config #3's subset) on the port's ops.

The port's counterpart of 16 queries of the JAX package's
``models/tpcds.py`` (:111-760), over the tables of
``benchmarks/tpcds_data.py``: the ``store_sales`` and ``web_sales`` facts
and the ``item``, ``date_dim`` and ``store`` dimensions.  Each is a scan,
filters, equi-joins (dense and sorted engines, composite two-column keys,
fused join→groupby, left, semi, anti and full outer joins) and a sorted
groupby, with the JAX package's plans and output order.  Queries that need
windows, rollup or cube, ``nunique``, casts or the rest of the string
functions wait for those modules.

``load_tables`` scans the Parquet files onto the GPU unless ``device``
says otherwise; every query runs where its tables are.
"""

from __future__ import annotations

import torch

from .. import types as T
from ..column import Column, Table
from ..ops import (anti_join, apply_boolean_mask, distinct, fill_null,
                   full_outer_join, groupby_aggregate, inner_join,
                   join_aggregate, semi_join, slice_table, sort_table, sum_)
from ..ops import strings as S

SS_COLS = ["ss_sold_date_sk", "ss_item_sk", "ss_store_sk", "ss_quantity",
           "ss_sales_price_cents", "ss_list_price_cents",
           "ss_ext_sales_price"]
WS_COLS = ["ws_sold_date_sk", "ws_item_sk", "ws_quantity",
           "ws_ext_sales_price"]
ITEM_COLS = ["i_item_sk", "i_item_id", "i_current_price", "i_brand_id",
             "i_brand", "i_category_id", "i_category", "i_manufact_id",
             "i_manager_id"]
DATE_COLS = ["d_date_sk", "d_year", "d_moy"]
STORE_COLS = ["s_store_sk", "s_state"]
TABLE_COLS = {"store_sales": SS_COLS, "item": ITEM_COLS,
              "date_dim": DATE_COLS, "store": STORE_COLS,
              "web_sales": WS_COLS}


def load_tables(files: dict, device=None) -> dict[str, Table]:
    """The query columns of each file (``web_sales`` where given), scanned
    by ``parquet.device_scan.scan_table``."""
    from ..parquet import device_scan
    return {name: device_scan.scan_table(files[name], columns=cols,
                                         device=device)
            for name, cols in TABLE_COLS.items() if name in files}


def _eq_scalar_mask(col: Column, value) -> torch.Tensor:
    if col.dtype.id == T.TypeId.STRING:
        b = S.equal_to_scalar(col, value)
        m = b.data.to(torch.bool)
        return m if b.validity is None else (m & b.validity)
    m = col.data == value
    return m if col.validity is None else (m & col.validity)


def _col(cols: list[str], name: str) -> int:
    return cols.index(name)


def _range_mask(col: Column, lo=None, hi=None, hi_strict: bool = False):
    """lo <= col <= hi (either bound optional; ``hi_strict`` makes the
    upper bound exclusive), False on null rows."""
    m = None
    if lo is not None:
        m = col.data >= lo
    if hi is not None:
        hm = (col.data < hi) if hi_strict else (col.data <= hi)
        m = hm if m is None else (m & hm)
    if col.validity is not None:
        m = col.validity if m is None else (m & col.validity)
    return m


def _group_sum(joined: Table, cols: list[str], key_names: list[str],
               value_name: str) -> Table:
    """GROUP BY keys, SUM(value), in key order; ``cols`` names the joined
    columns (left's then right's)."""
    out = groupby_aggregate(
        joined, [cols.index(k) for k in key_names],
        [(cols.index(value_name), "sum")])
    return sort_table(out, list(range(len(key_names))))


def _join_group_sum(lt: Table, rt: Table, left_on: int, right_on: int,
                    cols: list[str], key_names: list[str],
                    value_name: str) -> Table:
    """The final join and GROUP BY keys, SUM(value), fused by
    ``ops.join_aggregate``; ``cols`` names the joined schema."""
    out = join_aggregate(
        lt, rt, left_on, right_on, [cols.index(k) for k in key_names],
        [(cols.index(value_name), "sum")])
    return sort_table(out, list(range(len(key_names))))


def q3(tables: dict[str, Table], manufact_id: int = 436,
       moy: int = 11) -> Table:
    """SELECT d_year, i_brand_id, i_brand, sum(ss_ext_sales_price)
    FROM store_sales ⋈ item ⋈ date_dim
    WHERE i_manufact_id = ? AND d_moy = ?
    GROUP BY d_year, i_brand_id, i_brand ORDER BY keys."""
    ss, item, dd = tables["store_sales"], tables["item"], tables["date_dim"]
    item_f = apply_boolean_mask(
        item, _eq_scalar_mask(item[_col(ITEM_COLS, "i_manufact_id")],
                              manufact_id))
    dd_f = apply_boolean_mask(
        dd, _eq_scalar_mask(dd[_col(DATE_COLS, "d_moy")], moy))
    j1 = inner_join(ss, item_f, _col(SS_COLS, "ss_item_sk"),
                    _col(ITEM_COLS, "i_item_sk"))
    return _join_group_sum(j1, dd_f, _col(SS_COLS, "ss_sold_date_sk"),
                           _col(DATE_COLS, "d_date_sk"),
                           SS_COLS + ITEM_COLS + DATE_COLS,
                           ["d_year", "i_brand_id", "i_brand"],
                           "ss_ext_sales_price")


def q42(tables: dict[str, Table], manager_id: int = 1, year: int = 2000,
        moy: int = 11) -> Table:
    """GROUP BY d_year, i_category_id, i_category with manager and date
    predicates (Q42's shape)."""
    ss, item, dd = tables["store_sales"], tables["item"], tables["date_dim"]
    item_f = apply_boolean_mask(
        item, _eq_scalar_mask(item[_col(ITEM_COLS, "i_manager_id")],
                              manager_id))
    dd_mask = (_eq_scalar_mask(dd[_col(DATE_COLS, "d_moy")], moy)
               & _eq_scalar_mask(dd[_col(DATE_COLS, "d_year")], year))
    dd_f = apply_boolean_mask(dd, dd_mask)
    j1 = inner_join(ss, item_f, _col(SS_COLS, "ss_item_sk"),
                    _col(ITEM_COLS, "i_item_sk"))
    return _join_group_sum(j1, dd_f, _col(SS_COLS, "ss_sold_date_sk"),
                           _col(DATE_COLS, "d_date_sk"),
                           SS_COLS + ITEM_COLS + DATE_COLS,
                           ["d_year", "i_category_id", "i_category"],
                           "ss_ext_sales_price")


def q52(tables: dict[str, Table], moy: int = 12, year: int = 2001) -> Table:
    """GROUP BY d_year, i_brand_id, i_brand for one month (Q52's shape)."""
    ss, dd = tables["store_sales"], tables["date_dim"]
    dd_mask = (_eq_scalar_mask(dd[_col(DATE_COLS, "d_moy")], moy)
               & _eq_scalar_mask(dd[_col(DATE_COLS, "d_year")], year))
    dd_f = apply_boolean_mask(dd, dd_mask)
    j1 = inner_join(ss, dd_f, _col(SS_COLS, "ss_sold_date_sk"),
                    _col(DATE_COLS, "d_date_sk"))
    cols1 = SS_COLS + DATE_COLS
    return _join_group_sum(j1, tables["item"], cols1.index("ss_item_sk"),
                           _col(ITEM_COLS, "i_item_sk"), cols1 + ITEM_COLS,
                           ["d_year", "i_brand_id", "i_brand"],
                           "ss_ext_sales_price")


def q55(tables: dict[str, Table], manager_id: int = 28) -> Table:
    """GROUP BY i_brand_id, i_brand for one manager (Q55's shape)."""
    ss, item = tables["store_sales"], tables["item"]
    item_f = apply_boolean_mask(
        item, _eq_scalar_mask(item[_col(ITEM_COLS, "i_manager_id")],
                              manager_id))
    return _join_group_sum(ss, item_f, _col(SS_COLS, "ss_item_sk"),
                           _col(ITEM_COLS, "i_item_sk"),
                           SS_COLS + ITEM_COLS,
                           ["i_brand_id", "i_brand"], "ss_ext_sales_price")


def q_state_rollup(tables: dict[str, Table], state: str = "TN") -> Table:
    """The stores of one state: the decimal64(-2) sum of the sales
    prices, and the mean and count of the quantities."""
    ss, store = tables["store_sales"], tables["store"]
    store_f = apply_boolean_mask(
        store, _eq_scalar_mask(store[_col(STORE_COLS, "s_state")], state))
    j1 = inner_join(ss, store_f, _col(SS_COLS, "ss_store_sk"),
                    _col(STORE_COLS, "s_store_sk"))
    cols = SS_COLS + STORE_COLS
    # the cents are the unscaled decimal: read them as decimal64(-2)
    price_i = cols.index("ss_sales_price_cents")
    work = list(j1.columns)
    work[price_i] = Column(T.decimal64(-2), j1[price_i].data,
                           validity=j1[price_i].validity)
    out = groupby_aggregate(
        Table(work), [cols.index("s_state")],
        [(price_i, "sum"), (cols.index("ss_quantity"), "mean"),
         (cols.index("ss_quantity"), "count")])
    return sort_table(out, [0])


def q7(tables: dict[str, Table], year: int = 2000) -> Table:
    """SELECT i_item_id, avg(ss_quantity), avg(ss_list_price),
    avg(ss_sales_price) FROM ss ⋈ item ⋈ date WHERE d_year = ?
    GROUP BY i_item_id ORDER BY i_item_id (Q7's shape)."""
    ss, item, dd = tables["store_sales"], tables["item"], tables["date_dim"]
    dd_f = apply_boolean_mask(
        dd, _eq_scalar_mask(dd[_col(DATE_COLS, "d_year")], year))
    j1 = inner_join(ss, dd_f, _col(SS_COLS, "ss_sold_date_sk"),
                    _col(DATE_COLS, "d_date_sk"))
    cols1 = SS_COLS + DATE_COLS
    cols = cols1 + ITEM_COLS
    out = join_aggregate(
        j1, item, cols1.index("ss_item_sk"), _col(ITEM_COLS, "i_item_sk"),
        [cols.index("i_item_id")],
        [(cols.index("ss_quantity"), "mean"),
         (cols.index("ss_list_price_cents"), "mean"),
         (cols.index("ss_sales_price_cents"), "mean")])
    return sort_table(out, [0])


def q19(tables: dict[str, Table], year: int = 1999, moy: int = 11,
        manager_lo: int = 1, manager_hi: int = 50) -> Table:
    """Brand revenue for a range of manager ids in one month (Q19's
    shape)."""
    ss, item, dd = tables["store_sales"], tables["item"], tables["date_dim"]
    item_f = apply_boolean_mask(
        item, _range_mask(item[_col(ITEM_COLS, "i_manager_id")],
                          manager_lo, manager_hi))
    dd_mask = (_eq_scalar_mask(dd[_col(DATE_COLS, "d_moy")], moy)
               & _eq_scalar_mask(dd[_col(DATE_COLS, "d_year")], year))
    dd_f = apply_boolean_mask(dd, dd_mask)
    j1 = inner_join(ss, item_f, _col(SS_COLS, "ss_item_sk"),
                    _col(ITEM_COLS, "i_item_sk"))
    return _join_group_sum(j1, dd_f, _col(SS_COLS, "ss_sold_date_sk"),
                           _col(DATE_COLS, "d_date_sk"),
                           SS_COLS + ITEM_COLS + DATE_COLS,
                           ["i_brand_id", "i_brand", "i_manufact_id"],
                           "ss_ext_sales_price")


def q62(tables: dict[str, Table], year: int = 2000, qty_lo: int = 10,
        qty_hi: int = 60) -> Table:
    """Sales counts per month for a band of quantities (Q62's count
    shape)."""
    ss, dd = tables["store_sales"], tables["date_dim"]
    ss_f = apply_boolean_mask(
        ss, _range_mask(ss[_col(SS_COLS, "ss_quantity")], qty_lo, qty_hi))
    dd_f = apply_boolean_mask(
        dd, _eq_scalar_mask(dd[_col(DATE_COLS, "d_year")], year))
    cols = SS_COLS + DATE_COLS
    out = join_aggregate(ss_f, dd_f, _col(SS_COLS, "ss_sold_date_sk"),
                         _col(DATE_COLS, "d_date_sk"), [cols.index("d_moy")],
                         [(cols.index("ss_quantity"), "count")])
    return sort_table(out, [0])


def q52_topn(tables: dict[str, Table], moy: int = 12, year: int = 2001,
             n: int = 10) -> Table:
    """Q52 with ORDER BY sum DESC, brand id ASC LIMIT n."""
    out = q52(tables, moy=moy, year=year)
    ranked = sort_table(out, [3, 1], ascending=[False, True])
    return slice_table(ranked, 0, n)


def q78_outer(tables: dict[str, Table]) -> Table:
    """Per-item store revenue beside web revenue, FULL OUTER (Q78's
    shape): items that sold in either channel, a missing side's revenue
    0."""
    ss, ws = tables["store_sales"], tables["web_sales"]
    s_rev = groupby_aggregate(ss, [_col(SS_COLS, "ss_item_sk")],
                              [(_col(SS_COLS, "ss_ext_sales_price"), "sum")])
    w_rev = groupby_aggregate(ws, [_col(WS_COLS, "ws_item_sk")],
                              [(_col(WS_COLS, "ws_ext_sales_price"), "sum")])
    j = full_outer_join(s_rev, w_rev, 0, 0)
    # [s_item, s_sum, w_item, w_sum]: coalesce(s_item, w_item), read
    # before any fill
    left_valid = j[0].validity_or_true()
    key = Column(j[0].dtype, torch.where(left_valid, j[0].data, j[2].data))
    out = Table([key, fill_null(j[1], 0.0), fill_null(j[3], 0.0)])
    return sort_table(out, [0])


def q25_two_fact(tables: dict[str, Table], year: int = 2000) -> Table:
    """Items sold in both channels in one year, with each channel's
    revenue (Q25's two-fact inner join)."""
    ss, ws, dd = (tables["store_sales"], tables["web_sales"],
                  tables["date_dim"])
    dd_f = apply_boolean_mask(
        dd, _eq_scalar_mask(dd[_col(DATE_COLS, "d_year")], year))
    js = inner_join(ss, dd_f, _col(SS_COLS, "ss_sold_date_sk"),
                    _col(DATE_COLS, "d_date_sk"))
    jw = inner_join(ws, dd_f, _col(WS_COLS, "ws_sold_date_sk"),
                    _col(DATE_COLS, "d_date_sk"))
    s_rev = groupby_aggregate(
        js, [_col(SS_COLS, "ss_item_sk")],
        [(SS_COLS.index("ss_ext_sales_price"), "sum")])
    w_rev = groupby_aggregate(
        jw, [_col(WS_COLS, "ws_item_sk")],
        [(WS_COLS.index("ws_ext_sales_price"), "sum")])
    j = inner_join(s_rev, w_rev, 0, 0)
    return sort_table(Table([j[0], j[1], j[3]]), [0])


def q_channel_day(tables: dict[str, Table]) -> Table:
    """Per-category store and web revenue over (item, day) tuples sold
    in both channels: each channel grouped on the tuple, the channels
    joined on the two-column key (the composite dense path), then a
    fused join and groupby against item."""
    ss, ws, item = (tables["store_sales"], tables["web_sales"],
                    tables["item"])
    s_rev = groupby_aggregate(
        ss, [_col(SS_COLS, "ss_item_sk"), _col(SS_COLS, "ss_sold_date_sk")],
        [(_col(SS_COLS, "ss_ext_sales_price"), "sum")])
    w_rev = groupby_aggregate(
        ws, [_col(WS_COLS, "ws_item_sk"), _col(WS_COLS, "ws_sold_date_sk")],
        [(_col(WS_COLS, "ws_ext_sales_price"), "sum")])
    j1 = inner_join(s_rev, w_rev, [0, 1], [0, 1])
    # [item, day, s_sum] ++ [item, day, w_sum]
    work = Table([j1[0], j1[2], j1[5]])
    cols = ["item_sk", "s_sum", "w_sum"] + ITEM_COLS
    out = join_aggregate(
        work, item, 0, _col(ITEM_COLS, "i_item_sk"),
        [cols.index("i_category")],
        [(cols.index("s_sum"), "sum"), (cols.index("w_sum"), "sum")])
    return sort_table(out, [0])


def q_web_also_qty(tables: dict[str, Table]) -> Table:
    """Store quantity per store over (item, day) tuples that also sold on
    the web: a two-column join whose fused groupby never builds the
    pairs."""
    ss, ws = tables["store_sales"], tables["web_sales"]
    pairs = distinct(Table([ws[_col(WS_COLS, "ws_item_sk")],
                            ws[_col(WS_COLS, "ws_sold_date_sk")]]))
    cols = SS_COLS + ["wi_item_sk", "wd_date_sk"]
    out = join_aggregate(
        ss, pairs,
        [_col(SS_COLS, "ss_item_sk"), _col(SS_COLS, "ss_sold_date_sk")],
        [0, 1],
        [cols.index("ss_store_sk")], [(cols.index("ss_quantity"), "sum")])
    return sort_table(out, [0])


def q_brand_rev_left(tables: dict[str, Table], manager_id: int = 28) -> Table:
    """Revenue per brand of one manager's items, every other sale kept
    as the null brand (LEFT OUTER → GROUP BY), fused with
    ``how="left"``."""
    ss, item = tables["store_sales"], tables["item"]
    item_f = apply_boolean_mask(
        item, _eq_scalar_mask(item[_col(ITEM_COLS, "i_manager_id")],
                              manager_id))
    cols = SS_COLS + ITEM_COLS
    out = join_aggregate(ss, item_f, _col(SS_COLS, "ss_item_sk"),
                         _col(ITEM_COLS, "i_item_sk"),
                         [cols.index("i_brand_id")],
                         [(cols.index("ss_ext_sales_price"), "sum"),
                          (cols.index("ss_item_sk"), "count")], how="left")
    return sort_table(out, [0])


def q23_semi(tables: dict[str, Table], min_sales: int = 30) -> Table:
    """Revenue of the sales of items with more than ``min_sales`` sales
    (Q23's semi join): one row, the revenue and the row count."""
    ss = tables["store_sales"]
    freq = groupby_aggregate(ss, [_col(SS_COLS, "ss_item_sk")],
                             [(_col(SS_COLS, "ss_item_sk"), "count")])
    freq_f = apply_boolean_mask(freq, freq[1].data > min_sales)
    hits = semi_join(ss, freq_f, _col(SS_COLS, "ss_item_sk"), 0)
    total = sum_(hits[_col(SS_COLS, "ss_ext_sales_price")])
    dev = total.device
    return Table([Column(T.float64, total.reshape(1)),
                  Column(T.int64, torch.tensor([hits.num_rows],
                                               dtype=torch.int64,
                                               device=dev))])


def q16_anti(tables: dict[str, Table]) -> Table:
    """Items with no store sale (Q16's anti join)."""
    ss, item = tables["store_sales"], tables["item"]
    unsold = anti_join(item, ss, _col(ITEM_COLS, "i_item_sk"),
                       _col(SS_COLS, "ss_item_sk"))
    return sort_table(
        Table([unsold[_col(ITEM_COLS, "i_item_sk")],
               unsold[_col(ITEM_COLS, "i_manufact_id")]]), [0])


QUERIES = {"q3": q3, "q42": q42, "q52": q52, "q55": q55,
           "q_state_rollup": q_state_rollup, "q7": q7, "q19": q19,
           "q62": q62, "q52_topn": q52_topn,
           "q_brand_rev_left": q_brand_rev_left, "q23_semi": q23_semi,
           "q16_anti": q16_anti, "q78_outer": q78_outer,
           "q25_two_fact": q25_two_fact, "q_channel_day": q_channel_day,
           "q_web_also_qty": q_web_also_qty}
