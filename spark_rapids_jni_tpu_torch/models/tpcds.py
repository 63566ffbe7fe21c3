"""TPC-DS queries (BASELINE config #3's subset) on the port's ops.

The port's counterpart of the JAX package's ``models/tpcds.py``: its 50
queries, in its order, over the tables of ``benchmarks/tpcds_data.py``:
the ``store_sales`` and ``web_sales`` facts and the ``item``,
``date_dim`` and ``store`` dimensions.  Each is a scan, filters,
equi-joins (dense and sorted engines, composite two-column keys, fused
join→groupby, left, semi, anti and full outer joins), sorted groupbys
with their grouping sets, windows (``ops.window``), LIKE
(``ops.strings``) and reductions, with the JAX package's plans and output
order.  Device scalars stay on the device where the JAX query keeps them,
and no query copies from the host, so that each can be captured as one
CUDA graph (``models/compiled.py``).

``load_tables`` scans the Parquet files onto the GPU unless ``device``
says otherwise; every query runs where its tables are.
"""

from __future__ import annotations

import torch

from .. import types as T
from ..column import Column, Table
from ..ops import (anti_join, apply_boolean_mask, concat_tables, distinct,
                   fill_null, full_outer_join, groupby_aggregate,
                   groupby_cube, groupby_grouping_sets, groupby_nunique,
                   groupby_rollup, inner_join, isin, join_aggregate, mean,
                   semi_join, slice_table, sort_table, sum_)
from ..ops import strings as S
from ..ops import window as W

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
                  Column(T.int64, torch.full((1,), hits.num_rows,
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




def _count_of(mask: torch.Tensor) -> torch.Tensor:
    """[1] int64: the True rows of ``mask``, on its device."""
    return mask.sum(dtype=torch.int64).reshape(1)


# -- aggregate-then-compare, unions, CASE WHEN, IN ----------------------------

def q65(tables: dict[str, Table], frac: float = 0.9) -> Table:
    """Brands whose revenue is below ``frac`` × the mean brand revenue
    (Q65's shape: each group against an aggregate of the aggregates)."""
    ss, item = tables["store_sales"], tables["item"]
    cols = SS_COLS + ITEM_COLS
    rev = join_aggregate(ss, item, _col(SS_COLS, "ss_item_sk"),
                         _col(ITEM_COLS, "i_item_sk"),
                         [cols.index("i_brand_id")],
                         [(cols.index("ss_ext_sales_price"), "sum")])
    # a device scalar: the comparison broadcasts it, with no host read
    threshold = mean(rev[1]) * frac
    return sort_table(
        apply_boolean_mask(rev, _range_mask(rev[1], hi=threshold,
                                            hi_strict=True)), [0])


def q_store_counts(tables: dict[str, Table]) -> Table:
    """Sales per store, stores with none included (LEFT OUTER → COUNT of
    a nullable column), fused with ``how="left"``."""
    ss, store = tables["store_sales"], tables["store"]
    cols = STORE_COLS + SS_COLS
    out = join_aggregate(
        store, ss, _col(STORE_COLS, "s_store_sk"),
        _col(SS_COLS, "ss_store_sk"),
        [cols.index("s_store_sk"), cols.index("s_state")],
        [(cols.index("ss_item_sk"), "count")], how="left")
    return sort_table(out, [0])


def q67_rank(tables: dict[str, Table], top_n: int = 3) -> Table:
    """The top ``top_n`` brands of each category by revenue: RANK() OVER
    (PARTITION BY category ORDER BY sum DESC) <= N (Q67's window)."""
    ss, item = tables["store_sales"], tables["item"]
    j = inner_join(ss, item, _col(SS_COLS, "ss_item_sk"),
                   _col(ITEM_COLS, "i_item_sk"))
    cols = SS_COLS + ITEM_COLS
    rev = groupby_aggregate(
        j, [cols.index("i_category"), cols.index("i_brand_id")],
        [(cols.index("ss_ext_sales_price"), "sum")])
    # rev: [i_category, i_brand_id, sum]
    spec = W.WindowSpec(rev, partition_by=[0], order_by_keys=[2, 1],
                        ascending=[False, True])
    rk = W.rank(spec, [2, 1])
    out = apply_boolean_mask(Table(list(rev.columns) + [rk]),
                             rk.data <= top_n)
    return sort_table(out, [0, 3, 1])


def q_like_brands(tables: dict[str, Table], pat: str = "#1",
                  cat_prefix: str = "S") -> Table:
    """Revenue by category of the items whose brand contains ``pat`` and
    whose category starts with ``cat_prefix`` (LIKE predicates)."""
    ss, item = tables["store_sales"], tables["item"]
    brand_has = S.contains(item[_col(ITEM_COLS, "i_brand")], pat)
    cat_ok = S.starts_with(item[_col(ITEM_COLS, "i_category")], cat_prefix)
    m = brand_has.data.to(torch.bool) & cat_ok.data.to(torch.bool)
    item_f = apply_boolean_mask(item, m)
    return _join_group_sum(ss, item_f, _col(SS_COLS, "ss_item_sk"),
                           _col(ITEM_COLS, "i_item_sk"),
                           SS_COLS + ITEM_COLS, ["i_category"],
                           "ss_ext_sales_price")


def q_union_channels(tables: dict[str, Table]) -> Table:
    """Store and web revenue per category: both facts as (item_sk,
    price), UNION ALL, then joined and grouped (Q71/Q76's shape)."""
    ss, ws, item = (tables["store_sales"], tables["web_sales"],
                    tables["item"])
    common = ["item_sk", "price"]
    part_s = Table([ss[_col(SS_COLS, "ss_item_sk")],
                    ss[_col(SS_COLS, "ss_ext_sales_price")]])
    part_w = Table([ws[_col(WS_COLS, "ws_item_sk")],
                    ws[_col(WS_COLS, "ws_ext_sales_price")]])
    both = concat_tables([part_s, part_w])
    return _join_group_sum(both, item, 0, _col(ITEM_COLS, "i_item_sk"),
                           common + ITEM_COLS, ["i_category"], "price")


def q_lag_growth(tables: dict[str, Table]) -> Table:
    """Month-over-month revenue change per store: the sum per (store,
    year, month) less LAG(sum) over the store ordered by (year, month)."""
    ss, dd = tables["store_sales"], tables["date_dim"]
    j = inner_join(ss, dd, _col(SS_COLS, "ss_sold_date_sk"),
                   _col(DATE_COLS, "d_date_sk"))
    cols = SS_COLS + DATE_COLS
    rev = groupby_aggregate(
        j, [cols.index("ss_store_sk"), cols.index("d_year"),
            cols.index("d_moy")],
        [(cols.index("ss_ext_sales_price"), "sum")])
    # rev: [store, year, moy, sum]
    spec = W.WindowSpec(rev, partition_by=[0], order_by_keys=[1, 2])
    prev = W.lag(spec, 3, 1)
    pv = torch.where(prev.validity_or_true(), prev.data, 0.0)
    delta = Column(T.float64, rev[3].data - pv, validity=prev.validity)
    return sort_table(Table(list(rev.columns) + [delta]), [0, 1, 2])


def q_running_share(tables: dict[str, Table], year: int = 2000) -> Table:
    """Cumulative revenue per store across the months of one year (a
    window running sum, Q47's spirit)."""
    ss, dd = tables["store_sales"], tables["date_dim"]
    dd_f = apply_boolean_mask(
        dd, _eq_scalar_mask(dd[_col(DATE_COLS, "d_year")], year))
    j = inner_join(ss, dd_f, _col(SS_COLS, "ss_sold_date_sk"),
                   _col(DATE_COLS, "d_date_sk"))
    cols = SS_COLS + DATE_COLS
    rev = groupby_aggregate(
        j, [cols.index("ss_store_sk"), cols.index("d_moy")],
        [(cols.index("ss_ext_sales_price"), "sum")])
    spec = W.WindowSpec(rev, partition_by=[0], order_by_keys=[1])
    cum = W.running_sum(spec, 2)
    return sort_table(Table(list(rev.columns) + [cum]), [0, 1])


def q_nunique_items(tables: dict[str, Table]) -> Table:
    """COUNT(DISTINCT item) per store (Q14's distinct count)."""
    ss = tables["store_sales"]
    out = groupby_nunique(ss, [_col(SS_COLS, "ss_store_sk")],
                          _col(SS_COLS, "ss_item_sk"))
    return sort_table(out, [0])


def q_having(tables: dict[str, Table], min_total: float = 1000.0) -> Table:
    """GROUP BY brand HAVING SUM(price) > ``min_total`` (Q23's HAVING),
    fused: the pairs of the join are never built."""
    ss, item = tables["store_sales"], tables["item"]
    cols = SS_COLS + ITEM_COLS
    rev = join_aggregate(ss, item, _col(SS_COLS, "ss_item_sk"),
                         _col(ITEM_COLS, "i_item_sk"),
                         [cols.index("i_brand_id")],
                         [(cols.index("ss_ext_sales_price"), "sum")])
    return sort_table(apply_boolean_mask(rev, rev[1].data > min_total), [0])


def q_case_when(tables: dict[str, Table], qty_cut: int = 50) -> Table:
    """Per category, the revenue of bulk rows (quantity > ``qty_cut``)
    and of the rest, in one pass over two masked value columns (CASE
    WHEN).  A NULL quantity takes the ELSE branch; a NULL price adds 0."""
    ss, item = tables["store_sales"], tables["item"]
    j = inner_join(ss, item, _col(SS_COLS, "ss_item_sk"),
                   _col(ITEM_COLS, "i_item_sk"))
    cols = SS_COLS + ITEM_COLS
    qcol = j[cols.index("ss_quantity")]
    pcol = j[cols.index("ss_ext_sales_price")]
    price = torch.where(pcol.validity_or_true(), pcol.data, 0.0)
    bulk = qcol.validity_or_true() & (qcol.data > qty_cut)
    cb = Column(T.float64, torch.where(bulk, price, 0.0))
    cr = Column(T.float64, torch.where(bulk, 0.0, price))
    work = Table(list(j.columns) + [cb, cr])
    out = groupby_aggregate(
        work, [cols.index("i_category")],
        [(len(cols), "sum"), (len(cols) + 1, "sum")])
    return sort_table(out, [0])


def q_distinct_pairs(tables: dict[str, Table]) -> Table:
    """DISTINCT (brand_id, category_id) pairs (dropDuplicates)."""
    item = tables["item"]
    pairs = Table([item[_col(ITEM_COLS, "i_brand_id")],
                   item[_col(ITEM_COLS, "i_category_id")]])
    return sort_table(distinct(pairs), [0, 1])


def q_isin_states(tables: dict[str, Table],
                  states: tuple = ("TN", "CA")) -> Table:
    """Revenue of the stores in an IN-list of states."""
    ss, store = tables["store_sales"], tables["store"]
    m = isin(store[_col(STORE_COLS, "s_state")], list(states))
    store_f = apply_boolean_mask(store, m)
    return _join_group_sum(ss, store_f, _col(SS_COLS, "ss_store_sk"),
                           _col(STORE_COLS, "s_store_sk"),
                           SS_COLS + STORE_COLS, ["s_state"],
                           "ss_ext_sales_price")


# -- rollup, cube, grouping sets, bands, selection aggregates ----------------

def q36_rollup(tables: dict[str, Table]) -> Table:
    """ROLLUP(i_category, i_brand) revenue (Q36): the detail rows, the
    category subtotals and the grand total, ``grouping_id`` last."""
    ss, item = tables["store_sales"], tables["item"]
    j = inner_join(ss, item, _col(SS_COLS, "ss_item_sk"),
                   _col(ITEM_COLS, "i_item_sk"))
    cols = SS_COLS + ITEM_COLS
    out = groupby_rollup(
        j, [cols.index("i_category"), cols.index("i_brand")],
        [(cols.index("ss_ext_sales_price"), "sum")])
    # [i_category, i_brand, sum, grouping_id]: by level, then the keys
    return sort_table(out, [3, 0, 1])


def q86_rollup(tables: dict[str, Table]) -> Table:
    """ROLLUP(d_year, d_moy) revenue (Q86's time hierarchy)."""
    ss, dd = tables["store_sales"], tables["date_dim"]
    j = inner_join(ss, dd, _col(SS_COLS, "ss_sold_date_sk"),
                   _col(DATE_COLS, "d_date_sk"))
    cols = SS_COLS + DATE_COLS
    out = groupby_rollup(
        j, [cols.index("d_year"), cols.index("d_moy")],
        [(cols.index("ss_ext_sales_price"), "sum")])
    return sort_table(out, [3, 0, 1])


def q27_cube(tables: dict[str, Table]) -> Table:
    """CUBE(i_category, s_state): the mean quantity and the revenue (Q27's
    item × store geography)."""
    ss, item, store = (tables["store_sales"], tables["item"],
                       tables["store"])
    j1 = inner_join(ss, item, _col(SS_COLS, "ss_item_sk"),
                    _col(ITEM_COLS, "i_item_sk"))
    cols1 = SS_COLS + ITEM_COLS
    j2 = inner_join(j1, store, cols1.index("ss_store_sk"),
                    _col(STORE_COLS, "s_store_sk"))
    cols = cols1 + STORE_COLS
    out = groupby_cube(
        j2, [cols.index("i_category"), cols.index("s_state")],
        [(cols.index("ss_quantity"), "mean"),
         (cols.index("ss_ext_sales_price"), "sum")])
    return sort_table(out, [4, 0, 1])


def q5_grouping_sets(tables: dict[str, Table]) -> Table:
    """Store and web revenue with a channel tag, GROUPING SETS ((channel,
    category), (channel), ()) (Q5's report)."""
    ss, ws, item = (tables["store_sales"], tables["web_sales"],
                    tables["item"])
    part_s = Table([ss[_col(SS_COLS, "ss_item_sk")],
                    ss[_col(SS_COLS, "ss_ext_sales_price")],
                    Column(T.int32, torch.zeros(ss.num_rows,
                                                dtype=torch.int32,
                                                device=ss.device))])
    part_w = Table([ws[_col(WS_COLS, "ws_item_sk")],
                    ws[_col(WS_COLS, "ws_ext_sales_price")],
                    Column(T.int32, torch.ones(ws.num_rows,
                                               dtype=torch.int32,
                                               device=ws.device))])
    both = concat_tables([part_s, part_w])
    j = inner_join(both, item, 0, _col(ITEM_COLS, "i_item_sk"))
    cols = ["item_sk", "price", "channel"] + ITEM_COLS
    out = groupby_grouping_sets(
        j, [cols.index("channel"), cols.index("i_category")],
        [[0, 1], [0], []], [(cols.index("price"), "sum")])
    return sort_table(out, [3, 0, 1])


def q88_counts(tables: dict[str, Table]) -> Table:
    """One row of sale counts in four quantity bands (Q88)."""
    q = tables["store_sales"][_col(SS_COLS, "ss_quantity")]
    qv, val = q.data, q.validity_or_true()
    return Table([Column(T.int64, _count_of(val & (qv >= lo) & (qv <= hi)))
                  for lo, hi in [(1, 25), (26, 50), (51, 75), (76, 100)]])


def q90_ratio(tables: dict[str, Table]) -> Table:
    """Sales in the first and the second half of the year and their
    ratio, one row (Q90)."""
    ss, dd = tables["store_sales"], tables["date_dim"]
    j = inner_join(ss, dd, _col(SS_COLS, "ss_sold_date_sk"),
                   _col(DATE_COLS, "d_date_sk"))
    cols = SS_COLS + DATE_COLS
    moy = j[cols.index("d_moy")]
    mv, val = moy.data, moy.validity_or_true()
    am = _count_of(val & (mv <= 6))
    pm = _count_of(val & (mv > 6))
    ratio = am.to(torch.float64) / pm.clamp(min=1).to(torch.float64)
    return Table([Column(T.int64, am), Column(T.int64, pm),
                  Column(T.float64, ratio)])


def q29_minmax(tables: dict[str, Table]) -> Table:
    """Min, max and mean quantity per brand (Q29's selection
    aggregates)."""
    ss, item = tables["store_sales"], tables["item"]
    cols = SS_COLS + ITEM_COLS
    qi = cols.index("ss_quantity")
    out = join_aggregate(ss, item, _col(SS_COLS, "ss_item_sk"),
                         _col(ITEM_COLS, "i_item_sk"),
                         [cols.index("i_brand_id")],
                         [(qi, "min"), (qi, "max"), (qi, "mean")])
    return sort_table(out, [0])


def q48_bands(tables: dict[str, Table]) -> Table:
    """Total quantity per state of the sales in (qty in [1, 20] and price
    < $50) or (qty in [41, 60] and price > $150) (Q48's disjunction)."""
    ss, store = tables["store_sales"], tables["store"]
    q = ss[_col(SS_COLS, "ss_quantity")]
    p = ss[_col(SS_COLS, "ss_sales_price_cents")]
    qv, pv = q.data, p.data
    val = q.validity_or_true() & p.validity_or_true()
    m = val & (((qv >= 1) & (qv <= 20) & (pv < 50_00))
               | ((qv >= 41) & (qv <= 60) & (pv > 150_00)))
    ss_f = apply_boolean_mask(ss, m)
    j = inner_join(ss_f, store, _col(SS_COLS, "ss_store_sk"),
                   _col(STORE_COLS, "s_store_sk"))
    cols = SS_COLS + STORE_COLS
    out = groupby_aggregate(j, [cols.index("s_state")],
                            [(cols.index("ss_quantity"), "sum")])
    return sort_table(out, [0])


def q13_avg_bands(tables: dict[str, Table]) -> Table:
    """The mean sales price in three quantity bands, one row (Q13)."""
    ss = tables["store_sales"]
    q = ss[_col(SS_COLS, "ss_quantity")]
    p = ss[_col(SS_COLS, "ss_sales_price_cents")]
    qv = q.data
    val = q.validity_or_true() & p.validity_or_true()
    pc = p.data.to(torch.float64)
    cols = []
    for lo, hi in [(1, 33), (34, 66), (67, 100)]:
        m = val & (qv >= lo) & (qv <= hi)
        cnt = _count_of(m).clamp(min=1)
        avg = torch.where(m, pc, 0.0).sum() / cnt.to(torch.float64)
        cols.append(Column(T.float64, avg / 100.0))
    return Table(cols)


def q96_count(tables: dict[str, Table], year: int = 2000,
              qty_min: int = 80) -> Table:
    """The count and total quantity of the high-quantity sales of one
    year (Q96)."""
    ss, dd = tables["store_sales"], tables["date_dim"]
    ss_f = apply_boolean_mask(
        ss, _range_mask(ss[_col(SS_COLS, "ss_quantity")], qty_min))
    dd_f = apply_boolean_mask(
        dd, _eq_scalar_mask(dd[_col(DATE_COLS, "d_year")], year))
    j = inner_join(ss_f, dd_f, _col(SS_COLS, "ss_sold_date_sk"),
                   _col(DATE_COLS, "d_date_sk"))
    cols = SS_COLS + DATE_COLS
    qsum = sum_(j[cols.index("ss_quantity")])
    return Table([Column(T.int64, torch.full((1,), j.num_rows,
                                             dtype=torch.int64,
                                             device=ss.device)),
                  Column(T.int64, qsum.reshape(1).to(torch.int64))])


def q_minmax_price(tables: dict[str, Table]) -> Table:
    """Min and max ``i_current_price`` (decimal32) per category."""
    item = tables["item"]
    pi = _col(ITEM_COLS, "i_current_price")
    out = groupby_aggregate(item, [_col(ITEM_COLS, "i_category")],
                            [(pi, "min"), (pi, "max")])
    return sort_table(out, [0])


def q_multi_measure(tables: dict[str, Table]) -> Table:
    """Per store: the quantity sum, the decimal64(-2) sum of the sales
    prices and the mean list price, three measure types in one groupby."""
    ss = tables["store_sales"]
    price_i = _col(SS_COLS, "ss_sales_price_cents")
    work = list(ss.columns)
    work[price_i] = Column(T.decimal64(-2), ss[price_i].data,
                           validity=ss[price_i].validity)
    out = groupby_aggregate(
        Table(work), [_col(SS_COLS, "ss_store_sk")],
        [(_col(SS_COLS, "ss_quantity"), "sum"), (price_i, "sum"),
         (_col(SS_COLS, "ss_list_price_cents"), "mean")])
    return sort_table(out, [0])


def q_rollup3(tables: dict[str, Table]) -> Table:
    """ROLLUP(d_year, d_moy, s_state) revenue, three levels deep."""
    ss, dd, store = (tables["store_sales"], tables["date_dim"],
                     tables["store"])
    j1 = inner_join(ss, dd, _col(SS_COLS, "ss_sold_date_sk"),
                    _col(DATE_COLS, "d_date_sk"))
    cols1 = SS_COLS + DATE_COLS
    j2 = inner_join(j1, store, cols1.index("ss_store_sk"),
                    _col(STORE_COLS, "s_store_sk"))
    cols = cols1 + STORE_COLS
    out = groupby_rollup(
        j2, [cols.index("d_year"), cols.index("d_moy"),
             cols.index("s_state")],
        [(cols.index("ss_ext_sales_price"), "sum")])
    return sort_table(out, [4, 0, 1, 2])


def q_first_last(tables: dict[str, Table]) -> Table:
    """Each item's first and last sales price in date order (FIRST and
    LAST, Q64's family)."""
    ss = tables["store_sales"]
    srt = sort_table(ss, [_col(SS_COLS, "ss_sold_date_sk")])
    pi = _col(SS_COLS, "ss_sales_price_cents")
    out = groupby_aggregate(srt, [_col(SS_COLS, "ss_item_sk")],
                            [(pi, "first"), (pi, "last")])
    return sort_table(out, [0])


def q_rownum_dedup(tables: dict[str, Table], keep: int = 2) -> Table:
    """Each store's ``keep`` highest-revenue months (ROW_NUMBER dedup)."""
    ss, dd = tables["store_sales"], tables["date_dim"]
    j = inner_join(ss, dd, _col(SS_COLS, "ss_sold_date_sk"),
                   _col(DATE_COLS, "d_date_sk"))
    cols = SS_COLS + DATE_COLS
    rev = groupby_aggregate(
        j, [cols.index("ss_store_sk"), cols.index("d_moy")],
        [(cols.index("ss_ext_sales_price"), "sum")])
    spec = W.WindowSpec(rev, partition_by=[0], order_by_keys=[2, 1],
                        ascending=[False, True])
    rn = W.row_number(spec)
    out = apply_boolean_mask(Table(list(rev.columns) + [rn]),
                             rn.data <= keep)
    return sort_table(out, [0, 3])


def q_cross_ratio(tables: dict[str, Table]) -> Table:
    """Web over store revenue per category where both channels sold (an
    aggregate, a join of the aggregates, a ratio)."""
    ss, ws, item = (tables["store_sales"], tables["web_sales"],
                    tables["item"])
    js = inner_join(ss, item, _col(SS_COLS, "ss_item_sk"),
                    _col(ITEM_COLS, "i_item_sk"))
    jw = inner_join(ws, item, _col(WS_COLS, "ws_item_sk"),
                    _col(ITEM_COLS, "i_item_sk"))
    cs = SS_COLS + ITEM_COLS
    cw = WS_COLS + ITEM_COLS
    s_rev = groupby_aggregate(js, [cs.index("i_category")],
                              [(cs.index("ss_ext_sales_price"), "sum")])
    w_rev = groupby_aggregate(jw, [cw.index("i_category")],
                              [(cw.index("ws_ext_sales_price"), "sum")])
    j = inner_join(s_rev, w_rev, 0, 0)
    ratio = Column(T.float64, j[3].data / j[1].data)
    return sort_table(Table([j[0], j[1], j[3], ratio]), [0])


def q_null_share(tables: dict[str, Table]) -> Table:
    """Per category, the web sales' row count beside the count and sum of
    their non-null prices (COUNT(*) against COUNT(col))."""
    ws, item = tables["web_sales"], tables["item"]
    j = inner_join(ws, item, _col(WS_COLS, "ws_item_sk"),
                   _col(ITEM_COLS, "i_item_sk"))
    cols = WS_COLS + ITEM_COLS
    out = groupby_aggregate(
        j, [cols.index("i_category")],
        [(cols.index("ws_item_sk"), "count"),
         (cols.index("ws_ext_sales_price"), "count"),
         (cols.index("ws_ext_sales_price"), "sum")])
    return sort_table(out, [0])


# -- deviations, INTERSECT and EXCEPT, dense_rank, two-level groupby ---------

def q17_stats(tables: dict[str, Table]) -> Table:
    """The mean, deviation and count of the quantity per state (Q17)."""
    ss, store = tables["store_sales"], tables["store"]
    j = inner_join(ss, store, _col(SS_COLS, "ss_store_sk"),
                   _col(STORE_COLS, "s_store_sk"))
    cols = SS_COLS + STORE_COLS
    qi = cols.index("ss_quantity")
    out = groupby_aggregate(j, [cols.index("s_state")],
                            [(qi, "mean"), (qi, "std"), (qi, "count")])
    return sort_table(out, [0])


def _channel_distinct(tables: dict[str, Table], item_col: str):
    """The distinct ``item_col`` values of the store sales' items and of
    the web sales' items."""
    ss, ws, item = (tables["store_sales"], tables["web_sales"],
                    tables["item"])
    js = inner_join(ss, item, _col(SS_COLS, "ss_item_sk"),
                    _col(ITEM_COLS, "i_item_sk"))
    jw = inner_join(ws, item, _col(WS_COLS, "ws_item_sk"),
                    _col(ITEM_COLS, "i_item_sk"))
    cs = SS_COLS + ITEM_COLS
    cw = WS_COLS + ITEM_COLS
    return (distinct(Table([js[cs.index(item_col)]])),
            distinct(Table([jw[cw.index(item_col)]])))


def q8_intersect(tables: dict[str, Table]) -> Table:
    """The categories sold in both channels (INTERSECT, by a semi join;
    Q8/Q38's spirit)."""
    s_cat, w_cat = _channel_distinct(tables, "i_category_id")
    return sort_table(semi_join(s_cat, w_cat, 0, 0), [0])


def q87_except(tables: dict[str, Table]) -> Table:
    """The brands sold in store and never on the web (EXCEPT, by an anti
    join; Q87)."""
    s_b, w_b = _channel_distinct(tables, "i_brand_id")
    return sort_table(anti_join(s_b, w_b, 0, 0), [0])


def q_dense_rank_cat(tables: dict[str, Table], top_n: int = 2) -> Table:
    """The top ``top_n`` revenue months of each category, ties sharing a
    rank with no gaps (DENSE_RANK, Q70)."""
    ss, item, dd = tables["store_sales"], tables["item"], tables["date_dim"]
    j1 = inner_join(ss, item, _col(SS_COLS, "ss_item_sk"),
                    _col(ITEM_COLS, "i_item_sk"))
    cols1 = SS_COLS + ITEM_COLS
    j2 = inner_join(j1, dd, cols1.index("ss_sold_date_sk"),
                    _col(DATE_COLS, "d_date_sk"))
    cols = cols1 + DATE_COLS
    rev = groupby_aggregate(
        j2, [cols.index("i_category"), cols.index("d_moy")],
        [(cols.index("ss_ext_sales_price"), "sum")])
    spec = W.WindowSpec(rev, partition_by=[0], order_by_keys=[2, 1],
                        ascending=[False, True])
    dr = W.dense_rank(spec, [2])
    out = apply_boolean_mask(Table(list(rev.columns) + [dr]),
                             dr.data <= top_n)
    return sort_table(out, [0, 3, 1])


def q34_baskets(tables: dict[str, Table], qty_min: int = 60) -> Table:
    """Per store, how many items sold at least ``qty_min`` in all: a
    groupby over a groupby's output (Q34)."""
    ss = tables["store_sales"]
    per_item = groupby_aggregate(
        ss, [_col(SS_COLS, "ss_store_sk"), _col(SS_COLS, "ss_item_sk")],
        [(_col(SS_COLS, "ss_quantity"), "sum")])
    big = apply_boolean_mask(per_item, per_item[2].data >= qty_min)
    out = groupby_aggregate(big, [0], [(1, "count")])
    return sort_table(out, [0])


# the JAX package's QUERIES, in its order
QUERIES = {"q3": q3, "q42": q42, "q52": q52, "q55": q55,
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

# the queries that read the second fact table (skipped without it)
_NEEDS_WEB = {"q_union_channels", "q5_grouping_sets", "q78_outer",
              "q25_two_fact", "q_cross_ratio", "q_null_share",
              "q8_intersect", "q87_except", "q_channel_day",
              "q_web_also_qty"}


def run_all(files: dict, device=None) -> dict[str, Table]:
    """Every query on ``files`` with its default parameters; the
    ``web_sales`` queries only where that file is given."""
    tables = load_tables(files, device=device)
    return {name: fn(tables) for name, fn in QUERIES.items()
            if name not in _NEEDS_WEB or "web_sales" in tables}
