"""TPC-DS queries as SQL text, paired with hand-built plan trees (the
JAX package's ``models/tpcds_sql.py``).

The SQL front-end's differential corpus: every entry carries (a) the
query as SQL text — the form a client would POST at the serving layer —
and (b) a hand-built **unoptimized** ``plan/ir.py`` tree shaped exactly
as the binder emits it.  ``tests/test_torch_sql.py`` asserts, per
query, that

* the SQL-born optimized tree and the hand-built optimized tree share
  one structural fingerprint, which is also the JAX package's, and
* executing both over the synthetic TPC-DS dataset produces
  bit-identical Tables.

Fingerprint equality is the strong claim: it means a SQL submission
dedupes against a pre-existing hand-built plan's cache entry.

The corpus intentionally sweeps the whole grammar: star joins,
BETWEEN/IN predicates, HAVING (literal and scalar-aggregate thresholds),
ROLLUP/CUBE/GROUPING SETS, COUNT(DISTINCT), MIN/MAX/FIRST/LAST/STDDEV,
window functions (rank over aggregates, row_number dedupe, running
sums), derived tables, LEFT SEMI/ANTI joins, UNION ALL, DISTINCT,
ORDER BY ... DESC, LIMIT, and ``:name`` parameters.
"""

from __future__ import annotations

from ..plan import ir
from . import tpcds_plans
from .tpcds_plans import TABLE_SCHEMAS  # noqa: F401  (re-export)

_SS_ITEM = ir.Join(ir.Scan("store_sales"), ir.Scan("item"),
                   ("ss_item_sk",), ("i_item_sk",))
_SS_DATE = ir.Join(ir.Scan("store_sales"), ir.Scan("date_dim"),
                   ("ss_sold_date_sk",), ("d_date_sk",))
_SUM_EXT = ("ss_ext_sales_price", "sum", "sum_ss_ext_sales_price")


def _eq(col: str, value) -> ir.Cmp:
    return ir.Cmp("==", ir.Col(col), ir.Lit(value))


# --- hand trees for the queries tpcds_plans does not already build ----------

def q62_range_plan(year: int = 2000, qty_lo: int = 10,
                   qty_hi: int = 80) -> ir.Plan:
    j = ir.Join(_SS_ITEM, ir.Scan("date_dim"),
                ("ss_sold_date_sk",), ("d_date_sk",))
    f = ir.Filter(j, ir.And((
        _eq("d_year", year),
        ir.Between(ir.Col("ss_quantity"), lo=qty_lo, hi=qty_hi))))
    return ir.Sort(ir.Aggregate(f, ("i_item_id",),
                                (("ss_ext_sales_price", "sum", "total"),)),
                   ("i_item_id",))


def q52_topn_plan(moy: int = 12, year: int = 2001, n: int = 10) -> ir.Plan:
    return ir.Limit(tpcds_plans.q52_plan(moy=moy, year=year), n)


def q_store_counts_plan() -> ir.Plan:
    j = ir.Join(ir.Scan("store_sales"), ir.Scan("store"),
                ("ss_store_sk",), ("s_store_sk",))
    return ir.Sort(ir.Aggregate(j, ("s_state",),
                                (("ss_item_sk", "count", "n_sales"),)),
                   ("s_state",))


def q_isin_states_plan(states=("TN", "GA", "SD")) -> ir.Plan:
    j = ir.Join(ir.Scan("store_sales"), ir.Scan("store"),
                ("ss_store_sk",), ("s_store_sk",))
    f = ir.Filter(j, ir.IsIn(ir.Col("s_state"), tuple(states)))
    return ir.Sort(ir.Aggregate(f, ("s_state",), (_SUM_EXT,)), ("s_state",))


def q36_rollup_plan() -> ir.Plan:
    return ir.Aggregate(_SS_ITEM, ("i_category_id", "i_brand_id"),
                        (("ss_ext_sales_price", "sum", "total"),),
                        grouping="rollup")


def q27_cube_plan() -> ir.Plan:
    j = ir.Join(_SS_DATE, ir.Scan("item"), ("ss_item_sk",), ("i_item_sk",))
    return ir.Aggregate(j, ("d_year", "i_manager_id"),
                        (("ss_ext_sales_price", "sum", "total"),),
                        grouping="cube")


def q5_grouping_sets_plan() -> ir.Plan:
    j = ir.Join(_SS_DATE, ir.Scan("item"), ("ss_item_sk",), ("i_item_sk",))
    return ir.Aggregate(j, ("d_year", "i_category_id"),
                        (("ss_ext_sales_price", "sum", "total"),),
                        grouping="sets",
                        grouping_sets=((0, 1), (0,), ()))


def q_minmax_price_plan() -> ir.Plan:
    agg = ir.Aggregate(ir.Scan("item"), ("i_category_id",),
                       (("i_current_price", "min", "min_price"),
                        ("i_current_price", "max", "max_price")))
    return ir.Sort(agg, ("i_category_id",))


def q_first_last_plan() -> ir.Plan:
    agg = ir.Aggregate(ir.Scan("item"), ("i_brand_id",),
                       (("i_item_sk", "first", "first_sk"),
                        ("i_item_sk", "last", "last_sk")))
    return ir.Sort(agg, ("i_brand_id",))


def q17_stats_plan() -> ir.Plan:
    agg = ir.Aggregate(_SS_ITEM, ("i_category_id",),
                       (("ss_quantity", "mean", "avg_qty"),
                        ("ss_quantity", "std", "std_qty")))
    return ir.Sort(agg, ("i_category_id",))


def q_nunique_items_plan() -> ir.Plan:
    agg = ir.Aggregate(_SS_DATE, ("d_year",),
                       (("ss_item_sk", "nunique", "n_items"),))
    return ir.Sort(agg, ("d_year",))


def q_distinct_pairs_plan() -> ir.Plan:
    return ir.Distinct(ir.Project(ir.Scan("store_sales"),
                                  ("ss_store_sk", "ss_item_sk")))


def q67_rank_plan(top_n: int = 3) -> ir.Plan:
    agg = ir.Aggregate(_SS_ITEM, ("i_category_id", "i_brand_id"),
                       (("ss_ext_sales_price", "sum", "total"),))
    w = ir.Window(agg, "rank", ("i_category_id",), ("total",), "rk",
                  ascending=(False,))
    return ir.Filter(w, ir.Cmp("<=", ir.Col("rk"), ir.Lit(top_n)))


def q_rownum_dedup_plan(keep: int = 2) -> ir.Plan:
    w = ir.Window(ir.Scan("store_sales"), "row_number",
                  ("ss_item_sk",), ("ss_store_sk",), "rn")
    p = ir.Project(w, ("ss_item_sk", "ss_store_sk", "rn"))
    return ir.Filter(p, ir.Cmp("<=", ir.Col("rn"), ir.Lit(keep)))


def q_running_share_plan() -> ir.Plan:
    agg = ir.Aggregate(_SS_DATE, ("d_year", "d_moy"),
                       (("ss_ext_sales_price", "sum", "m_total"),))
    return ir.Window(agg, "running_sum", ("d_year",), ("d_moy",),
                     "running", value="m_total")


def q_lag_growth_plan() -> ir.Plan:
    agg = ir.Aggregate(_SS_DATE, ("d_year", "d_moy"),
                       (("ss_ext_sales_price", "sum", "m_total"),))
    return ir.Window(agg, "lag", ("d_year",), ("d_moy",), "prev",
                     value="m_total")


def q_union_channels_plan() -> ir.Plan:
    store = ir.Aggregate(_SS_DATE, ("d_year",),
                         (("ss_ext_sales_price", "sum", "total"),))
    web = ir.Aggregate(
        ir.Join(ir.Scan("web_sales"), ir.Scan("date_dim"),
                ("ws_sold_date_sk",), ("d_date_sk",)),
        ("d_year",), (("ws_ext_sales_price", "sum", "total"),))
    return ir.Union((store, web), ("d_year", "total"))


def q16_anti_plan() -> ir.Plan:
    j = ir.Join(ir.Scan("store_sales"), ir.Scan("web_sales"),
                ("ss_item_sk",), ("ws_item_sk",), how="anti")
    return ir.Sort(ir.Aggregate(j, ("ss_store_sk",),
                                (("ss_ext_sales_price", "sum", "total"),)),
                   ("ss_store_sk",))


def q23_semi_plan() -> ir.Plan:
    j = ir.Join(ir.Scan("store_sales"), ir.Scan("web_sales"),
                ("ss_item_sk",), ("ws_item_sk",), how="semi")
    return ir.Sort(ir.Aggregate(j, ("ss_store_sk",),
                                (("ss_ext_sales_price", "sum", "total"),)),
                   ("ss_store_sk",))


def q34_baskets_plan(min_cnt: int = 100) -> ir.Plan:
    agg = ir.Aggregate(ir.Scan("store_sales"), ("ss_store_sk",),
                       (("ss_item_sk", "count", "cnt"),))
    f = ir.Filter(agg, ir.Cmp(">", ir.Col("cnt"), ir.Lit(min_cnt)))
    return ir.Sort(f, ("ss_store_sk",))


# --- the corpus: name → (sql, hand-tree builder, default params) ------------

SQL: dict[str, str] = {
    "q3": """
        SELECT d_year, i_brand_id, i_brand,
               SUM(ss_ext_sales_price) AS sum_ss_ext_sales_price
        FROM store_sales
        JOIN item ON ss_item_sk = i_item_sk
        JOIN date_dim ON ss_sold_date_sk = d_date_sk
        WHERE i_manufact_id = :manufact_id AND d_moy = :moy
        GROUP BY d_year, i_brand_id, i_brand
        ORDER BY d_year, i_brand_id, i_brand
    """,
    "q7": """
        SELECT i_item_id, AVG(ss_quantity) AS avg_quantity,
               AVG(ss_list_price_cents) AS avg_list_price,
               AVG(ss_sales_price_cents) AS avg_sales_price
        FROM store_sales
        JOIN date_dim ON ss_sold_date_sk = d_date_sk
        JOIN item ON ss_item_sk = i_item_sk
        WHERE d_year = :year
        GROUP BY i_item_id ORDER BY i_item_id
    """,
    "q19": """
        SELECT i_brand_id, i_brand, i_manufact_id,
               SUM(ss_ext_sales_price) AS sum_ss_ext_sales_price
        FROM store_sales
        JOIN item ON ss_item_sk = i_item_sk
        JOIN date_dim ON ss_sold_date_sk = d_date_sk
        WHERE i_manager_id BETWEEN :manager_lo AND :manager_hi
          AND d_moy = :moy AND d_year = :year
        GROUP BY i_brand_id, i_brand, i_manufact_id
        ORDER BY i_brand_id, i_brand, i_manufact_id
    """,
    "q42": """
        SELECT d_year, i_category_id, i_category,
               SUM(ss_ext_sales_price) AS sum_ss_ext_sales_price
        FROM store_sales
        JOIN item ON ss_item_sk = i_item_sk
        JOIN date_dim ON ss_sold_date_sk = d_date_sk
        WHERE i_manager_id = :manager_id AND d_moy = :moy
          AND d_year = :year
        GROUP BY d_year, i_category_id, i_category
        ORDER BY d_year, i_category_id, i_category
    """,
    "q52": """
        SELECT d_year, i_brand_id, i_brand,
               SUM(ss_ext_sales_price) AS sum_ss_ext_sales_price
        FROM store_sales
        JOIN date_dim ON ss_sold_date_sk = d_date_sk
        JOIN item ON ss_item_sk = i_item_sk
        WHERE d_moy = :moy AND d_year = :year
        GROUP BY d_year, i_brand_id, i_brand
        ORDER BY d_year, i_brand_id, i_brand
    """,
    "q55": """
        SELECT i_brand_id, i_brand,
               SUM(ss_ext_sales_price) AS sum_ss_ext_sales_price
        FROM store_sales
        JOIN item ON ss_item_sk = i_item_sk
        WHERE i_manager_id = :manager_id
        GROUP BY i_brand_id, i_brand ORDER BY i_brand_id, i_brand
    """,
    "q65": """
        SELECT i_brand_id,
               SUM(ss_ext_sales_price) AS sum_ss_ext_sales_price
        FROM store_sales
        JOIN item ON ss_item_sk = i_item_sk
        GROUP BY i_brand_id
        HAVING sum_ss_ext_sales_price
             < AVG(sum_ss_ext_sales_price) * :frac
        ORDER BY i_brand_id
    """,
    "q_having": """
        SELECT i_brand_id,
               SUM(ss_ext_sales_price) AS sum_ss_ext_sales_price
        FROM store_sales
        JOIN item ON ss_item_sk = i_item_sk
        GROUP BY i_brand_id
        HAVING sum_ss_ext_sales_price > :min_total
        ORDER BY i_brand_id
    """,
    "q62_range": """
        SELECT i_item_id, SUM(ss_ext_sales_price) AS total
        FROM store_sales
        JOIN item ON ss_item_sk = i_item_sk
        JOIN date_dim ON ss_sold_date_sk = d_date_sk
        WHERE d_year = :year AND ss_quantity BETWEEN :qty_lo AND :qty_hi
        GROUP BY i_item_id ORDER BY i_item_id
    """,
    "q52_topn": """
        SELECT d_year, i_brand_id, i_brand,
               SUM(ss_ext_sales_price) AS sum_ss_ext_sales_price
        FROM store_sales
        JOIN date_dim ON ss_sold_date_sk = d_date_sk
        JOIN item ON ss_item_sk = i_item_sk
        WHERE d_moy = :moy AND d_year = :year
        GROUP BY d_year, i_brand_id, i_brand
        ORDER BY d_year, i_brand_id, i_brand
        LIMIT 10
    """,
    "q_store_counts": """
        SELECT s_state, COUNT(ss_item_sk) AS n_sales
        FROM store_sales
        JOIN store ON ss_store_sk = s_store_sk
        GROUP BY s_state ORDER BY s_state
    """,
    "q_isin_states": """
        SELECT s_state, SUM(ss_ext_sales_price) AS sum_ss_ext_sales_price
        FROM store_sales
        JOIN store ON ss_store_sk = s_store_sk
        WHERE s_state IN ('TN', 'GA', 'SD')
        GROUP BY s_state ORDER BY s_state
    """,
    "q36_rollup": """
        SELECT i_category_id, i_brand_id,
               SUM(ss_ext_sales_price) AS total, grouping_id
        FROM store_sales
        JOIN item ON ss_item_sk = i_item_sk
        GROUP BY ROLLUP (i_category_id, i_brand_id)
    """,
    "q27_cube": """
        SELECT d_year, i_manager_id,
               SUM(ss_ext_sales_price) AS total, grouping_id
        FROM store_sales
        JOIN date_dim ON ss_sold_date_sk = d_date_sk
        JOIN item ON ss_item_sk = i_item_sk
        GROUP BY CUBE (d_year, i_manager_id)
    """,
    "q5_grouping_sets": """
        SELECT d_year, i_category_id,
               SUM(ss_ext_sales_price) AS total, grouping_id
        FROM store_sales
        JOIN date_dim ON ss_sold_date_sk = d_date_sk
        JOIN item ON ss_item_sk = i_item_sk
        GROUP BY GROUPING SETS ((d_year, i_category_id), (d_year), ())
    """,
    "q_minmax_price": """
        SELECT i_category_id, MIN(i_current_price) AS min_price,
               MAX(i_current_price) AS max_price
        FROM item GROUP BY i_category_id ORDER BY i_category_id
    """,
    "q_first_last": """
        SELECT i_brand_id, FIRST(i_item_sk) AS first_sk,
               LAST(i_item_sk) AS last_sk
        FROM item GROUP BY i_brand_id ORDER BY i_brand_id
    """,
    "q17_stats": """
        SELECT i_category_id, AVG(ss_quantity) AS avg_qty,
               STDDEV(ss_quantity) AS std_qty
        FROM store_sales
        JOIN item ON ss_item_sk = i_item_sk
        GROUP BY i_category_id ORDER BY i_category_id
    """,
    "q_nunique_items": """
        SELECT d_year, COUNT(DISTINCT ss_item_sk) AS n_items
        FROM store_sales
        JOIN date_dim ON ss_sold_date_sk = d_date_sk
        GROUP BY d_year ORDER BY d_year
    """,
    "q_distinct_pairs": """
        SELECT DISTINCT ss_store_sk, ss_item_sk FROM store_sales
    """,
    "q67_rank": """
        SELECT i_category_id, i_brand_id, total, rk
        FROM (SELECT i_category_id, i_brand_id,
                     SUM(ss_ext_sales_price) AS total,
                     RANK() OVER (PARTITION BY i_category_id
                                  ORDER BY total DESC) AS rk
              FROM store_sales
              JOIN item ON ss_item_sk = i_item_sk
              GROUP BY i_category_id, i_brand_id)
        WHERE rk <= :top_n
    """,
    "q_rownum_dedup": """
        SELECT ss_item_sk, ss_store_sk, rn
        FROM (SELECT ss_item_sk, ss_store_sk,
                     ROW_NUMBER() OVER (PARTITION BY ss_item_sk
                                        ORDER BY ss_store_sk) AS rn
              FROM store_sales)
        WHERE rn <= :keep
    """,
    "q_running_share": """
        SELECT d_year, d_moy, SUM(ss_ext_sales_price) AS m_total,
               SUM(m_total) OVER (PARTITION BY d_year
                                  ORDER BY d_moy) AS running
        FROM store_sales
        JOIN date_dim ON ss_sold_date_sk = d_date_sk
        GROUP BY d_year, d_moy
    """,
    "q_lag_growth": """
        SELECT d_year, d_moy, SUM(ss_ext_sales_price) AS m_total,
               LAG(m_total) OVER (PARTITION BY d_year
                                  ORDER BY d_moy) AS prev
        FROM store_sales
        JOIN date_dim ON ss_sold_date_sk = d_date_sk
        GROUP BY d_year, d_moy
    """,
    "q_union_channels": """
        SELECT d_year, SUM(ss_ext_sales_price) AS total
        FROM store_sales
        JOIN date_dim ON ss_sold_date_sk = d_date_sk
        GROUP BY d_year
        UNION ALL
        SELECT d_year, SUM(ws_ext_sales_price) AS total
        FROM web_sales
        JOIN date_dim ON ws_sold_date_sk = d_date_sk
        GROUP BY d_year
    """,
    "q16_anti": """
        SELECT ss_store_sk, SUM(ss_ext_sales_price) AS total
        FROM store_sales
        LEFT ANTI JOIN web_sales ON ss_item_sk = ws_item_sk
        GROUP BY ss_store_sk ORDER BY ss_store_sk
    """,
    "q23_semi": """
        SELECT ss_store_sk, SUM(ss_ext_sales_price) AS total
        FROM store_sales
        LEFT SEMI JOIN web_sales ON ss_item_sk = ws_item_sk
        GROUP BY ss_store_sk ORDER BY ss_store_sk
    """,
    "q34_baskets": """
        SELECT ss_store_sk, COUNT(ss_item_sk) AS cnt
        FROM store_sales
        GROUP BY ss_store_sk
        HAVING cnt > :min_cnt
        ORDER BY ss_store_sk
    """,
}

#: name → hand-built unoptimized tree builder (binder-shaped)
HAND = {
    "q3": tpcds_plans.q3_plan, "q7": tpcds_plans.q7_plan,
    "q19": tpcds_plans.q19_plan, "q42": tpcds_plans.q42_plan,
    "q52": tpcds_plans.q52_plan, "q55": tpcds_plans.q55_plan,
    "q65": tpcds_plans.q65_plan, "q_having": tpcds_plans.q_having_plan,
    "q62_range": q62_range_plan, "q52_topn": q52_topn_plan,
    "q_store_counts": q_store_counts_plan,
    "q_isin_states": q_isin_states_plan,
    "q36_rollup": q36_rollup_plan, "q27_cube": q27_cube_plan,
    "q5_grouping_sets": q5_grouping_sets_plan,
    "q_minmax_price": q_minmax_price_plan,
    "q_first_last": q_first_last_plan, "q17_stats": q17_stats_plan,
    "q_nunique_items": q_nunique_items_plan,
    "q_distinct_pairs": q_distinct_pairs_plan,
    "q67_rank": q67_rank_plan, "q_rownum_dedup": q_rownum_dedup_plan,
    "q_running_share": q_running_share_plan,
    "q_lag_growth": q_lag_growth_plan,
    "q_union_channels": q_union_channels_plan,
    "q16_anti": q16_anti_plan, "q23_semi": q23_semi_plan,
    "q34_baskets": q34_baskets_plan,
}

#: default ``:name`` bindings per query (empty dict = no parameters)
PARAMS: dict[str, dict] = {
    "q3": {"manufact_id": 436, "moy": 11},
    "q7": {"year": 2000},
    "q19": {"manager_lo": 1, "manager_hi": 50, "moy": 11, "year": 1999},
    "q42": {"manager_id": 1, "moy": 11, "year": 2000},
    "q52": {"moy": 12, "year": 2001},
    "q55": {"manager_id": 28},
    "q65": {"frac": 0.9},
    "q_having": {"min_total": 1000.0},
    "q62_range": {"year": 2000, "qty_lo": 10, "qty_hi": 80},
    "q52_topn": {"moy": 12, "year": 2001},
    "q67_rank": {"top_n": 3},
    "q_rownum_dedup": {"keep": 2},
    "q34_baskets": {"min_cnt": 100},
}

QUERY_NAMES = tuple(SQL)
assert set(SQL) == set(HAND)


def hand_tree(name: str) -> ir.Plan:
    """The hand-built unoptimized tree with the corpus-default params."""
    params = PARAMS.get(name, {})
    return HAND[name](**params)
