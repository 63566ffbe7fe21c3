"""TPC-DS queries as logical plan trees (the JAX package's
``models/tpcds_plans.py``, over the port's ``models/tpcds.py``).

Each builder returns the **unoptimized**, SQL-shaped tree: scans of full
tables, joins, one ``Filter`` with the whole WHERE clause sitting *above*
the joins, a plain ``Aggregate``, then ``Sort``.  No hand-placed
projections, no pre-filtered dimensions, no fused-aggregate calls — the
optimizer has to earn all of that:

* filter pushdown splits the WHERE conjuncts through the joins into the
  scans (where footer stats prune row groups before decode),
* projection pushdown narrows every scan to consumed columns,
* fuse_join_aggregate detects the ``Aggregate(Join(...))`` tail and emits
  the ``ops.join_aggregate`` fused path.

The optimized trees lower to the *exact* op sequence of the hand-fused
``tpcds.py`` queries (same join order, same mask order, same fused tail),
so results are bit-identical — ``tests/test_torch_plan.py`` asserts it.
"""

from __future__ import annotations

from ..plan import ir, lower, rules
from . import tpcds

#: base-table name → column names, as ``tpcds.load_tables`` decodes them
TABLE_SCHEMAS: dict[str, list[str]] = {
    name: list(cols) for name, cols in tpcds.TABLE_COLS.items()}

_SUM_EXT = ("ss_ext_sales_price", "sum", "sum_ss_ext_sales_price")


def _eq(col: str, value) -> ir.Cmp:
    return ir.Cmp("==", ir.Col(col), ir.Lit(value))


def q3_plan(manufact_id: int = 436, moy: int = 11) -> ir.Plan:
    j = ir.Join(ir.Join(ir.Scan("store_sales"), ir.Scan("item"),
                        ("ss_item_sk",), ("i_item_sk",)),
                ir.Scan("date_dim"),
                ("ss_sold_date_sk",), ("d_date_sk",))
    f = ir.Filter(j, ir.And((_eq("i_manufact_id", manufact_id),
                             _eq("d_moy", moy))))
    keys = ("d_year", "i_brand_id", "i_brand")
    return ir.Sort(ir.Aggregate(f, keys, (_SUM_EXT,)), keys)


def q42_plan(manager_id: int = 1, year: int = 2000,
             moy: int = 11) -> ir.Plan:
    j = ir.Join(ir.Join(ir.Scan("store_sales"), ir.Scan("item"),
                        ("ss_item_sk",), ("i_item_sk",)),
                ir.Scan("date_dim"),
                ("ss_sold_date_sk",), ("d_date_sk",))
    # conjunct order mirrors the hand query's mask order (moy, then year)
    f = ir.Filter(j, ir.And((_eq("i_manager_id", manager_id),
                             _eq("d_moy", moy), _eq("d_year", year))))
    keys = ("d_year", "i_category_id", "i_category")
    return ir.Sort(ir.Aggregate(f, keys, (_SUM_EXT,)), keys)


def q52_plan(moy: int = 12, year: int = 2001) -> ir.Plan:
    j = ir.Join(ir.Join(ir.Scan("store_sales"), ir.Scan("date_dim"),
                        ("ss_sold_date_sk",), ("d_date_sk",)),
                ir.Scan("item"), ("ss_item_sk",), ("i_item_sk",))
    f = ir.Filter(j, ir.And((_eq("d_moy", moy), _eq("d_year", year))))
    keys = ("d_year", "i_brand_id", "i_brand")
    return ir.Sort(ir.Aggregate(f, keys, (_SUM_EXT,)), keys)


def q55_plan(manager_id: int = 28) -> ir.Plan:
    j = ir.Join(ir.Scan("store_sales"), ir.Scan("item"),
                ("ss_item_sk",), ("i_item_sk",))
    f = ir.Filter(j, _eq("i_manager_id", manager_id))
    keys = ("i_brand_id", "i_brand")
    return ir.Sort(ir.Aggregate(f, keys, (_SUM_EXT,)), keys)


def q7_plan(year: int = 2000) -> ir.Plan:
    j = ir.Join(ir.Join(ir.Scan("store_sales"), ir.Scan("date_dim"),
                        ("ss_sold_date_sk",), ("d_date_sk",)),
                ir.Scan("item"), ("ss_item_sk",), ("i_item_sk",))
    f = ir.Filter(j, _eq("d_year", year))
    aggs = (("ss_quantity", "mean", "avg_quantity"),
            ("ss_list_price_cents", "mean", "avg_list_price"),
            ("ss_sales_price_cents", "mean", "avg_sales_price"))
    return ir.Sort(ir.Aggregate(f, ("i_item_id",), aggs), ("i_item_id",))


def q19_plan(year: int = 1999, moy: int = 11, manager_lo: int = 1,
             manager_hi: int = 50) -> ir.Plan:
    j = ir.Join(ir.Join(ir.Scan("store_sales"), ir.Scan("item"),
                        ("ss_item_sk",), ("i_item_sk",)),
                ir.Scan("date_dim"),
                ("ss_sold_date_sk",), ("d_date_sk",))
    f = ir.Filter(j, ir.And((
        ir.Between(ir.Col("i_manager_id"), manager_lo, manager_hi),
        _eq("d_moy", moy), _eq("d_year", year))))
    keys = ("i_brand_id", "i_brand", "i_manufact_id")
    return ir.Sort(ir.Aggregate(f, keys, (_SUM_EXT,)), keys)


def q65_plan(frac: float = 0.9) -> ir.Plan:
    j = ir.Join(ir.Scan("store_sales"), ir.Scan("item"),
                ("ss_item_sk",), ("i_item_sk",))
    agg = ir.Aggregate(j, ("i_brand_id",), (_SUM_EXT,))
    # HAVING against a global aggregate-of-the-aggregate: stays a device
    # scalar through lowering, exactly like the hand query's threshold
    having = ir.Cmp("<", ir.Col(_SUM_EXT[2]),
                    ir.Mul(ir.ScalarAgg("mean", ir.Col(_SUM_EXT[2])),
                           ir.Lit(frac)))
    return ir.Sort(ir.Filter(agg, having), ("i_brand_id",))


def q_having_plan(min_total: float = 1000.0) -> ir.Plan:
    j = ir.Join(ir.Scan("store_sales"), ir.Scan("item"),
                ("ss_item_sk",), ("i_item_sk",))
    agg = ir.Aggregate(j, ("i_brand_id",), (_SUM_EXT,))
    having = ir.Cmp(">", ir.Col(_SUM_EXT[2]), ir.Lit(min_total))
    return ir.Sort(ir.Filter(agg, having), ("i_brand_id",))


#: name → unoptimized-tree builder (same names/params as ``tpcds.QUERIES``)
PLANS = {
    "q3": q3_plan, "q7": q7_plan, "q19": q19_plan, "q42": q42_plan,
    "q52": q52_plan, "q55": q55_plan, "q65": q65_plan,
    "q_having": q_having_plan,
}


def optimized(name: str, stats=None, **params) -> rules.OptimizeResult:
    """Build + optimize one named query's plan tree."""
    return rules.optimize(PLANS[name](**params), TABLE_SCHEMAS,
                          stats=stats)


def plan_fn(name: str, stats=None, **params):
    """``(qfn, optimized_tree)`` for a named query: ``qfn(tables)`` is
    drop-in for the hand-fused ``tpcds.QUERIES[name]`` — same tables
    dict in, bit-identical Table out — and carries
    ``qfn.plan_fingerprint`` for the exec plan cache."""
    res = optimized(name, stats=stats, **params)
    return lower.compile_plan(res.tree, TABLE_SCHEMAS), res.tree
