"""A TPC-DS star from a seed, written as Parquet and loaded onto the card.

The benchmark's copy of ``tools/torch_tpcds_parquet.py``'s generator
(itself the numpy twin of ``benchmarks/tpcds_data.generate``): the five
tables ``store_sales``, ``item``, ``date_dim``, ``store`` and
``web_sales``, the same Parquet types (INT32 keys and quantities, INT64
cents, DOUBLE prices, UTF8 strings, ``i_current_price`` a
FIXED_LEN_BYTE_ARRAY DECIMAL(7,2)), about 3% nulls in
``ws_ext_sales_price``, no dictionary, row groups of 1,048,576 rows.
Unlike the original, every table's row count comes from the config (a
published scale factor's), and ``date_dim`` is TPC-DS's calendar: one
row a day from 1900-01-02, with the year and month of that day, while
the sales fall on the days of the config's sales span.  Pages are
UNCOMPRESSED here (the scan runs only in set-up).

:func:`reference` makes the host arrays from the seed; :func:`prepare`
writes them and loads the files with the port's ``models.tpcds.
load_tables``; the tables stay on the card.
"""

from __future__ import annotations

import numpy as np

from . import parquet as W

CATEGORIES = ["Books", "Home", "Electronics", "Jewelry", "Music",
              "Shoes", "Sports", "Women", "Men", "Children"]
STATES = ["TN", "CA", "TX", "WA", "NY", "GA", "OH", "IL"]
PRICE_DECIMAL = (7, 2)
SCHEMA = {
    "store_sales": ["ss_sold_date_sk", "ss_item_sk", "ss_store_sk",
                    "ss_quantity", "ss_sales_price_cents",
                    "ss_list_price_cents", "ss_ext_sales_price"],
    "item": ["i_item_sk", "i_item_id", "i_current_price", "i_brand_id",
             "i_brand", "i_category_id", "i_category", "i_manufact_id",
             "i_manager_id"],
    "date_dim": ["d_date_sk", "d_year", "d_moy"],
    "store": ["s_store_sk", "s_state"],
    "web_sales": ["ws_sold_date_sk", "ws_item_sk", "ws_quantity",
                  "ws_ext_sales_price"],
}
KINDS = {np.dtype(np.int32): "int32", np.dtype(np.int64): "int64",
         np.dtype(np.float64): "float64"}
FIRST_DATE = np.datetime64("1900-01-02", "D")     # d_date_sk 1


def sales_span(config: dict) -> tuple:
    """The config's sales days as (first ``d_date_sk``, number of days)."""
    first = np.datetime64(config["sales_first_date"], "D")
    return int((first - FIRST_DATE).astype(int)) + 1, int(config["sales_days"])


def tpcds_arrays(n_sales: int, n_web: int, n_items: int, n_dates: int,
                 n_stores: int, sales: tuple, seed: int) -> dict:
    """The five tables as {table: {column: array}}; ``sales`` is the
    (first ``d_date_sk``, days) every sale falls in; ``i_current_price``
    is int64 cents; ``ws_ext_sales_price_valid`` is the validity of
    ``ws_ext_sales_price``; ``ss_ext_cents`` and ``ws_ext_cents`` hold
    the cents the prices are made of, for an exact oracle."""
    rng = np.random.default_rng(seed)
    first_sale, sale_days = sales
    if first_sale < 1 or first_sale + sale_days - 1 > n_dates:
        raise ValueError("the sales span lies outside date_dim")
    sk = np.arange(1, n_items + 1, dtype=np.int32)
    item = {
        "i_item_sk": sk,
        "i_item_id": np.array([f"AAAA{s:012d}" for s in range(1, n_items + 1)],
                              dtype=object),
        "i_current_price": rng.integers(50, 500_00, n_items).astype(np.int64),
        "i_brand_id": rng.integers(1000, 1100, n_items).astype(np.int32),
        "i_brand": np.array([f"brand#{b}" for b in
                             rng.integers(1, 60, n_items)], dtype=object),
        "i_category_id": rng.integers(
            1, len(CATEGORIES) + 1, n_items).astype(np.int32),
        "i_category": np.array(
            [CATEGORIES[c] for c in rng.integers(0, len(CATEGORIES),
                                                 n_items)], dtype=object),
        "i_manufact_id": rng.integers(1, 1000, n_items).astype(np.int32),
        "i_manager_id": rng.integers(1, 100, n_items).astype(np.int32),
    }
    days = FIRST_DATE + np.arange(n_dates)
    months = days.astype("datetime64[M]").astype(np.int64)
    date_dim = {
        "d_date_sk": np.arange(1, n_dates + 1, dtype=np.int32),
        "d_year": (1970 + months // 12).astype(np.int32),
        "d_moy": (1 + months % 12).astype(np.int32),
    }
    store = {
        "s_store_sk": np.arange(1, n_stores + 1, dtype=np.int32),
        "s_state": np.array([STATES[s] for s in
                             rng.integers(0, len(STATES), n_stores)],
                            dtype=object),
    }
    price_cents = rng.integers(100, 300_00, n_sales).astype(np.int64)
    list_cents = price_cents + rng.integers(0, 50_00, n_sales)
    qty = rng.integers(1, 100, n_sales).astype(np.int32)
    store_sales = {
        "ss_sold_date_sk": rng.integers(first_sale, first_sale + sale_days,
                                        n_sales).astype(np.int32),
        "ss_item_sk": rng.integers(1, n_items + 1, n_sales).astype(np.int32),
        # the last store never sells (a dimension row no sale matches)
        "ss_store_sk": rng.integers(1, max(n_stores, 2),
                                    n_sales).astype(np.int32),
        "ss_quantity": qty,
        "ss_sales_price_cents": price_cents,
        "ss_list_price_cents": list_cents,
        "ss_ext_sales_price": (price_cents * qty).astype(np.float64) / 100.0,
    }
    w_price = rng.integers(100, 300_00, n_web).astype(np.int64)
    w_qty = rng.integers(1, 100, n_web).astype(np.int32)
    w_ext = (w_price * w_qty).astype(np.float64) / 100.0
    web_sales = {
        "ws_sold_date_sk": rng.integers(first_sale, first_sale + sale_days,
                                        n_web).astype(np.int32),
        "ws_item_sk": rng.integers(1, n_items + 1, n_web).astype(np.int32),
        "ws_quantity": w_qty,
        "ws_ext_sales_price": w_ext,
    }
    web_sales["ws_ext_sales_price_valid"] = ~(rng.random(n_web) < 0.03)
    store_sales["ss_ext_cents"] = price_cents * qty
    web_sales["ws_ext_cents"] = w_price * w_qty
    return {"store_sales": store_sales, "item": item, "date_dim": date_dim,
            "store": store, "web_sales": web_sales}


def _strings(name: str, values: np.ndarray):
    payloads = [v.encode() for v in values]
    offs = np.zeros(len(payloads) + 1, np.int64)
    np.cumsum([len(p) for p in payloads], out=offs[1:])
    chars = np.frombuffer(b"".join(payloads), np.uint8)
    return W.plain_strings_column(name, chars, offs)


def table_columns(table: str, arrays: dict) -> list:
    cols = []
    for name in SCHEMA[table]:
        v = arrays[name]
        if name == "i_current_price":
            cols.append(W.decimal_column(name, v, *PRICE_DECIMAL))
        elif v.dtype == object:
            cols.append(_strings(name, v))
        else:
            phys = {"int32": "INT32", "int64": "INT64",
                    "float64": "DOUBLE"}[KINDS[v.dtype]]
            cols.append(W.ParquetColumn(name, phys, v, "plain",
                                        validity=arrays.get(name + "_valid")))
    return cols


def reference_columns(table: str, arrays: dict) -> list:
    """A fixed-width table's columns in order for the row reference."""
    return [(KINDS[arrays[name].dtype], arrays[name])
            for name in SCHEMA[table]]


def reference(config: dict, seed: int) -> dict:
    """The config's star on the host, from the seed alone: the arrays the
    oracle reads and the fixed-width tables' columns as the row reference
    takes them."""
    arrays = tpcds_arrays(
        int(config["store_sales_rows"]), int(config["web_sales_rows"]),
        int(config["items"]), int(config["dates"]), int(config["stores"]),
        sales_span(config), seed)
    return {"arrays": arrays,
            "reference": {"store_sales": reference_columns(
                "store_sales", arrays["store_sales"])}}


def prepare(config: dict, seed: int, device) -> dict:
    """:func:`reference`, and the tables ``load_tables`` puts on
    ``device`` from the files written of it."""
    from spark_rapids_jni_tpu_torch.models import tpcds
    host = reference(config, seed)
    rg = int(config["writer"]["row_group_rows"])
    files = {t: W.write_parquet(table_columns(t, host["arrays"][t]), rg)
             for t in SCHEMA}
    host["tables"] = tpcds.load_tables(files, device=device)
    return host
