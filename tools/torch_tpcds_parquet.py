#!/usr/bin/env python3
"""TPC-DS test tables as Parquet, written with numpy.

    python3 tools/torch_tpcds_parquet.py --n-sales 10000000 --n-items 20000 \\
        --n-stores 50 --seed 5 --out-dir tpcds/

The numpy twin of ``benchmarks/tpcds_data.generate``, for machines without
pyarrow: the same five tables (``store_sales``, ``item``, ``date_dim``,
``store``, ``web_sales``) with the same values for the same arguments
(the same ``np.random.default_rng(seed)`` draws in the same order), the
same Parquet types (INT32 keys and quantities, INT64 cents, DOUBLE
prices, UTF8 strings, ``i_current_price`` as a FIXED_LEN_BYTE_ARRAY
DECIMAL(7,2)), about 3% nulls in ``ws_ext_sales_price`` (the only
OPTIONAL column), SNAPPY pages and no dictionary.  Row groups hold
1,048,576 rows, pyarrow's default.  The pages come from
``tools/torch_lineitem_parquet.py``'s writer.

:func:`tpcds_arrays` gives the tables as numpy arrays (strings as object
arrays of ``str``), which ``tools/torch_tpcds_oracle.py`` answers the
queries from.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_lineitem_parquet as W  # noqa: E402

CATEGORIES = ["Books", "Home", "Electronics", "Jewelry", "Music",
              "Shoes", "Sports", "Women", "Men", "Children"]
STATES = ["TN", "CA", "TX", "WA", "NY", "GA", "OH", "IL"]
ROW_GROUP_ROWS = 1 << 20
PRICE_DECIMAL = (7, 2)


def tpcds_arrays(n_sales: int = 100_000, n_items: int = 2000,
                 n_dates: int = 366 * 3, n_stores: int = 12,
                 seed: int = 42) -> dict[str, dict[str, np.ndarray]]:
    """The five tables as {table: {column: array}}, drawn as
    ``benchmarks/tpcds_data.generate`` draws them.  ``i_current_price``
    is int64 cents; ``ws_ext_sales_price_valid`` is the validity of
    ``ws_ext_sales_price`` (True = present)."""
    rng = np.random.default_rng(seed)
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
    date_dim = {
        "d_date_sk": np.arange(1, n_dates + 1, dtype=np.int32),
        "d_year": (1999 + (np.arange(n_dates) // 366)).astype(np.int32),
        "d_moy": (1 + (np.arange(n_dates) // 30) % 12).astype(np.int32),
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
        "ss_sold_date_sk": rng.integers(1, n_dates + 1,
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
    n_web = max(n_sales // 3, 1)
    w_price = rng.integers(100, 300_00, n_web).astype(np.int64)
    w_qty = rng.integers(1, 100, n_web).astype(np.int32)
    w_ext = (w_price * w_qty).astype(np.float64) / 100.0
    web_sales = {
        "ws_sold_date_sk": rng.integers(1, n_dates + 1,
                                        n_web).astype(np.int32),
        "ws_item_sk": rng.integers(1, n_items + 1, n_web).astype(np.int32),
        "ws_quantity": w_qty,
        "ws_ext_sales_price": w_ext,
    }
    web_sales["ws_ext_sales_price_valid"] = ~(rng.random(n_web) < 0.03)
    # the cents the prices are made of, for an exact oracle
    store_sales["ss_ext_cents"] = price_cents * qty
    web_sales["ws_ext_cents"] = w_price * w_qty
    return {"store_sales": store_sales, "item": item, "date_dim": date_dim,
            "store": store, "web_sales": web_sales}


def _strings(name: str, values: np.ndarray) -> W.ParquetColumn:
    payloads = [v.encode() for v in values]
    offs = np.zeros(len(payloads) + 1, np.int64)
    np.cumsum([len(p) for p in payloads], out=offs[1:])
    chars = np.frombuffer(b"".join(payloads), np.uint8)
    return W.plain_strings_column(name, chars, offs)


def _number(name: str, values: np.ndarray, validity=None) -> W.ParquetColumn:
    phys = {np.dtype(np.int32): "INT32", np.dtype(np.int64): "INT64",
            np.dtype(np.float64): "DOUBLE"}[values.dtype]
    return W.ParquetColumn(name, phys, values, "plain", validity=validity)


# the columns of each file, in generate's order
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


def table_columns(table: str, arrays: dict) -> list:
    """The ParquetColumns of one table's arrays."""
    cols = []
    for name in SCHEMA[table]:
        v = arrays[name]
        if name == "i_current_price":
            cols.append(W.decimal_column(name, v, *PRICE_DECIMAL))
        elif v.dtype == object:
            cols.append(_strings(name, v))
        else:
            cols.append(_number(name, v, arrays.get(name + "_valid")))
    return cols


def tpcds_parquet(n_sales: int = 100_000, n_items: int = 2000,
                  n_dates: int = 366 * 3, n_stores: int = 12,
                  seed: int = 42, row_group_rows: int = ROW_GROUP_ROWS):
    """(file bytes by table, arrays by table) for ``generate``'s
    arguments."""
    arrays = tpcds_arrays(n_sales, n_items, n_dates, n_stores, seed)
    files = {t: W.write_parquet(table_columns(t, arrays[t]), row_group_rows,
                                codec="SNAPPY")
             for t in SCHEMA}
    return files, arrays


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n-sales", type=int, default=100_000)
    ap.add_argument("--n-items", type=int, default=2000)
    ap.add_argument("--n-dates", type=int, default=366 * 3)
    ap.add_argument("--n-stores", type=int, default=12)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--out-dir", required=True)
    args = ap.parse_args(argv)
    files, _ = tpcds_parquet(args.n_sales, args.n_items, args.n_dates,
                             args.n_stores, args.seed)
    os.makedirs(args.out_dir, exist_ok=True)
    for name, raw in files.items():
        path = os.path.join(args.out_dir, name + ".parquet")
        with open(path, "wb") as f:
            f.write(raw)
        print(f"{path}: {len(raw)} bytes")
    return 0


if __name__ == "__main__":
    sys.exit(main())
