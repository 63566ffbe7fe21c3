"""TPC-H Q1, the pricing summary: scan → filter → exact decimal products →
groupby on the two flags.

    SELECT l_returnflag, l_linestatus,
           sum(l_quantity), sum(l_extendedprice),
           sum(l_extendedprice*(1-l_discount))            AS sum_disc_price,
           sum(l_extendedprice*(1-l_discount)*(1+l_tax))  AS sum_charge,
           avg(l_quantity), avg(l_extendedprice), avg(l_discount),
           count(l_quantity)
    FROM lineitem WHERE l_shipdate <= ? GROUP BY 1,2 ORDER BY 1,2

The port's counterpart of the JAX package's ``models/tpch_q1.py:32-68``.
The last column counts the rows whose ``l_quantity`` is not null, as the
JAX package's Q1 does (TPC-H's ``count(*)`` where the column has no
nulls, as in TPC-H's own data).
The money columns are decimals (FLBA in the file); the products are
128-bit limb products (``ops.decimal128``) at scales -4 and -6, and their
sums limb sums, exact.  The groupby's output is already in key order.
"""

from __future__ import annotations

import torch

from .. import types as T
from ..column import Column, Table
from ..ops import apply_boolean_mask, decimal128 as d128, groupby_aggregate

COLUMNS = ["l_returnflag", "l_linestatus", "l_quantity", "l_extendedprice",
           "l_discount", "l_tax", "l_shipdate"]


def run(file_bytes, cutoff_days: int, device=None) -> Table:
    """Scan a lineitem file and compute Q1 (on the GPU unless ``device``
    says otherwise).  Returns [returnflag, linestatus, sum_qty,
    sum_base_price (decimal64, -2), sum_disc_price (decimal128, -4),
    sum_charge (decimal128, -6), avg_qty, avg_price, avg_disc, count],
    sorted by the two flags."""
    from ..parquet import device_scan
    t = device_scan.scan_table(file_bytes, columns=COLUMNS, device=device)
    ship = t.columns[6]
    mask = ship.data <= cutoff_days
    if ship.validity is not None:
        mask = mask & ship.validity
    t = apply_boolean_mask(t, mask)       # WHERE removes rows (Spark)
    flag, status, qty, price, disc, tax, _ = t.columns

    # 1 - discount and 1 + tax, unscaled decimal64 at scale -2
    one_minus_disc = Column(T.decimal64(-2), 100 - disc.data.to(torch.int64),
                            validity=disc.validity)
    one_plus_tax = Column(T.decimal64(-2), 100 + tax.data.to(torch.int64),
                          validity=tax.validity)

    # exact 128-bit products: the scales add, -2 + -2 = -4, then -6
    disc_price = d128.mul(d128.widen(price), d128.widen(one_minus_disc))
    charge = d128.mul(disc_price, d128.widen(one_plus_tax))

    work = Table([flag, status, qty, price, disc_price, charge, disc])
    return groupby_aggregate(
        work, [0, 1],
        [(2, "sum"),      # sum_qty
         (3, "sum"),      # sum_base_price (decimal64, scale kept)
         (4, "sum"),      # sum_disc_price (decimal128 limb sum)
         (5, "sum"),      # sum_charge (decimal128 limb sum)
         (2, "mean"),     # avg_qty
         (3, "mean"),     # avg_price (value domain)
         (6, "mean"),     # avg_disc (value domain)
         (2, "count")])   # the JAX package's count(*): non-null quantities
