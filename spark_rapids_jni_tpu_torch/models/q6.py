"""TPC-H Q6 on the device scan: scan → filter → sum of revenue.

    SELECT sum(l_extendedprice * l_discount) AS revenue
    FROM lineitem
    WHERE l_shipdate >= DATE '1994-01-01'
      AND l_shipdate <  DATE '1995-01-01'
      AND l_discount BETWEEN 0.05 AND 0.07
      AND l_quantity < 24

The port's counterpart of the JAX package's ``models/q6.py:30-49``.  The
scan decodes the four columns on the device (``parquet.device_scan``); the
predicate, the product and the masked sums are torch ops over them (the
JAX package's ``q6_kernel`` is a ``jax.jit``, not a Pallas kernel).  The
filter never compacts: the mask weighs every row.
"""

from __future__ import annotations

import torch

COLUMNS = ["l_quantity", "l_extendedprice", "l_discount", "l_shipdate"]


def q6(quantity: torch.Tensor, extendedprice: torch.Tensor,
       discount: torch.Tensor, shipdate: torch.Tensor, date_lo: int,
       date_hi: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The predicate and aggregate; dates as int32 days since the epoch.
    Returns (revenue float64, matched int64) as device scalars."""
    mask = ((shipdate >= date_lo) & (shipdate < date_hi)
            & (discount >= 0.05 - 1e-9) & (discount <= 0.07 + 1e-9)
            & (quantity < 24))
    revenue = torch.where(mask, extendedprice * discount, 0.0)
    return (revenue.sum(dtype=torch.float64),
            mask.sum(dtype=torch.int64))


def run(file_bytes, date_lo_days: int, date_hi_days: int,
        device=None) -> tuple[float, int]:
    """Scan a lineitem Parquet file and compute Q6 on the device (the
    GPU unless ``device`` says otherwise)."""
    from ..parquet import device_scan
    table = device_scan.scan_table(file_bytes, columns=COLUMNS,
                                   device=device)
    quantity, extendedprice, discount, shipdate = (c.data for c in table)
    revenue, matched = q6(quantity, extendedprice, discount, shipdate,
                          date_lo_days, date_hi_days)
    revenue, matched = torch.stack([revenue, matched.to(torch.float64)]
                                   ).tolist()
    return revenue, int(matched)
