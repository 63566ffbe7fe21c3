"""The Mortgage ETL's feature table from the generator's numbers, in numpy.

An oracle for ``models.mortgage.etl`` apart from both packages: it reads
no text and calls no parser, but builds each feature from the source
numbers of ``tools/torch_mortgage_parquet.py`` ``mortgage_arrays``:

* dates as days since 1970-01-01 by numpy's calendar;
* the UPB as the integer cents its text shows, null where blank;
* delinquency with the code "X" as -1;
* state and seller codes as the ranks of the distinct strings, sorted,
  a null seller -1;
* per loan the largest delinquency, the mean UPB in dollars (exact cents
  sums), the record count and the first period;
* the acquisitions joined to those, by loan.

:func:`features` gives the columns (``FEATURE_COLS``' names) and their
validity; :func:`check` holds a result table against them.
"""

from __future__ import annotations

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_mortgage_parquet import (  # noqa: E402
    FIRST_LOAN_ID, SELLERS, STATES)

FEATURE_COLS = ["loan_id", "orig_rate_e4", "orig_upb", "orig_date_days",
                "state_code", "seller_code", "max_delinquency", "mean_upb",
                "num_records", "first_period_days"]
MEAN_RTOL = 1e-12


def month_days(year: np.ndarray, month: np.ndarray) -> np.ndarray:
    """int32 days since 1970-01-01 of the first of each (year, month)."""
    months = (np.asarray(year, np.int64) - 1970) * 12 + (
        np.asarray(month, np.int64) - 1)
    return months.astype("datetime64[M]").astype("datetime64[D]").astype(
        np.int64).astype(np.int32)


def _ranks(words: list, idx: np.ndarray, valid: np.ndarray) -> np.ndarray:
    """int32 rank of each row's word among the distinct valid words,
    sorted; -1 where not valid."""
    present = sorted({words[i] for i in np.unique(idx[valid])})
    rank_of = np.array([present.index(w) if w in present else -1
                        for w in words], np.int32)
    return np.where(valid, rank_of[idx], -1).astype(np.int32)


def features(arrays: dict) -> tuple[dict, dict]:
    """({name: values}, {name: validity}) of the feature table, its rows
    by loan id."""
    a, p = arrays["acq"], arrays["perf"]
    n_loans = a["loan_id"].shape[0]
    loan = p["loan_id"] - FIRST_LOAN_ID
    count = np.bincount(loan, minlength=n_loans)
    upb_n = np.bincount(loan, weights=p["upb_valid"], minlength=n_loans)
    cents = np.zeros(n_loans, np.int64)
    np.add.at(cents, loan[p["upb_valid"]], p["upb_cents"][p["upb_valid"]])
    delinq = np.full(n_loans, np.iinfo(np.int64).min)
    np.maximum.at(delinq, loan, p["status"].astype(np.int64))
    first = np.full(n_loans, np.iinfo(np.int32).max, np.int32)
    np.minimum.at(first, loan, month_days(p["period_year"],
                                          p["period_month"]))
    mean_valid = upb_n > 0
    mean = np.where(mean_valid, cents / np.maximum(upb_n, 1) / 100.0, 0.0)

    keep = count > 0                   # the inner join: loans with records
    cols = {
        "loan_id": a["loan_id"],
        "orig_rate_e4": a["rate_e4"].astype(np.int64),
        "orig_upb": a["orig_upb"].astype(np.int64),
        "orig_date_days": month_days(a["orig_year"], a["orig_month"]),
        "state_code": _ranks(STATES, a["state"],
                             np.ones(n_loans, bool)),
        "seller_code": _ranks(SELLERS, a["seller"], a["seller_valid"]),
        "max_delinquency": delinq,
        "mean_upb": mean,
        "num_records": count.astype(np.int64),
        "first_period_days": first,
    }
    cols = {k: v[keep] for k, v in cols.items()}
    valid = {k: np.ones(cols["loan_id"].shape[0], bool) for k in cols}
    valid["mean_upb"] = mean_valid[keep]
    return cols, valid


def _require(cond, msg) -> None:
    # a raise, not an assert: the check must hold under python -O too
    if not cond:
        raise AssertionError(msg)


def check(table, want: tuple[dict, dict]) -> float:
    """Holds a feature table (port columns, any device) against
    :func:`features`: every column exact and with the same validity, but
    ``mean_upb``, within a relative MEAN_RTOL on its valid rows.  Returns
    the largest relative error of ``mean_upb``; raises AssertionError."""
    cols, valid = want
    _require(table.num_columns == len(FEATURE_COLS),
             f"{table.num_columns} columns")
    _require(table.num_rows == cols["loan_id"].shape[0],
             f"{table.num_rows} rows, want {cols['loan_id'].shape[0]}")
    rel = 0.0
    for i, name in enumerate(FEATURE_COLS):
        c = table[i]
        v = c.validity_or_true().cpu().numpy()
        _require(np.array_equal(v, valid[name]), f"{name}: validity")
        got = c.data.cpu().numpy()
        if name == "mean_upb":
            w = cols[name][v]
            err = np.abs(got[v] - w) / np.maximum(np.abs(w), 1e-300)
            rel = float(err.max(initial=0.0))
            _require(rel <= MEAN_RTOL, f"{name}: relative error {rel}")
            continue
        _require(got.dtype == cols[name].dtype, f"{name}: {got.dtype}")
        bad = np.flatnonzero((got != cols[name]) & v)
        _require(bad.size == 0,
                 f"{name}: {bad.size} rows differ" + (
                     f", first {bad[0]}: {got[bad[0]]} != "
                     f"{cols[name][bad[0]]}" if bad.size else ""))
    return rel
