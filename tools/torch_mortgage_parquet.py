#!/usr/bin/env python3
"""Mortgage ETL test files as Parquet, written with numpy.

    python3 tools/torch_mortgage_parquet.py --n-loans 1000000 --periods 12 \\
        --seed 11 --out-dir mortgage/

The numpy twin of ``benchmarks/mortgage_data.generate``, for machines
without pyarrow: the same two files (``perf``: loan_id and four text
columns, ``periods_per_loan`` rows a loan; ``acq``: loan_id and five
text columns, a row a loan) with the same values for the same arguments.
It draws from ``np.random.default_rng(seed)`` in ``generate``'s order;
a vector draw gives the values of as many scalar draws, so only
``orig_date``'s interleaved year and month draws stay a scalar loop.
The text is made from the numbers with numpy, byte for byte Python's
``f"{u:.2f}"``, ``f"{r:.4f}"`` and ``str(u)``: a float's cents or
ten-thousandths are rounded half to even from its exact binary value,
as Python's formatting rounds.

The files are written as pyarrow's defaults write them: every column
OPTIONAL and dictionary-encoded, falling back to PLAIN from the first
page that takes its dictionary past 1 MiB, SNAPPY, v1 data pages of at
most 1 MiB and 20,000 rows, row groups of 1,048,576 rows.  The pages come
from ``tools/torch_lineitem_parquet.py``'s writer; a text column is its
distinct strings (``strings``) and each row's index into them.

:func:`mortgage_arrays` gives the source numbers, which
``tools/torch_mortgage_oracle.py`` builds the feature table from.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_lineitem_parquet as W  # noqa: E402

SELLERS = ["BANK OF AMERICA", "WELLS FARGO", "QUICKEN", "OTHER",
           "JPMORGAN CHASE", "CITIMORTGAGE"]
STATES = ["CA", "TX", "NY", "FL", "IL", "WA", "OH", "GA"]
ROW_GROUP_ROWS = 1 << 20
FIRST_LOAN_ID = 10 ** 11
FIRST_PERIOD_YEAR = 2019


def _scaled_half_even(x: np.ndarray, k: int) -> np.ndarray:
    """int64 round-half-even of x * 10**k for finite x >= 0, exact: with
    x = M * 2**(e-53) (M a 53-bit integer), x * 10**k = M * 5**k *
    2**(e-53+k), and the shift's dropped bits decide the rounding."""
    if 5 ** k >= 1 << 10:
        raise ValueError("M * 5**k must fit int64")
    mant, e = np.frexp(x)
    M = (mant * 2.0 ** 53).astype(np.int64)
    N = M * 5 ** k
    s = (53 - e - k).astype(np.int64)
    if x.size and not (s.min() >= 1 and s.max() <= 62):
        raise ValueError("values out of the exact range")
    q = N >> s
    rem = N & ((np.int64(1) << s) - 1)
    half = np.int64(1) << (s - 1)
    up = (rem > half) | ((rem == half) & (q & 1 == 1))
    return q + up


def number_text(units: np.ndarray, frac_digits: int = 0) -> tuple:
    """(chars uint8, int64 offsets [n+1]) of nonnegative int64 ``units``
    as decimal text, ``frac_digits`` of them after a point ("123.45" for
    12345 and 2); a negative unit is the empty string."""
    units = np.asarray(units, np.int64)
    n = units.shape[0]
    blank = units < 0
    v = np.where(blank, 0, units)
    ip, fp = np.divmod(v, 10 ** frac_digits)
    nd = np.ones(n, np.int64)
    for k in range(1, 19):
        nd += ip >= 10 ** k
    wi = int(nd.max(initial=1))

    def digits(x, width):
        return [((x // 10 ** (width - 1 - p)) % 10 + ord("0")).astype(
            np.uint8) for p in range(width)]

    cols = digits(ip, wi)
    if frac_digits:
        cols += [np.full(n, ord("."), np.uint8)] + digits(fp, frac_digits)
    mat = np.stack(cols, axis=1)
    keep = np.arange(mat.shape[1])[None, :] >= (wi - nd)[:, None]
    keep &= ~blank[:, None]
    lens = keep.sum(axis=1)
    offs = np.zeros(n + 1, np.int64)
    np.cumsum(lens, out=offs[1:])
    return mat[keep], offs


def words_text(words: list) -> tuple:
    """(chars, int64 offsets) of a list of str."""
    payloads = [w.encode() for w in words]
    offs = np.zeros(len(payloads) + 1, np.int64)
    np.cumsum([len(p) for p in payloads], out=offs[1:])
    return np.frombuffer(b"".join(payloads), np.uint8).copy(), offs


def mortgage_arrays(n_loans: int = 2000, periods_per_loan: int = 12,
                    seed: int = 11) -> dict:
    """The source numbers of both files, drawn as ``generate`` draws
    them: {"acq": {...}, "perf": {...}} of numpy arrays.  Rates and UPBs
    come as the integers their text shows (ten-thousandths, cents);
    ``status`` -1 is the code "X"; ``*_valid`` are validities."""
    rng = np.random.default_rng(seed)
    loan_ids = np.arange(FIRST_LOAN_ID, FIRST_LOAN_ID + n_loans,
                         dtype=np.int64)
    rate = rng.uniform(2.5, 8.0, n_loans)
    orig_upb = rng.integers(50_000, 800_000, n_loans)
    orig_year = np.empty(n_loans, np.int64)
    orig_month = np.empty(n_loans, np.int64)
    integers = rng.integers
    for i in range(n_loans):          # generate's interleaved scalar draws
        orig_year[i] = integers(2000, 2020)
        orig_month[i] = integers(1, 13)
    state = rng.integers(0, len(STATES), n_loans)
    seller = rng.integers(0, len(SELLERS), n_loans)
    seller_valid = rng.random(n_loans) >= 0.05
    acq = {"loan_id": loan_ids, "rate_e4": _scaled_half_even(rate, 4),
           "orig_upb": orig_upb, "orig_year": orig_year,
           "orig_month": orig_month, "state": state, "seller": seller,
           "seller_valid": seller_valid}

    n_perf = n_loans * periods_per_loan
    month = np.tile(np.arange(periods_per_loan), n_loans)
    status_pool = rng.integers(0, 4, n_perf)
    status = np.where(rng.random(n_perf) < 0.03, -1, status_pool)
    upb = rng.uniform(10_000, 900_000, n_perf)
    upb_valid = rng.random(n_perf) >= 0.02          # "" (blank) otherwise
    servicer = rng.integers(0, len(SELLERS), n_perf)
    servicer_valid = rng.random(n_perf) >= 0.3
    perf = {"loan_id": np.repeat(loan_ids, periods_per_loan),
            "period_year": FIRST_PERIOD_YEAR + month // 12,
            "period_month": 1 + month % 12,
            "upb_cents": _scaled_half_even(upb, 2), "upb_valid": upb_valid,
            "status": status, "servicer": servicer,
            "servicer_valid": servicer_valid}
    return {"acq": acq, "perf": perf}


def _text_column(name: str, keys: np.ndarray, text, validity=None):
    """A dictionary-encoded text column: the distinct ``keys``, each
    made text by ``text(distinct keys)``, and each row's index."""
    lo = int(keys.min(initial=0))
    span = int(keys.max(initial=0)) - lo + 1
    if span <= keys.shape[0]:                # a table, not a sort
        uniq = np.flatnonzero(np.bincount(keys - lo, minlength=span)) + lo
        table = np.zeros(span, np.int64)
        table[uniq - lo] = np.arange(uniq.shape[0])
        codes = table[keys - lo]
    else:
        uniq, codes = np.unique(keys, return_inverse=True)
    return W.ParquetColumn(name, "BYTE_ARRAY", codes.reshape(-1).astype(
        np.int64), "dict", "UTF8", None,
        np.ones(keys.shape[0], bool) if validity is None else validity,
        text(uniq))


def _loan_column(ids: np.ndarray) -> W.ParquetColumn:
    return W.ParquetColumn("loan_id", "INT64", ids, "dict",
                           validity=np.ones(ids.shape[0], bool))


def _word_text(words: list):
    return lambda keys: words_text([words[k] for k in keys])


def _date_text(fmt: str):
    """Text of y * 100 + m keys: "%Y-%m-01" or "%m/01/%Y"."""
    def text(keys):
        return words_text([(fmt.format(y=k // 100, m=k % 100))
                           for k in keys.tolist()])
    return text


def acq_columns(a: dict) -> list:
    return [
        _loan_column(a["loan_id"]),
        _text_column("orig_interest_rate", a["rate_e4"],
                     lambda k: number_text(k, 4)),
        _text_column("orig_upb", a["orig_upb"], number_text),
        _text_column("orig_date", a["orig_year"] * 100 + a["orig_month"],
                     _date_text("{y}-{m:02d}-01")),
        _text_column("state", a["state"], _word_text(STATES)),
        _text_column("seller_name", a["seller"], _word_text(SELLERS),
                     a["seller_valid"]),
    ]


def perf_columns(p: dict) -> list:
    return [
        _loan_column(p["loan_id"]),
        _text_column("monthly_reporting_period",
                     p["period_year"] * 100 + p["period_month"],
                     _date_text("{m:02d}/01/{y}")),
        _text_column("current_actual_upb",
                     np.where(p["upb_valid"], p["upb_cents"], -1),
                     lambda k: number_text(k, 2)),
        _text_column("current_loan_delinquency_status", p["status"],
                     lambda k: words_text(["X" if s < 0 else str(s)
                                           for s in k.tolist()])),
        _text_column("servicer_name", p["servicer"], _word_text(SELLERS),
                     p["servicer_valid"]),
    ]


# pyarrow's write_table defaults (SNAPPY; dictionary fallback past 1 MiB;
# 1 MiB pages of at most 20,000 rows) are Spark's
PYARROW_DEFAULTS = W.SPARK_DEFAULTS


def mortgage_parquet(n_loans: int = 2000, periods_per_loan: int = 12,
                     seed: int = 11, row_group_rows: int = ROW_GROUP_ROWS):
    """({"perf": bytes, "acq": bytes}, :func:`mortgage_arrays`) for
    ``generate``'s arguments."""
    arrays = mortgage_arrays(n_loans, periods_per_loan, seed)
    files = {"perf": W.write_parquet(perf_columns(arrays["perf"]),
                                     row_group_rows, **PYARROW_DEFAULTS),
             "acq": W.write_parquet(acq_columns(arrays["acq"]),
                                    row_group_rows, **PYARROW_DEFAULTS)}
    return files, arrays


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n-loans", type=int, default=2000)
    ap.add_argument("--periods", type=int, default=12)
    ap.add_argument("--seed", type=int, default=11)
    ap.add_argument("--out-dir", required=True)
    args = ap.parse_args(argv)
    files, _ = mortgage_parquet(args.n_loans, args.periods, args.seed)
    os.makedirs(args.out_dir, exist_ok=True)
    for name, raw in files.items():
        path = os.path.join(args.out_dir, name + ".parquet")
        with open(path, "wb") as f:
            f.write(raw)
        print(f"{path}: {len(raw)} bytes")
    return 0


if __name__ == "__main__":
    sys.exit(main())
