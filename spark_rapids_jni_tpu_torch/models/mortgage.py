"""Mortgage ETL (BASELINE config #5): the string- and decimal-cast-heavy
feature stage of the RAPIDS Spark Mortgage demo, on the port's ops.

The port's counterpart of the JAX package's ``models/mortgage.py``
(:28-131).  The performance and acquisition files arrive as raw text
columns, dictionary-encoded as pyarrow and Spark write them:

1. scan the raw Parquet files (``parquet.device_scan.scan_table``);
2. parse dates (``strings.to_date``), decimals (``to_decimal``) and
   integers (``to_int64``); the unparseable delinquency code "X" → -1;
3. code the categorical dimensions (state, seller) as order-preserving
   dictionary ranks, a null seller → -1;
4. per loan over its performance records: the largest delinquency, the
   mean UPB, the record count, the first reporting period;
5. join those onto the parsed acquisitions: one numeric feature row a
   loan, sorted by loan (the XGBoost input).

A dictionary column reaches its parser materialized (B5 → B6 → B2, then
B3 cuts its byte matrix), the JAX package's route.  :func:`feature_spec`
is the handoff to the ML layer (``ml/``): the feature table packed into
a float32 matrix with a label on the card.
"""

from __future__ import annotations

import torch

from .. import types as T
from ..column import Column, Table
from ..ops import (cast, fill_null, groupby_aggregate, inner_join,
                   sort_table)
from ..ops import strings as S

PERF_COLS = ["loan_id", "monthly_reporting_period", "current_actual_upb",
             "current_loan_delinquency_status", "servicer_name"]
ACQ_COLS = ["loan_id", "orig_interest_rate", "orig_upb", "orig_date",
            "state", "seller_name"]

# the feature table's columns, in etl()'s order
FEATURE_COLS = ["loan_id", "orig_rate_e4", "orig_upb", "orig_date_days",
                "state_code", "seller_code", "max_delinquency", "mean_upb",
                "num_records", "first_period_days"]


def load_tables(files: dict, device=None) -> dict[str, Table]:
    """The ETL's columns of the ``perf`` and ``acq`` files, scanned onto
    ``device`` (the GPU unless the caller says otherwise)."""
    from ..parquet import device_scan
    return {"perf": device_scan.scan_table(files["perf"], columns=PERF_COLS,
                                           device=device),
            "acq": device_scan.scan_table(files["acq"], columns=ACQ_COLS,
                                          device=device)}


def _parse_perf(perf: Table) -> Table:
    """Raw performance strings → (loan_id, period days, UPB cents,
    delinquency)."""
    loan = perf[PERF_COLS.index("loan_id")]
    period = S.to_date(perf[PERF_COLS.index("monthly_reporting_period")],
                       "%m/%d/%Y")
    upb = S.to_decimal(perf[PERF_COLS.index("current_actual_upb")], -2)
    # "X" (unknown) parses to null; the demo takes it as -1 before the max
    delinq = fill_null(
        S.to_int64(perf[PERF_COLS.index("current_loan_delinquency_status")]),
        -1)
    return Table([loan, period, upb, delinq])


def _parse_acq(acq: Table) -> Table:
    """Raw acquisition strings → typed columns and categorical codes."""
    loan = acq[ACQ_COLS.index("loan_id")]
    rate = S.to_decimal(acq[ACQ_COLS.index("orig_interest_rate")], -4)
    upb = S.to_int64(acq[ACQ_COLS.index("orig_upb")])
    odate = S.to_date(acq[ACQ_COLS.index("orig_date")], "%Y-%m-%d")
    state_codes, _ = S.dictionary_encode(acq[ACQ_COLS.index("state")])
    seller = acq[ACQ_COLS.index("seller_name")]
    seller_codes, _ = S.dictionary_encode(seller)
    # a null seller → code -1 (the demo's "unknown" bucket)
    seller_codes = fill_null(
        Column(seller_codes.dtype, seller_codes.data,
               validity=seller.validity), -1)
    return Table([loan, rate, upb, odate, state_codes, seller_codes])


def etl(files: dict, device=None) -> Table:
    """The whole pipeline: the feature table (FEATURE_COLS, by loan)."""
    return etl_tables(load_tables(files, device))


def etl_tables(tables: dict[str, Table]) -> Table:
    """The plan over loaded tables, without the scan."""
    perf = _parse_perf(tables["perf"])
    acq = _parse_acq(tables["acq"])
    agg = groupby_aggregate(
        perf, [0],
        [(3, "max"),     # the largest delinquency
         (2, "mean"),    # the mean UPB, a float64 in dollars (the decimal's
         #                 scale applied by the groupby)
         (0, "count"),   # the record count
         (1, "min")])    # the first reporting period
    # acq's 6 columns, then agg's 5 but for its loan_id
    joined = inner_join(acq, agg, 0, 0)
    feats = [joined[i] for i in range(6)] + [joined[i] for i in range(7, 11)]
    return sort_table(Table(feats), [0])


def feature_spec():
    """The demo's ETL→ML handoff: every numeric ETL output except the loan
    id feeds the model; the label is "severely delinquent"
    (max_delinquency > 2 — the generator emits delinquency grades 2/3, so
    >2 is the class split that actually separates).  The returned spec
    packs ``etl_tables`` output straight into the feature matrix on the
    card."""
    from ..ml.features import Feature, FeatureSpec
    feats = [c for c in FEATURE_COLS
             if c not in ("loan_id", "max_delinquency")]
    return FeatureSpec.of([Feature(c, impute="mean") for c in feats],
                          label="max_delinquency",
                          label_transform=("gt", 2.0))


def feature_matrix(files: dict, device=None):
    """(loan ids, float32 [n_loans, len(FEATURE_COLS) - 1]): the feature
    table as the XGBoost input, every column numeric and no null left
    (a mean over all-blank UPBs aside), on ``device``."""
    t = etl(files, device)
    lanes = [(cast(c, T.float64) if c.dtype.is_decimal else c).data.to(
        torch.float32) for c in t.columns[1:]]
    return t[0].data, torch.stack(lanes, dim=1)
