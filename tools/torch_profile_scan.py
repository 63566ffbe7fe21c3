#!/usr/bin/env python3
"""Where the time of the PyTorch port's device Parquet scan goes, on one GPU.

    python3 tools/torch_profile_scan.py [--seed N] [--out DIR]

Writes the two lineitem files of ``chip_smoke.py`` phase 5 (SF1, 6,001,215
rows and all 16 columns; and 1,048,576 rows of 15 columns with 10% nulls),
then, after one warm-up each, profiles with ``torch.profiler`` one call of:
the SF1 ``scan_table`` of the first 15 columns, the nulls-file
``scan_table``, Q6 on the SF1 file, the materialization of the SF1 table's
four dictionary-string columns, ``convert_to_rows`` of the scanned
15-column table, and, for the full table of ``chip_smoke.py`` phase 8, the
scan of all 16 columns (PLAIN ``l_comment`` among them) and its
``convert_to_rows``; TPC-H Q1 (``models.tpch_q1.run``) on the SF1 file in
Q1's layout of ``chip_smoke.py`` phase 10 (FLBA decimals); and the scan
of the 16 columns written as Spark's defaults write them
(``chip_smoke.py`` phase 11: SNAPPY, dictionary fallback to PLAIN).  For
each it prints the host wall time, the scan's host spans (page walk, the
decompression inside it, the slab waves' uploads, inside the walk for
the waves that fill while the columns stage, decode launches;
``parquet.scan.*`` in ``device_scan.scan_table`` and
``decode.decompress``), the device-busy time (the union of the
kernels' intervals), the device's idle share, and the device ops that took
the most time.  The scans run as the environment sets them: under
``SRJT_STAGE_PIPELINE=1`` the walk and its decompression run on a
producer thread, whose ranges ``torch.profiler`` does not record, so the
walk's and the staging's milliseconds then come from the scans'
``parquet.stage.overlap`` events (``walk_thread``, ``stage_thread``,
``overlap``).  The full per-op tables go to
``DIR/torch_profile_scan.txt`` (default ``build/profiles``).  Needs a CUDA
device; imports the port, never JAX.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPANS = ("parquet.scan.walk", "parquet.scan.decompress",
         "parquet.scan.rowfilter", "parquet.scan.upload",
         "parquet.scan.decode")


def _span_ms(prof) -> dict:
    """Host milliseconds inside each scan span (summed over calls).  A span
    also appears as a device-side annotation of the same name, whose host
    time is 0: keep the larger."""
    out = {}
    for a in prof.key_averages():
        if a.key in SPANS:
            k = a.key.rsplit(".", 1)[1]
            out[k] = max(out.get(k, 0.0), a.cpu_time_total / 1e3)
    return out


def profile_scans(fn) -> tuple:
    """``profile_call(fn)`` and the scans' milliseconds inside it: the
    profiler's spans, and where a scan ran the walk/stage pipeline, the
    producer thread's walk, the staging and their overlap summed from its
    ``parquet.stage.overlap`` events."""
    from torch_profile_rowconv import profile_call

    from spark_rapids_jni_tpu_torch.utils import flight
    was = flight.enabled()
    flight.set_enabled(True)
    t0 = round(time.time(), 6)
    try:
        prof, wall = profile_call(fn)
    finally:
        flight.set_enabled(was)
    split = _span_ms(prof)
    runs = [e for e in flight.events()
            if e["kind"] == "parquet.stage.overlap" and e["ts"] >= t0]
    if runs:
        for key, field in (("walk_thread", "walk_ms"),
                           ("stage_thread", "stage_ms"),
                           ("overlap", "overlap_ms")):
            split[key] = sum(e[field] for e in runs)
    return prof, wall, split


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "profiles"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import chip_smoke
    import torch_lineitem_parquet as W
    from torch_profile_rowconv import (NAME_CHARS, TOP, _busy_us,
                                       _device_total)
    import spark_rapids_jni_tpu_torch as pt
    from spark_rapids_jni_tpu_torch import _native
    from spark_rapids_jni_tpu_torch.models import q6, tpch_q1
    from spark_rapids_jni_tpu_torch.parquet import device_scan

    _native.build()
    card = chip_smoke.phase_device()
    os.makedirs(args.out, exist_ok=True)
    report = os.path.join(args.out, "torch_profile_scan.txt")
    raw, _, _ = W.lineitem_parquet(W.SF1_ROWS, args.seed)
    raw_n, _, _ = W.lineitem_parquet(
        chip_smoke.NULL_ROWS, args.seed + 1,
        row_group_rows=chip_smoke.NULL_ROWS // chip_smoke.NULL_ROW_GROUPS,
        null_fraction=chip_smoke.NULL_FRACTION, pages_per_chunk=2,
        columns=W.LINEITEM_NO_COMMENT)
    raw_q1, _, _ = W.lineitem_parquet(W.SF1_ROWS, args.seed + 3,
                                      columns=W.LINEITEM_Q1)
    raw_spark, _, _ = W.lineitem_parquet(
        W.SF1_ROWS, args.seed, row_group_rows=chip_smoke.SPARK_ROW_GROUP_ROWS,
        **W.SPARK_DEFAULTS)
    cols15 = [name for name, *_ in W.LINEITEM_NO_COMMENT]
    lo, hi = chip_smoke.Q6_DATES
    sf1 = device_scan.scan_table(raw, columns=cols15)
    full = device_scan.scan_table(raw)

    def materialize_all():
        table = device_scan.scan_table(raw, columns=cols15)
        torch.cuda.synchronize()
        return table, lambda: [c.materialize() for c in table.columns
                               if isinstance(c, pt.DictColumn)]

    cases = [
        ("scan SF1", lambda: device_scan.scan_table(raw, columns=cols15)),
        ("scan nulls", lambda: device_scan.scan_table(raw_n)),
        ("q6 SF1", lambda: q6.run(raw, lo, hi)),
        ("materialize SF1 strings", None),
        ("to_rows SF1 scanned", lambda: pt.convert_to_rows(sf1)),
        ("scan SF1 16 columns", lambda: device_scan.scan_table(raw)),
        ("to_rows SF1 16 columns", lambda: pt.convert_to_rows(full)),
        ("q1 SF1", lambda: tpch_q1.run(raw_q1, chip_smoke.Q1_CUTOFF)),
        ("scan SF1 Spark SNAPPY", lambda: device_scan.scan_table(raw_spark)),
    ]
    with open(report, "w") as fh:
        for name, fn in cases:
            if fn is None:
                materialize_all()[1]()                  # warm-up
                _, fn = materialize_all()
            else:
                fn()                                    # warm-up
            prof, wall, split = profile_scans(fn)
            busy = _busy_us(prof)
            spans = ", ".join(f"{k} {v:.3f} ms" for k, v in split.items())
            avgs = sorted(prof.key_averages(), key=_device_total, reverse=True)
            top = ", ".join(
                f"{a.key[:NAME_CHARS]} {_device_total(a) / 1e3:.3f} ms "
                f"x{a.count}" for a in avgs[:TOP] if _device_total(a) > 0)
            print(f"[profile] {name}: wall {wall / 1e3:.3f} ms, host spans "
                  f"[{spans}], device busy {busy / 1e3:.3f} ms, idle share "
                  f"{1 - busy / wall:.3f}; top device ops: {top} [{card}]",
                  flush=True)
            fh.write(f"== {name} ==\n")
            fh.write(prof.key_averages().table(
                sort_by="self_device_time_total", row_limit=40))
            fh.write("\n")
    print(f"[profile] per-op tables in {report}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
