#!/usr/bin/env python3
"""The scan walls of two checkouts of the PyTorch port, alternated on one GPU.

    python3 tools/torch_scan_ab.py --pkg A=DIR --pkg B=DIR [--order ABBA]
        [--calls 5] [--data DIR]

Writes the files of ``chip_smoke.py``'s scans once into ``--data``
(default ``build/scan_ab``): phase 11's SF1 lineitem as Spark writes it
(SNAPPY), phase 13's TPC-DS files, phase 14's Mortgage files and phase
20's nested event table, with the script's own sizes and seeds.  Then,
for each letter of ``--order``, one process imports the port from that
letter's checkout (the root of a tree holding
``spark_rapids_jni_tpu_torch``), builds its kernels and times, after one
warm-up call each, ``--calls`` calls of ``device_scan.scan_table`` on
the SNAPPY and the nested file and of ``tpcds.load_tables`` and
``mortgage.load_tables`` on theirs, every call ended by
``torch.cuda.synchronize``.  It prints one ``[scan_ab]`` JSON line a turn
(each call's wall in ms, the median) and a summary line: each checkout's
medians over all its turns and B's over A's.  Needs a CUDA device;
imports the port, never JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCANS = ("sf1_snappy", "tpcds_load_tables", "mortgage_load_tables",
         "nested")


def write_files(data: str) -> dict:
    """The four inputs as files under ``data``; their paths by scan."""
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import chip_smoke as S
    import torch_lineitem_parquet as W
    import torch_mortgage_parquet as MW
    import torch_nested_parquet as NW
    import torch_tpcds_parquet as TW

    os.makedirs(data, exist_ok=True)
    made = {"sf1_snappy": {"file": S.spark_file(W, 0)[0]},
            "tpcds_load_tables": TW.tpcds_parquet(**S.TPCDS_ARGS)[0],
            "mortgage_load_tables": MW.mortgage_parquet(**S.MORTGAGE_ARGS)[0],
            "nested": {"file": NW.nested_parquet(
                S.NESTED_ROWS, S.NESTED_SEED, NW.ROW_GROUP_ROWS)[0]}}
    paths = {}
    for scan, files in made.items():
        paths[scan] = {}
        for name, raw in files.items():
            path = os.path.join(data, f"{scan}.{name}.parquet")
            with open(path, "wb") as fh:
                fh.write(raw)
            paths[scan][name] = path
    with open(os.path.join(data, "manifest.json"), "w") as fh:
        json.dump(paths, fh)
    return paths


def read(path: str) -> bytes:
    with open(path, "rb") as fh:
        return fh.read()


def turn(pkg: str, paths: dict, calls: int) -> dict:
    """One checkout's walls (ms) for every scan, in this process."""
    import torch
    sys.path.insert(0, os.path.abspath(pkg))
    from spark_rapids_jni_tpu_torch import _native
    from spark_rapids_jni_tpu_torch.models import mortgage, tpcds
    from spark_rapids_jni_tpu_torch.parquet import device_scan

    _native.build()
    files = {scan: {name: read(p) for name, p in named.items()}
             for scan, named in paths.items()}
    run = {"sf1_snappy":
           lambda: device_scan.scan_table(files["sf1_snappy"]["file"]),
           "tpcds_load_tables":
           lambda: tpcds.load_tables(files["tpcds_load_tables"]),
           "mortgage_load_tables":
           lambda: mortgage.load_tables(files["mortgage_load_tables"]),
           "nested": lambda: device_scan.scan_table(files["nested"]["file"])}
    out = {}
    for scan in SCANS:
        walls = []
        for i in range(calls + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = run[scan]()
            torch.cuda.synchronize()
            if i:
                walls.append(round((time.perf_counter() - t0) * 1e3, 3))
            del got
        out[scan] = {"walls_ms": walls,
                     "median_ms": statistics.median(walls)}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--pkg", action="append", required=True,
                    help="LETTER=DIR, a checkout's root (twice)")
    ap.add_argument("--order", default="ABBA")
    ap.add_argument("--calls", type=int, default=5)
    ap.add_argument("--data", default=os.path.join(ROOT, "build", "scan_ab"))
    ap.add_argument("--turn", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    pkgs = dict(p.split("=", 1) for p in args.pkg)
    if args.turn:
        # only the manifest: importing chip_smoke here could load the
        # other checkout's port
        with open(os.path.join(args.data, "manifest.json")) as fh:
            paths = json.load(fh)
        print(json.dumps(turn(pkgs[args.turn], paths, args.calls)),
              flush=True)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    t0 = time.perf_counter()
    write_files(args.data)
    print(f"[scan_ab] files written in {time.perf_counter() - t0:.1f} s",
          flush=True)
    medians = {letter: {scan: [] for scan in SCANS} for letter in pkgs}
    for k, letter in enumerate(args.order):
        done = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--turn", letter,
             "--calls", str(args.calls), "--data", args.data]
            + [f"--pkg={p}" for p in args.pkg],
            capture_output=True, text=True, check=True)
        got = json.loads(done.stdout.strip().splitlines()[-1])
        for scan in SCANS:
            medians[letter][scan].append(got[scan]["median_ms"])
        print("[scan_ab] " + json.dumps({"turn": k, "pkg": letter,
                                         "scans": got, "card": card}),
              flush=True)
    a, b = sorted(pkgs)
    summary = {scan: {a: statistics.median(medians[a][scan]),
                      b: statistics.median(medians[b][scan]),
                      f"{b}_over_{a}": round(
                          statistics.median(medians[b][scan])
                          / statistics.median(medians[a][scan]), 4),
                      "turn_medians": {x: medians[x][scan] for x in (a, b)}}
               for scan in SCANS}
    print("[scan_ab] summary " + json.dumps({"order": args.order,
                                             "scans": summary,
                                             "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
