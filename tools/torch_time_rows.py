#!/usr/bin/env python3
"""Host wall of one row-conversion table's to_rows and from_rows, on one GPU.

    python3 tools/torch_time_rows.py [--case spark_12_2str] [--reps 200]
                                     [--seed 0]

Makes the table of ``chip_smoke.py`` phase 4 named by ``--case`` (1,048,576
rows, from ``--seed`` with numpy), warms up, then times ``--reps`` calls of
``convert_to_rows`` and of ``convert_from_rows`` in turns, each on the host
clock and ending in ``torch.cuda.synchronize()``, and prints each
direction's median and quartiles with the card's name and power limit.
Run it from two checkouts in turns to compare them on one card.  Needs a
CUDA device; imports the port, never JAX.
"""

from __future__ import annotations

import argparse
import os
import statistics
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--case", default="spark_12_2str")
    ap.add_argument("--reps", type=int, default=200)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke
    import spark_rapids_jni_tpu_torch as pt
    from spark_rapids_jni_tpu_torch import _native, interop
    from spark_rapids_jni_tpu_torch import types as T

    card = chip_smoke.phase_device()
    _native.build()
    ci = list(chip_smoke.CASES).index(args.case)
    n_cols, every, max_len = chip_smoke.CASES[args.case]
    table = interop.table_from_numpy(chip_smoke.make_columns(
        T, n_cols, every, max_len, chip_smoke.ROWS,
        np.random.default_rng(args.seed + ci)), device="cuda")
    batch = pt.convert_to_rows(table)[0]
    calls = {"to_rows": lambda: pt.convert_to_rows(table),
             "from_rows": lambda: pt.convert_from_rows(batch, table.schema)}
    times = {name: [] for name in calls}
    for _ in range(3):
        for fn in calls.values():
            fn()
    for _ in range(args.reps):
        for name, fn in calls.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - t0) * 1e3)
    for name, ts in times.items():
        q1, med, q3 = statistics.quantiles(ts, n=4)
        print(f"[time] {args.case} {name} in {ROOT}: median {med:.3f} ms "
              f"(quartiles {q1:.3f}, {q3:.3f}) over {args.reps} calls "
              f"[{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
