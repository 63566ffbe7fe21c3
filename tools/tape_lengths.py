#!/usr/bin/env python3
"""Tape length of every TPC-DS query, JAX package beside the PyTorch port.

    JAX_PLATFORMS=cpu python3 tools/tape_lengths.py [--sales N] [--items N]

Runs each query of ``models.tpcds.QUERIES`` once under ``syncs.capture``
in both packages, on the CPU, on the data of ``tests/torch_tpcds_cases.py``
(``benchmarks.tpcds_data.generate`` at 40,000 sales rows, 500 items, seed
7; the parameters ``tools/torch_tpcds_oracle.query_params`` picks), and
prints one line a query, then the queries whose lengths differ and a JSON
summary.  The JAX package's eager queries take about 8 minutes on the CPU.
"""

import argparse
import json
import pathlib
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tools"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sales", type=int, default=40_000)
    ap.add_argument("--items", type=int, default=500)
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args(argv)

    import jax
    jax.config.update("jax_platforms", "cpu")
    import torch_tpcds_oracle as O
    import torch_tpcds_parquet as TW
    from benchmarks import tpcds_data
    from spark_rapids_jni_tpu.models import compiled as jcompiled
    from spark_rapids_jni_tpu.models import tpcds as jtpcds
    from spark_rapids_jni_tpu.utils import syncs as jsyncs
    from spark_rapids_jni_tpu_torch.models import compiled, tpcds
    from spark_rapids_jni_tpu_torch.utils import syncs

    data = dict(n_sales=args.sales, n_items=args.items, seed=args.seed)
    files = tpcds_data.generate(**data)
    _, arrays = TW.tpcds_parquet(**data)
    params = O.query_params(arrays)
    jtables = jtpcds.load_tables(files)
    ptables = tpcds.load_tables(files, device="cpu")
    lengths = {}
    for name in tpcds.QUERIES:
        jtape, ptape = [], []
        with jsyncs.capture(jtape):
            jcompiled._materialized(
                jtpcds.QUERIES[name](jtables, **params[name]))
        with syncs.capture(ptape):
            compiled._materialized(
                tpcds.QUERIES[name](ptables, **params[name]))
        lengths[name] = {"jax": len(jtape), "port": len(ptape)}
        print(f"{name}: JAX {len(jtape)}, port {len(ptape)}", flush=True)
    differ = {k: v for k, v in lengths.items() if v["jax"] != v["port"]}
    print(f"differ: {differ}")
    print(json.dumps({"data": data, "lengths": lengths}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
