"""The controls of the output checks: the reference put in the program's
place, one precision below the configuration's, read by the same check.

    python3 -m portbench.control --workload <cell> --seeds <n> [<n> ...]

Found by name, as the harness finds a cell's parts: the config's loader
(``portbench/data/<loader>.py``) makes the seed's host data with
``reference(config, seed)``, and the cell's traffic kind
(``portbench/traffic/<kind>.py``) reads the control from it with
``control(cell, seed, host)``.  Prints each seed's readings beside the
cell's limits: every reading that passes no limit fails the control.
Needs no card (the references are NumPy); it runs at the cell's own size.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def readings(cell: dict, seed: int) -> dict:
    from .harness import data_loader, seed_for_numpy, traffic_kind
    seed = seed_for_numpy(seed)
    host = data_loader(cell["config"]["loader"]).reference(cell["config"],
                                                           seed)
    return traffic_kind(cell["traffic"]["kind"]).control(cell, seed, host)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from portbench import harness
    cell = harness.resolve(args.workload)
    limits = cell["workload"]["limits"]
    for seed in args.seeds:
        got = readings(cell, seed)
        failed = [k for k, v in got.items() if v > limits[k]]
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "readings": got, "limits": limits,
                          "control_fails": bool(failed)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
