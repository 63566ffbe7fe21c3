"""What the port's tracing costs a served cell, on the card.

One run of a portbench cell in one of three modes, as one JSON line:

* ``off``: metrics and the profiler off (the benchmark's ``--trace 0``);
* ``metrics``: the program's metrics on through the measured window (its
  spans, and so their profiler ranges, recorded), no profiler;
* ``profiler``: the benchmark's ``--trace 1``: metrics on, and
  ``torch.profiler`` over the slice in the window's middle; the line
  carries the traced run's per-layer metrics and breakdown.

Each line holds the window's end-to-end metrics and the same two numbers
over the profiled slice's seconds in every mode (requests completed in
it over its seconds; the 95th percentile of those submitted in it), so
the profiler's cost shows beside the others.  ``--sites`` instead times
one ``utils.metrics.span`` site, in ns, with metrics off and on.

    python3 tools/torch_trace_cost.py --workload tpcds_serve_sf1 --seed 7 --seconds 51 --mode metrics
    python3 tools/torch_trace_cost.py --sites

From the root of a checkout, on a machine with a card; run each mode in a
process of its own, as the benchmark runs each run.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _p95(lat: list):
    lat = sorted(lat)
    if not lat:
        return None
    v = lat[max(math.ceil(0.95 * len(lat)) - 1, 0)]
    return v if math.isfinite(v) else None


def _slice_numbers(run, harness) -> dict:
    served = run.state["served"]
    start, length = harness._slice(run.traffic, run.seconds)
    a = served["t0"] + start
    b = a + length
    recs = served["records"]
    done = sum(1 for _, _, te, ok in recs if ok and a <= te <= b)
    lat = [(te - ts) * 1e3 if ok else math.inf
           for _, ts, te, ok in recs if a <= ts <= b]
    return {"slice_queries_per_s": done / length,
            "slice_query_p95_ms": _p95(lat)}


def run_one(workload: str, seed: int, seconds: float, mode: str,
            cell=None, device=None) -> dict:
    """One run; ``cell`` (``harness.resolve``'s) and ``device`` as
    ``harness.run_cell`` takes them."""
    from portbench import harness
    from spark_rapids_jni_tpu_torch.utils import metrics
    cell = cell or harness.resolve(workload)
    kind = harness.traffic_kind(cell["traffic"]["kind"])
    got = {}
    window, end_to_end = kind.window, kind.end_to_end

    def metered_window(run):
        metrics.reset()
        metrics.set_enabled(True)
        try:
            window(run)
        finally:
            metrics.set_enabled(False)

    def kept_end_to_end(run):
        values = end_to_end(run)
        got.update(values, **_slice_numbers(run, harness))
        return values

    if mode == "metrics":
        kind.window = metered_window
    kind.end_to_end = kept_end_to_end
    out = harness.run_cell(workload, seed, seconds, mode == "profiler",
                           device=device, cell=cell,
                           t_start=harness.process_start())
    line = {"mode": mode, "seed": seed, "workload": workload,
            "card": out["device"]["kind"], "correct": out["correct"], **got}
    if mode == "profiler":
        line["per_layer"] = {k: v["value"] for k, v in out["metrics"].items()}
        line["breakdown"] = out.get("breakdown")
        line["busy_s"] = out["device"].get("busy_s")
        line["window_s"] = out["device"].get("window_s")
    return line


def site_ns(n: int = 200_000) -> dict:
    """ns a ``with metrics.span(...)`` site costs, metrics off and on (on:
    the span, its profiler range and, on a card, its NVTX range)."""
    from spark_rapids_jni_tpu_torch.utils import metrics
    out = {}
    for on in (False, True):
        metrics.set_enabled(on)
        metrics.reset()
        for _ in range(1000):
            with metrics.span("exec.wait", rid="q#1"):
                pass
        t0 = time.perf_counter_ns()
        for _ in range(n):
            with metrics.span("exec.wait", rid="q#1"):
                pass
        out["on" if on else "off"] = (time.perf_counter_ns() - t0) / n
    metrics.reset()
    metrics.set_enabled(None)
    return {"site_ns": out}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", default="tpcds_serve_sf1")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--seconds", type=float, default=51)
    ap.add_argument("--mode", choices=("off", "metrics", "profiler"),
                    default="off")
    ap.add_argument("--sites", action="store_true")
    args = ap.parse_args(argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import torch
    if not torch.cuda.is_available():
        print("torch_trace_cost: no CUDA device", file=sys.stderr)
        return 1
    if args.sites:
        line = site_ns()
        line["card"] = torch.cuda.get_device_name(0)
    else:
        line = run_one(args.workload, args.seed, args.seconds, args.mode)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
