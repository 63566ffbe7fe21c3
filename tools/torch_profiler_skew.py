#!/usr/bin/env python3
"""Which device rows ``torch.profiler`` drops on the card, and how that
changes over a process's life.

    python3 tools/torch_profiler_skew.py [--minutes M] [--every S]

Builds the port's kernels, then every ``S`` seconds for ``M`` minutes
profiles windows of REPS calls each of B7 (``u8_to_u32``, 48 MB of words
from a 256 MiB byte buffer) and of ``clone().view``, the library call
``chip_smoke.py`` times beside it, each call after a 128 MiB L2 flush as
``chip_smoke.device_ms`` makes it, in three forms: as they stand
(``bare``), with ``PAD_S`` of host sleep before the calls and after the
closing synchronize (``pad``), and as ``chip_smoke.profile_window``
takes a window (``prelude``: ``PAD_S`` of sleep, then PRELUDE flushes,
then the calls).  For each window it reads the profiler's raw records
(``kineto_results``) and reports:

* ``kept``: the timed function's device rows with a positive duration
  in ``prof.events()``, what ``chip_smoke.device_ms`` counts;
* ``raw``: its device records before torch's post-processing;
* ``missing``: the launches (runtime calls of the flushes and the
  function, in order) that have no device record, as index ranges;
* ``lead_us``: the median of a device record's start minus its
  launch's start (in real time never below zero, so a negative value is
  the device clock running behind the host's).

One JSON line a tick, then a summary line: windows short of rows by form
and function, and ``lead_us`` at the first and the last tick.

Needs one CUDA card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

import torch

REPS = 20
PAD_S = 0.05
SRC_BYTES = 256 << 20
START = 4
N_WORDS = 12_000_000
PRELUDE = 64
FORMS = ("bare", "pad", "prelude")
LAUNCHES = ("cudaLaunchKernel", "cudaMemcpyAsync")


def ranges(idx: list) -> list:
    out = []
    for i in idx:
        if out and out[-1][1] == i - 1:
            out[-1][1] = i
        else:
            out.append([i, i])
    return out


def window(fn, symbol: str, flush, form: str) -> dict:
    from torch.profiler import ProfilerActivity, profile
    pad = 0.0 if form == "bare" else PAD_S
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(pad)
        for _ in range(PRELUDE if form == "prelude" else 0):
            flush()
        for _ in range(REPS):
            flush()
            fn()
        torch.cuda.synchronize()
        if form == "pad":
            time.sleep(pad)
    kept = sum(1 for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and symbol in e.name and e.time_range.end > e.time_range.start)
    raw = prof.profiler.kineto_results.events()
    dev = {}
    for e in raw:
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            dev.setdefault(e.correlation_id(), []).append(e)
    launches = sorted((e for e in raw
                       if e.device_type() == torch.autograd.DeviceType.CPU
                       and any(n in e.name() for n in LAUNCHES)),
                      key=lambda e: e.start_ns())
    missing = [i for i, e in enumerate(launches)
               if e.correlation_id() not in dev]
    leads = [(d.start_ns() - e.start_ns()) / 1e3 for e in launches
             for d in dev.get(e.correlation_id(), ())]
    return {"kept": kept,
            "raw": sum(1 for ds in dev.values() for d in ds
                       if symbol in d.name()),
            "launches": len(launches), "missing": ranges(missing),
            "lead_us": statistics.median(leads) if leads else None}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--minutes", type=float, default=8.0)
    ap.add_argument("--every", type=float, default=15.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from spark_rapids_jni_tpu_torch import _native
    from spark_rapids_jni_tpu_torch.rowconv import bytepath
    t0 = time.perf_counter()
    _native.build()
    gen = torch.Generator(device="cuda").manual_seed(0)
    src = torch.randint(0, 256, (SRC_BYTES,), dtype=torch.uint8,
                        device="cuda", generator=gen)
    buf = torch.zeros(128 << 20, dtype=torch.uint8, device="cuda")

    def flush():
        buf.view(-1, 1024).amax(dim=1)

    cases = {
        "u8_to_u32": (lambda: bytepath.u8_to_u32(src, START, N_WORDS),
                      "u8_to_u32_kernel"),
        "clone": (lambda: src[START:START + 4 * N_WORDS].clone()
                  .view(torch.int32), "Memcpy"),
    }
    for fn, _ in cases.values():
        fn()
    torch.cuda.synchronize()
    print(f"[skew] built and ready in {time.perf_counter() - t0:.1f} s; "
          f"{torch.cuda.get_device_name(0)} torch {torch.__version__}",
          flush=True)
    start = time.perf_counter()
    ticks = []
    sessions = 0
    while True:
        t = time.perf_counter() - start
        tick = {"t_s": round(t, 1), "sessions": sessions}
        for name, (fn, symbol) in cases.items():
            for form in FORMS:
                tick[f"{name}/{form}"] = window(fn, symbol, flush, form)
                sessions += 1
        ticks.append(tick)
        print(json.dumps(tick), flush=True)
        if t >= args.minutes * 60:
            break
        time.sleep(max(0.0, args.every - (time.perf_counter() - start - t)))
    keys = [k for k in ticks[0] if "/" in k]
    summary = {
        "ticks": len(ticks), "sessions": sessions, "reps": REPS,
        "pad_s": PAD_S,
        "short_windows": {k: sum(1 for x in ticks if x[k]["kept"] < REPS)
                          for k in keys},
        "lead_us_first": {k: ticks[0][k]["lead_us"] for k in keys},
        "lead_us_last": {k: ticks[-1][k]["lead_us"] for k in keys},
        "card": torch.cuda.get_device_name(0)}
    print("[skew] summary " + json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
