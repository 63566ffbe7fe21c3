#!/usr/bin/env python3
"""Where the time of the PyTorch port's row conversion goes, on one GPU.

    python3 tools/torch_profile_rowconv.py [--seed N] [--out DIR]

For each table of ``chip_smoke.py`` (212 fixed-width columns; 12 columns
with 2 strings; 155 columns with 16 strings), after one warm-up, profiles
one ``convert_to_rows`` and one ``convert_from_rows`` with ``torch.profiler``
and prints the host wall time, the device-busy time (the union of the
kernels' intervals), the device's idle share of the wall time, what the
call asked of the device (kernels, memsets and copies each way, by their
device rows; a copy to the host is a synchronisation, and so is each
stream synchronisation the host made), and the device ops that took the
most time.  The full per-op tables go to
``DIR/torch_profile_rowconv.txt`` (default ``build/profiles``).  Needs a CUDA
device; imports the port, never JAX.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOP = 8
# kernel names are C++ signatures; the start is enough to tell them apart
NAME_CHARS = 48


def _busy_us(prof) -> float:
    """Union of the device kernels' intervals, in microseconds."""
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy


def _device_work(prof) -> str:
    """Kernels, memsets and copies the call ran on the device, and the
    host's stream synchronisations."""
    counts = {"kernels": 0, "memsets": 0, "HtoD": 0, "DtoH": 0, "DtoD": 0,
              "syncs": 0}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            name = e.name
            if name.startswith("Memset"):
                counts["memsets"] += 1
            elif name.startswith("Memcpy"):
                for way in ("HtoD", "DtoH", "DtoD"):
                    if way in name:
                        counts[way] += 1
            else:
                counts["kernels"] += 1
        elif e.name in ("cudaStreamSynchronize", "cudaDeviceSynchronize"):
            counts["syncs"] += 1
    return ", ".join(f"{k} {v}" for k, v in counts.items())


def _device_total(avg) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(avg, attr):
            return getattr(avg, attr)
    return 0.0


def profile_call(fn):
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    return prof, wall_us


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "profiles"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke
    import spark_rapids_jni_tpu_torch as pt
    from spark_rapids_jni_tpu_torch import _native, interop
    from spark_rapids_jni_tpu_torch import types as T

    _native.build()
    os.makedirs(args.out, exist_ok=True)
    report = os.path.join(args.out, "torch_profile_rowconv.txt")
    chip_smoke.phase_device()
    with open(report, "w") as fh:
        for ci, (case, (n_cols, every, max_len)) in enumerate(
                chip_smoke.CASES.items()):
            rng = np.random.default_rng(args.seed + ci)
            table = interop.table_from_numpy(chip_smoke.make_columns(
                T, n_cols, every, max_len, chip_smoke.ROWS, rng),
                device="cuda")
            batch = pt.convert_to_rows(table)[0]
            pt.convert_from_rows(batch, table.schema)      # warm-up
            for direction, fn in (
                    ("to_rows", lambda: pt.convert_to_rows(table)),
                    ("from_rows", lambda: pt.convert_from_rows(
                        batch, table.schema))):
                prof, wall = profile_call(fn)
                busy = _busy_us(prof)
                avgs = sorted(prof.key_averages(), key=_device_total,
                              reverse=True)
                top = ", ".join(
                    f"{a.key[:NAME_CHARS]} {_device_total(a) / 1e3:.3f} ms "
                    f"x{a.count}" for a in avgs[:TOP] if _device_total(a) > 0)
                print(f"[profile] {case} {direction}: wall {wall / 1e3:.3f} ms,"
                      f" device busy {busy / 1e3:.3f} ms, idle share "
                      f"{1 - busy / wall:.3f}; device work: "
                      f"{_device_work(prof)}; top device ops: {top}",
                      flush=True)
                fh.write(f"== {case} {direction} ==\n")
                fh.write(prof.key_averages().table(
                    sort_by="self_device_time_total", row_limit=40))
                fh.write("\n")
            del table, batch
            torch.cuda.empty_cache()
    print(f"[profile] per-op tables in {report}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
