#!/usr/bin/env python3
"""B3's and B4's threads an item against the alternatives, on one GPU.

    python3 tools/torch_bench_ragged.py [--seed N] [--reps N]

``csrc/ragged.cu`` gives each row (B3, unpack) or segment (B4, segmented
copy) a power-of-two group of threads that covers the mean item in 16-byte
chunks (``log_group``).  This script builds the source as it stands and
three variants in which ``log_group`` gives one thread an item, or covers
32 or 64 bytes a thread, and times each build's C entries on inputs shaped
as the main path hands them to the kernels (from numpy, with ``--seed``):

* B4: the 12-column table's to_rows chars (1,048,576 rows, two strings of
  0-39 chars, 10% nulls, rows of 81 bytes) and from_rows chars (column
  after column out of the rows); SF1 ``l_comment``'s PLAIN prefix strip
  (6,001,215 strings of 10-43 chars behind 4-byte prefixes); five strings
  of 1-17 chars into 6,001,215 rows of 146 bytes, the shape of SF1's
  16-column to_rows;
* B3: the fixed region of JCUDF rows (M = 47 out of the 12-column rows;
  M = 110 out of 6,001,215 SF1-wide rows) and one string column of 0-39
  chars into rows of 40 bytes.

Each time is the median of ``--reps`` calls, each timed alone by CUDA
events after a 128 MB read that flushes L2, the builds taken in turns
(in order, then in reverse).  Every variant's output must equal the
source's.  Prints one line an input, with the card's name and power
limit.  Needs a CUDA device and ``nvcc``; imports the port, never JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import shutil
import statistics
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "build", "torch_bench_ragged")
GROUP = "inline int log_group(int64_t bytes) {"
CHUNKS = "const int64_t chunks = (bytes + kChunk - 1) / kChunk;"
FLUSH_BYTES = 128 << 20


def variants(source: str) -> dict:
    """The source as it stands and its three variants of log_group."""
    for marker in (GROUP, CHUNKS):
        if marker not in source:
            raise SystemExit(f"csrc/ragged.cu no longer holds {marker!r}")
    out = {"16 B a thread (source)": source,
           "one thread an item": source.replace(GROUP,
                                                GROUP + "\n  return 0;")}
    for b in (32, 64):
        out[f"{b} B a thread"] = source.replace(
            CHUNKS, f"const int64_t chunks = (bytes + {b} - 1) / {b};")
    return out


def build(native, sources: dict) -> dict:
    """Compiles every source at once with the port's nvcc flags; returns
    the loaded libraries by name."""
    os.makedirs(OUT, exist_ok=True)
    jobs = {}
    for i, (name, text) in enumerate(sources.items()):
        cu, so = (os.path.join(OUT, f"v{i}.{ext}") for ext in ("cu", "so"))
        with open(cu, "w") as fh:
            fh.write(text)
        nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
        cmd = [nvcc, *native.NVCC_FLAGS, "-o", so, cu]
        jobs[name] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT,
                                           text=True))
    libs = {}
    for name, (so, proc) in jobs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"{name}: nvcc exited {proc.returncode}\n{out}")
        lib = ctypes.CDLL(so)
        for fn, argtypes in native.SIGNATURES["ragged"].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        lib.srjt_error_string.argtypes = (ctypes.c_int,)
        lib.srjt_error_string.restype = ctypes.c_char_p
        libs[name] = lib
    return libs


def _starts(sizes, gaps=0):
    step = np.asarray(sizes, np.int64) + gaps
    return np.cumsum(step) - step


def segment_inputs(rng) -> dict:
    """(src, src_offs, dst_offs, sizes, dst_size) in numpy, by name."""
    out = {}
    n = 1 << 20
    lens = rng.integers(0, 40, (2, n)) * (rng.random((2, n)) >= 0.1)
    out["B4 12-column to_rows"] = _into_rows(rng, lens, 81)
    rows = (47 + lens.sum(0) + 7) // 8 * 8
    so = (_starts(rows)[None, :] + 47 + np.cumsum(lens, 0) - lens)
    sizes = lens.reshape(-1)
    out["B4 12-column from_rows"] = (
        rng.integers(1, 256, rows.sum(), dtype=np.uint8), so.reshape(-1),
        _starts(sizes), sizes, int(sizes.sum()))
    sizes = rng.integers(10, 44, 6_001_215)
    out["B4 SF1 l_comment strip"] = (
        rng.integers(1, 256, sizes.sum() + 4 * sizes.size + 13,
                     dtype=np.uint8),
        _starts(sizes, 4) + 13, _starts(sizes), sizes, int(sizes.sum()))
    out["B4 SF1-wide to_rows"] = _into_rows(
        rng, rng.integers(1, 18, (5, 6_001_215)), 146)
    return out


def _into_rows(rng, lens, width):
    """Chars of len(lens) string columns into rows of ``width`` bytes."""
    base = np.concatenate([[0], np.cumsum(lens.sum(1))[:-1]])
    so = np.stack([_starts(col) + b for col, b in zip(lens, base)])
    do = np.arange(lens.shape[1])[None, :] * width + np.cumsum(lens, 0) - lens
    return (rng.integers(1, 256, lens.sum(), dtype=np.uint8),
            so.T.reshape(-1), do.T.reshape(-1), lens.T.reshape(-1),
            lens.shape[1] * width)


def unpack_inputs(rng) -> dict:
    """(flat, offsets, M) in numpy, by name."""
    out = {}
    for name, M, sizes in (
            ("B3 12-column fixed region", 47,
             rng.integers(6, 16, 1 << 20) * 8),
            ("B3 SF1-wide fixed region", 110,
             rng.integers(14, 30, 6_001_215) * 8),
            ("B3 one string into rows", 40, rng.integers(0, 40, 1 << 20))):
        offs = np.zeros(sizes.size + 1, np.int64)
        np.cumsum(sizes, out=offs[1:])
        out[name] = (rng.integers(1, 256, offs[-1], dtype=np.uint8), offs, M)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from spark_rapids_jni_tpu_torch import _native
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    with open(os.path.join(_native.CSRC, "ragged.cu")) as fh:
        libs = build(_native, variants(fh.read()))
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    flush = torch.zeros(FLUSH_BYTES, dtype=torch.uint8, device=dev)
    rng = np.random.default_rng(args.seed)

    def on_card(arrays):
        return [torch.from_numpy(np.ascontiguousarray(
                    a, np.uint8 if i == 0 else np.int64)).to(dev)
                if isinstance(a, np.ndarray) else a
                for i, a in enumerate(arrays)]

    def segcopy(lib, src, so, do, sizes, dst_size):
        out = torch.empty(dst_size, dtype=torch.uint8, device=dev)
        _native.check(lib, lib.srjt_segmented_copy(
            src.data_ptr(), src.numel(), so.data_ptr(), do.data_ptr(),
            sizes.data_ptr(), sizes.numel(), out.data_ptr(), dst_size,
            stream), "srjt_segmented_copy")
        return out

    def unpack(lib, flat, offs, M):
        out = torch.empty((offs.numel() - 1, M), dtype=torch.uint8,
                          device=dev)
        _native.check(lib, lib.srjt_unpack_rows(
            flat.data_ptr(), flat.numel(), offs.data_ptr(), offs.numel() - 1,
            M, out.data_ptr(), stream), "srjt_unpack_rows")
        return out

    def time_one(fn) -> float:
        times = []
        for _ in range(args.reps):
            flush.view(-1, 1024).amax(dim=1)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)

    cases = [(name, segcopy, a) for name, a in segment_inputs(rng).items()]
    cases += [(name, unpack, a) for name, a in unpack_inputs(rng).items()]
    names = list(libs)
    for what, call, arrays in cases:
        inputs = on_card(arrays)
        want = call(libs[names[0]], *inputs)
        times = {name: [] for name in names}
        for order in (names, names[::-1]):
            for name in order:
                got = call(libs[name], *inputs)
                if not torch.equal(got, want):
                    raise SystemExit(f"{what}: {name} differs from the source")
                del got
                times[name].append(time_one(
                    lambda: call(libs[name], *inputs)))
        print(f"[bench] {what}: " + "; ".join(
            f"{name} {', '.join(f'{t:.4f}' for t in ts)} ms"
            for name, ts in times.items()) + f" [{card}]", flush=True)
        del inputs, want
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
