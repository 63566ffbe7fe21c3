#!/usr/bin/env python3
"""B1's way of building its output range, and two choices around it, timed
on one GPU.

    python3 tools/torch_bench_xpack.py [--seed N] [--reps N]

1. B1 (``csrc/xpack.cu``) brings each CTA's run of rows and their offsets
   into shared memory in one round trip, builds the run's output range
   there and stores it in 16-byte chunks.  This script builds the source as
   it stands and three variants: a tile of 8 KiB instead of 16; the rows'
   payload loaded after their offsets arrive, sized by them, instead of
   whole rows with the offsets; and no tile at all, every run on the
   kernel's direct path (a group of threads a row copying straight from the
   row matrix to the output).  It times each, and B2 (``csrc/ragged.cu``)
   on the same rows as bytes, on rows shaped as to_rows hands them to B1:
   the 12-column table (1,048,576 rows of 47 fixed bytes and two strings of
   0-39 chars, 10% nulls, M = 128), ``var_155_16str`` (1,048,576 rows of
   720 fixed bytes and 16 strings of 0-9 chars, M = 896) and SF1
   lineitem's 16 columns (6,001,215 rows, 118 fixed bytes and five strings
   of lineitem's lengths, M = 192).
2. One string column's chars into the row matrix: B3 into a separate
   [n, M - fixed] tile (the route before the matrix was built in place,
   which then needed a concatenate) against B4 at a row stride into
   [n, M], 1,048,576 strings of 0-39 chars; and ``convert_to_rows`` of a
   table of that string column and an INT64 one, whichever route the tree
   takes.
3. B5 on a large dictionary (1,048,576 entries of 10-43 chars, l_comment's
   lengths, rows of 48 bytes as ``DictColumn.materialize`` pads them)
   against B3's kernel at the same width, which computes the same bytes:
   B5's wrapper with device offsets, or, in a tree whose ``csrc/
   bytepath.cu`` still has B5's own kernel (``srjt_extract_rows``), that
   kernel's C entry.
4. B5's wrapper on the host: the host microseconds a call of it takes on
   SF1's largest dictionary shape (25 entries, rows of 32 bytes), and of
   the steps of its launch path, each the mean of 2,000 calls back to
   back (device work queued, not waited for).

``--parts`` picks the parts to run (default all: ``1234``); parts 2 and 3
also run in a tree with the earlier B1 and B5.

Each time is the median of ``--reps`` calls, each timed alone by CUDA
events after a 128 MB read that flushes L2, the candidates taken in turns
(in order, then in reverse).  Candidates of one input must give equal
bytes.  Prints one line an input, with the card's name and power limit.
Needs a CUDA device and ``nvcc``; imports the port, never JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "build", "torch_bench_xpack")
FLUSH_BYTES = 128 << 20
KERNEL = "template <int W>\n__global__ void __launch_bounds__(kThreads)\n" \
         "pack_windows_kernel("
END = "}  // namespace"

# the variants' edits of csrc/xpack.cu: (text in the source, replacement)
TILE = ("constexpr int64_t kTileBytes = 16 * 1024;",
        "constexpr int64_t kTileBytes = 8 * 1024;")
WHOLE_ROWS = ("""    for (int64_t v = threadIdx.x; v < rows * Mw / 4; v += kThreads) {
      cp_async16(s_tile + 4 * v, src + 4 * v);
    }
""", "")
PAYLOAD_ROWS = ("""  cp_async_wait_all();
  __syncthreads();
  const int64_t o0 = s_offs[0];""", """  cp_async_wait_all();
  __syncthreads();
  if (tiled) {
    const int lane = threadIdx.x & ((1 << log_g) - 1);
    for (int i = threadIdx.x >> log_g; i < rows; i += kThreads >> log_g) {
      const int64_t size = s_offs[i + 1] - s_offs[i];
      const int64_t len = size < Mw ? size : Mw;
      for (int64_t k = 4 * lane; k < len; k += 4 << log_g) {
        cp_async16(s_tile + i * Mw + k, src + i * Mw + k);
      }
    }
    cp_async_wait_all();
    __syncthreads();
  }
  const int64_t o0 = s_offs[0];""")
DIRECT_ONLY = r"""template <int W>
__global__ void __launch_bounds__(kThreads)
pack_windows_kernel(const uint32_t* __restrict__ dense, int64_t n, int64_t Mw,
                    const int64_t* __restrict__ dst_w, int per_cta, int log_g,
                    uint32_t* __restrict__ out, int64_t total_w) {
  __shared__ int64_t s_offs[kMaxRows + 1];
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * per_cta;
  const int rows = static_cast<int>(n - r0 < per_cta ? n - r0 : per_cta);
  for (int i = threadIdx.x; i <= rows; i += kThreads) {
    cp_async8(s_offs + i, dst_w + r0 + i);
  }
  cp_async_wait_all();
  __syncthreads();
  copy_rows<W>(dense + r0 * Mw, rows, Mw, s_offs, log_g, out, total_w);
  zero_edges(s_offs, rows, out, total_w, W == 4);
}

"""


def variants(source: str) -> dict:
    """The source as it stands and its three variants."""
    for text, _ in (TILE, WHOLE_ROWS, PAYLOAD_ROWS):
        if text not in source:
            raise SystemExit(f"csrc/xpack.cu no longer holds {text!r}")
    if KERNEL not in source:
        raise SystemExit("csrc/xpack.cu no longer holds the kernel template")
    a = source.index(KERNEL)
    b = source.index(END, a)
    return {
        "16 KiB tile, whole rows (source)": source,
        "8 KiB tile": source.replace(*TILE),
        "payload after offsets": source.replace(*WHOLE_ROWS).replace(
            *PAYLOAD_ROWS),
        "direct path only": source[:a] + DIRECT_ONLY + source[b:]}


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
        print(f"[build] {name}: " + " | ".join(
            line.strip() for line in out.splitlines()
            if "registers" in line or "smem" in line), flush=True)
        lib = ctypes.CDLL(so)
        for fn, argtypes in native.SIGNATURES["xpack"].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        lib.srjt_error_string.argtypes = (ctypes.c_int,)
        lib.srjt_error_string.restype = ctypes.c_char_p
        libs[name] = lib
    return libs


# SF1 lineitem's string lengths: l_returnflag, l_linestatus, l_shipinstruct
# and l_shipmode (their dictionaries), l_comment (10-43 chars)
SHIPINSTRUCT = (17, 11, 4, 16)
SHIPMODE = (7, 3, 4, 4, 5, 4, 3)


def row_inputs(rng, gen, dev) -> dict:
    """(dense words [n, Mw] int32, word offsets int64 [n+1], total words)
    on the card, by name: rows of a table's fixed bytes and its chars
    padded to 8 bytes, random words up to each row's size."""
    def rows(fixed, chars, M):
        sizes = (fixed + chars + 7) // 8 * 8
        assert sizes.max() <= M
        offs = np.zeros(sizes.size + 1, np.int64)
        np.cumsum(sizes // 4, out=offs[1:])
        n, Mw = sizes.size, M // 4
        dense = torch.randint(-2**31, 2**31 - 1, (n, Mw), dtype=torch.int32,
                              device=dev, generator=gen)
        w = torch.from_numpy(sizes // 4).to(dev)
        dense[torch.arange(Mw, device=dev)[None, :] >= w[:, None]] = 0
        return dense, torch.from_numpy(offs).to(dev), int(offs[-1])

    n = 1 << 20
    valid = rng.random((2, n)) >= 0.1
    twelve = (rng.integers(0, 40, (2, n)) * valid).sum(0)
    valid = rng.random((16, n)) >= 0.1
    wide = (rng.integers(0, 10, (16, n)) * valid).sum(0)
    m = 6_001_215
    sf1 = (2 + np.array(SHIPINSTRUCT)[rng.integers(0, 4, m)]
           + np.array(SHIPMODE)[rng.integers(0, 7, m)]
           + rng.integers(10, 44, m))
    return {"12-column to_rows": lambda: rows(47, twelve, 128),
            "var_155_16str to_rows": lambda: rows(720, wide, 896),
            "SF1 16-column to_rows": lambda: rows(118, sf1, 192)}


def one_string_routes(rng, dev, compare, time_one, card) -> None:
    """One string column into the row matrix: B3 into a tile, or B4 in
    place; and to_rows of a one-string table."""
    import spark_rapids_jni_tpu_torch as pt
    from spark_rapids_jni_tpu_torch import interop
    from spark_rapids_jni_tpu_torch.rowconv import ragged
    n, fixed, M = 1 << 20, 16, 64
    lens = rng.integers(0, 40, n) * (rng.random(n) >= 0.1)
    offs = np.zeros(n + 1, np.int64)
    np.cumsum(lens, out=offs[1:])
    chars = torch.from_numpy(rng.integers(32, 127, offs[-1], dtype=np.uint8)
                             ).to(dev)
    offs, lens = (torch.from_numpy(a).to(dev) for a in (offs, lens))
    dst = torch.arange(n, device=dev) * M + fixed
    compare(f"one string column into rows ({n} rows of 0-39 chars, M = {M})",
            {"B3 into a [n, M - fixed] tile":
             lambda: ragged.unpack_rows(chars, offs, M - fixed),
             "B4 at a row stride into [n, M]":
             lambda: ragged.segmented_copy(chars, offs[:-1], dst, lens,
                                           n * M).view(n, M)[:, fixed:]})
    host = [np.ascontiguousarray(t.cpu().numpy()) for t in (chars, offs)]
    table = interop.table_from_numpy(
        [(int(pt.TypeId.STRING), 0, host[0], host[1].astype(np.int32), None),
         (int(pt.TypeId.INT64), 0, rng.integers(-99, 99, n), None, None)],
        device=dev)
    ms = [time_one(lambda: pt.convert_to_rows(table)) for _ in range(2)]
    print(f"[bench] to_rows of a one-string table ({n} rows, a string of "
          f"0-39 chars and an INT64): {', '.join(f'{t:.4f}' for t in ms)} "
          f"ms [{card}]", flush=True)


def large_dictionary(native, rng, dev, stream, compare) -> None:
    """B5 on a large dictionary, and B3's kernel on the same input."""
    from spark_rapids_jni_tpu_torch.rowconv import bytepath, ragged
    D, M = 1 << 20, 48
    lens = rng.integers(10, 44, D)
    offs = np.zeros(D + 1, np.int64)
    np.cumsum(lens, out=offs[1:])
    flat = torch.from_numpy(rng.integers(32, 127, offs[-1], dtype=np.uint8)
                            ).to(dev)
    offs = torch.from_numpy(offs).to(dev)
    calls = {}
    if "srjt_extract_rows" in native.SIGNATURES["bytepath"]:
        lib = native.library("bytepath")

        def own_kernel():
            out = torch.empty((D, M // 4), dtype=torch.int32, device=dev)
            native.check(lib, lib.srjt_extract_rows(
                flat.data_ptr(), flat.numel(), offs.data_ptr(), D, M, M // 4,
                out.data_ptr(), stream), "srjt_extract_rows")
            return out
        calls["B5's own kernel"] = own_kernel
    else:
        calls["B5 extract_rows"] = lambda: bytepath.extract_rows(flat, offs, M)
    calls["B3 unpack_rows"] = lambda: ragged.unpack_rows(
        flat, offs, M).view(torch.int32)
    compare(f"dictionary extract ({D} entries of 10-43 chars, M = {M})",
            calls)


def host_path(native, bytepath, rng, dev, stream, card) -> None:
    """Host microseconds a call of B5's wrapper and of its launch steps."""
    D, M, calls = 25, 32, 2000
    lens = rng.integers(3, 18, D)
    offs = np.zeros(D + 1, np.int64)
    np.cumsum(lens, out=offs[1:])
    flat = torch.from_numpy(rng.integers(32, 127, offs[-1], dtype=np.uint8)
                            ).to(dev)
    doffs = torch.from_numpy(offs).to(dev)
    lib = native.library("ragged")
    out = torch.empty((D, M), dtype=torch.uint8, device=dev)

    def device_context():
        with torch.cuda.device(dev):
            pass

    def c_entry():
        native.check(lib, lib.srjt_unpack_rows(
            flat.data_ptr(), flat.numel(), doffs.data_ptr(), D, M,
            out.data_ptr(), stream), "srjt_unpack_rows")

    steps = {
        "extract_rows, device offsets":
            lambda: bytepath.extract_rows(flat, doffs, M),
        "extract_rows, host offsets":
            lambda: bytepath.extract_rows(flat, offs, M),
        "_native.launch": lambda: native.launch(
            "ragged", "srjt_unpack_rows", dev, flat.data_ptr(), flat.numel(),
            doffs.data_ptr(), D, M, out.data_ptr()),
        "C entry by ctypes": c_entry,
        "torch.cuda.current_stream": lambda: torch.cuda.current_stream(
            dev).cuda_stream,
        "raw current stream": lambda: torch._C._cuda_getCurrentRawStream(
            torch.cuda.current_device()),
        "torch.cuda.device context": device_context,
        "torch.empty": lambda: torch.empty((D, M), dtype=torch.uint8,
                                           device=dev),
    }
    res = {}
    for name, fn in steps.items():
        for _ in range(100):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        res[name] = (time.perf_counter() - t0) / calls * 1e6
        torch.cuda.synchronize()
    print("[bench] B5 wrapper on the host, us a call: " + "; ".join(
        f"{name} {us:.2f}" for name, us in res.items()) + f" [{card}]",
        flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--parts", default="1234")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from spark_rapids_jni_tpu_torch import _native
    from spark_rapids_jni_tpu_torch.rowconv import bytepath, ragged
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    flush = torch.zeros(FLUSH_BYTES, dtype=torch.uint8, device=dev)
    rng = np.random.default_rng(args.seed)
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)

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

    def compare(what, calls: dict) -> None:
        """Equal outputs, then each call timed twice, in turns."""
        names = list(calls)
        want = calls[names[0]]()
        times = {name: [] for name in names}
        for order in (names, names[::-1]):
            for name in order:
                if not torch.equal(calls[name](), want):
                    raise SystemExit(f"{what}: {name} differs from "
                                     f"{names[0]}")
                times[name].append(time_one(calls[name]))
        print(f"[bench] {what}: " + "; ".join(
            f"{name} {', '.join(f'{t:.4f}' for t in ts)} ms"
            for name, ts in times.items()) + f" [{card}]", flush=True)
        del want
        torch.cuda.empty_cache()

    def pack_windows(lib, dense, dst, total_w):
        def call():
            out = torch.empty(total_w, dtype=torch.int32, device=dev)
            _native.check(lib, lib.srjt_pack_windows(
                dense.data_ptr(), dense.shape[0], dense.shape[1],
                dst.data_ptr(), out.data_ptr(), total_w, stream),
                "srjt_pack_windows")
            return out
        return call

    if "1" in args.parts:
        with open(os.path.join(_native.CSRC, "xpack.cu")) as fh:
            libs = build(_native, variants(fh.read()))
    for what, make in (row_inputs(rng, gen, dev).items()
                       if "1" in args.parts else ()):
        dense, dst, total_w = make()
        calls = {name: pack_windows(lib, dense, dst, total_w)
                 for name, lib in libs.items()}
        b2 = (dense.view(torch.uint8), dst * 4, total_w * 4)
        calls["B2 pack_rows"] = lambda: ragged.pack_rows(*b2).view(torch.int32)
        compare(f"B1 {what} ({dense.shape[0]} rows, M = "
                f"{4 * dense.shape[1]})", calls)
        del dense, dst, b2, calls

    if "2" in args.parts:
        one_string_routes(rng, dev, compare, time_one, card)
    if "3" in args.parts:
        large_dictionary(_native, rng, dev, stream, compare)
    if "4" in args.parts:
        host_path(_native, bytepath, rng, dev, stream, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
