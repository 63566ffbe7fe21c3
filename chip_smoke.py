#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Drives the port's main paths, JCUDF row ↔ column conversion, the
device Parquet scan and the queries on it (TPC-H Q6 and Q1, the 50
TPC-DS queries, eager and compiled to CUDA graphs, the Mortgage ETL,
TPC-DS as SQL text and plan trees through the planner, those queries
and texts served to concurrent clients by the serving runtime, the
Mortgage ETL trained on and served, views refreshed over appended files,
per-node profiles, persisted tapes, adaptive execution, the repartition
join, the arena, the fault shim, Arrow), through their public entry points
on the card, and fails (non-zero exit, no result line) if anything is
wrong:

1. device: the card's name, count, and ``nvidia-smi`` name and power limit;
   no CUDA device is a failure;
2. build: compiles the CUDA kernels, the host walker and decompressor, and
   the JVM-facing library (host tables, the host JCUDF and footer engines,
   the JNI natives, the trampoline to ``bridge.py``) from
   ``spark_rapids_jni_tpu_torch/csrc``, all at once;
3. kernels: runs B1, B3 and B4 on the inputs the row path hands them
   (captured from a run of the 12-column table, to_rows and from_rows),
   holds each byte for byte against its plain PyTorch version, and times
   both with CUDA events (around the wrappers) and the kernel with
   ``torch.profiler`` (its device rows alone, and a zero-fill its wrapper
   adds; the library calls of phase 7 likewise), beside its bound and, for
   B1-B5, its sector floor (every 32-byte sector holding payload read
   whole); B2 is timed once on B1's rows too, the choice the routing rule
   made;
4. path: ``convert_to_rows`` → ``convert_from_rows`` round trips of three
   tables from the reference's row-conversion benchmark at 1,048,576 rows
   (212 fixed-width columns; 12 columns with 2 strings of 0-39 chars;
   155 columns with 16 strings of 0-9 chars), each required to give back
   every column exactly, its first 10,000 rows held against the numpy
   oracle, and the kernel launch counts read around each run; for each
   table with strings, B1 and B2 timed on the rows its to_rows packs;
5. scan: TPC-H SF1 lineitem with all 16 columns (6,001,215 rows, row
   groups of 1,048,576 rows, 1 MiB pages, ``l_comment`` PLAIN, written by
   ``tools/torch_lineitem_parquet.py``); the device Parquet scan
   (``parquet.device_scan.scan_table``) of its first 15 columns, as
   earlier runs scanned them, timed, every row of every column required
   equal to the generator's arrays, dictionary strings materialized and
   held likewise; 5b: a 15-column file of 1,048,576 rows, OPTIONAL
   columns with 10% nulls, 4 row groups and 2 pages a chunk, exact
   likewise;
6. Q6 and rows: ``models.q6.run`` on the SF1 file against numpy and
   ``math.fsum``, then the scanned 15-column table through
   ``convert_to_rows`` → ``convert_from_rows``, exact, its first 10,000
   rows held against the numpy oracle;
7. scan kernels: B2 and B5–B7 on the largest inputs the scan and the
   materialization hand them, each held byte for byte against its plain
   version and timed with CUDA events beside one PyTorch call that
   computes the same function, where there is one; B2's and B5's sector
   floors beside their bounds; B5 also on a large dictionary (1,048,576
   entries of 10-43 chars, ``l_comment``'s lengths); B7 and
   ``clone().view`` on the same bytes at every start % 4 and a 16-aligned
   start, each exact;
8. full table: the scan of all 16 columns, timed, ``l_comment`` equal to
   the generator's chars row for row, then the table through
   ``convert_to_rows`` → ``convert_from_rows`` in one batch (about 1 GB of
   rows), exact, its first 10,000 rows held against the numpy oracle.
   This path launches every kernel, B1–B7;
9. SF1 copies: B1, B3 and B4 on the largest input each caller hands them
   on the 16 columns (the ``l_comment`` prefix strip; to_rows, B4's chars
   into the row matrix and B1's pack of it; from_rows), exact against
   their plain versions (run on pieces of the input where the whole would
   not fit) and timed as in phase 3;
10. Q1: TPC-H SF1 lineitem in Q1's layout (6,001,215 rows, the flags as
   dictionary strings, ``l_extendedprice`` FLBA DECIMAL(12,2) PLAIN,
   ``l_discount`` and ``l_tax`` FLBA DECIMAL(4,2) dictionary-encoded;
   ``tools/torch_lineitem_parquet.py``), ``models.tpch_q1.run`` on it with
   the cutoff 1998-12-01 minus 90 days, every output column held against
   an exact integer oracle from the generator's arrays (keys, counts,
   ``sum_qty`` and the three money sums as unscaled integers; the means
   to a relative 1e-12), timed as the median wall of three calls; B3 and
   B4, which Q1 launches for its string keys, and B7, which its scan
   launches, held against their plain versions on the largest inputs Q1
   hands them and timed as in phase 3; then Q1 on a 1,048,576-row file
   with OPTIONAL columns and 10% nulls, exact the same way;
11. Spark's files: TPC-H SF1 lineitem, all 16 columns, as Spark's
   defaults write it (``SPARK_DEFAULTS`` of
   ``tools/torch_lineitem_parquet.py``: SNAPPY, every column
   dictionary-encoded with parquet-mr's fallback to PLAIN once a
   dictionary passes 1 MiB, 1 MiB pages of at most 20,000 rows; row
   groups of 1,048,576 rows as in phases 5-10, so that the walls
   compare): the scan of every column exact against the generator
   (strings materialized; each column's page runs printed), its median
   wall of three calls and GB/s beside phase 8's UNCOMPRESSED scan of the
   same rows, and one profiled call's split between the page walk (its
   decompression apart), the upload and the decode, with the device's
   idle share, on a line of its own; Q6 on it, exact as in phase 6;
   row-group pruning by ``l_orderkey`` (sorted) keeping exactly the groups
   the generator's own bounds reckon, their rows equal to the generator's,
   and a predicate that prunes every group giving zero rows of the same
   dtypes; B4 and B7 on the largest inputs this scan hands them, against
   their plain versions and timed as in phase 3.  11b: 1,048,576 rows as
   Spark's v2 writer writes them with timestamp dates (GZIP, DataPageV2,
   10% nulls, the dates INT96 and dictionary-encoded, DELTA_BINARY_PACKED
   and DELTA_BYTE_ARRAY fallbacks), exact;
12. the JNI/C surface (run after phase 9, on its file): SF1's 16 columns,
   strings materialized, as a C host table handle through
   ``srjt_to_rows_device`` (997,969,848 row bytes, equal to
   ``convert_to_rows``' and to the host C++ engine's ``srjt_to_rows``)
   and back through ``srjt_from_rows_device`` (every column exact), B1, B3
   and B4 launched; the RowConversion natives on phase 3's 12-column table
   through a ctypes JNIEnv, against the host engine, and
   ParquetFooter.readAndFilter on the SF1 footer, against ``footer.py``;
   the median walls of the device calls and of the host engine's, beside
   ``convert_to_rows`` / ``convert_from_rows``, and the device calls'
   split (handle read, upload, convert, download, import), on a
   ``[jni] split`` JSON line;
13. TPC-DS: the five tables of ``benchmarks/tpcds_data.generate``
   at 10,000,000 ``store_sales`` rows, 20,000 items and 50 stores
   (BASELINE config #3's SF1 scale), written by
   ``tools/torch_tpcds_parquet.py``; ``models.tpcds.load_tables`` timed;
   each of the 50 queries of ``models.tpcds.QUERIES`` (joins, grouping
   sets, windows, LIKE) with parameters picked from the data, its
   result held against the numpy oracle (``tools/torch_tpcds_oracle.py``:
   exact, float sums within a relative 1e-12 of the exact cents sums,
   deviations and ratios within 1e-11), the median wall of three calls
   after the first and the engine, key plan and fused path each join
   took (``ops.join_plan.COUNTS``); q3's joins with each engine pinned,
   identical; q3, q_channel_day, q36_rollup and q27_cube profiled
   (device busy, idle share, largest device ops); the build-index
   cache's entries, bytes and evictions; B3, B4 and B7 on the largest
   inputs the phase hands them, against their plain versions and timed
   as in phase 3.  A ``[tpcds] summary`` JSON line holds the walls,
   paths and launches.
14. Mortgage ETL (BASELINE config #5): ``benchmarks/mortgage_data.
   generate``'s files at 1,000,000 loans x 12 periods (12,000,000
   performance rows in 12 row groups, 1,000,000 acquisitions, seed 11),
   written as pyarrow's defaults write them by
   ``tools/torch_mortgage_parquet.py``; ``models.mortgage.load_tables``
   and ``etl_tables`` timed (first call and median of three), each
   profiled after a warm-up; every feature column held against the numpy
   oracle (``tools/torch_mortgage_oracle.py``: exact, ``mean_upb`` within
   a relative 1e-12); each dictionary column's materialization timed;
   B2-B7 on the largest inputs the phase hands them, against their plain
   versions and timed as in phase 3, on a ``[mortgage] summary`` JSON
   line;
15. compiled TPC-DS (run right after phase 13, on its tables): each of
   the 50 queries through ``models.compiled.compile_query`` (an eager
   capture run recording the tape of sizes, then one CUDA graph captured
   under the tape's replay over private copies of the tables), its
   checked ``run`` held against the oracle with phase 13's tolerances
   and against the capture run's result (integers exact, floats within
   a relative 1e-12), ``run_unchecked`` under
   ``torch.cuda.set_sync_debug_mode("error")`` with the sync count
   unchanged, the medians of three walls of the graph, the checked run
   and the eager tape replay beside phase 13's eager median, the tape's
   length, the graph's capture ms, pool bytes and the B3, B4 and B7
   launches inside it (B3 and B4 must be in some graph; B7 runs in the
   scan only); then q3 compiled on tables of 1,000,000 ``store_sales``
   rows at seed 7 must raise ``StaleTapeError`` on tables of the same
   row counts at seed 77, and compiled there equal the oracle; on a
   ``[compiled] summary`` JSON line.
16. SQL and the planner (run last, on phase 13's tables and files): each
   of the 28 SQL texts of ``models.tpcds_sql`` through
   ``sql.compile_sql`` (phase 13's parameters where the query takes
   them, the corpus defaults otherwise), held against its twin: the
   hand-fused ``tpcds.QUERIES[name]`` for the 8 ``tpcds_plans`` queries,
   the hand tree run through ``plan.execute`` on a ``TableCatalog`` for
   the other 20 (their ``QUERIES`` namesakes are other queries): schema,
   validity, keys, integers and strings exactly, floats within a
   relative 1e-12 (a float sum's atomics add in any order on the card;
   the bits are held on the CPU), the same kernel launches as the twin;
   the 8 against the numpy oracle too; the optimized tree's fingerprint
   equal to the hand tree's; its median of 3 and its twin's, alternated,
   beside phase 13's eager median; then compiled to one CUDA graph,
   ``run`` against the eager result, the graph's median and launches.
   The 8 plan queries and q62_range (whose BETWEEN reaches the fact
   table's scan) through ``plan.FileCatalog`` on the files: columns and
   row groups pruned, rows pruned by the fused row filter, each against
   its twin on the loaded tables, the rows kept, complete scans, masks
   skipped and the wall of a call after the first; B3, B4 and B7 on the
   largest inputs the phase hands them, against their plain versions
   and timed as in phase 3; q3's and q62_range's FileCatalog calls
   profiled (the scans' host spans, the device's busy time and idle
   share); on a ``[sql] summary`` JSON line.
17. the serving runtime (run last, on phase 13's tables and files, with
   phase 15's and 16's compiled queries gone): ``exec.QueryScheduler(
   workers=4)`` with the JAX package's defaults (one card, a coalesce
   window of 4 ms, a queue of 32, a plan cache of 32); four client
   threads, each keeping at most 8 requests unresolved, send each of the
   50 TPC-DS queries twice, back to back, and each of the 28 SQL texts
   once through ``submit_sql``: every result equal to the oracle (TPC-DS)
   or to the SQL text's eager run (floats within a relative 1e-12), q7
   bit-equal to its serial eager run, one graph captured for each
   distinct plan and every repeat a plan-cache hit or a shared launch,
   the evictions printed; bursts of 16 q3 requests on one set of tables
   and over two same-shape copies of ``store_sales`` (coalesced, equal to
   serial runs); four requests with ``loader=`` scanned on the prefetch
   thread; admission under a cap of 1.5 requests (deferred) and below one
   (degraded to the sorted engine); ``ExecQueueFull``,
   ``ExecDeadlineExceeded`` and ``ExecShutdown``; an injected OOM at
   ``exec.dispatch`` retried, an injected device error quarantining the
   replica until the recovery probe's canary re-admits it, with incident
   files; requests a second at 1 and 4 workers (for the record); B3, B4
   and B7 on the largest inputs the phase hands them, against their
   plain versions and timed as in phase 3 (without the library call:
   this late in the run the profiler loses its memcpy rows); on an
   ``[exec] summary`` JSON
   line (request counts, p50 and p99 of ``exec.e2e_ms`` and of each
   ``exec.stage.*``, plan-cache stats, batches, failover counts, the
   phase's peak ``torch.cuda.max_memory_allocated``, its seconds).
18. ML, stream, profiles and tapes (last, on phase 13's tables and
   arrays and phase 14's files): the ETL's output packed by
   ``mortgage.feature_spec()`` into a 1,000,000 x 8 float32 matrix on
   the card, bit-identical to the lane rules' numpy oracle
   (``tools/torch_ml_oracle.py``); logistic regression trained by Adam
   (step 1e-6) for 3 epochs of 3,906 batches of 256, each epoch one
   CUDA-graph replay, epochs 2-3 under
   ``torch.cuda.set_sync_debug_mode("error")``, held against a float64
   replay of the same batches (losses within a relative 1e-4, parameters
   within 1e-7 + 1e-3 x the largest); the model as a ``ServableModel``
   over ``etl_tables`` served by ``QueryScheduler(workers=4)`` (one
   request, then 16 from four clients twice, each client on loans of its
   own and one request in flight; a warm request one graph replay or
   one member of a batch graph's launch), every prediction bit-identical to ``predict_table``; store_sales written as a
   6,000,000-row base and four 1,000,000-row appends behind a keyed
   merge-exact view over store_sales ⋈ item (incremental) and a rollup
   (full), each refreshed through ``submit_refresh`` after every append,
   bit-identical to a from-scratch recompute and equal to the numpy
   oracle, the delta scans reading only the new row group, a
   ``FeatureView`` repacking each time; the 8 plan queries under
   ``explain_analyze`` (each node's rows equal to
   ``tools/torch_plan_oracle.py``'s; two unprofiled runs compared; with
   torch's deterministic algorithms the profiled run bit-identical to
   the unprofiled one; profiled and unprofiled medians) and the
   ``@traced`` ranges under ``torch.profiler``; with deterministic
   algorithms, q3, q65 and the servable served with ``SRJT_AOT_DIR``
   set, then by a fresh scheduler that warms up from the store with no
   eager capture run, bit-identical, and a tampered tape recaptured once;
   B2-B7 on the largest inputs the phase hands them; ``[ml]``,
   ``[stream]``, ``[profile]``, ``[aot]`` summary lines.
19. adaptive execution and the rest of slice 17 (last, on phase 13's
   tables, files and arrays and phase 11's file): the 8 plan trees and the 28 SQL texts with ``SRJT_AQE``
   on and off, the adaptive result bit-identical to the static one under
   torch's deterministic algorithms and equal to the oracle, each
   query's decisions and both medians, the adaptive qfn compiled to a
   graph against its eager run; phase 17's mix served with ``SRJT_AQE=1``
   after the SQL texts served static, the plan cache holding both
   variants of every SQL plan; ``tools/aqe_bench.py``'s
   ``mispredicted_order`` (1,500,000 fact rows) and ``skewed_join``
   (2,097,152 rows, 90% on one key, 8 shards on the card), static
   against adaptive, bit-identical; store_sales ⋈ item by category on 4
   shards of the card through ``parallel.repartition_join_agg_auto``
   against numpy, 0 dropped, the bytes exchanged (a copy on one card:
   no interconnect is measured); ``load_tables`` and the 50 queries with
   ``SRJT_HBM_ARENA=1`` against the oracle, the reservations' peak and
   ``torch.cuda.memory_reserved`` with the arena off and on; 18 served
   requests under the torch fault shim with injected ``torch.launch``
   OOMs, every answer equal to the oracle after retries, the
   interceptions by site; q3 over 4 permuted copies of store_sales as
   one launch of a 4-member graph against 4 replays; SF1 lineitem
   (phase 11's file) through its Arrow buffers and back, byte-equal;
   ``spark_12_2str`` at 32,000,000 rows (rows past 2.5 GB) through
   ``convert_to_rows``' batch split and back, byte-equal, GB/s; every
   kernel B1-B7 launched in the phase; an ``[aqe] summary`` line.

The last line of standard output is ``{"ok": true, "device": {...}}``; the
line before it holds the per-kernel results as JSON (B1's, B3's, B4's, B5's
and B7's with every input they were measured on, Q1's among them).  Tables
and files are made from ``--seed`` with numpy.  Imports torch, numpy and the
port, never JAX.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import ctypes as C
import functools
import gc
import json
import os
import statistics
import subprocess
import sys
import threading
import time

import numpy as np
import torch

ROWS = 1 << 20
ORACLE_ROWS = 10_000
NULL_FRACTION = 0.1
# H100 SXM memory rate (NVIDIA data sheet), the bound of byte-moving kernels
HBM_BYTES_PER_S = 3.35e12
KERNEL_REPS = 20
PATH_REPS = 3

# (columns, a string column every k-th slot or None, string lengths drawn
# from [0, max_len)), after benchmarks/row_conversion.py:5-9,28-29,76-101
CASES = {
    "fixed_212": (212, None, 0),
    "spark_12_2str": (12, 6, 40),
    "var_155_16str": (155, 10, 10),
}
# the fixed-width cycle of benchmarks/datagen.py:22-36
FIXED_CYCLE = ("INT64", "INT32", "INT16", "INT8", "FLOAT32", "BOOL8")

# every kernel, in the order of the kernel table (B1-B7): its source, the
# TPU kernel it replaces, and the run its inputs are captured from
# ("to_rows" / "from_rows": phase 3's 12-column table; "scan": phase 7)
KERNELS = {
    "pack_windows": ("spark_rapids_jni_tpu_torch/csrc/xpack.cu",
                     "spark_rapids_jni_tpu/rowconv/xpallas.py:186", "to_rows"),
    "pack_rows": ("spark_rapids_jni_tpu_torch/csrc/ragged.cu",
                  "spark_rapids_jni_tpu/rowconv/ragged.py:291", "scan"),
    "unpack_rows": ("spark_rapids_jni_tpu_torch/csrc/ragged.cu",
                    "spark_rapids_jni_tpu/rowconv/ragged.py:417", "from_rows"),
    "segmented_copy": ("spark_rapids_jni_tpu_torch/csrc/ragged.cu",
                       "spark_rapids_jni_tpu/rowconv/ragged.py:559", "to_rows"),
    "extract_rows": ("spark_rapids_jni_tpu_torch/csrc/ragged.cu",
                     "spark_rapids_jni_tpu/rowconv/xpallas.py:312", "scan"),
    "gather_rows": ("spark_rapids_jni_tpu_torch/csrc/bytepath.cu",
                    "spark_rapids_jni_tpu/rowconv/xpallas.py:405", "scan"),
    "u8_to_u32": ("spark_rapids_jni_tpu_torch/csrc/bytepath.cu",
                  "spark_rapids_jni_tpu/rowconv/xpallas.py:486", "scan"),
}
# the device work of each wrapper, as torch.profiler names it: the
# __global__ functions it launches (B5's wrapper launches B3's kernel)
KERNEL_SYMBOLS = {
    "pack_windows": ("pack_windows_kernel",),
    "pack_rows": ("pack_rows_kernel",),
    "unpack_rows": ("unpack_rows_kernel",),
    "segmented_copy": ("segmented_copy_kernel",),
    "extract_rows": ("unpack_rows_kernel",),
    "gather_rows": ("gather_rows_kernel",),
    "u8_to_u32": ("u8_to_u32_kernel",),
}
# device work a wrapper may add around its kernel, counted in its device
# time where it shows: B4's wrapper zero-filled dst before its kernel came
# to write every byte itself
WRAPPER_EXTRAS = {"segmented_copy": ("FillFunctor", "Memset")}
# B7's start alignments timed in phase 7: start % 16 of the copy
B7_STARTS = (4, 1, 2, 3, 0)
# one PyTorch call computing the same function, where there is one
LIBRARY = {
    "gather_rows": "torch.index_select(mat, 0, idx)",
    "u8_to_u32": "src[s:s+4n].clone().view(torch.int32)",
}
# what the kernels line keeps of each input a kernel was measured on
INPUT_KEYS = ("measured_in", "shape", "ms", "device_ms", "bound_ms",
              "floor_ms", "plain_ms")
# B1, B3 and B4, whose inputs phase 9 records, and the (run, kernel) pairs
# it must see
SF1_KERNELS = ("pack_windows", "unpack_rows", "segmented_copy")
SF1_COPIES = (("SF1 scan", "segmented_copy"), ("SF1 to_rows", "segmented_copy"),
              ("SF1 to_rows", "pack_windows"),
              ("SF1 from_rows", "unpack_rows"),
              ("SF1 from_rows", "segmented_copy"))
# the kernels whose wrappers phase 7 records
SCAN_KERNELS = ("pack_rows", "extract_rows", "gather_rows", "u8_to_u32")
# B5's large dictionary in phase 7: entries, and their lengths drawn from
# [lo, hi) as l_comment's
LARGE_DICT = (1 << 20, 10, 44)
NULL_ROWS = 1 << 20
NULL_ROW_GROUPS = 4
Q6_DATES = (8766, 9131)          # [1994-01-01, 1995-01-01) in epoch days
Q6_REL_TOL = 1e-12
Q1_CUTOFF = 10561 - 90           # 1998-12-01 minus 90 days, in epoch days
Q1_MEAN_RTOL = 1e-12
# the kernels Q1 launches: B3 and B4 for its string keys (dictionary_encode's
# byte matrix, the STRING gathers of the dictionary and of the output
# keys), B7 for the scan's PLAIN quantities and its dictionaries' values
Q1_KERNELS = ("unpack_rows", "segmented_copy", "u8_to_u32")
# phase 11's row groups: those of phases 5-10, so that the walls compare
# (Spark's own are 128 MiB)
SPARK_ROW_GROUP_ROWS = 1 << 20


class SmokeFailure(RuntimeError):
    pass


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(*args) -> None:
    print(*args, flush=True)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

def make_columns(T, n_cols: int, string_every, max_len: int, n: int,
                 rng: np.random.Generator) -> list:
    """Column tuples (type_id, scale, data, offsets, validity) in numpy,
    with NULL_FRACTION nulls; a null string has no chars."""
    cols = []
    for i in range(n_cols):
        valid = rng.random(n) >= NULL_FRACTION
        if string_every and i % string_every == 0:
            lens = rng.integers(0, max_len, n) * valid
            offs = np.zeros(n + 1, dtype=np.int32)
            np.cumsum(lens, out=offs[1:])
            chars = rng.integers(32, 127, int(offs[-1]), dtype=np.uint8)
            cols.append((int(T.TypeId.STRING), 0, chars, offs, valid))
            continue
        dt = T.DType(T.TypeId[FIXED_CYCLE[i % len(FIXED_CYCLE)]])
        st = dt.storage
        if dt.id == T.TypeId.FLOAT32:
            data = rng.standard_normal(n).astype(st)
        elif dt.id == T.TypeId.BOOL8:
            data = rng.integers(0, 2, n, dtype=st)
        else:
            info = np.iinfo(st)
            data = rng.integers(info.min // 2, info.max // 2, n, dtype=st)
        cols.append((int(dt.id), 0, data, None, valid))
    return cols


# ---------------------------------------------------------------------------
# measurement helpers
# ---------------------------------------------------------------------------

def time_cuda(fn, reps: int, warmup: int = 2) -> float:
    """Mean milliseconds of ``fn`` over ``reps`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


# bytes read between profiled calls to push their inputs out of the 50 MB
# L2 cache (read, so that no dirty line is left to write back), and the
# kernel that reads them (left out of the sums)
FLUSH_BYTES = 128 << 20
# kernel names are C++ signatures; the start is enough to tell them apart
NAME_CHARS = 60
# profiled windows a device time is the median of, and windows taken
# before a measurement fails: a window that still lacks device rows (see
# profile_window) is taken again after PROFILE_RETRY_S
PROFILE_WINDOWS = 3
PROFILE_TRIES = 12
PROFILE_RETRY_S = 0.25
FLUSH_KERNEL = "reduce_kernel"
# a profiled window opens with PROFILE_PAD_S of host sleep and a prelude
# of flushes (whose rows are left out), PRELUDE_FLUSHES of them, doubled
# after each short window of a measurement up to PRELUDE_MAX
PROFILE_PAD_S = 0.05
PRELUDE_FLUSHES = 64
PRELUDE_MAX = 1024
# profiled windows taken and those short of device rows, over the run
PROFILE_COUNTS: collections.Counter = collections.Counter()
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaMemcpyAsync", "cudaMemsetAsync")


def profile_window(buf, work, prelude: int = PRELUDE_FLUSHES):
    """``torch.profiler``'s profile (CPU and device) of ``work()`` after
    PROFILE_PAD_S of host sleep and ``prelude`` flushes of ``buf``.  A
    session on the card may have no device record of its first launches
    (its raw records lack them; ``tools/torch_profiler_skew.py``): at
    the start of a process, those within a few ms of its start, whose
    device timestamps run behind; in one measurement of a whole run of
    this script, the first 23 of 40 launches of every window, with the
    sleep or without.  The sleep and the prelude take those."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_PAD_S)
        for _ in range(prelude):
            flush(buf)
        work()
        torch.cuda.synchronize()
    return prof


@functools.lru_cache(maxsize=1)
def flush_buffer() -> torch.Tensor:
    """The buffer the flush reads, checked once: a profiled flush must show
    only FLUSH_KERNEL rows on the device (a row-wise maximum needs no
    scratch memset, which the kernels' own memsets would be mistaken for)."""
    buf = torch.zeros(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    flush(buf)
    torch.cuda.synchronize()
    prof = profile_window(buf, lambda: flush(buf))
    names = {e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA}
    require(names and all(FLUSH_KERNEL in name for name in names),
            f"the L2 flush ran other device work: {names}")
    return buf


def flush(buf: torch.Tensor) -> None:
    buf.view(-1, 1024).amax(dim=1)


def missing_launches(prof) -> list:
    """The launches of a profiled window (runtime calls in order) that
    have no device record among the profiler's raw records, as index
    ranges, and the count of launches."""
    raw = prof.profiler.kineto_results.events()
    dev = {e.correlation_id() for e in raw
           if e.device_type() == torch.autograd.DeviceType.CUDA}
    launches = sorted((e for e in raw
                       if e.device_type() == torch.autograd.DeviceType.CPU
                       and any(n in e.name() for n in LAUNCH_CALLS)),
                      key=lambda e: e.start_ns())
    out = []
    for i, e in enumerate(launches):
        if e.correlation_id() in dev:
            continue
        if out and out[-1][1] == i - 1:
            out[-1][1] = i
        else:
            out.append([i, i])
    return [out, len(launches)]


def device_ms(fn, reps: int, symbols=None, extras=()) -> tuple:
    """Mean device milliseconds a call of ``fn`` keeps the card busy, from
    ``torch.profiler``'s device rows over windows of ``reps`` calls, each
    call after a read of FLUSH_BYTES so that it reads its inputs from
    device memory.  A window counts the rows whose names hold one of
    ``symbols`` or ``extras``, or every device row but the flush's (the
    symbols must all show, the extras may not): the median row of
    each name, summed over the names, as every call launches each of its
    kernels once.  The profiler on the card may lose rows or give them
    broken times, so a window in which a symbol has no row, or a name fewer
    than half its calls' rows with a time, is taken again, and the result
    is the median of PROFILE_WINDOWS windows (each as
    :func:`profile_window` takes it), within PROFILE_TRIES.  Host time
    between launches does not count, as it does in :func:`time_cuda`.
    Returns the time and the rows of the last window, by name."""
    buf = flush_buffer()
    fn()
    torch.cuda.synchronize()

    def calls():
        for _ in range(reps):
            flush(buf)
            fn()
    windows, counts, prelude = [], {}, PRELUDE_FLUSHES
    for _ in range(PROFILE_TRIES):
        prof = profile_window(buf, calls, prelude)
        PROFILE_COUNTS["windows"] += 1
        by_name = collections.defaultdict(list)
        for e in prof.events():
            if (e.device_type == torch.autograd.DeviceType.CUDA
                    and FLUSH_KERNEL not in e.name
                    and (symbols is None
                         or any(s in e.name for s in symbols + extras))):
                us = e.time_range.end - e.time_range.start
                if us > 0:
                    by_name[e.name].append(us)
        counts = {name[:NAME_CHARS]: len(t) for name, t in by_name.items()}
        if (by_name and all(2 * len(t) >= reps for t in by_name.values())
                and all(any(s in name for name in by_name)
                        for s in symbols or ())):
            windows.append(sum(statistics.median(t)
                               for t in by_name.values()))
            if len(windows) == PROFILE_WINDOWS:
                return statistics.median(windows) / 1e3, counts
        else:
            PROFILE_COUNTS["short"] += 1
            log(f"[kernels] the profiler lost device rows of {symbols} "
                f"({counts} of {reps} calls after {prelude} prelude "
                f"flushes; launches with no device record, of all: "
                f"{missing_launches(prof)}): profiling again")
            prelude = min(2 * prelude, PRELUDE_MAX)
            time.sleep(PROFILE_RETRY_S)
    raise SmokeFailure(f"the profiler gave {len(windows)} whole windows of "
                       f"{symbols} in {PROFILE_TRIES}: {counts}")


def bytes_moved(name: str, args) -> int:
    """Bytes a kernel must read once and write once on these inputs."""
    if name == "extract_rows":
        flat, offs, M = args
        payload = int((offs[1:] - offs[:-1]).clamp(0, M).sum())
        width = 4 * -(-M // 4)
        return payload + offs.numel() * 8 + (offs.numel() - 1) * width
    if name == "gather_rows":
        mat, idx = args
        return (mat.numel() * 4 + idx.numel() * 4
                + idx.numel() * mat.shape[1] * 4)
    if name == "u8_to_u32":
        src, start, n_words = args
        return 8 * n_words
    if name == "pack_windows":
        dense, dst, total_w = args
        payload = int((dst[1:] - dst[:-1]).clamp(0, dense.shape[1]).sum())
        return 4 * payload + dst.numel() * 8 + 4 * total_w
    if name == "pack_rows":
        dense, offs, total = args
        payload = int((offs[1:] - offs[:-1]).clamp(0, dense.shape[1]).sum())
        return payload + offs.numel() * 8 + total
    if name == "unpack_rows":
        flat, offs, M = args
        payload = int((offs[1:] - offs[:-1]).clamp(0, M).sum())
        return payload + offs.numel() * 8 + (offs.numel() - 1) * M
    src, so, do, sizes, dst_size = args
    return int(sizes.sum()) + 3 * sizes.numel() * 8 + dst_size


def describe(args) -> list:
    return [list(a.shape) if isinstance(a, torch.Tensor) else a for a in args]


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_device() -> str:
    require(torch.cuda.is_available(), "no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0].strip()
    log(f"[device] {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}"
        f" torch {torch.__version__} cuda {torch.version.cuda}")
    log(card)
    return card


def phase_build(native) -> None:
    t0 = time.perf_counter()
    logs = native.build()
    names = (native.library_path(s).name for s in
             native.SOURCES + native.HOST_SOURCES + (native.JNI_LIBRARY,))
    log(f"[build] {', '.join(names)} in {time.perf_counter() - t0:.2f} s")
    for name, out in logs.items():
        for line in out.strip().splitlines():
            log(f"[build] {name}: {line}")


class Kernels:
    """The kernel modules, their wrappers by name and their launch counts."""

    def __init__(self, *modules):
        self.modules = modules
        self.module_of = {fn.__name__: m for m in modules for fn in m.KERNELS}

    def wrapper(self, name):
        return getattr(self.module_of[name], name)

    def plain(self, name):
        return getattr(self.module_of[name], name + "_plain")

    def reset(self) -> None:
        for m in self.modules:
            m.reset_launches()

    def counts(self) -> dict:
        out = {}
        for m in self.modules:
            out.update(m.launch_counts())
        return out


def record_inputs(kernels, names, keep, run) -> dict:
    """Calls ``run()`` with the wrappers of ``names`` recording their
    inputs: ``keep(captured, name, args)`` decides what is kept."""
    captured = {}
    originals = {name: kernels.wrapper(name) for name in names}

    def recorder(fn):
        def wrapper(*args):
            keep(captured, fn.__name__, args)
            return fn(*args)
        # a wrapper counts its launches on the module's name for it, which
        # is this recorder while the capture runs; those launches are not
        # the main path's and are dropped with the recorder
        wrapper.launches = 0
        return wrapper

    try:
        for name, fn in originals.items():
            setattr(kernels.module_of[name], name, recorder(fn))
        run()
    finally:
        for name, fn in originals.items():
            setattr(kernels.module_of[name], name, fn)
    torch.cuda.synchronize()
    return captured


def measure(kernels, name, args, card, what, library=None) -> dict:
    """One kernel against its plain version on ``args``: equal, its error,
    both times, its bound, its sector floor and the library call's time."""
    kernel = kernels.wrapper(name)
    got = kernel(*args)
    torch.cuda.synchronize()
    equal, err, plain_ms = against_plain(kernels, name, args, got)
    require(equal, f"{name} ({what}) disagrees with its plain version")
    ms = time_cuda(lambda: kernel(*args), KERNEL_REPS)
    dev_ms, _ = device_ms(lambda: kernel(*args), KERNEL_REPS,
                          KERNEL_SYMBOLS[name], WRAPPER_EXTRAS.get(name, ()))
    library_ms = library_dev_ms = None
    if library is not None:
        require(torch.equal(library(), got), f"{name}: library call differs")
        library_ms = time_cuda(library, KERNEL_REPS)
        library_dev_ms, rows = device_ms(library, KERNEL_REPS)
        log(f"[kernels] {name} ({what}): the library call's device rows "
            f"{rows}")
    del got
    nbytes = bytes_moved(name, args)
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    floor = floor_bytes(name, args)
    floor_ms = None if floor is None else floor / HBM_BYTES_PER_S * 1e3
    shape = describe(args)
    log(f"[kernels] {name} ({what}) inputs {shape}: equal={equal} "
        f"max_abs_err={err} {ms:.4f} ms ({nbytes / ms / 1e6:.1f} GB/s; "
        f"bound {bound_ms:.4f} ms for {nbytes} bytes, sector floor "
        f"{fmt_ms(floor_ms)} ms), device {dev_ms:.4f} ms; plain "
        f"{plain_ms:.4f} ms; library {fmt_ms(library_ms)} ms, device "
        f"{fmt_ms(library_dev_ms)} ms [{card}]")
    out = dict(equal=equal, max_abs_err=err, ms=ms, device_ms=dev_ms,
               plain_ms=plain_ms, bound_ms=bound_ms, library_ms=library_ms,
               library_device_ms=library_dev_ms, bytes=nbytes,
               shape=shape, measured_in=what)
    if floor_ms is not None:
        out["floor_ms"] = floor_ms
    return out


# output bytes above which the plain version runs on pieces of the rows or
# segments: it holds several int64 words for every byte of output
PLAIN_PIECE_BYTES = 1 << 26


def plain_pieces(name: str, args) -> list:
    """(slice of the kernel's output, the plain version's inputs for it):
    the whole input, or for B1, B3 and B4 over PLAIN_PIECE_BYTES of output,
    runs of consecutive rows or segments (B1's and B4's destinations
    ascend, so a run owns the output from its first start to the next
    run's, the last run to the end)."""
    if name == "unpack_rows":
        flat, offs, M = args
        n = offs.numel() - 1
        per = max(1, PLAIN_PIECE_BYTES // max(M, 1))
        if n <= per:
            return [(slice(None), args)]
        return [(slice(r, min(r + per, n)),
                 (flat, offs[r:min(r + per, n) + 1], M))
                for r in range(0, n, per)]
    if name == "pack_windows":
        dense, dst, total_w = args
        n, Mw = dense.shape
        per = max(1, PLAIN_PIECE_BYTES // 4 // max(Mw, 1))
        if 4 * total_w <= PLAIN_PIECE_BYTES or n <= per:
            return [(slice(None), args)]
        firsts = list(range(0, n, per))
        starts = dst[firsts].tolist() + [total_w]
        return [(slice(lo, hi),
                 (dense[r:r + per], dst[r:min(r + per, n) + 1] - lo, hi - lo))
                for r, lo, hi in zip(firsts, starts[:-1], starts[1:])]
    if name == "segmented_copy":
        src, so, do, sizes, dst_size = args
        k = sizes.numel()
        if dst_size <= PLAIN_PIECE_BYTES or k == 0:
            return [(slice(None), args)]
        per = max(1, k * PLAIN_PIECE_BYTES // dst_size)
        firsts = list(range(0, k, per))
        bounds = [0] + do[firsts[1:]].tolist() + [dst_size]
        return [(slice(lo, hi),
                 (src, so[a:a + per], do[a:a + per] - lo, sizes[a:a + per],
                  hi - lo))
                for a, lo, hi in zip(firsts, bounds[:-1], bounds[1:])]
    return [(slice(None), args)]


def against_plain(kernels, name, args, got) -> tuple:
    """(equal, max_abs_err, plain ms) of ``got`` against the plain version
    on the same inputs, piece by piece (:func:`plain_pieces`).  The plain
    time is the mean of three calls on a whole input, else the sum of the
    pieces' times in one pass."""
    plain = kernels.plain(name)
    pieces = plain_pieces(name, args)
    equal, err, ms = True, 0, 0.0
    for part, piece_args in pieces:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        want = plain(*piece_args)
        end.record()
        end.synchronize()
        ms += start.elapsed_time(end)
        have = got[part]
        if have.shape != want.shape:
            equal = False
            continue
        equal = equal and torch.equal(have, want)
        if want.numel():
            diff = (have.contiguous().view(torch.uint8).to(torch.int16)
                    - want.contiguous().view(torch.uint8).to(torch.int16))
            err = max(err, int(diff.abs().max()))
        del want, have
    if len(pieces) == 1:
        ms = time_cuda(lambda: plain(*args), 3, warmup=1)
    return equal, err, ms


def fmt_ms(ms) -> str:
    return "null" if ms is None else f"{ms:.4f}"


def phase_kernels(pt, kernels, table, card) -> dict:
    """Phase 3: B1, B3 and B4 on the inputs the 12-column table's round
    trip hands them; B2 timed on B1's rows as bytes."""
    direction = ["to_rows"]

    def keep(captured, name, args):
        captured.setdefault((direction[0], name), args)

    def run():
        batch = pt.convert_to_rows(table)[0]
        direction[0] = "from_rows"
        pt.convert_from_rows(batch, table.schema)

    captured = record_inputs(
        kernels, ("pack_windows", "pack_rows", "unpack_rows",
                  "segmented_copy"), keep, run)
    require(("to_rows", "pack_rows") not in captured,
            "to_rows packed its rows with B2, not B1")
    results = {}
    for (direction_, name), args in sorted(captured.items()):
        results[(direction_, name)] = measure(kernels, name, args, card,
                                              direction_)
    for name, (_, _, where) in KERNELS.items():
        if where != "scan":
            require((where, name) in results,
                    f"the row path never called {name} in {where}")

    # what the routing rule chose between: B2 on the same rows
    _, b2_ms = compare_routes(kernels, captured[("to_rows", "pack_windows")],
                              "12 columns", card)
    results[("to_rows", "pack_windows")]["b2_same_rows_ms"] = b2_ms
    return results


def compare_routes(kernels, args, what, card) -> tuple:
    """B1 and B2 on the same rows (B2's as bytes at byte offsets): equal
    output, and the time of each by CUDA events."""
    from spark_rapids_jni_tpu_torch.rowconv.convert import _reinterpret
    dense_w, dst_w, total_w = args
    b2_args = (_reinterpret(dense_w, torch.uint8), dst_w * 4, total_w * 4)
    b1, b2 = kernels.wrapper("pack_windows"), kernels.wrapper("pack_rows")
    b1_out, b2_out = b1(*args), b2(*b2_args)
    torch.cuda.synchronize()
    require(torch.equal(_reinterpret(b1_out, torch.uint8), b2_out),
            f"{what}: B1 and B2 pack the same rows differently")
    del b1_out, b2_out
    b1_ms = time_cuda(lambda: b1(*args), KERNEL_REPS)
    b2_ms = time_cuda(lambda: b2(*b2_args), KERNEL_REPS)
    b1_dev, _ = device_ms(lambda: b1(*args), KERNEL_REPS,
                          KERNEL_SYMBOLS["pack_windows"])
    b2_dev, _ = device_ms(lambda: b2(*b2_args), KERNEL_REPS,
                          KERNEL_SYMBOLS["pack_rows"])
    log(f"[kernels] routing ({what}): on the same {total_w * 4} row bytes "
        f"(rows of {dense_w.shape[1] * 4} bytes padded) B1 pack_windows "
        f"{b1_ms:.4f} ms (device {b1_dev:.4f}), B2 pack_rows {b2_ms:.4f} ms "
        f"(device {b2_dev:.4f}) [{card}]")
    return b1_ms, b2_ms


def check_round_trip(table, back) -> None:
    require(back.num_rows == table.num_rows and
            back.schema == table.schema, "round trip changed the shape")
    for ci, (a, b) in enumerate(zip(table.columns, back.columns)):
        require(torch.equal(a.validity_or_true(), b.validity_or_true()),
                f"column {ci}: validity differs")
        require(torch.equal(a.data.contiguous().view(torch.uint8),
                            b.data.contiguous().view(torch.uint8)),
                f"column {ci}: data differs")
        if a.dtype.is_variable_width:
            require(torch.equal(a.offsets, b.offsets),
                    f"column {ci}: offsets differ")


def check_oracle(convert, reference, table, batch, k: int) -> None:
    head = convert.slice_table(table, 0, min(k, table.num_rows))
    want, want_offs = reference.to_rows_np(head)
    got_offs = batch.offsets[:head.num_rows + 1].cpu().numpy()
    got = batch.data[:int(got_offs[-1])].cpu().numpy()
    require(np.array_equal(got_offs, want_offs), "row offsets differ from the oracle")
    require(np.array_equal(got, want), "row bytes differ from the numpy oracle")


def add_counts(launches: dict, counts: dict) -> None:
    for k, v in counts.items():
        launches[k] += v


def phase_path(pt, T, interop, convert, reference, kernels, card, seed, rows,
               launches):
    """Phase 4: the three tables of the row-conversion benchmark."""
    for ci, (case, (n_cols, every, max_len)) in enumerate(CASES.items()):
        rng = np.random.default_rng(seed + ci)
        t0 = time.perf_counter()
        table = interop.table_from_numpy(
            make_columns(T, n_cols, every, max_len, rows, rng), device="cuda")
        torch.cuda.synchronize()
        log(f"[path] {case}: {n_cols} columns x {rows} rows made in "
            f"{time.perf_counter() - t0:.2f} s")
        torch.cuda.reset_peak_memory_stats()

        counts = {}
        kernels.reset()
        t0 = time.perf_counter()
        batches = pt.convert_to_rows(table)
        torch.cuda.synchronize()
        first_to = time.perf_counter() - t0
        counts["to_rows"] = kernels.counts()
        require(len(batches) == 1, f"{case}: expected one batch")
        batch = batches[0]
        kernels.reset()
        t0 = time.perf_counter()
        back = pt.convert_from_rows(batch, table.schema)
        torch.cuda.synchronize()
        first_from = time.perf_counter() - t0
        counts["from_rows"] = kernels.counts()

        check_round_trip(table, back)
        check_oracle(convert, reference, table, batch, ORACLE_ROWS)
        for d in counts.values():
            add_counts(launches, d)
        if every:
            # B1 packs the rows; B3 and B4 move the chars and fixed region
            for name in ("pack_windows", "unpack_rows", "segmented_copy"):
                require(sum(d[name] for d in counts.values()) > 0,
                        f"{case}: {name} never launched on the path")
            require(counts["to_rows"]["pack_rows"] == 0,
                    f"{case}: to_rows launched B2")

        times = {}
        for direction, fn in (("to_rows", lambda: pt.convert_to_rows(table)),
                              ("from_rows", lambda: pt.convert_from_rows(
                                  batch, table.schema))):
            times[direction] = median_wall(fn)
        nbytes = batch.num_bytes
        for direction, first in (("to_rows", first_to),
                                 ("from_rows", first_from)):
            t = times[direction]
            log(f"[path] {case} {direction}: {nbytes} row bytes, first "
                f"{first * 1e3:.3f} ms, median of {PATH_REPS} "
                f"{t * 1e3:.3f} ms = {nbytes / t / 1e9:.2f} GB/s; launches "
                f"{counts[direction]} [{card}]")
        log(f"[path] {case}: round trip exact, first {ORACLE_ROWS} rows equal "
            f"the oracle, peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        del batches, back
        if every:
            captured = record_inputs(
                kernels, ("pack_windows",),
                lambda c, name, args: c.setdefault(name, args),
                lambda: pt.convert_to_rows(table))
            compare_routes(kernels, captured["pack_windows"], case, card)
            del captured
        del table, batch
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phases 5-8: the device Parquet scan, Q6, the scan kernels, the full table
# ---------------------------------------------------------------------------

def median_wall(fn, reps: int = PATH_REPS) -> float:
    """Median seconds of ``fn`` ending in a device synchronisation."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def expected_chars(vocab: list, codes: np.ndarray, valid) -> tuple:
    """(chars, int32 offsets) of a dictionary string column, in numpy."""
    vlen = np.array([len(v) for v in vocab], np.int64)
    lens = vlen[codes] if valid is None else np.where(valid, vlen[codes], 0)
    offs = np.zeros(codes.shape[0] + 1, np.int64)
    np.cumsum(lens, out=offs[1:])
    vstart = np.concatenate([[0], np.cumsum(vlen)[:-1]])
    flat = np.frombuffer(b"".join(vocab), np.uint8)
    src = (np.repeat(vstart[codes] - offs[:-1], lens)
           + np.arange(int(offs[-1]), dtype=np.int64))
    return flat[src], offs.astype(np.int32)


def present_chars(chars: np.ndarray, offs: np.ndarray, valid) -> tuple:
    """(chars, offsets) of a string column whose null rows have no
    chars."""
    if valid is None:
        return chars, offs
    lens = np.where(valid, offs[1:] - offs[:-1], 0)
    out = np.zeros(lens.shape[0] + 1, np.int64)
    np.cumsum(lens, out=out[1:])
    src = (np.repeat(offs[:-1] - out[:-1], lens)
           + np.arange(int(out[-1]), dtype=np.int64))
    return chars[src], out


def check_scanned(pt, W, table, data, validity, what: str) -> None:
    """Every row of every column equals the generator's arrays
    (vectorised on the card); dictionary strings also by their codes,
    PLAIN strings by their chars and offsets."""
    names = [name for name, *_ in W.LINEITEM][:table.num_columns]
    require([c.num_rows for c in table.columns] ==
            [data["l_orderkey"].shape[0]] * len(names),
            f"{what}: row counts differ")
    for name, col in zip(names, table.columns):
        v = validity.get(name)
        valid = None if v is None else torch.from_numpy(v).cuda()
        require(torch.equal(col.validity_or_true(),
                            valid if valid is not None
                            else torch.ones_like(col.validity_or_true())),
                f"{what}: {name} validity differs")
        want = data[name]
        if name == "l_comment":
            require(not isinstance(col, pt.DictColumn),
                    f"{what}: l_comment is a DictColumn")
            chars, offs = present_chars(*want, v)
            require(torch.equal(col.offsets, torch.from_numpy(
                offs.astype(np.int32)).cuda()),
                f"{what}: l_comment offsets differ")
            require(torch.equal(col.data, torch.from_numpy(chars).cuda()),
                    f"{what}: l_comment chars differ")
            continue
        if name in W.VOCAB:
            require(isinstance(col, pt.DictColumn),
                    f"{what}: {name} is not a DictColumn")
            entries = [e.encode() for e in col.dictionary.to_pylist()]
            lut = torch.tensor([W.VOCAB[name].index(e) for e in entries],
                               dtype=torch.int64, device=col.device)
            got = lut[col.codes.to(torch.int64)]
            exp = torch.from_numpy(want.astype(np.int64)).cuda()
            ok = got == exp if valid is None else (got == exp) | ~valid
            require(bool(ok.all()), f"{what}: {name} codes differ")
            continue
        exp = want if v is None else np.where(v, want, 0).astype(want.dtype)
        require(torch.equal(col.data, torch.from_numpy(exp).cuda()),
                f"{what}: {name} values differ")


def check_materialized(W, table, data, validity, what: str) -> None:
    for (name, *_), col in zip(W.LINEITEM, table.columns):
        if name not in W.VOCAB:
            continue
        chars, offs = expected_chars(W.VOCAB[name], data[name],
                                     validity.get(name))
        m = col.materialize()
        require(torch.equal(m.offsets, torch.from_numpy(offs).cuda()),
                f"{what}: {name} materialized offsets differ")
        require(torch.equal(m.data, torch.from_numpy(chars).cuda()),
                f"{what}: {name} materialized chars differ")


def column_chunk_bytes(raw: bytes, names) -> int:
    """The bytes of the column chunks of ``names`` in a Parquet file."""
    from spark_rapids_jni_tpu_torch.parquet import decode as D
    from spark_rapids_jni_tpu_torch.parquet.footer import extract_footer_bytes
    from spark_rapids_jni_tpu_torch.parquet.thrift import parse_struct
    meta = parse_struct(bytes(extract_footer_bytes(memoryview(raw))))
    leaves = [leaf.name for leaf in D.leaf_schema_elements(meta)]
    want = {leaves.index(name) for name in names}
    return sum(chunk.get(D.CC.META_DATA).get(D.CMD.TOTAL_COMPRESSED_SIZE)
               for g in meta.get(D.FMD.ROW_GROUPS).values
               for i, chunk in enumerate(g.get(D.RG.COLUMNS).values)
               if i in want)


def phase_scan(pt, W, device_scan, kernels, card, seed, launches):
    """Phases 5 and 5b.  Returns the SF1 file, its generator arrays and
    the names of its first 15 columns."""
    t0 = time.perf_counter()
    raw, data, _ = W.lineitem_parquet(W.SF1_ROWS, seed)
    log(f"[scan] SF1 lineitem: {W.SF1_ROWS} rows, {len(W.LINEITEM)} columns,"
        f" {len(raw)} file bytes, written in {time.perf_counter() - t0:.2f} s")
    cols15 = [name for name, *_ in W.LINEITEM_NO_COMMENT]
    bytes15 = column_chunk_bytes(raw, cols15)

    kernels.reset()
    t0 = time.perf_counter()
    table = device_scan.scan_table(raw, columns=cols15)
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    check_scanned(pt, W, table, data, {}, "SF1")
    check_materialized(W, table, data, {}, "SF1")
    torch.cuda.synchronize()
    counts = kernels.counts()
    add_counts(launches, counts)
    for name in ("extract_rows", "gather_rows", "u8_to_u32", "pack_rows"):
        require(counts[name] > 0, f"scan: {name} never launched on the path")
    log(f"[scan] SF1: every row of every column equals the generator; "
        f"launches (scan + materialize) {counts}")
    del table
    wall = median_wall(lambda: device_scan.scan_table(raw, columns=cols15))
    log(f"[scan] SF1 scan_table of the first 15 columns: their chunks hold "
        f"{bytes15} bytes, first {first * 1e3:.3f} ms, median of {PATH_REPS} "
        f"{wall * 1e3:.3f} ms = {bytes15 / wall / 1e9:.3f} GB/s [{card}]")

    raw_n, data_n, valid_n = W.lineitem_parquet(
        NULL_ROWS, seed + 1, row_group_rows=NULL_ROWS // NULL_ROW_GROUPS,
        null_fraction=NULL_FRACTION, pages_per_chunk=2,
        columns=W.LINEITEM_NO_COMMENT)
    kernels.reset()
    table = device_scan.scan_table(raw_n)
    check_scanned(pt, W, table, data_n, valid_n, "nulls")
    check_materialized(W, table, data_n, valid_n, "nulls")
    torch.cuda.synchronize()
    counts = kernels.counts()
    add_counts(launches, counts)
    wall = median_wall(lambda: device_scan.scan_table(raw_n))
    log(f"[scan] nulls: {NULL_ROWS} rows, {NULL_ROW_GROUPS} row groups, "
        f"{NULL_FRACTION:.0%} nulls, {len(raw_n)} bytes: exact; median of "
        f"{PATH_REPS} {wall * 1e3:.3f} ms = {len(raw_n) / wall / 1e9:.3f} "
        f"GB/s; launches {counts} [{card}]")
    del table
    torch.cuda.empty_cache()
    return raw, data, cols15


def rows_round_trip(pt, convert, reference, kernels, table, what, card,
                    launches) -> dict:
    """``table`` → rows → back, exact, the first rows against the oracle;
    returns the launch counts of the two calls."""
    kernels.reset()
    t0 = time.perf_counter()
    batches = pt.convert_to_rows(table)
    torch.cuda.synchronize()
    to_s = time.perf_counter() - t0
    require(len(batches) == 1, f"{what}: expected one row batch")
    batch = batches[0]
    t0 = time.perf_counter()
    back = pt.convert_from_rows(batch, table.schema)
    torch.cuda.synchronize()
    from_s = time.perf_counter() - t0
    counts = kernels.counts()
    add_counts(launches, counts)
    check_round_trip(table, back)
    check_oracle(convert, reference, table, batch, ORACLE_ROWS)
    log(f"[rows] {what}: {batch.num_bytes} row bytes, to_rows "
        f"(DictColumns materialized) {to_s * 1e3:.3f} ms, from_rows "
        f"{from_s * 1e3:.3f} ms; round trip exact, first {ORACLE_ROWS} rows "
        f"equal the oracle; launches {counts} [{card}]")
    return counts


def run_q6(q6, kernels, raw, data, what: str, card, launches) -> None:
    """``models.q6.run`` on ``raw``: the matched count equal to numpy's,
    the revenue to Q6_REL_TOL of ``math.fsum`` over the generator's
    arrays; timed as the median wall of PATH_REPS calls."""
    import math
    lo, hi = Q6_DATES
    kernels.reset()
    revenue, matched = q6.run(raw, lo, hi)
    counts = kernels.counts()
    mask = ((data["l_shipdate"] >= lo) & (data["l_shipdate"] < hi)
            & (data["l_discount"] >= 0.05 - 1e-9)
            & (data["l_discount"] <= 0.07 + 1e-9)
            & (data["l_quantity"] < 24))
    want = math.fsum((data["l_extendedprice"][mask]
                      * data["l_discount"][mask]).tolist())
    require(matched == int(mask.sum()), f"Q6 {what} matched {matched}, "
            f"numpy {int(mask.sum())}")
    rel = abs(revenue - want) / abs(want)
    require(rel <= Q6_REL_TOL, f"Q6 {what} revenue {revenue!r} vs fsum "
            f"{want!r}: relative {rel:.3e}")
    wall = median_wall(lambda: q6.run(raw, lo, hi))
    log(f"[q6] {what}: matched {matched} (numpy equal), revenue {revenue!r} "
        f"vs fsum {want!r} (relative {rel:.3e} <= {Q6_REL_TOL}); median of "
        f"{PATH_REPS} {wall * 1e3:.3f} ms; launches {counts} [{card}]")
    add_counts(launches, counts)


def phase_q6_rows(pt, W, device_scan, q6, convert, reference, kernels, card,
                  raw, data, cols15, launches):
    """Phase 6: Q6 on the SF1 file, then the scanned 15 columns through
    rows."""
    run_q6(q6, kernels, raw, data, "SF1", card, launches)

    table = device_scan.scan_table(raw, columns=cols15)
    torch.cuda.synchronize()
    counts = rows_round_trip(pt, convert, reference, kernels, table,
                             "SF1 scanned 15 columns", card, launches)
    for name in ("extract_rows", "gather_rows", "pack_rows", "pack_windows"):
        require(counts[name] > 0, f"rows: {name} never launched")
    del table
    torch.cuda.empty_cache()


def phase_full_table(pt, W, device_scan, convert, reference, kernels, card,
                     raw, data, launches):
    """Phase 8: all 16 columns scanned (PLAIN ``l_comment`` among them),
    then through rows and back."""
    kernels.reset()
    t0 = time.perf_counter()
    table = device_scan.scan_table(raw)
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    scan_counts = kernels.counts()
    check_scanned(pt, W, table, data, {}, "SF1 16 columns")
    require(scan_counts["segmented_copy"] > 0,
            "full scan: B4 never stripped the PLAIN prefixes")
    torch.cuda.synchronize()
    add_counts(launches, kernels.counts())
    log(f"[full] SF1 16 columns: every row of every column equals the "
        f"generator, l_comment's {data['l_comment'][0].shape[0]} chars row "
        f"for row; launches (scan) {scan_counts}")
    counts = rows_round_trip(pt, convert, reference, kernels, table,
                             "SF1 16 columns", card, launches)
    for name in KERNELS:
        if name != "u8_to_u32":          # B7 ran in the scan
            require(counts[name] > 0, f"full rows: {name} never launched")
    del table
    torch.cuda.empty_cache()
    wall = median_wall(lambda: device_scan.scan_table(raw))
    log(f"[full] SF1 scan_table of 16 columns: {len(raw)} file bytes, "
        f"first {first * 1e3:.3f} ms, median of {PATH_REPS} "
        f"{wall * 1e3:.3f} ms = {len(raw) / wall / 1e9:.3f} GB/s [{card}]")
    full_scan = (wall, len(raw))
    table = device_scan.scan_table(raw)
    to_wall = median_wall(lambda: pt.convert_to_rows(table))
    batch = pt.convert_to_rows(table)[0]
    from_wall = median_wall(lambda: pt.convert_from_rows(batch, table.schema))
    log(f"[full] SF1 16 columns rows: {batch.num_bytes} row bytes; to_rows "
        f"(DictColumns materialized once, before) median of {PATH_REPS} "
        f"{to_wall * 1e3:.3f} ms = {batch.num_bytes / to_wall / 1e9:.3f} "
        f"GB/s; from_rows {from_wall * 1e3:.3f} ms = "
        f"{batch.num_bytes / from_wall / 1e9:.3f} GB/s [{card}]")
    del table, batch
    torch.cuda.empty_cache()
    return full_scan


def phase_full_kernels(pt, device_scan, kernels, raw, card) -> dict:
    """Phase 9: B1, B3 and B4 on the largest input each of their callers
    hands them on SF1's 16 columns: the scan's PLAIN ``l_comment`` prefix
    strip, the 16-column to_rows (the chars into the row matrix, B1's pack
    of it) and its from_rows (the fixed region and the chars), each held
    byte for byte against its plain version and timed beside its bound and
    sector floor."""
    direction = ["scan"]

    def keep(captured, name, args):
        key = (f"SF1 {direction[0]}", name)
        nb = bytes_moved(name, args)
        if key not in captured or nb > captured[key][0]:
            captured[key] = (nb, args)

    def run():
        table = device_scan.scan_table(raw)
        direction[0] = "to_rows"
        batch = pt.convert_to_rows(table)[0]
        direction[0] = "from_rows"
        pt.convert_from_rows(batch, table.schema)

    captured = record_inputs(kernels, SF1_KERNELS, keep, run)
    for key in SF1_COPIES:
        require(key in captured, f"SF1: {key[1]} never called in {key[0]}")
    results = {}
    for key, (_, args) in sorted(captured.items()):
        results[key] = measure(kernels, key[1], args, card, key[0])
    del captured
    torch.cuda.empty_cache()
    return results


def library_call(name: str, args):
    if name == "gather_rows":
        mat, idx = args
        return lambda: torch.index_select(mat, 0, idx)
    if name == "u8_to_u32":
        src, s, n = args
        return lambda: src[s:s + 4 * n].clone().view(torch.int32)
    return None


def phase_scan_kernels(device_scan, kernels, raw, cols15, card,
                       seed) -> tuple:
    """Phase 7: B2 and B5-B7 on the largest inputs (by bytes moved) that
    the scan of the 15 columns and the materialization of its dictionary
    strings hand them; B5 also on a large dictionary (LARGE_DICT), at the
    row width materialize pads it to.  Returns the results by kernel, and
    the extra inputs' results by kernel."""
    def keep(captured, name, args):
        nb = bytes_moved(name, args)
        old = captured.get(name)
        if old is None or nb > old[0]:
            captured[name] = (nb, args)

    def run():
        table = device_scan.scan_table(raw, columns=cols15)
        for col in table.columns:
            if hasattr(col, "materialize"):
                col.materialize()

    captured = record_inputs(kernels, SCAN_KERNELS, keep, run)
    results = {}
    for name in SCAN_KERNELS:
        require(name in captured, f"the scan never called {name}")
        args = captured[name][1]
        lib = library_call(name, args)
        results[name] = measure(kernels, name, args, card, "scan", lib)
    results["u8_to_u32"]["starts"] = b7_starts(
        kernels, captured["u8_to_u32"][1], card)
    del captured
    D, lo, hi = LARGE_DICT
    rng = np.random.default_rng(seed)
    lens = rng.integers(lo, hi, D)
    offs = np.zeros(D + 1, np.int64)
    np.cumsum(lens, out=offs[1:])
    flat = torch.from_numpy(rng.integers(32, 127, int(offs[-1]),
                                         dtype=np.uint8)).cuda()
    M = -(-(hi - 1) // 16) * 16          # materialize's 16-byte padding
    large = measure(kernels, "extract_rows",
                    (flat, torch.from_numpy(offs).cuda(), M), card,
                    "large dictionary")
    return results, {"extract_rows": [large]}


def sectors_read(starts: torch.Tensor, lens: torch.Tensor) -> int:
    """The 32-byte sectors that reads of [starts, starts + lens) touch,
    each counted once: the ranges (which do not overlap) sorted by start,
    a sector shared by neighbours counted once."""
    live = lens > 0
    starts, lens = starts[live], lens[live]
    starts, order = torch.sort(starts)
    lens = lens[order]
    first, last = starts // 32, (starts + lens - 1) // 32
    shared = int((first[1:] == last[:-1]).sum())
    return int((last - first + 1).sum()) - shared


def floor_bytes(name: str, args):
    """B1-B5's honest floor in bytes: every 32-byte sector of the source
    that holds payload read whole (rows and strings of a few bytes at byte
    offsets share few sectors; B1's rows are read up to their size), plus
    the offsets and the output, as in :func:`bytes_moved`; None for the
    other kernels."""
    if name == "pack_windows":
        dense, dst, total_w = args
        n, Mw = dense.shape
        rows = torch.arange(n, device=dst.device)
        ncopy = 4 * (dst[1:] - dst[:-1]).clamp(0, Mw)
        return (32 * sectors_read(dense.data_ptr() + rows * 4 * Mw, ncopy)
                + dst.numel() * 8 + 4 * total_w)
    if name == "pack_rows":
        dense, offs, total = args
        M = dense.shape[1]
        rows = torch.arange(dense.shape[0], device=offs.device)
        ncopy = (offs[1:] - offs[:-1]).clamp(0, M)
        return (32 * sectors_read(dense.data_ptr() + rows * M, ncopy)
                + offs.numel() * 8 + total)
    if name in ("unpack_rows", "extract_rows"):
        flat, offs, M = args
        n = offs.numel() - 1
        lo = offs[:-1]
        ncopy = (offs[1:].clamp(max=flat.numel()) - lo).clamp(0, M)
        ncopy[lo < 0] = 0
        width = M if name == "unpack_rows" else 4 * -(-M // 4)
        return (32 * sectors_read(flat.data_ptr() + lo, ncopy)
                + offs.numel() * 8 + n * width)
    if name == "segmented_copy":
        src, so, do, sizes, dst_size = args
        return (32 * sectors_read(src.data_ptr() + so, sizes)
                + 3 * sizes.numel() * 8 + dst_size)
    return None


def b7_starts(kernels, args, card) -> dict:
    """B7 and ``clone().view`` on the bytes phase 7 captured, copied to
    each start alignment of B7_STARTS (start % 16): exact, and both timed
    by CUDA events over the wrappers and by the profiler's device rows."""
    src, start, n = args
    kernel, plain = kernels.wrapper("u8_to_u32"), kernels.plain("u8_to_u32")
    log(f"[kernels] u8_to_u32 (scan): captured start {start}, start % 16 = "
        f"{(src.data_ptr() + start) % 16}, {n} words")
    want = plain(src, start, n)
    out = {}
    for mod in B7_STARTS:
        buf = torch.empty(4 * n + 64, dtype=torch.uint8, device=src.device)
        s = (mod - buf.data_ptr()) % 16 + 16
        buf[s:s + 4 * n] = src[start:start + 4 * n]
        got = kernel(buf, s, n)
        lib = lambda: buf[s:s + 4 * n].clone().view(torch.int32)  # noqa: E731
        torch.cuda.synchronize()
        require(torch.equal(got, want) and torch.equal(lib(), want),
                f"u8_to_u32 at start % 16 = {mod} differs")
        dev, _ = device_ms(lambda: kernel(buf, s, n), KERNEL_REPS,
                           KERNEL_SYMBOLS["u8_to_u32"])
        lib_dev, rows = device_ms(lib, KERNEL_REPS)
        row = dict(ms=time_cuda(lambda: kernel(buf, s, n), KERNEL_REPS),
                   device_ms=dev, library_ms=time_cuda(lib, KERNEL_REPS),
                   library_device_ms=lib_dev)
        out[f"start%16={mod}"] = row
        log(f"[kernels] u8_to_u32 start % 16 = {mod}: exact; B7 "
            f"{row['ms']:.4f} ms, device {row['device_ms']:.4f} ms; "
            f"clone().view {row['library_ms']:.4f} ms, device "
            f"{row['library_device_ms']:.4f} ms (rows {rows}) [{card}]")
        del buf, got
    return out


# ---------------------------------------------------------------------------
# phase 10: TPC-H Q1
# ---------------------------------------------------------------------------

def exact_sum(x: np.ndarray) -> int:
    """The exact sum of int64 values below 2^62 in magnitude, as a Python
    int: the high and low 32-bit halves summed apart (each sum fits int64
    below 2^31 values)."""
    return (int((x >> 32).sum(dtype=np.int64)) << 32) + int(
        (x & 0xFFFFFFFF).sum(dtype=np.int64))


def q1_oracle(W, data, validity, cutoff) -> list:
    """Q1's rows from the generator's integer arrays, in the port's
    semantics: nulls skipped by every aggregate, a null key its own group
    ordered first, ``count`` the valid quantities, the money sums
    unscaled."""
    n = data["l_shipdate"].shape[0]

    def valid(name):
        v = validity.get(name)
        return np.ones(n, bool) if v is None else v

    keep = (data["l_shipdate"] <= cutoff) & valid("l_shipdate")
    flag = np.where(valid("l_returnflag"), data["l_returnflag"] + 1, 0)
    status = np.where(valid("l_linestatus"), data["l_linestatus"] + 1, 0)
    group = flag * 3 + status
    qty = data["l_quantity"].astype(np.int64)
    price = data["l_extendedprice_unscaled"]
    disc = data["l_discount_unscaled"]
    tax = data["l_tax_unscaled"]
    disc_price = price * (100 - disc)                       # scale -4
    charge = disc_price * (100 + tax)                       # scale -6
    vq, vp, vd = valid("l_quantity"), valid("l_extendedprice"), valid(
        "l_discount")
    vdp = vp & vd
    vc = vdp & valid("l_tax")
    rows = []
    for g in np.unique(group[keep]):
        m = keep & (group == g)
        f, st = divmod(int(g), 3)
        cq, cp, cd = (int((m & v).sum()) for v in (vq, vp, vd))
        s_qty, s_price = exact_sum(qty[m & vq]), exact_sum(price[m & vp])
        rows.append((
            W.VOCAB["l_returnflag"][f - 1].decode() if f else None,
            W.VOCAB["l_linestatus"][st - 1].decode() if st else None,
            s_qty, s_price, exact_sum(disc_price[m & vdp]),
            exact_sum(charge[m & vc]),
            s_qty / max(cq, 1), s_price / 100 / max(cp, 1),
            exact_sum(disc[m & vd]) / 100 / max(cd, 1), cq))
    return rows


def check_q1(T, out, want: list, what: str) -> float:
    """Every column of Q1's output against the oracle: keys, dtypes,
    counts and sums exact, the means to Q1_MEAN_RTOL.  Returns the means'
    largest relative error, which a passing run prints too."""
    require(out.num_rows == len(want),
            f"{what}: {out.num_rows} groups, the oracle has {len(want)}")
    dtypes = [T.string, T.string, T.int64, T.decimal64(-2),
              T.decimal128(-4), T.decimal128(-6), T.float64, T.float64,
              T.float64, T.int64]
    require(out.schema == dtypes, f"{what}: output types {out.schema}")
    cols = list(zip(*want))
    for ci in (0, 1, 2, 3, 4, 5, 9):
        require(out[ci].to_pylist() == list(cols[ci]),
                f"{what}: column {ci} {out[ci].to_pylist()} != "
                f"{list(cols[ci])}")
    worst = 0.0
    for ci in (6, 7, 8):
        got = out[ci].to_numpy()
        exp = np.asarray(cols[ci], np.float64)
        rel = np.abs(got - exp) / np.maximum(np.abs(exp), 1e-300)
        require(bool((rel <= Q1_MEAN_RTOL).all()),
                f"{what}: mean column {ci} {got} vs {exp} (relative "
                f"{rel.max():.3e})")
        worst = max(worst, float(rel.max(initial=0.0)))
    return worst


def phase_q1(T, W, tpch_q1, kernels, card, seed, launches) -> dict:
    """Phase 10: Q1 on SF1 lineitem and on a 10%-null file, exact against
    the integer oracle; B3 and B4 on the inputs Q1 hands them."""
    t0 = time.perf_counter()
    raw, data, _ = W.lineitem_parquet(W.SF1_ROWS, seed + 3,
                                      columns=W.LINEITEM_Q1)
    log(f"[q1] SF1 lineitem, Q1 layout: {W.SF1_ROWS} rows, "
        f"{len(W.LINEITEM_Q1)} columns, {len(raw)} file bytes, written in "
        f"{time.perf_counter() - t0:.2f} s")
    want = q1_oracle(W, data, {}, Q1_CUTOFF)
    del data
    kernels.reset()
    t0 = time.perf_counter()
    out = tpch_q1.run(raw, Q1_CUTOFF)
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    counts = kernels.counts()
    add_counts(launches, counts)
    for name in Q1_KERNELS:
        require(counts[name] > 0, f"Q1: {name} never launched")
    rel = check_q1(T, out, want, "Q1 SF1")
    wall = median_wall(lambda: tpch_q1.run(raw, Q1_CUTOFF))
    log(f"[q1] SF1: {out.num_rows} groups, every column equals the integer "
        f"oracle (means to {Q1_MEAN_RTOL}: largest relative error "
        f"{rel:.3e}), {sum(r[9] for r in want)} rows "
        f"counted; first {first * 1e3:.3f} ms, median of {PATH_REPS} "
        f"{wall * 1e3:.3f} ms = {len(raw) / wall / 1e9:.3f} GB/s of file; "
        f"launches {counts} [{card}]")

    def keep(captured, name, args):
        nb = bytes_moved(name, args)
        if name not in captured or nb > captured[name][0]:
            captured[name] = (nb, args)

    captured = record_inputs(kernels, Q1_KERNELS, keep,
                             lambda: tpch_q1.run(raw, Q1_CUTOFF))
    results = {("Q1", name): measure(kernels, name, captured[name][1], card,
                                     "Q1", library_call(name,
                                                        captured[name][1]))
               for name in Q1_KERNELS}
    del captured, out, raw
    torch.cuda.empty_cache()

    raw_n, data_n, valid_n = W.lineitem_parquet(
        NULL_ROWS, seed + 4, row_group_rows=NULL_ROWS // NULL_ROW_GROUPS,
        null_fraction=NULL_FRACTION, pages_per_chunk=2, columns=W.LINEITEM_Q1)
    kernels.reset()
    out = tpch_q1.run(raw_n, Q1_CUTOFF)
    torch.cuda.synchronize()
    counts = kernels.counts()
    add_counts(launches, counts)
    for name in Q1_KERNELS:
        require(counts[name] > 0, f"Q1 nulls: {name} never launched")
    rel = check_q1(T, out, q1_oracle(W, data_n, valid_n, Q1_CUTOFF),
                   "Q1 nulls")
    wall = median_wall(lambda: tpch_q1.run(raw_n, Q1_CUTOFF))
    log(f"[q1] nulls: {NULL_ROWS} rows, {NULL_FRACTION:.0%} nulls, "
        f"{out.num_rows} groups (a null key's among them), exact (means' "
        f"largest relative error {rel:.3e}); median of "
        f"{PATH_REPS} {wall * 1e3:.3f} ms; launches {counts} [{card}]")
    return results


# ---------------------------------------------------------------------------
# phase 11: Parquet files as Spark writes them
# ---------------------------------------------------------------------------

def slice_rows(data: dict, a: int, b: int) -> dict:
    """The generator's arrays of rows [a, b)."""
    out = {}
    for name, arr in data.items():
        if name == "l_comment":
            chars, offs = arr
            out[name] = (chars[offs[a]:offs[b]], offs[a:b + 1] - offs[a])
        else:
            out[name] = arr[a:b]
    return out


def run_kinds(device_scan, raw) -> dict:
    """Each column's kinds of page runs over its row groups, as the scan's
    page walk finds them: "dict", "plain" (PLAIN or DELTA), or both (a
    dictionary that fell back)."""
    from spark_rapids_jni_tpu_torch.parquet import decode as D
    from spark_rapids_jni_tpu_torch.parquet.footer import extract_footer_bytes
    from spark_rapids_jni_tpu_torch.parquet.thrift import parse_struct
    mv = memoryview(raw)
    meta = parse_struct(bytes(extract_footer_bytes(mv)))
    leaves = D.leaf_schema_elements(meta)
    kinds = {leaf.name: set() for leaf in leaves}
    for g in meta.get(D.FMD.ROW_GROUPS).values:
        for leaf, chunk in zip(leaves, g.get(D.RG.COLUMNS).values):
            kinds[leaf.name].update(
                k for k, _ in device_scan._walk_chunk(mv, chunk, leaf).runs)
    return {name: "+".join(sorted(k)) for name, k in kinds.items()}


def scan_split(device_scan, raw) -> dict:
    """One profiled ``scan_table`` of ``raw``: its wall, host spans (the
    page walk, the decompression inside it, the slab's upload and the
    decode launches; ``parquet.scan.*``), the device's busy time and idle
    share, all in milliseconds."""
    from torch_profile_rowconv import _busy_us, profile_call
    from torch_profile_scan import _span_ms
    prof, wall = profile_call(lambda: device_scan.scan_table(raw))
    busy = _busy_us(prof)
    out = {k: round(v, 3) for k, v in _span_ms(prof).items()}
    out.update(wall_ms=round(wall / 1e3, 3), device_busy_ms=round(busy / 1e3, 3),
               idle_share=round(1 - busy / wall, 3))
    return out


def spark_file(W, seed) -> tuple:
    """SF1 lineitem as Spark's defaults write it (phase 11's file)."""
    return W.lineitem_parquet(W.SF1_ROWS, seed,
                              row_group_rows=SPARK_ROW_GROUP_ROWS,
                              **W.SPARK_DEFAULTS)


def phase_spark(pt, W, device_scan, q6, kernels, card, seed, launches,
                full_scan, keep: dict) -> dict:
    """Phase 11: SF1 lineitem, all 16 columns, as Spark's defaults write
    it (``W.SPARK_DEFAULTS``: SNAPPY, every column dictionary-encoded with
    the fallback to PLAIN at a 1 MiB dictionary, 1 MiB pages of at most
    20,000 rows; row groups of 1,048,576 rows as in phases 5-10): the scan
    exact, timed beside phase 8's UNCOMPRESSED scan of the same rows
    (``full_scan``: its median wall and file bytes), Q6 exact, row-group
    pruning on the sorted ``l_orderkey`` against the generator's own
    per-group bounds, and a predicate that prunes every group; then 11b
    (:func:`phase_spark_v2`).  Returns B4's and B7's results on the
    largest inputs this scan hands them; keeps the file in ``keep["raw"]``
    for phase 19."""
    t0 = time.perf_counter()
    raw, data, _ = spark_file(W, seed)
    keep["raw"] = raw
    log(f"[spark] SF1 lineitem as Spark writes it ({W.SPARK_DEFAULTS}): "
        f"{W.SF1_ROWS} rows, {len(raw)} file bytes, written in "
        f"{time.perf_counter() - t0:.2f} s; row groups of "
        f"{SPARK_ROW_GROUP_ROWS} rows")
    spans = scan_split(device_scan, raw)            # also the warm-up
    kernels.reset()
    t0 = time.perf_counter()
    table = device_scan.scan_table(raw)
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    counts = kernels.counts()
    check_scanned(pt, W, table, data, {}, "Spark SF1")
    check_materialized(W, table, data, {}, "Spark SF1")
    torch.cuda.synchronize()
    add_counts(launches, kernels.counts())
    for name in ("segmented_copy", "extract_rows", "gather_rows",
                 "pack_rows", "u8_to_u32"):
        require(counts[name] > 0, f"Spark scan: {name} never launched")
    log(f"[spark] SF1: every row of every column equals the generator, "
        f"strings materialized; page runs by column "
        f"{run_kinds(device_scan, raw)}; host-decoded columns "
        f"{table.host_decoded_cols}; launches (scan) {counts}")
    del table
    torch.cuda.empty_cache()
    wall = median_wall(lambda: device_scan.scan_table(raw))
    full_wall, full_bytes = full_scan
    log(f"[spark] SF1 SNAPPY scan_table of 16 columns: median of {PATH_REPS} "
        f"{wall * 1e3:.3f} ms = {len(raw) / wall / 1e9:.3f} GB/s of "
        f"{len(raw)} file bytes ({full_bytes / wall / 1e9:.3f} GB/s of the "
        f"UNCOMPRESSED file's bytes), first {first * 1e3:.3f} ms; phase 8's "
        f"UNCOMPRESSED scan of the same rows {full_wall * 1e3:.3f} ms = "
        f"{full_bytes / full_wall / 1e9:.3f} GB/s [{card}]")
    log("[spark] split " + json.dumps(dict(
        spans, median_wall_ms=round(wall * 1e3, 3),
        gb_per_s=round(len(raw) / wall / 1e9, 3), file_bytes=len(raw),
        phase8_wall_ms=round(full_wall * 1e3, 3), card=card)))

    run_q6(q6, kernels, raw, data, "Spark SF1", card, launches)

    # pruning: [lo, hi] on the sorted l_orderkey, against the generator's
    # own per-group bounds
    keys = data["l_orderkey"]
    rg = SPARK_ROW_GROUP_ROWS
    lo, hi = int(keys[5 * rg // 2]), int(keys[7 * rg // 2])
    bounds = [(a, min(a + rg, keys.shape[0]))
              for a in range(0, keys.shape[0], rg)]
    want = [g for g, (a, b) in enumerate(bounds)
            if not (keys[a:b].max() < lo or keys[a:b].min() > hi)]
    require(0 < len(want) < len(bounds), f"pruning keeps {want}")
    conds = [("l_orderkey", "ge", lo), ("l_orderkey", "le", hi)]
    kernels.reset()
    t0 = time.perf_counter()
    table = device_scan.scan_table(raw, rowgroup_predicate=conds)
    torch.cuda.synchronize()
    pruned_s = time.perf_counter() - t0
    add_counts(launches, kernels.counts())
    a, b = bounds[want[0]][0], bounds[want[-1]][1]
    require(want == list(range(want[0], want[-1] + 1)),
            f"kept groups {want} are not contiguous")
    check_scanned(pt, W, table, slice_rows(data, a, b), {}, "Spark pruned")
    log(f"[spark] pruning l_orderkey in [{lo}, {hi}]: groups {want} of "
        f"{len(bounds)} kept, as the generator's bounds reckon; rows "
        f"[{a}, {b}) equal the generator's, {pruned_s * 1e3:.3f} ms [{card}]")
    schema = table.schema
    del table
    none = device_scan.scan_table(raw,
                                  rowgroup_predicate=[("l_orderkey", "lt", 0)])
    require(none.num_rows == 0 and none.schema == schema,
            f"the all-pruned scan gave {none.num_rows} rows of {none.schema}")
    log(f"[spark] all groups pruned: zero rows, dtypes {none.schema}")

    def keep(captured, name, args):
        nb = bytes_moved(name, args)
        if name not in captured or nb > captured[name][0]:
            captured[name] = (nb, args)

    captured = record_inputs(kernels, ("segmented_copy", "u8_to_u32"), keep,
                             lambda: device_scan.scan_table(raw))
    results = {("SF1 Spark scan", name): measure(
        kernels, name, args, card, "SF1 Spark scan", library_call(name, args))
        for name, (_, args) in sorted(captured.items())}
    del captured, raw, data
    torch.cuda.empty_cache()
    phase_spark_v2(pt, W, device_scan, kernels, card, seed, launches)
    return results


def phase_spark_v2(pt, W, device_scan, kernels, card, seed, launches) -> None:
    """Phase 11b: 1,048,576 rows as Spark writes them with
    ``parquet.writer.version=v2`` and timestamp dates: GZIP, DataPageV2,
    10% nulls, the three dates INT96 and dictionary-encoded, the fallback
    to DELTA_BINARY_PACKED for the keys and DELTA_BYTE_ARRAY for
    ``l_comment`` (one row group: Spark's 128 MiB row groups hold these
    rows), exact against the generator."""
    raw, data, valid = W.lineitem_parquet(
        NULL_ROWS, seed + 5, row_group_rows=NULL_ROWS,
        null_fraction=NULL_FRACTION, int96_dates=True,
        **dict(W.SPARK_DEFAULTS, codec="GZIP", page_version=2))
    kernels.reset()
    table = device_scan.scan_table(raw)
    torch.cuda.synchronize()
    counts = kernels.counts()
    add_counts(launches, counts)
    dates = ("l_shipdate", "l_commitdate", "l_receiptdate")
    for name in dates:
        require(table[[n for n, *_ in W.LINEITEM].index(name)].dtype
                == pt.timestamp_ns, f"11b: {name} is not TIMESTAMP_NS")
    ns = dict(data, **{n: data[n].astype(np.int64) * W.NS_PER_DAY
                       for n in dates})
    check_scanned(pt, W, table, ns, valid, "Spark v2")
    check_materialized(W, table, data, valid, "Spark v2")
    require(table.host_decoded_cols > 0, "11b: no DELTA page was decoded")
    wall = median_wall(lambda: device_scan.scan_table(raw))
    log(f"[spark] v2: {NULL_ROWS} rows, GZIP, DataPageV2, "
        f"{NULL_FRACTION:.0%} nulls, INT96 dates, {len(raw)} bytes: exact; "
        f"{table.host_decoded_cols} columns decoded on the host (DELTA); "
        f"median of {PATH_REPS} {wall * 1e3:.3f} ms; launches {counts} "
        f"[{card}]")
    del table
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 12: the JNI/C surface on the card
# ---------------------------------------------------------------------------

# the kernels the bridge's row conversion launches on SF1's 16 columns
JNI_KERNELS = ("pack_windows", "unpack_rows", "segmented_copy")
# bytes held against each other at a time when 1 GB of rows is compared
COMPARE_CHUNK = 1 << 26


class JniEnv:
    """A minimal ``JNIEnv`` in ctypes: the slots of the JNI function table
    that the RowConversion, HostTable, HostColumn and ParquetFooter natives
    touch (JNI 6 numbering, as ``csrc/jni_min.h`` has it), over Python
    objects registered by id.  ``thrown`` holds (class, message) of the
    last exception a native threw."""

    SLOTS = 233

    def __init__(self):
        self.objects, self.thrown, self._keep = {}, None, []
        table = (C.c_void_p * self.SLOTS)()
        vp, i32, i64 = C.c_void_p, C.c_int32, C.c_int64

        def put(slot, restype, argtypes, fn):
            cb = C.CFUNCTYPE(restype, *argtypes)(fn)
            self._keep.append(cb)
            table[slot] = C.cast(cb, vp)

        def region(env, arr, start, n, out):
            for i in range(n):
                out[i] = self.objects[arr][start + i]

        def set_region(env, arr, start, n, vals):
            for i in range(n):
                self.objects[arr][start + i] = vals[i]

        def utf(env, s, is_copy):
            buf = C.create_string_buffer(self.objects[s].encode())
            self._keep.append(buf)
            return C.cast(buf, vp).value

        def throw(env, cls, msg):
            self.thrown = (self.objects[cls], msg.decode())
            return 0

        put(6, vp, [vp, C.c_char_p], lambda env, n: self.ref(n.decode()))
        put(14, i32, [vp, vp, C.c_char_p], throw)
        put(169, vp, [vp, vp, vp], utf)
        put(170, None, [vp, vp, C.c_char_p], lambda env, s, c: None)
        put(171, i32, [vp, vp], lambda env, a: len(self.objects[a]))
        put(173, vp, [vp, vp, i32], lambda env, a, i: self.objects[a][i])
        put(180, vp, [vp, i32], lambda env, n: self.ref([0] * n))
        put(203, None, [vp, vp, i32, i32, C.POINTER(i32)], region)
        put(204, None, [vp, vp, i32, i32, C.POINTER(i64)], region)
        put(212, None, [vp, vp, i32, i32, C.POINTER(i64)], set_region)
        self._table = table
        self._table_p = C.cast(table, vp)
        self.env = C.pointer(self._table_p)

    def ref(self, obj) -> int:
        """A "jobject" for ``obj`` (a list stands for a Java array)."""
        oid = len(self.objects) + 1
        self.objects[oid] = obj
        return oid


def jni_natives(lib) -> dict:
    """The JNI natives phase 12 calls, by ``Class_method``, each taking the
    env first (the jclass argument is passed as null)."""
    vp, i32, i64 = C.c_void_p, C.c_int32, C.c_int64
    sigs = {
        "HostColumn_makeFixed": (i64, [i32, i32, i64, i64, i64]),
        "HostColumn_makeString": (i64, [i64, i64, i64, i64]),
        "HostColumn_close": (None, [i64]),
        "HostColumn_dataSize": (i64, [i64]),
        "HostColumn_dataAddress": (i64, [i64]),
        "HostColumn_offsetsAddress": (i64, [i64]),
        "HostColumn_validAddress": (i64, [i64]),
        "HostTable_makeTable": (i64, [vp]),
        "HostTable_rowCount": (i64, [i64]),
        "HostTable_columns": (vp, [i64]),
        "HostTable_close": (None, [i64]),
        "RowConversion_convertToRows": (i64, [i64]),
        "RowConversion_convertFromRows": (i64, [i64, i32, vp, vp]),
        "RowConversion_freeRows": (None, [i64]),
        "ParquetFooter_readAndFilter": (i64, [i64, i64, i64, i64, vp, vp, vp,
                                              i32, C.c_uint8]),
        "ParquetFooter_getNumRows": (i64, [i64]),
        "ParquetFooter_getNumColumns": (i64, [i64]),
        "ParquetFooter_serializeThriftFile": (i64, [i64, i64, i64]),
        "ParquetFooter_close": (None, [i64]),
    }
    out = {}
    for name, (restype, argtypes) in sigs.items():
        fn = C.CFUNCTYPE(restype, vp, vp, *argtypes)(
            ("Java_com_tpu_rapids_jni_" + name, lib))
        out[name] = (lambda f: lambda env, *a: f(env.env, None, *a))(fn)
    return out


def c_view(addr, n: int, dtype=np.uint8) -> np.ndarray:
    """``n`` items of ``dtype`` at C address ``addr``, a numpy view."""
    if not n:
        return np.zeros(0, dtype)
    buf = (C.c_uint8 * (n * np.dtype(dtype).itemsize)).from_address(addr)
    return np.frombuffer(buf, dtype)


def same_bytes(a: np.ndarray, b: np.ndarray) -> bool:
    """Byte equality, COMPARE_CHUNK bytes at a time."""
    a, b = a.view(np.uint8).reshape(-1), b.view(np.uint8).reshape(-1)
    return a.size == b.size and all(
        np.array_equal(a[i:i + COMPARE_CHUNK], b[i:i + COMPARE_CHUNK])
        for i in range(0, a.size, COMPARE_CHUNK))


def handle_columns(lib, t) -> list:
    """(type, data, offsets, validity) views of every column of host table
    ``t``; the column handles it opens are freed (the table keeps the
    buffers)."""
    n = lib.srjt_table_rows(t)
    out = []
    for i in range(lib.srjt_table_cols(t)):
        h = lib.srjt_table_column(t, i)
        offs, valid = lib.srjt_column_offsets(h), lib.srjt_column_valid(h)
        out.append((lib.srjt_column_type(h),
                    c_view(lib.srjt_column_data(h),
                           lib.srjt_column_data_size(h)),
                    c_view(offs, n + 1, np.int32) if offs else None,
                    c_view(valid, n) if valid else None))
        lib.srjt_column_free(h)
    return out


def row_batch(lib, rows) -> tuple:
    """(bytes, int32 offsets) views of a one-batch RowBatches handle."""
    require(lib.srjt_rows_num_batches(rows) == 1, "expected one row batch")
    n = lib.srjt_rows_batch_rows(rows, 0)
    return (c_view(lib.srjt_rows_batch_data(rows, 0),
                   lib.srjt_rows_batch_size(rows, 0)),
            c_view(lib.srjt_rows_batch_offsets(rows, 0), n + 1, np.int32))


def host_handle(lib, cols) -> int:
    """A host table handle holding copies of ``interop`` column tuples."""
    handles = []
    for tid, scale, data, offs, valid in cols:
        v = None if valid is None else valid.astype(np.uint8)
        vp = None if v is None else v.ctypes.data
        h = (lib.srjt_column_fixed(tid, scale, data.shape[0],
                                   data.ctypes.data, vp) if offs is None else
             lib.srjt_column_string(offs.size - 1, offs.ctypes.data,
                                    data.ctypes.data, vp))
        require(bool(h), f"the host table refused a column of type {tid}")
        handles.append(h)
    t = lib.srjt_table((C.c_void_p * len(handles))(*handles), len(handles))
    for h in handles:
        lib.srjt_column_free(h)
    require(bool(t), "srjt_table refused the columns")
    return t


def split_ms(steps, cleanup, reps: int = PATH_REPS) -> dict:
    """Median ms of each step of a chain, run one after another with a
    synchronisation around each: ``steps`` is [(name, fn)], each fn called
    with the previous one's result (the first with None), the last result
    handed to ``cleanup`` outside the timing."""
    times = collections.defaultdict(list)
    for _ in range(reps):
        out = None
        for name, fn in steps:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(out)
            torch.cuda.synchronize()
            times[name].append(time.perf_counter() - t0)
        cleanup(out)
    return {k: statistics.median(v) * 1e3 for k, v in times.items()}


def phase_jni(pt, T, W, interop, bridge, native, device_scan, kernels, card,
              raw, seed, launches) -> None:
    """Phase 12: the JNI/C surface on the card.  SF1's 16 columns as a C
    host table through ``srjt_to_rows_device`` and back through
    ``srjt_from_rows_device``, exact against the port's
    ``convert_to_rows`` and the host C++ engine; the RowConversion natives
    on the 12-column table through a ctypes JNIEnv, and ParquetFooter's on
    the SF1 file's footer; the walls and their split."""
    lib = native.jni_library()
    scanned = device_scan.scan_table(raw)
    table = pt.Table([c.materialize() if isinstance(c, pt.DictColumn) else c
                      for c in scanned.columns])
    del scanned
    t0 = time.perf_counter()
    cols = interop.table_to_numpy(table)
    t = host_handle(lib, cols)
    log(f"[jni] SF1 16 columns as a host table handle in "
        f"{time.perf_counter() - t0:.2f} s")
    tids = np.asarray([c[0] for c in cols], np.int32)
    scales = np.asarray([c[1] for c in cols], np.int32)
    ncols = len(cols)

    # the main path: the C entry points
    kernels.reset()
    rows = lib.srjt_to_rows_device(t)
    require(bool(rows), "srjt_to_rows_device failed: "
            + lib.srjt_device_last_error().decode())
    back = lib.srjt_from_rows_device(rows, 0, tids.ctypes.data,
                                     scales.ctypes.data, ncols)
    require(bool(back), "srjt_from_rows_device failed: "
            + lib.srjt_device_last_error().decode())
    torch.cuda.synchronize()
    counts = kernels.counts()
    for name in JNI_KERNELS:
        require(counts[name] > 0, f"jni: {name} never launched")
    add_counts(launches, counts)

    data, offs = row_batch(lib, rows)
    want = pt.convert_to_rows(table)
    require(len(want) == 1, "convert_to_rows: expected one batch")
    require(same_bytes(data, want[0].data.cpu().numpy())
            and same_bytes(offs, want[0].offsets.cpu().numpy()),
            "srjt_to_rows_device differs from convert_to_rows")
    del want
    host = lib.srjt_to_rows(t)
    require(bool(host), "srjt_to_rows failed")
    hdata, hoffs = row_batch(lib, host)
    require(same_bytes(data, hdata) and same_bytes(offs, hoffs),
            "srjt_to_rows_device differs from the host engine")
    for ci, (a, b) in enumerate(zip(handle_columns(lib, t),
                                    handle_columns(lib, back))):
        require(a[0] == b[0] and same_bytes(a[1], b[1]),
                f"jni: column {ci} data differs after the round trip")
        require((a[2] is None) == (b[2] is None)
                and (a[2] is None or same_bytes(a[2], b[2])),
                f"jni: column {ci} offsets differ after the round trip")
        valid = np.ones(table.num_rows, np.uint8) if a[3] is None else a[3]
        require(b[3] is not None and same_bytes(valid, b[3]),
                f"jni: column {ci} validity differs after the round trip")
    log(f"[jni] SF1 16 columns: srjt_to_rows_device gave {data.size} row "
        f"bytes equal to convert_to_rows' and the host engine's; "
        f"srjt_from_rows_device gave back every column exactly; launches "
        f"{counts}")
    lib.srjt_table_free(back)

    # the walls (each call alone, its result freed outside the timing),
    # then the bridge's steps one by one
    free_rows, free_table = lib.srjt_rows_free, lib.srjt_table_free
    batch = pt.convert_to_rows(table)[0]
    schema = table.schema
    walls = {}
    for name, fn, cleanup in (
            ("to_rows_device", lambda _: lib.srjt_to_rows_device(t),
             free_rows),
            ("to_rows_host", lambda _: lib.srjt_to_rows(t), free_rows),
            ("convert_to_rows", lambda _: pt.convert_to_rows(table),
             lambda _: None),
            ("from_rows_device", lambda _: lib.srjt_from_rows_device(
                rows, 0, tids.ctypes.data, scales.ctypes.data, ncols),
             free_table),
            ("from_rows_host", lambda _: lib.srjt_from_rows(
                rows, 0, tids.ctypes.data, scales.ctypes.data, ncols),
             free_table),
            ("convert_from_rows", lambda _: pt.convert_from_rows(
                batch, schema), lambda _: None)):
        walls[name] = split_ms([(name, fn)], cleanup)[name]
    del batch
    dev = table.device
    split_to = split_ms([
        ("read", lambda _: bridge.read_table(lib, t)),
        ("upload", lambda c: bridge.upload(c, dev)),
        ("convert", lambda tb: pt.convert_to_rows(tb)),
        ("download", lambda b: bridge.download(b)),
        ("import", lambda h: bridge.import_rows(lib, h))], free_rows)
    split_from = split_ms([
        ("read", lambda _: bridge.read_rows(lib, rows, 0)),
        ("upload", lambda r: bridge.upload_rows(r, dev)),
        ("convert", lambda b: pt.convert_from_rows(b, schema)),
        ("download", lambda tb: bridge.download_table(tb)),
        ("import", lambda c: bridge.import_table(lib, c))], free_table)
    log(f"[jni] SF1 walls, median of {PATH_REPS} (ms): " + ", ".join(
        f"{k} {v:.3f}" for k, v in walls.items()) + f" [{card}]")
    log("[jni] split " + json.dumps({
        "card": card, "rows": table.num_rows, "row_bytes": int(data.size),
        "column_bytes": sum(a.nbytes for c in cols for a in c[2:]
                            if a is not None),
        "walls_ms": walls, "to_rows_device_split_ms": split_to,
        "from_rows_device_split_ms": split_from}))
    for h in (rows, host):
        lib.srjt_rows_free(h)
    lib.srjt_table_free(t)
    del table, cols, data, offs, hdata, hoffs
    torch.cuda.empty_cache()

    phase_jni_natives(T, W, lib, kernels, card, raw, seed, launches)


def phase_jni_natives(T, W, lib, kernels, card, raw, seed,
                      launches) -> None:
    """The RowConversion natives through a ctypes JNIEnv on the 12-column
    table of phase 3 (1,048,576 rows, 10% nulls), against the host engine;
    ParquetFooter's on the SF1 file's footer, against ``footer.py``."""
    from spark_rapids_jni_tpu_torch.parquet import footer
    jni, env = jni_natives(lib), JniEnv()
    n_cols, every, max_len = CASES["spark_12_2str"]
    cols = make_columns(T, n_cols, every, max_len, ROWS,
                        np.random.default_rng(seed + 1))
    handles = []
    for tid, scale, data, offs, valid in cols:
        v = valid.astype(np.uint8)
        h = (jni["HostColumn_makeFixed"](env, tid, scale, ROWS,
                                         data.ctypes.data, v.ctypes.data)
             if offs is None else
             jni["HostColumn_makeString"](env, ROWS, offs.ctypes.data,
                                          data.ctypes.data, v.ctypes.data))
        require(bool(h) and env.thrown is None, f"makeFixed/makeString: "
                f"{env.thrown}")
        handles.append(h)
    t = jni["HostTable_makeTable"](env, env.ref(handles))
    require(bool(t) and env.thrown is None, f"makeTable: {env.thrown}")
    for h in handles:
        jni["HostColumn_close"](env, h)
    tids = env.ref([c[0] for c in cols])
    scales = env.ref([c[1] for c in cols])

    kernels.reset()
    rows = jni["RowConversion_convertToRows"](env, t)
    require(bool(rows) and env.thrown is None,
            f"convertToRows threw {env.thrown}")
    back = jni["RowConversion_convertFromRows"](env, rows, 0, tids, scales)
    require(bool(back) and env.thrown is None,
            f"convertFromRows threw {env.thrown}")
    torch.cuda.synchronize()
    counts = kernels.counts()
    for name in JNI_KERNELS:
        require(counts[name] > 0, f"jni natives: {name} never launched")
    add_counts(launches, counts)

    host = lib.srjt_to_rows(t)
    data, offs = row_batch(lib, rows)
    hdata, hoffs = row_batch(lib, host)
    require(same_bytes(data, hdata) and same_bytes(offs, hoffs),
            "convertToRows differs from the host engine")
    lib.srjt_rows_free(host)
    out = env.objects[jni["HostTable_columns"](env, back)]
    require(jni["HostTable_rowCount"](env, back) == ROWS, "row count differs")
    for ci, (h, (tid, _, cdata, coffs, valid)) in enumerate(zip(out, cols)):
        got = c_view(jni["HostColumn_dataAddress"](env, h),
                     jni["HostColumn_dataSize"](env, h))
        require(same_bytes(got, cdata), f"natives: column {ci} data differs")
        if coffs is not None:
            got = c_view(jni["HostColumn_offsetsAddress"](env, h), ROWS + 1,
                         np.int32)
            require(same_bytes(got, coffs),
                    f"natives: column {ci} offsets differ")
        got = c_view(jni["HostColumn_validAddress"](env, h), ROWS)
        require(same_bytes(got, valid.astype(np.uint8)),
                f"natives: column {ci} validity differs")
        jni["HostColumn_close"](env, h)
    jni["RowConversion_freeRows"](env, rows)
    for h in (t, back):
        jni["HostTable_close"](env, h)
    log(f"[jni] natives: convertToRows of the 12-column table "
        f"({ROWS} rows, {data.size} row bytes) equals the host engine, "
        f"convertFromRows gives back every column; launches {counts} "
        f"[{card}]")

    # ParquetFooter on the SF1 file's footer
    blob = footer.extract_footer_bytes(bytes(raw))
    names = [name for name, *_ in W.LINEITEM]
    schema = footer.StructElement("root", *map(footer.ValueElement, names))
    want = footer.read_and_filter(blob, 0, len(raw), schema)
    flat, nc, tags = schema.flatten_depth_first()
    buf = np.frombuffer(blob, np.uint8).copy()
    h = jni["ParquetFooter_readAndFilter"](
        env, buf.ctypes.data, buf.size, 0, len(raw), env.ref(
            [env.ref(s) for s in flat]), env.ref(nc), env.ref(tags),
        len(schema.children), 0)
    require(bool(h) and env.thrown is None, f"readAndFilter threw "
            f"{env.thrown}")
    n_rows = jni["ParquetFooter_getNumRows"](env, h)
    require(n_rows == want.num_rows, f"ParquetFooter rows {n_rows}, "
            f"footer.py {want.num_rows}")
    require(jni["ParquetFooter_getNumColumns"](env, h) == want.num_columns,
            "ParquetFooter columns differ from footer.py")
    ser = want.serialize_thrift_file()
    got = np.zeros(len(ser) + 64, np.uint8)
    size = jni["ParquetFooter_serializeThriftFile"](env, h, got.ctypes.data,
                                                    got.size)
    require(bytes(got[:size]) == ser, "ParquetFooter's serialized footer "
            "differs from footer.py's")
    jni["ParquetFooter_close"](env, h)
    log(f"[jni] ParquetFooter.readAndFilter of the SF1 footer ({len(blob)} "
        f"bytes, {len(names)} columns): {n_rows} rows, its serialized "
        f"footer equal to footer.py's")


# ---------------------------------------------------------------------------
# phase 13: TPC-DS joins
# ---------------------------------------------------------------------------

# BASELINE config #3's SF1 scale, tools/query_bench.py:134-135's arguments
TPCDS_ARGS = dict(n_sales=10_000_000, n_items=20_000, n_stores=50, seed=5)
# the kernels phase 13 launches: B3 for its string keys' byte matrix, B4
# for the STRING gathers of the keys, B7 for the scan
TPCDS_KERNELS = ("unpack_rows", "segmented_copy", "u8_to_u32")
TPCDS_PROFILED = ("q3", "q_channel_day", "q36_rollup", "q27_cube")
TPCDS_TOP = 8


def profile_summary(fn, card, warm: bool = True, need: tuple = (),
                    tries: int = 1) -> dict:
    """Device busy ms, idle share and the largest device ops of one call
    of ``fn`` after a warm-up (unless the caller warmed it), by
    ``torch.profiler``.  A window that lacks a device row whose name
    holds each string of ``need`` (the profiler drops a window's first
    device records at times) is taken again, up to ``tries`` windows;
    ``windows`` and ``rows_complete`` say how many were taken and whether
    the last one had them."""
    from torch_profile_rowconv import (NAME_CHARS, _busy_us, _device_total,
                                       profile_call)
    if warm:
        fn()
    for window in range(1, tries + 1):
        prof, wall_us = profile_call(fn)
        rows = {e.name for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA}
        complete = all(any(s in r for r in rows) for s in need)
        if complete:
            break
    busy = _busy_us(prof)
    avgs = sorted(prof.key_averages(), key=_device_total, reverse=True)
    top = [(a.key[:NAME_CHARS], round(_device_total(a) / 1e3, 3), a.count)
           for a in avgs[:TPCDS_TOP] if _device_total(a) > 0]
    out = dict(wall_ms=round(wall_us / 1e3, 3),
               device_busy_ms=round(busy / 1e3, 3),
               idle_share=round(1 - busy / wall_us, 3), top=top, card=card)
    if need:
        out.update(windows=window, rows_complete=complete)
    return out


def q3_indices(tables, params, join_plan, engine) -> list:
    """q3's two joins' indices with ``engine`` pinned: store_sales ⋈ the
    filtered items, then that join's rows ⋈ the filtered dates."""
    from spark_rapids_jni_tpu_torch import ops
    from spark_rapids_jni_tpu_torch.models import tpcds
    ss, item, dd = (tables["store_sales"], tables["item"],
                    tables["date_dim"])
    item_cols, date_cols = tpcds.ITEM_COLS, tpcds.DATE_COLS
    item_f = ops.apply_boolean_mask(item, tpcds._eq_scalar_mask(
        item[item_cols.index("i_manufact_id")], params["manufact_id"]))
    dd_f = ops.apply_boolean_mask(dd, tpcds._eq_scalar_mask(
        dd[date_cols.index("d_moy")], params["moy"]))
    ss_item = tpcds.SS_COLS.index("ss_item_sk")
    ss_date = tpcds.SS_COLS.index("ss_sold_date_sk")
    with join_plan.force_engine(engine):
        li, ri = ops.join_indices(ss[ss_item], item_f[0], "inner")
        j1 = ops.inner_join(ss, item_f, ss_item, 0)
        li2, ri2 = ops.join_indices(j1[ss_date], dd_f[0], "inner")
        torch.cuda.synchronize()
        return [li, ri, li2, ri2]


def tpcds_inputs(args: dict) -> tuple:
    """The TPC-DS files and arrays of ``tools/torch_tpcds_parquet.py`` for
    ``args``, each query's parameters and the numpy oracle's answers."""
    import torch_tpcds_oracle as O
    import torch_tpcds_parquet as TW
    from spark_rapids_jni_tpu_torch.models import tpcds

    t0 = time.perf_counter()
    files, arrays = TW.tpcds_parquet(**args)
    log(f"[tpcds] {args}: files written in "
        f"{time.perf_counter() - t0:.2f} s, rows "
        f"{ {t: len(next(iter(a.values()))) for t, a in arrays.items()} }, "
        f"bytes { {t: len(b) for t, b in files.items()} }")
    params = O.query_params(arrays)
    t0 = time.perf_counter()
    want = {name: O.answer(name, arrays, params[name])
            for name in tpcds.QUERIES}
    log(f"[tpcds] the numpy oracle answered in "
        f"{time.perf_counter() - t0:.2f} s; parameters {params}")
    return files, arrays, params, want


def phase_tpcds(kernels, card, launches) -> tuple:
    """Phase 13: the 50 TPC-DS queries on a 10,000,000-row store_sales,
    each against the numpy oracle; both engines on q3; B3, B4 and B7 on
    the inputs the queries hand them; four queries profiled; the
    build-index cache's bytes and evictions.  Returns the kernel results
    and what phase 15 reuses: the tables, parameters, oracle answers and
    each query's eager median."""
    import torch_tpcds_oracle as O
    from spark_rapids_jni_tpu_torch.models import tpcds
    from spark_rapids_jni_tpu_torch.ops import join_plan

    t_phase = time.perf_counter()
    files, arrays, params, want = tpcds_inputs(TPCDS_ARGS)

    kernels.reset()
    t0 = time.perf_counter()
    tables = tpcds.load_tables(files)
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    counts = kernels.counts()
    add_counts(launches, counts)
    require(all(t.device.type == "cuda" for t in tables.values()),
            "load_tables left a table off the card")
    load_wall = median_wall(lambda: tpcds.load_tables(files))
    total_bytes = sum(len(b) for b in files.values())
    log(f"[tpcds] load_tables: first {first * 1e3:.3f} ms, median of "
        f"{PATH_REPS} {load_wall * 1e3:.3f} ms for {total_bytes} file "
        f"bytes ({total_bytes / load_wall / 1e9:.3f} GB/s); launches "
        f"{counts} [{card}]")

    phase_counts = collections.Counter(counts)
    report = {"card": card, "load_tables_ms": round(load_wall * 1e3, 3),
              "queries": {}}
    for name, fn in tpcds.QUERIES.items():
        kw = params[name]
        kernels.reset()
        join_plan.reset_counts()
        t0 = time.perf_counter()
        out = fn(tables, **kw)
        torch.cuda.synchronize()
        first = time.perf_counter() - t0
        counts = kernels.counts()
        paths = dict(sorted(join_plan.COUNTS.items()))
        add_counts(launches, counts)
        phase_counts.update(counts)
        try:
            rel = O.check(name, out, want[name])
        except AssertionError as e:
            raise SmokeFailure(f"tpcds {name}: {e}") from None
        wall = median_wall(lambda: fn(tables, **kw))
        report["queries"][name] = dict(
            wall_ms=round(wall * 1e3, 3), first_ms=round(first * 1e3, 3),
            rows=out.num_rows, max_rel_err=rel, paths=paths,
            launches=counts)
        log(f"[tpcds] {name} {kw}: {out.num_rows} rows equal the oracle "
            f"(floats' largest relative error {rel:.3e}); median of "
            f"{PATH_REPS} {wall * 1e3:.3f} ms, first {first * 1e3:.3f} ms; "
            f"engines and paths {paths}; launches {counts} [{card}]")
        del out
    for name in TPCDS_KERNELS:
        require(phase_counts[name] > 0, f"tpcds: {name} never launched")
    report["index_cache_after_queries"] = join_plan.index_cache_stats()
    log(f"[tpcds] build-index cache after the queries: "
        f"{report['index_cache_after_queries']}")

    # the engines against each other at full size
    q3p = params["q3"]
    dense = q3_indices(tables, q3p, join_plan, "dense")
    srt = q3_indices(tables, q3p, join_plan, "sorted")
    require(all(torch.equal(a, b) for a, b in zip(dense, srt)),
            "q3: the dense and sorted engines give different indices")
    log(f"[tpcds] q3's two joins, dense vs sorted engine: identical "
        f"indices ({dense[0].numel()} and {dense[2].numel()} pairs)")
    del dense, srt

    for name in TPCDS_PROFILED:
        prof = profile_summary(lambda: tpcds.QUERIES[name](tables,
                                                          **params[name]),
                             card)
        report["queries"][name]["profile"] = prof
        log(f"[tpcds] profile {name}: " + json.dumps(prof))

    def keep(captured, name, args):
        nb = bytes_moved(name, args)
        if name not in captured or nb > captured[name][0]:
            captured[name] = (nb, args)

    def run_all():
        t = tpcds.load_tables(files)
        for name, fn in tpcds.QUERIES.items():
            fn(t, **params[name])

    captured = record_inputs(kernels, TPCDS_KERNELS, keep, run_all)
    results = {("TPC-DS", name): measure(kernels, name, args, card, "TPC-DS",
                                         library_call(name, args))
               for name, (_, args) in sorted(captured.items())}
    cache = join_plan.index_cache_stats()
    log(f"[tpcds] build-index cache at the end of the phase: "
        f"{cache['entries']} entries, {cache['bytes']} bytes (cap "
        f"{join_plan.INDEX_CACHE_CAP}), {cache['evictions']} evictions")
    report["index_cache"] = cache
    report["launches"] = dict(phase_counts)
    report["phase_s"] = round(time.perf_counter() - t_phase, 1)
    log("[tpcds] summary " + json.dumps(report))
    eager_ms = {name: q["wall_ms"] for name, q in report["queries"].items()}
    query_launches = {name: q["launches"]
                      for name, q in report["queries"].items()}
    del captured
    torch.cuda.empty_cache()
    return results, (tables, params, want, eager_ms, files, query_launches,
                     arrays)


# ---------------------------------------------------------------------------
# phase 15: the TPC-DS queries compiled to CUDA graphs
# ---------------------------------------------------------------------------

# the kernels the compiled queries' graphs must hold: B3 (the string keys'
# byte matrix) and B4 (STRING gathers).  B7 runs in the scan only, which
# reads host files and so lies outside every graph; its count is printed.
COMPILED_KERNELS = ("unpack_rows", "segmented_copy")
GRAPH_KERNELS = ("unpack_rows", "segmented_copy", "u8_to_u32")
# the stale-tape check: q3 compiled on seed 7's tables, run on seed 77's
STALE_ARGS = dict(n_sales=1_000_000, n_items=20_000, n_stores=50)
STALE_SEEDS = (7, 77)


def same_as_expected(O, name: str, got, expected, want) -> None:
    """A compiled result equals the capture run's: the schema, every
    integer, key and string exactly, each float within a relative 1e-12
    of the magnitude the oracle holds it to (``want``'s scale: a lag's
    difference against its two sums); a float sum's atomics add in any
    order."""
    require(got.schema == expected.schema,
            f"compiled {name}: schema differs from the capture run")
    try:
        O.check(name, got, O.as_answer(expected, want))
    except AssertionError as e:
        raise SmokeFailure(f"compiled {name} against its capture run: "
                           f"{e}") from None


def stale_tape_check(card) -> dict:
    """q3 compiled on tables at seed 7, run on tables of the same row
    counts at seed 77 (two string columns' chars differ in length, so
    ``run`` captures a graph for them under the old tape first): it must
    raise StaleTapeError, and compiled again on them it must give the
    oracle's answer."""
    import torch_tpcds_oracle as O
    import torch_tpcds_parquet as TW
    from spark_rapids_jni_tpu_torch.models import compiled, tpcds

    made = []
    for seed in STALE_SEEDS:
        files, arrays = TW.tpcds_parquet(seed=seed, **STALE_ARGS)
        made.append((tpcds.load_tables(files), arrays))
    (tables, arrays), (tables2, arrays2) = made
    params = O.query_params(arrays)["q3"]
    qfn = functools.partial(tpcds.QUERIES["q3"], **params)
    cq = compiled.compile_query(qfn, tables)
    try:
        cq.run(tables2)
    except compiled.StaleTapeError as e:
        message = str(e)
    else:
        raise SmokeFailure("compiled q3 ran on seed 77's tables without "
                           "StaleTapeError")
    torch.cuda.synchronize()
    fresh = compiled.compile_query(qfn, tables2)
    try:
        O.check("q3", fresh.run(tables2), O.answer("q3", arrays2, params))
    except AssertionError as e:
        raise SmokeFailure(f"compiled q3 on seed 77's tables: {e}") from None
    out = {"args": STALE_ARGS, "seeds": STALE_SEEDS, "error": message[:200],
           "tape_len": len(cq.tape),
           "tapes_differ_at": [i for i, (a, b) in
                               enumerate(zip(cq.tape, fresh.tape))
                               if a != b][:8]}
    log(f"[compiled] stale tape: q3 compiled at seed 7 raised on seed 77's "
        f"tables ({message[:160]}); compiled again there, it equals the "
        f"oracle [{card}]")
    return out


def phase_compiled(kernels, card, launches, tpcds_ctx) -> None:
    """Phase 15: each TPC-DS query of phase 13, on its tables, compiled
    (``models.compiled.compile_query``: an eager capture run, then one
    CUDA graph under the tape's replay), run checked and unchecked and
    held against the oracle and the capture run's result; the medians of
    the graph, the checked run and the eager tape replay beside phase
    13's eager median; the unchecked run under
    ``torch.cuda.set_sync_debug_mode("error")``; each graph's tape length,
    capture ms, pool bytes and kernel launches; then the stale-tape
    check."""
    import torch_tpcds_oracle as O
    from spark_rapids_jni_tpu_torch.models import compiled, tpcds
    from spark_rapids_jni_tpu_torch.models.compiled import _materialized
    from spark_rapids_jni_tpu_torch.utils import syncs

    tables, params, want, eager_ms = tpcds_ctx[:4]
    t_phase = time.perf_counter()
    report = {"card": card, "queries": {}}
    in_graphs = collections.Counter()
    kernels.reset()
    compiled.reset_counts()
    for name, fn in tpcds.QUERIES.items():
        qfn = functools.partial(fn, **params[name])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            cq = compiled.compile_query(qfn, tables)
        except Exception as e:
            raise SmokeFailure(f"compiled {name}: capture failed: "
                               f"{type(e).__name__}: {e}") from e
        torch.cuda.synchronize()
        compile_s = time.perf_counter() - t0
        out = cq.run(tables)
        try:
            O.check(name, out, want[name])
        except AssertionError as e:
            raise SmokeFailure(f"compiled {name}: {e}") from None
        same_as_expected(O, name, out, cq.expected, want[name])
        del out
        torch.cuda.synchronize()
        syncs_before = syncs.sync_count()
        torch.cuda.set_sync_debug_mode("error")
        try:
            again = cq.run_unchecked(tables)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        require(syncs.sync_count() == syncs_before,
                f"compiled {name}: run_unchecked counted a host sync")
        same_as_expected(O, name, again, cq.expected, want[name])
        del again

        def replay_eager():
            with syncs.replay(cq.tape):
                _materialized(qfn(tables))

        walls = {"graph_ms": median_wall(lambda: cq.run_unchecked(tables)),
                 "checked_ms": median_wall(lambda: cq.run(tables)),
                 "tape_replay_ms": median_wall(replay_eager)}
        walls = {k: round(v * 1e3, 3) for k, v in walls.items()}
        graph = {k: cq.graph_launches[k] for k in GRAPH_KERNELS}
        in_graphs.update(graph)
        report["queries"][name] = dict(
            eager_ms=eager_ms[name], **walls, tape_len=len(cq.tape),
            capture_ms=round(cq.graph_capture_ms, 3),
            pool_bytes=cq.graph_pool_bytes, static_bytes=cq.static_bytes,
            compile_s=round(compile_s, 3),
            graph_launches=graph)
        log(f"[compiled] {name}: equal to the oracle and the capture run; "
            f"graph {walls['graph_ms']:.3f} ms, checked "
            f"{walls['checked_ms']:.3f} ms, eager tape replay "
            f"{walls['tape_replay_ms']:.3f} ms, eager (phase 13) "
            f"{eager_ms[name]:.3f} ms; tape {len(cq.tape)}, capture "
            f"{cq.graph_capture_ms:.3f} ms, pool {cq.graph_pool_bytes} "
            f"bytes, in the graph {graph} [{card}]")
        del cq
        torch.cuda.empty_cache()
    counts = kernels.counts()
    add_counts(launches, counts)
    for name in COMPILED_KERNELS:
        require(in_graphs[name] > 0,
                f"compiled: {name} is in no captured graph")
    report["in_graphs"] = dict(in_graphs)
    report["launches"] = counts
    report["counts"] = dict(compiled.COUNTS)
    report["stale"] = stale_tape_check(card)
    report["phase_s"] = round(time.perf_counter() - t_phase, 1)
    log("[compiled] summary " + json.dumps(report))



# ---------------------------------------------------------------------------
# phase 16: SQL and the planner
# ---------------------------------------------------------------------------

# the kernels phase 16 launches: B3 for the string keys' byte matrix and B4
# for the STRING gathers of the SQL queries on the loaded tables, B7 in the
# FileCatalog scans
SQL_KERNELS = ("unpack_rows", "segmented_copy", "u8_to_u32")
# the FileCatalog queries: the 8 tpcds_plans queries, whose predicates sit
# on the dimensions, and q62_range, whose BETWEEN on ss_quantity reaches
# the fact table's scan, where the fused row filter prunes its rows
FILE_QUERIES = ("q3", "q7", "q19", "q42", "q52", "q55", "q65", "q_having",
                "q62_range")
# a float sum's atomics add in any order on the card, so two runs of one
# op sequence may differ in their last bits: floats are held to this
# relative error, everything else exactly (the CPU tests hold the bits)
SQL_FLOAT_RTOL = 1e-12
# FileCatalog queries profiled: the scan's host spans, device busy, idle
FILE_PROFILED = ("q3", "q62_range")


def nonzero(counts: dict) -> dict:
    return {k: v for k, v in counts.items() if v}


def paired_medians(fa, fb, reps: int = PATH_REPS) -> tuple:
    """Median seconds of ``fa`` and of ``fb``, their calls alternated so
    that both see the same host."""
    ta, tb = [], []
    for _ in range(reps):
        ta.append(median_wall(fa, 1))
        tb.append(median_wall(fb, 1))
    return statistics.median(ta), statistics.median(tb)


def sql_params(TS, name: str, picked: dict) -> dict:
    """A corpus query's parameters: phase 13's (``query_params``) where it
    takes them, ``tpcds_sql.PARAMS`` otherwise."""
    p = dict(TS.PARAMS.get(name, {}))
    p.update({k: v for k, v in picked.get(name, {}).items() if k in p})
    return p


def table_diff(got, want, what: str) -> tuple:
    """Holds ``got`` against ``want``: the schema, row count, validity,
    keys, integers and strings exactly, floats within SQL_FLOAT_RTOL on
    the valid rows.  Returns (bit-identical, largest relative float
    error)."""
    from spark_rapids_jni_tpu_torch.column import force_column
    require(got.num_columns == want.num_columns
            and got.num_rows == want.num_rows,
            f"{what}: {got.num_rows} x {got.num_columns}, expected "
            f"{want.num_rows} x {want.num_columns}")
    same, worst = True, 0.0
    for i, (a, b) in enumerate(zip(got.columns, want.columns)):
        a, b = force_column(a), force_column(b)
        require(a.dtype == b.dtype, f"{what}: column {i} is {a.dtype}, "
                f"expected {b.dtype}")
        va, vb = a.validity, b.validity
        require((va is None) == (vb is None)
                and (va is None or torch.equal(va, vb)),
                f"{what}: column {i}'s validity differs")
        if a.dtype.is_variable_width:
            require(torch.equal(a.offsets, b.offsets)
                    and torch.equal(a.data, b.data),
                    f"{what}: column {i}'s strings differ")
            continue
        da, db = a.data, b.data
        if not da.is_floating_point():
            require(torch.equal(da, db), f"{what}: column {i} differs")
            continue
        bits = {2: torch.int16, 4: torch.int32, 8: torch.int64}[
            da.element_size()]
        if torch.equal(da.view(bits), db.view(bits)):
            continue
        same = False
        ok = a.validity_or_true() & ~(da.isnan() & db.isnan())
        scale = torch.maximum(da.abs(), db.abs()).clamp_min(1e-300)
        rel = float(((da - db).abs() / scale)[ok].max()) if ok.any() else 0.0
        worst = max(worst, rel)
        require(rel <= SQL_FLOAT_RTOL, f"{what}: column {i} differs by a "
                f"relative {rel:.3e}")
    return same, worst


def file_split(fn) -> dict:
    """One profiled call of ``fn``: its wall, the scans' host spans
    (``parquet.scan.*``: the page walk with the staging, the
    decompression inside the walk, the row filter, the upload and the
    decode launches), the device's busy time and idle share, in ms."""
    from torch_profile_rowconv import _busy_us, profile_call
    from torch_profile_scan import _span_ms
    prof, wall = profile_call(fn)
    busy = _busy_us(prof)
    out = {k: round(v, 3) for k, v in _span_ms(prof).items()}
    out.update(wall_ms=round(wall / 1e3, 3),
               device_busy_ms=round(busy / 1e3, 3),
               idle_share=round(1 - busy / wall, 3))
    return out


def phase_sql(kernels, card, launches, tpcds_ctx) -> dict:
    """Phase 16: the 28 SQL queries of ``models.tpcds_sql`` through
    ``sql.compile_sql`` on phase 13's tables, each against its hand-fused
    twin (the 8 ``tpcds_plans`` queries) or its hand tree (the other 20,
    whose ``tpcds.QUERIES`` namesakes are other queries), the oracle where
    phase 13 checks the query, and the hand tree's fingerprint; the
    FileCatalog queries on phase 13's files (row groups and rows pruned in
    the scan); every SQL-born query compiled to a CUDA graph against its
    eager run; B3, B4 and B7 on the largest inputs the phase hands them."""
    import torch_tpcds_oracle as O
    from spark_rapids_jni_tpu_torch import plan as P
    from spark_rapids_jni_tpu_torch import sql
    from spark_rapids_jni_tpu_torch.models import compiled, tpcds
    from spark_rapids_jni_tpu_torch.models import tpcds_plans
    from spark_rapids_jni_tpu_torch.models import tpcds_sql as TS
    from spark_rapids_jni_tpu_torch.parquet import device_scan
    from spark_rapids_jni_tpu_torch.plan import lower

    tables, params, want, eager_ms, files, q13_launches = tpcds_ctx[:6]
    schemas = TS.TABLE_SCHEMAS
    t_phase = time.perf_counter()
    report = {"card": card, "queries": {}, "file_catalog": {}}
    phase_counts = collections.Counter()
    in_graphs = collections.Counter()
    bit_identical = 0
    qfns = {}

    def hand_tree(name, p):
        return P.optimize(TS.HAND[name](**p), schemas).tree

    for name in TS.QUERY_NAMES:
        p = sql_params(TS, name, params)
        kernels.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        qfn = sql.compile_sql(TS.SQL[name], schemas, p)
        out = qfn(tables)
        torch.cuda.synchronize()
        first = time.perf_counter() - t0
        counts = kernels.counts()
        add_counts(launches, counts)
        phase_counts.update(counts)
        qfns[name] = qfn
        require(P.fingerprint(qfn.plan_tree)
                == P.fingerprint(hand_tree(name, p)),
                f"sql {name}: its fingerprint is not the hand tree's")
        fused = name in tpcds_plans.PLANS
        if fused:
            require(p == params[name], f"sql {name}: parameters {p} are not "
                    f"phase 13's {params[name]}")
            for k in TPCDS_KERNELS:
                require((counts[k] > 0) == (q13_launches[name][k] > 0),
                        f"sql {name}: {k} launched {counts[k]} times, "
                        f"{q13_launches[name][k]} in phase 13")

            def run_twin():
                return tpcds.QUERIES[name](tables, **p)
        else:
            tree = hand_tree(name, p)

            def run_twin():
                return P.execute(tree, P.TableCatalog(tables, schemas),
                                 record_stats=False)
        kernels.reset()
        twin = run_twin()
        torch.cuda.synchronize()
        twin_counts = kernels.counts()
        require(counts == twin_counts, f"sql {name}: launches {counts}, its "
                f"twin's {twin_counts}")
        same, rel = table_diff(out, twin, f"sql {name}")
        bit_identical += same
        oracle = None
        if fused:
            try:
                oracle = O.check(name, out, want[name])
            except AssertionError as e:
                raise SmokeFailure(f"sql {name}: {e}") from None
        del twin
        wall, twin_wall = paired_medians(lambda: qfn(tables), run_twin)
        # the same query captured as one CUDA graph, against its eager run
        cq = compiled.compile_query(qfn, tables)
        table_diff(cq.run(tables), out, f"compiled sql {name}")
        graph_ms = median_wall(lambda: cq.run_unchecked(tables))
        graph = {k: cq.graph_launches[k] for k in GRAPH_KERNELS}
        in_graphs.update(graph)
        entry = dict(
            params=p, rows=out.num_rows, twin="hand-fused" if fused
            else "hand tree", bit_identical=same, max_rel_err=rel,
            oracle_rel_err=oracle, wall_ms=round(wall * 1e3, 3),
            twin_ms=round(twin_wall * 1e3, 3), first_ms=round(first * 1e3, 3),
            eager_ms=eager_ms.get(name) if fused else None,
            graph_ms=round(graph_ms * 1e3, 3), tape_len=len(cq.tape),
            launches=counts, graph_launches=graph)
        report["queries"][name] = entry
        log(f"[sql] {name} {p}: {out.num_rows} rows equal the "
            f"{entry['twin']} (bit-identical {same}, floats' largest "
            f"relative difference {rel:.3e})"
            + ("" if oracle is None else
               f" and the oracle ({oracle:.3e})")
            + f"; median of {PATH_REPS} {wall * 1e3:.3f} ms, its twin's "
            f"{twin_wall * 1e3:.3f} (alternated; phase 13's hand-fused "
            f"{entry['eager_ms']} ms), first "
            f"{first * 1e3:.3f} ms, graph {graph_ms * 1e3:.3f} ms; launches "
            f"{nonzero(counts)}, in the graph {nonzero(graph)} [{card}]")
        del out, cq
        torch.cuda.empty_cache()
    for name in ("unpack_rows", "segmented_copy"):
        require(phase_counts[name] > 0, f"sql: {name} never launched")

    # the FileCatalog: scans of the files with columns, row groups and
    # rows pruned
    cat = P.FileCatalog(files)
    file_trees = {}
    file_b7 = 0
    for name in FILE_QUERIES:
        p = sql_params(TS, name, params) if name == "q62_range" \
            else params[name]
        tree = hand_tree(name, p)
        device_scan.reset_counts()
        lower.reset_counts()
        kernels.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = P.execute(tree, cat, record_stats=False)
        torch.cuda.synchronize()
        first = time.perf_counter() - t0
        counts = kernels.counts()
        add_counts(launches, counts)
        phase_counts.update(counts)
        file_b7 += counts["u8_to_u32"]
        scan_counts = dict(device_scan.COUNTS)
        plan_counts = dict(lower.COUNTS)
        twin = (tpcds.QUERIES[name](tables, **p)
                if name in tpcds_plans.PLANS
                else P.execute(tree, P.TableCatalog(tables, schemas),
                               record_stats=False))
        same, rel = table_diff(out, twin, f"FileCatalog {name}")
        del twin, out
        pred_scans = sum(isinstance(n, P.Scan) and n.predicate is not None
                         for n in P.ir.walk(tree))
        require(plan_counts.get("scan.filter_fused", 0) == pred_scans,
                f"FileCatalog {name}: {plan_counts} for {pred_scans} "
                "filtered scans")
        wall = median_wall(lambda: P.execute(tree, cat, record_stats=False),
                           reps=1)
        file_trees[name] = tree
        entry = dict(
            rows_kept=scan_counts.get("rowfilter.rows_kept", 0),
            filtered_scans=scan_counts.get("rowfilter.scans", 0),
            complete_scans=scan_counts.get("rowfilter.complete", 0),
            rowgroups_pruned=scan_counts.get("rowgroups_pruned", 0),
            rowgroups_kept=scan_counts.get("rowgroups_kept", 0),
            columns_pruned=plan_counts.get("scan.columns_pruned", 0),
            masks_skipped=plan_counts.get("scan.filter_fused", 0),
            bit_identical=same, max_rel_err=rel,
            first_ms=round(first * 1e3, 3), wall_ms=round(wall * 1e3, 3),
            launches=counts)
        report["file_catalog"][name] = entry
        log(f"[sql] FileCatalog {name} {p}: equal to the loaded tables' "
            f"(bit-identical {same}); the row filter kept "
            f"{entry['rows_kept']} rows in {entry['filtered_scans']} scans "
            f"({entry['complete_scans']} complete, {entry['masks_skipped']} "
            f"masks skipped), row groups pruned {entry['rowgroups_pruned']} "
            f"of {entry['rowgroups_pruned'] + entry['rowgroups_kept']}, "
            f"columns pruned {entry['columns_pruned']}; one call after the "
            f"first {wall * 1e3:.3f} ms (first {first * 1e3:.3f} ms); "
            f"launches {nonzero(counts)} [{card}]")
    require(file_b7 > 0, "FileCatalog: u8_to_u32 never launched")
    require(in_graphs["unpack_rows"] > 0 and in_graphs["segmented_copy"] > 0,
            "sql: B3 or B4 is in no captured graph")

    def keep(captured, name, args):
        nb = bytes_moved(name, args)
        if name not in captured or nb > captured[name][0]:
            captured[name] = (nb, args)

    def run_all():
        for qfn in qfns.values():
            qfn(tables)
        for tree in file_trees.values():
            P.execute(tree, cat, record_stats=False)

    captured = record_inputs(kernels, SQL_KERNELS, keep, run_all)
    results = {("SQL", name): measure(kernels, name, args, card, "SQL",
                                      library_call(name, args))
               for name, (_, args) in sorted(captured.items())}
    del captured
    # profiled last: a long profile can leave the next ones short of rows
    for name in FILE_PROFILED:
        split = file_split(lambda: P.execute(file_trees[name], cat,
                                             record_stats=False))
        report["file_catalog"][name]["profile"] = split
        log(f"[sql] FileCatalog {name} profiled: {json.dumps(split)} "
            f"[{card}]")
    report["bit_identical"] = bit_identical
    report["launches"] = dict(phase_counts)
    report["in_graphs"] = dict(in_graphs)
    report["sql_counts"] = dict(sql.COUNTS)
    report["phase_s"] = round(time.perf_counter() - t_phase, 1)
    log("[sql] summary " + json.dumps(report))
    torch.cuda.empty_cache()
    return results


# ---------------------------------------------------------------------------
# phase 17: the serving runtime
# ---------------------------------------------------------------------------

# the kernels phase 17 launches: B3 and B4 in the served queries' capture
# runs and graphs, B7 (and B4 for the string columns) in the scans of the
# loader-submitted requests
EXEC_KERNELS = ("unpack_rows", "segmented_copy", "u8_to_u32")
EXEC_CLIENTS = 4
# requests a client keeps outstanding: four clients never fill the queue
EXEC_OUTSTANDING = 8
EXEC_BURST = 16
EXEC_LOADERS = 4
# a slow request's sleep: long enough for the prefetcher to stage a scan
EXEC_BLOCK_S = 2.0
EXEC_STAGES = ("queue", "coalesce", "admission", "dispatch", "ready")
# queries of the warm throughput runs: their plans all fit the cache of 32
EXEC_WARM = 30


class Outstanding:
    """A client's window of at most ``limit`` unresolved tickets."""

    def __init__(self, limit: int):
        self.limit = limit
        self.open = collections.deque()

    def room(self, n: int) -> None:
        while self.open and len(self.open) + n > self.limit:
            self.open.popleft().exception()

    def add(self, tk) -> None:
        self.open.append(tk)

    def drain(self) -> None:
        while self.open:
            self.open.popleft().exception()


def serve_clients(sched, items, tables, schemas) -> tuple:
    """``items`` ((kind, name, qfn or (text, params), copies)) split
    among EXEC_CLIENTS threads, each submitting an item's copies back to
    back and keeping at most EXEC_OUTSTANDING requests unresolved.
    Returns the tickets by item and the wall seconds."""
    tickets = collections.defaultdict(list)
    errors = []

    def client(i):
        window = Outstanding(EXEC_OUTSTANDING)
        try:
            for kind, name, what, copies in items[i::EXEC_CLIENTS]:
                window.room(copies)
                for _ in range(copies):
                    if kind == "sql":
                        text, params = what
                        tk = sched.submit_sql(text, tables, schemas=schemas,
                                              params=params)
                    else:
                        tk = sched.submit(name, what, tables)
                    tickets[(kind, name)].append(tk)
                    window.add(tk)
            window.drain()
        except BaseException as e:
            errors.append(e)

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(i,))
               for i in range(EXEC_CLIENTS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    require(not errors, f"exec: a client failed: {errors[:1]}")
    return tickets, wall


def hist_quantiles(metrics, name: str) -> dict:
    """p50 and p99 of histogram ``name`` over its retained samples."""
    return {q: metrics.percentile(name, int(q[1:]), window_s=1e9)
            for q in ("p50", "p99")}


def phase_exec(kernels, card, launches, tpcds_ctx) -> dict:
    """Phase 17: the serving runtime on phase 13's tables and files.
    Four client threads send the 50 TPC-DS queries twice each and the 28
    SQL texts once to ``QueryScheduler(workers=4)`` with the JAX
    package's defaults; bursts of q3 on one set of tables and over two
    same-shape copies of store_sales; loader requests scanned on the
    prefetch thread; admission defer and degrade; the typed failures;
    an injected OOM retried and a device error quarantined and
    recovered; requests a second at 1 and 4 workers; B3, B4 and B7 on
    the largest inputs the phase hands them."""
    import tempfile

    import torch_tpcds_oracle as O
    from spark_rapids_jni_tpu_torch import exec as xc
    from spark_rapids_jni_tpu_torch import sql
    from spark_rapids_jni_tpu_torch.faultinj import injector as finj
    from spark_rapids_jni_tpu_torch.models import compiled, tpcds
    from spark_rapids_jni_tpu_torch.models import tpcds_sql as TS
    from spark_rapids_jni_tpu_torch.utils import flight, metrics

    tables, params, want, _, files, _ = tpcds_ctx[:6]
    schemas = TS.TABLE_SCHEMAS
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    metrics.set_enabled(True)
    metrics.reset()
    flight.reset()
    compiled.reset_counts()
    report = {"card": card}
    qfns = {name: functools.partial(fn, **params[name])
            for name, fn in tpcds.QUERIES.items()}
    sql_p = {name: sql_params(TS, name, params) for name in TS.QUERY_NAMES}

    # the serial answers the served ones are held to: the oracle for the
    # TPC-DS queries, each SQL text's eager run, q7's eager run's bits
    twins = {name: sql.compile_sql(TS.SQL[name], schemas, sql_p[name])(tables)
             for name in TS.QUERY_NAMES}
    q7_serial = qfns["q7"](tables)
    torch.cuda.synchronize()

    def check_tpcds(name, out, what):
        try:
            O.check(name, out, want[name])
        except AssertionError as e:
            raise SmokeFailure(f"exec {what} {name}: {e}") from None

    # -- concurrent serving: 100 TPC-DS requests and 28 SQL texts ----------
    items = [("tpcds", name, qfns[name], 2) for name in tpcds.QUERIES]
    items += [("sql", name, (TS.SQL[name], sql_p[name]), 1)
              for name in TS.QUERY_NAMES]
    kernels.reset()
    plans = xc.PlanCache()
    sched = xc.QueryScheduler(workers=4, plan_cache=plans)
    require(sched.n_devices == 1 and sched.coalesce_ms == 4.0
            and sched.queue_depth == 32 and plans.cap == 32,
            "exec: the scheduler's defaults are not the JAX package's")
    try:
        tickets, wall4 = serve_clients(sched, items, tables, schemas)
    finally:
        sched.shutdown()
    n_served = sum(len(v) for v in tickets.values())
    require(n_served == 128, f"exec: {n_served} requests, expected 128")
    bit_identical = 0
    with compiled.device_work():
        for (kind, name), tks in tickets.items():
            for tk in tks:
                out = tk.result()
                if kind == "sql":
                    same, _ = table_diff(out, twins[name], f"exec sql {name}")
                    bit_identical += same
                else:
                    check_tpcds(name, out, "served")
                if (kind, name) == ("tpcds", "q7"):
                    same, rel = table_diff(out, q7_serial, "exec q7")
                    require(same, f"exec q7: not bit-equal to the serial "
                            f"eager run ({rel:.3e})")
        torch.cuda.synchronize()
    counters = metrics.snapshot()["counters"]
    distinct = len(tpcds.QUERIES) + len(TS.QUERY_NAMES)
    captures = compiled.COUNTS["graph_capture"]
    misses = counters.get("exec.plan_cache.miss", 0)
    repeats = counters.get("exec.plan_cache.hit", 0) \
        + counters.get("exec.plan_cache.size_hit", 0)
    require(misses == distinct and captures == distinct,
            f"exec: {misses} misses and {captures} graph captures for "
            f"{distinct} distinct plans")
    require(repeats == len(tpcds.QUERIES),
            f"exec: {repeats} repeats served from the cache or a shared "
            f"launch, expected {len(tpcds.QUERIES)}")
    report["concurrent"] = dict(
        requests=n_served, wall_s=round(wall4, 3),
        requests_per_s=round(n_served / wall4, 3), captures=captures,
        misses=misses, repeats=repeats,
        evictions=counters.get("exec.plan_cache.evictions", 0),
        sql_bit_identical=bit_identical,
        peak_bytes=torch.cuda.max_memory_allocated())
    log(f"[exec] concurrent: {n_served} requests from {EXEC_CLIENTS} clients "
        f"in {wall4:.3f} s ({n_served / wall4:.3f} requests/s at 4 workers, "
        f"cold), every one equal to the oracle or its twin; {captures} "
        f"graphs captured for {distinct} plans, {repeats} repeats from the "
        f"cache or a shared launch, "
        f"{report['concurrent']['evictions']} evictions; q7 bit-equal to "
        f"its serial run [{card}]")

    # -- coalescing: a burst of q3 on one set of tables, and over two
    #    same-shape copies of store_sales ----------------------------------
    copy = dict(tables)
    copy["store_sales"] = pt_table_clone(tables["store_sales"])
    q3_copy = qfns["q3"](copy)
    q3_serial = qfns["q3"](tables)
    torch.cuda.synchronize()
    bursts = {}
    sched = xc.QueryScheduler(workers=4, plan_cache=plans)
    try:
        for what, sets in (("one", [tables] * EXEC_BURST),
                           ("two", [tables, copy] * (EXEC_BURST // 2))):
            before = metrics.snapshot()["histograms"].get(
                "exec.batch.size", {"count": 0})["count"]
            tks = [sched.submit("q3", qfns["q3"], t) for t in sets]
            outs = [tk.result() for tk in tks]
            hist = metrics.snapshot()["histograms"]["exec.batch.size"]
            with compiled.device_work():
                for t, out in zip(sets, outs):
                    serial = q3_serial if t is tables else q3_copy
                    table_diff(out, serial, f"exec burst {what}")
                    check_tpcds("q3", out, f"burst {what}")
            bursts[what] = dict(batches=hist["count"] - before,
                                largest=hist["max"])
    finally:
        sched.shutdown()
    del copy, q3_copy
    require(bursts["one"]["largest"] >= 2,
            f"exec: the q3 burst did not coalesce: {bursts}")
    report["bursts"] = bursts
    log(f"[exec] coalescing: bursts of {EXEC_BURST} q3 requests equal "
        f"their serial runs; {bursts} [{card}]")

    # -- prefetch: loader requests scanned on the prefetch thread while
    #    the one worker serves a slow request -------------------------------
    def slow_q3(tbls):
        time.sleep(EXEC_BLOCK_S)
        return qfns["q3"](tbls)

    sched = xc.QueryScheduler(workers=1, plan_cache=plans)
    try:
        blocker = sched.submit("slow", slow_q3, tables, compiled=False)
        tks = [sched.submit("q3", qfns["q3"],
                            loader=lambda: tpcds.load_tables(files))
               for _ in range(EXEC_LOADERS)]
        blocker.result()
        outs = [tk.result() for tk in tks]
        with compiled.device_work():
            for out in outs:
                check_tpcds("q3", out, "loader")
    finally:
        sched.shutdown()
    del outs
    counters = metrics.snapshot()["counters"]
    report["prefetch"] = {k: counters.get(f"exec.prefetch.{k}", 0)
                          for k in ("hit", "miss", "rejected")}
    require(report["prefetch"]["hit"] >= 1,
            f"exec: no loader request was prefetched: {report['prefetch']}")
    log(f"[exec] prefetch: {EXEC_LOADERS} loader requests equal the "
        f"oracle; {report['prefetch']} [{card}]")
    counts = kernels.counts()
    add_counts(launches, counts)
    for name in EXEC_KERNELS:
        require(counts[name] > 0, f"exec: {name} never launched")
    report["launches"] = counts

    # -- admission: defer under a cap of 1.5 requests, degrade below one --
    est = xc.request_bytes(tables)
    sched = xc.QueryScheduler(workers=4, plan_cache=plans, coalesce_ms=0,
                              inflight_bytes=int(est * 1.5))
    try:
        tks = [sched.submit("q3", qfns["q3"], tables) for _ in range(4)]
        outs = [tk.result() for tk in tks]
    finally:
        sched.shutdown()
    with compiled.device_work():
        for out in outs:
            check_tpcds("q3", out, "deferred")
    require(not any(tk.degraded for tk in tks), "exec: a fitting request "
            "was degraded")
    sched = xc.QueryScheduler(workers=1, plan_cache=plans,
                              inflight_bytes=est // 2)
    try:
        tk = sched.submit("q3", qfns["q3"], tables)
        out = tk.result()
    finally:
        sched.shutdown()
    require(tk.degraded, "exec: a request over the cap was not degraded")
    with compiled.device_work():
        table_diff(out, q3_serial, "exec degraded q3")
        check_tpcds("q3", out, "degraded")
    counters = metrics.snapshot()["counters"]
    report["admission"] = {"request_bytes": est,
                           "deferred": counters.get(
                               "exec.admission.deferred", 0),
                           "degraded": counters.get(
                               "exec.admission.degraded", 0)}
    require(report["admission"]["deferred"] >= 1,
            "exec: no request was deferred under a cap of 1.5 requests")
    log(f"[exec] admission: {report['admission']}; the deferred and the "
        f"degraded (sorted engine) requests equal the oracle [{card}]")

    # -- typed failures --------------------------------------------------
    def slow(tbls):
        time.sleep(0.05)
        return qfns["q3"](tbls)

    typed = {}
    sched = xc.QueryScheduler(workers=1, queue_depth=2, plan_cache=plans)
    try:
        held = []
        try:
            for _ in range(8):
                held.append(sched.submit("slow", slow, tables,
                                         compiled=False))
        except xc.ExecQueueFull as e:
            typed["queue_full"] = type(e).__name__
        for tk in held:
            tk.result()
        blocker = sched.submit("slow", slow, tables, compiled=False)
        late = sched.submit("late", slow, tables, compiled=False,
                            timeout_s=0.001)
        try:
            late.result()
        except xc.ExecDeadlineExceeded as e:
            typed["deadline"] = type(e).__name__
        blocker.result()
        queued = [sched.submit("slow", slow, tables, compiled=False)
                  for _ in range(2)]
    finally:
        sched.shutdown()
    for tk in queued:
        if isinstance(tk.exception(), xc.ExecShutdown):
            typed["shutdown"] = "ExecShutdown"
    require(set(typed) == {"queue_full", "deadline", "shutdown"},
            f"exec: typed failures {typed}")
    report["typed"] = typed
    log(f"[exec] typed failures: {typed} [{card}]")

    # -- faults on the card ----------------------------------------------
    inj = finj.get_injector()
    incident_dir = tempfile.mkdtemp(prefix="srjt-incidents-")
    # the raw value, to be put back after the phase
    saved_dir = os.environ.get("SRJT_INCIDENT_DIR")  # srjt-lint: disable=knob-env
    os.environ["SRJT_INCIDENT_DIR"] = incident_dir
    faults = {}
    try:
        sched = xc.QueryScheduler(workers=1, plan_cache=plans)
        try:
            inj.load_dict({"seed": 1, "sites": {"exec.dispatch": {
                "percent": 100, "injectionType": "oom",
                "interceptionCount": 1}}})
            inj.enable()
            out = sched.run("q3", qfns["q3"], tables)
            faults["oom_retries"] = sched.resilient.retry_count
            with compiled.device_work():
                check_tpcds("q3", out, "after an injected OOM")
            inj.load_dict({"seed": 1, "sites": {"exec.dispatch": {
                "percent": 100, "injectionType": "device_error",
                "maxHits": 1}}})
            tk = sched.submit("q3", qfns["q3"], tables)
            out = tk.result()
            rep = sched.replicas[0]
            deadline = time.monotonic() + 30
            while time.monotonic() < deadline and rep.state() != "healthy":
                time.sleep(0.01)
            faults.update(relocations=tk.relocations,
                          fatal=rep.resilient.fatal_count,
                          recoveries=rep.resilient.recovery_count,
                          state=rep.state())
            nxt = sched.run("q3", qfns["q3"], tables)
            with compiled.device_work():
                check_tpcds("q3", out, "relocated after a device error")
                check_tpcds("q3", nxt, "after the recovery")
        finally:
            inj.disable()
            sched.shutdown()
    finally:
        if saved_dir is None:
            os.environ.pop("SRJT_INCIDENT_DIR", None)
        else:
            os.environ["SRJT_INCIDENT_DIR"] = saved_dir
    incidents = sorted(os.listdir(incident_dir))
    faults["incidents"] = incidents
    require(faults["oom_retries"] >= 1, f"exec: the OOM was not retried: "
            f"{faults}")
    require(faults["fatal"] == 1 and faults["recoveries"] == 1
            and faults["state"] == "healthy",
            f"exec: the device error did not quarantine and recover: "
            f"{faults}")
    require(any(f.startswith("incident-quarantine-") for f in incidents)
            and any(f.startswith("incident-recovery-") for f in incidents),
            f"exec: incident files {incidents}")
    report["faults"] = faults
    log(f"[exec] faults: an injected OOM retried, a device error "
        f"quarantined the replica and the canary recovered it, every "
        f"answer equal to the oracle; {faults} [{card}]")

    # -- throughput for the record: the 100 TPC-DS requests again through
    #    one worker, then EXEC_WARM queries (whose plans all fit the cache)
    #    at 1 and 4 workers once warm --------------------------------------
    tpcds_items = [it for it in items if it[0] == "tpcds"]

    def timed(run_items, workers):
        before = metrics.snapshot()["counters"].get("exec.plan_cache.miss", 0)
        sched = xc.QueryScheduler(workers=workers, plan_cache=plans)
        try:
            tickets, wall = serve_clients(sched, run_items, tables, schemas)
        finally:
            sched.shutdown()
        n = 0
        with compiled.device_work():
            for (_, name), tks in tickets.items():
                for tk in tks:
                    check_tpcds(name, tk.result(), f"{workers}-worker")
                    n += 1
        misses = metrics.snapshot()["counters"].get(
            "exec.plan_cache.miss", 0) - before
        return dict(requests=n, requests_per_s=round(n / wall, 3),
                    wall_s=round(wall, 3), misses=misses, workers=workers)

    rates = {"concurrent_4": report["concurrent"]["requests_per_s"],
             "all_1": timed(tpcds_items, 1)}
    warm_items = tpcds_items[:EXEC_WARM]
    timed(warm_items, 4)                       # captures what it misses
    rates["warm_4"] = timed(warm_items, 4)
    rates["warm_1"] = timed(warm_items, 1)
    require(rates["warm_4"]["misses"] == 0 and rates["warm_1"]["misses"] == 0,
            f"exec: the warm runs missed the plan cache: {rates}")
    report["throughput"] = rates
    log(f"[exec] throughput (for the record, not a claim): {rates} [{card}]")

    # -- B3, B4 and B7 on the largest inputs the phase hands them ----------
    def keep(captured, name, args):
        nb = bytes_moved(name, args)
        if name not in captured or nb > captured[name][0]:
            captured[name] = (nb, args)

    def run_all():
        sched = xc.QueryScheduler(workers=4)
        window = Outstanding(EXEC_OUTSTANDING)
        try:
            for name, fn in qfns.items():
                window.room(1)
                window.add(sched.submit(name, fn, tables, compiled=False))
            window.add(sched.submit("q3", qfns["q3"], compiled=False,
                                    loader=lambda: tpcds.load_tables(files)))
            for tk in window.open:
                tk.result()
        finally:
            sched.shutdown()

    captured = record_inputs(kernels, EXEC_KERNELS, keep, run_all)
    # without the library call: this late in the run the profiler loses
    # most of the memcpy rows of B7's `clone().view` in every window;
    # phases 7, 13 and 16 time it
    results = {("serving", name): measure(kernels, name, args, card,
                                          "serving")
               for name, (_, args) in sorted(captured.items())}
    del captured
    snap = metrics.snapshot()
    hists = snap["histograms"]
    counters = snap["counters"]
    report["requests"] = {k: counters.get(f"exec.{k}", 0)
                          for k in ("submitted", "completed", "failed",
                                    "quarantined", "retries")}
    report["latency_ms"] = {"e2e": hist_quantiles(metrics, "exec.e2e_ms")}
    for st in EXEC_STAGES:
        if f"exec.stage.{st}_ms" in hists:
            report["latency_ms"][st] = hist_quantiles(
                metrics, f"exec.stage.{st}_ms")
    report["plan_cache"] = plans.stats()
    report["batches"] = {"count": hists.get("exec.batch.size",
                                            {}).get("count", 0),
                         "largest": hists.get("exec.batch.size",
                                              {}).get("max", 0)}
    report["failover"] = {k: counters.get(f"exec.failover.{k}", 0)
                          for k in ("relocated", "recovered", "probe_failed",
                                    "ejected")}
    report["peak_bytes"] = torch.cuda.max_memory_allocated()
    report["phase_s"] = round(time.perf_counter() - t_phase, 1)
    log("[exec] summary " + json.dumps(report))
    del plans, twins, q7_serial, q3_serial
    metrics.set_enabled(None)
    # the plan cache's entries and their weak-reference callbacks form
    # cycles: collect them, so that their graphs' pools go before phase 16
    gc.collect()
    torch.cuda.empty_cache()
    return results


def pt_table_clone(table):
    """A copy of ``table`` with every tensor cloned: the same shapes,
    distinct buffers."""
    from spark_rapids_jni_tpu_torch.column import Column, Table, force_column
    cols = []
    for c in table.columns:
        c = force_column(c)
        cols.append(Column(c.dtype, c.data.clone(),
                           None if c.offsets is None else c.offsets.clone(),
                           None if c.validity is None
                           else c.validity.clone()))
    return Table(cols, table.host_decoded_cols)


# ---------------------------------------------------------------------------
# phase 18: the Mortgage ETL trained and served, stream views, per-node
# profiles, persisted tapes
# ---------------------------------------------------------------------------

# the kernels phase 18 launches: B2, B5, B6 for the ETL's dictionary
# columns, B3 for its parsers and the plan queries' string keys, B4 for
# their string gathers and B7 in every scan (the ETL's, the delta scans')
PHASE18_KERNELS = ("pack_rows", "unpack_rows", "segmented_copy",
                   "extract_rows", "gather_rows", "u8_to_u32")
ML_EPOCHS = 3
# Adam's step size: the features are unnormalized (UPBs near 1e5, dates
# near 2e4 days), so a larger step drives the logits far past the
# sigmoid's range and the float32 run leaves the float64 replay
ML_LR = 1e-6
ML_SEED = 0
ML_CLIENTS = 4
ML_REQUESTS = 16
# the float32 training run against the float64 replay of its batches:
# each epoch's mean loss within a relative ML_LOSS_RTOL, each parameter
# within ML_PARAM_ATOL + ML_PARAM_RTOL x the replay's largest |parameter|
ML_LOSS_RTOL = 1e-4
ML_PARAM_ATOL = 1e-7
ML_PARAM_RTOL = 1e-3
# store_sales as a base file and appended files (phase 13's rows in order)
STREAM_BASE = 6_000_000
STREAM_APPEND = 1_000_000
STREAM_APPENDS = 4
# the profiled plan queries' medians
PROFILE_REPS = 3


def stream_plans(ir):
    """The two views over store_sales ⋈ item: a keyed aggregate of
    merge-exact aggregates (maintained incrementally) and a rollup
    (refreshed in full)."""
    join = ir.Join(ir.Scan("store_sales"), ir.Scan("item"),
                   ("ss_item_sk",), ("i_item_sk",))
    keys = ("i_category", "i_brand_id")
    inc = ir.Sort(ir.Aggregate(join, keys, (
        ("ss_quantity", "sum", "qty"), ("ss_quantity", "count", "n"),
        ("ss_sales_price_cents", "max", "top_cents"),
        ("ss_ext_sales_price", "min", "low_ext"),
        ("ss_quantity", "mean", "avg_qty"))), keys)
    rollup = ir.Aggregate(join, ("i_category_id", "i_brand_id"), (
        ("ss_quantity", "sum", "qty"), ("ss_quantity", "count", "n"),
        ("ss_sales_price_cents", "max", "top_cents")), grouping="rollup")
    return inc, rollup


def stream_oracle(arrays, rows: int) -> dict:
    """The incremental view from the first ``rows`` store_sales rows, by
    numpy: its key columns and aggregates in key order."""
    ss, item = arrays["store_sales"], arrays["item"]
    ix = ss["ss_item_sk"][:rows].astype(np.int64) - 1
    cat = np.asarray(item["i_category"], dtype=str)[ix]
    brand = item["i_brand_id"][ix]
    qty = ss["ss_quantity"][:rows].astype(np.int64)
    cents = ss["ss_sales_price_cents"][:rows]
    ext = ss["ss_ext_sales_price"][:rows]
    cats, cat_code = np.unique(cat, return_inverse=True)
    key = cat_code.astype(np.int64) * 10_000 + brand.astype(np.int64)
    uniq, inv = np.unique(key, return_inverse=True)
    g = len(uniq)
    n = np.bincount(inv, minlength=g)
    q = np.bincount(inv, weights=qty, minlength=g).astype(np.int64)
    top = np.full(g, np.iinfo(np.int64).min)
    np.maximum.at(top, inv, cents)
    low = np.full(g, np.inf)
    np.minimum.at(low, inv, ext)
    return {"i_category": cats[uniq // 10_000], "i_brand_id": uniq % 10_000,
            "qty": q, "n": n.astype(np.int64), "top_cents": top,
            "low_ext": low, "avg_qty": q.astype(np.float64) / n}


def rollup_rows(arrays, rows: int) -> int:
    """The rollup view's row count over the first ``rows`` store_sales
    rows: its (category id, brand) groups, category groups and the grand
    total."""
    ix = arrays["store_sales"]["ss_item_sk"][:rows].astype(np.int64) - 1
    cat = arrays["item"]["i_category_id"][ix].astype(np.int64)
    brand = arrays["item"]["i_brand_id"][ix].astype(np.int64)
    return (len(np.unique(cat * 10_000 + brand)) + len(np.unique(cat))
            + 1)


def check_stream_oracle(out, want: dict, what: str) -> None:
    """The incremental view's result equals the numpy oracle exactly."""
    from spark_rapids_jni_tpu_torch.column import force_column
    require(out.num_rows == len(want["n"]),
            f"{what}: {out.num_rows} groups, expected {len(want['n'])}")
    cols = [force_column(c) for c in out.columns]
    cat = cols[0]
    offs = cat.offsets.cpu().numpy()
    chars = cat.data.cpu().numpy().tobytes()
    got_cat = [chars[offs[i]:offs[i + 1]].decode()
               for i in range(out.num_rows)]
    require(got_cat == list(want["i_category"]), f"{what}: categories")
    for i, name in enumerate(("i_brand_id", "qty", "n", "top_cents",
                              "low_ext", "avg_qty"), start=1):
        got = cols[i].data.cpu().numpy()
        w = want[name]
        equal = (np.array_equal(got.view(np.int64), w.view(np.int64))
                 if got.dtype == np.float64 else np.array_equal(got, w))
        require(equal, f"{what}: {name} differs from the oracle")


def pack_oracle(MLO, out, spec, feature_cols):
    """The lane rules of ``ml/features.py`` on the ETL output's host
    columns (``tools/torch_ml_oracle.py``)."""
    from spark_rapids_jni_tpu_torch.column import force_column

    def host(f):
        c = force_column(out[feature_cols.index(f.name)])
        return (c.dtype.id.name, c.dtype.scale, c.data.cpu().numpy(),
                None if c.validity is None else c.validity.cpu().numpy(),
                f.impute)
    return MLO.pack([host(f) for f in spec.features], host(spec.label),
                    spec.label_transform)


def dealt_acq(tables: dict, seed: int) -> dict:
    """The Mortgage ETL's tables with every acquisition column but the
    loan id gathered by a seeded permutation: each loan gets another
    loan's acquisition record, the geometry stays the same."""
    from spark_rapids_jni_tpu_torch.column import Table, force_column
    from spark_rapids_jni_tpu_torch.ops import filter as F
    acq = tables["acq"]
    perm = torch.from_numpy(np.random.default_rng(seed).permutation(
        acq.num_rows)).to(force_column(acq.columns[0]).data.device)
    dealt = F.gather(acq, perm)
    return {"perf": tables["perf"], "acq": Table(
        [acq.columns[0]] + [force_column(c) for c in dealt.columns[1:]],
        acq.host_decoded_cols)}


@contextlib.contextmanager
def deterministic():
    """torch's deterministic algorithms, with warnings in place of errors:
    a float ``index_add_`` on the card then sums in a fixed order (by a
    sort) instead of by atomics."""
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)


def same_bits(a: torch.Tensor, b) -> bool:
    b = torch.as_tensor(b).to(a.device)
    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


def phase_ml_stream(kernels, card, launches, tpcds_ctx, mortgage_files):
    """Phase 18: the Mortgage ETL's output packed into a 1,000,000 x 8
    feature matrix (bit-identical to the numpy oracle of the lane rules),
    a logistic model trained by Adam for 3 epochs, each epoch one CUDA
    graph replay and epochs 2-3 under ``set_sync_debug_mode("error")``,
    held against a float64 replay of the same batches, then served
    through ``QueryScheduler(workers=4)`` to four clients, each on loans
    of its own (16 requests, each bit-identical to ``predict_table``);
    store_sales as a base file
    and four appended files behind an incremental view and a rollup,
    each refreshed through ``submit_refresh`` after every append and
    equal to a from-scratch recompute and to the numpy oracle, with a
    FeatureView repacking; the 8 plan queries under ``explain_analyze``
    (each node's rows against ``tools/torch_plan_oracle.py``, the result
    bit-identical to the unprofiled run's with deterministic algorithms)
    and the ``@traced`` ranges under ``torch.profiler``; q3, q65 and the
    servable compiled with a persisted tape store, then served again by
    a fresh scheduler that warms up from it with no eager capture run,
    bit-identical, and a tampered tape recaptured; B2-B7 on the largest
    inputs the phase hands them."""
    import tempfile

    import torch_ml_oracle as MLO
    import torch_plan_oracle as PO
    import torch_tpcds_parquet as TW
    import torch_lineitem_parquet as W
    from spark_rapids_jni_tpu_torch import exec as xc
    from spark_rapids_jni_tpu_torch import ml
    from spark_rapids_jni_tpu_torch.exec import artifacts
    from spark_rapids_jni_tpu_torch.models import (compiled, mortgage, tpcds,
                                                   tpcds_plans)
    from spark_rapids_jni_tpu_torch.plan import ir, lower, profile
    from spark_rapids_jni_tpu_torch.stream import DeltaTable, ViewRegistry
    from spark_rapids_jni_tpu_torch.utils import metrics

    tables, params, _, _, files, _, arrays = tpcds_ctx
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    metrics.set_enabled(True)
    metrics.reset()
    compiled.reset_counts()
    phase_counts = collections.Counter()
    report = {"card": card}

    def main_path(fn):
        """``fn()`` with the kernel counts reset before and added to the
        main path's after."""
        kernels.reset()
        out = fn()
        torch.cuda.synchronize()
        counts = kernels.counts()
        add_counts(launches, counts)
        phase_counts.update(counts)
        return out

    # -- ETL -> features ----------------------------------------------------
    spec = mortgage.feature_spec()
    t0 = time.perf_counter()
    mtables = main_path(lambda: mortgage.load_tables(mortgage_files))
    out = main_path(lambda: mortgage.etl_tables(mtables))
    fb = main_path(lambda: spec.pack(out, mortgage.FEATURE_COLS))
    etl_pack_s = time.perf_counter() - t0
    n_loans = MORTGAGE_ARGS["n_loans"]
    require(tuple(fb.X.shape) == (n_loans, 8) and fb.X.is_cuda,
            f"ml: feature matrix {tuple(fb.X.shape)} on {fb.X.device}")
    X_want, y_want = pack_oracle(MLO, out, spec, mortgage.FEATURE_COLS)
    require(same_bits(fb.X, X_want) and same_bits(fb.y, y_want),
            "ml: the feature matrix differs from the lane rules' oracle")
    pack_ms = median_wall(lambda: spec.pack(out, mortgage.FEATURE_COLS)) * 1e3
    stack_same = same_bits(spec.pack(out, mortgage.FEATURE_COLS,
                                     engine="stack").X, X_want)
    require(stack_same, "ml: the stack engine's matrix differs")
    log(f"[ml] {n_loans} x 8 feature matrix bit-identical to the oracle "
        f"(label mean {float(y_want.mean()):.4f}); ETL+pack {etl_pack_s:.3f}"
        f" s, pack median {pack_ms:.3f} ms [{card}]")

    # -- training: 3 epochs, each one graph replay --------------------------
    pipe = ml.BatchPipeline(fb, seed=ML_SEED)
    require(pipe.batch_size == 256 and pipe.num_batches == n_loans // 256,
            f"ml: {pipe.num_batches} batches of {pipe.batch_size}")
    trainer = ml.Trainer(ml.logistic_regression(), ml.adam(lr=ML_LR))
    marks = {}

    def on_epoch(e):
        if e == 0:
            torch.cuda.synchronize()
            marks["first"] = time.perf_counter()
            torch.cuda.set_sync_debug_mode("error")
        if e == ML_EPOCHS - 1:
            torch.cuda.set_sync_debug_mode("default")

    t0 = time.perf_counter()
    try:
        kernels.reset()
        res = trainer.fit(pipe, ML_EPOCHS, on_epoch=on_epoch)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    t_end = time.perf_counter()
    require(trainer.graph_captures == 1,
            f"ml: {trainer.graph_captures} epoch graphs captured")
    epoch0_ms = (marks["first"] - t0) * 1e3
    steady_ms = (t_end - marks["first"]) / (ML_EPOCHS - 1) * 1e3
    batches = [tuple(a.cpu().numpy() for a in pipe.epoch_arrays(e))
               for e in range(ML_EPOCHS)]
    t0 = time.perf_counter()
    losses64, p64 = MLO.replay(batches, "logreg", "adam",
                               {"w": np.zeros(8), "b": 0.0}, {"lr": ML_LR})
    replay_s = time.perf_counter() - t0
    del batches
    loss_rel = float(np.max(np.abs(res.losses - losses64)
                            / np.abs(losses64)))
    w32 = np.append(res.params["w"].cpu().numpy(),
                    float(res.params["b"].cpu()))
    w64 = np.append(p64["w"], p64["b"])
    param_err = float(np.max(np.abs(w32 - w64)))
    param_tol = ML_PARAM_ATOL + ML_PARAM_RTOL * float(np.max(np.abs(w64)))
    require(np.all(np.isfinite(res.losses)) and loss_rel <= ML_LOSS_RTOL,
            f"ml: losses {res.losses} against the replay's {losses64}")
    require(param_err <= param_tol,
            f"ml: parameters {param_err:.3e} from the replay's (limit "
            f"{param_tol:.3e})")
    report["train"] = dict(
        epochs=ML_EPOCHS, steps_per_epoch=pipe.num_batches,
        losses=[float(v) for v in res.losses],
        replay_losses=[float(v) for v in losses64],
        loss_rel_err=loss_rel, param_abs_err=param_err,
        param_limit=param_tol, epoch0_ms=round(epoch0_ms, 3),
        epoch_ms=round(steady_ms, 3), replay_s=round(replay_s, 2),
        rows_per_s=round(pipe.rows_per_epoch / steady_ms * 1e3, 1))
    log(f"[ml] trained: losses {res.losses} (float64 replay {losses64}, "
        f"largest relative difference {loss_rel:.3e}; parameters within "
        f"{param_err:.3e} of the replay's, limit {param_tol:.3e}); epoch 1 "
        f"with the graph capture {epoch0_ms:.1f} ms, epochs 2-3 "
        f"{steady_ms:.1f} ms each with no sync [{card}]")

    # -- serving the trained model ------------------------------------------
    sv = ml.register_servable(ml.ServableModel(
        "mortgage_logreg", mortgage.etl_tables, mortgage.FEATURE_COLS, spec,
        trainer.model, res.params))
    # each client scores loans of its own: client 0 the ETL's tables, each
    # other client the same files with the acquisition records dealt to
    # other loans (same geometry, other features), so that no two
    # requests in flight share buffers and the scheduler coalesces none
    # of them into one dispatch
    client_tables = [mtables] + [dealt_acq(mtables, i)
                                 for i in range(1, ML_CLIENTS)]
    with compiled.device_work():
        oracles = [sv.predict_table(t)[0].data for t in client_tables]
        torch.cuda.synchronize()
    require(all(not same_bits(oracles[0], o) for o in oracles[1:]),
            "ml: the clients' loans give the same predictions")

    def serve_round(sched):
        done, errors = [], []

        def client(i):
            # one request in flight a client: the next goes when the last
            # is answered
            try:
                for _ in range(ML_REQUESTS // ML_CLIENTS):
                    tk = sched.submit_predict(sv.name, client_tables[i])
                    done.append((i, tk.result(timeout=600)))
            except BaseException as e:
                errors.append(e)
        def runs():
            # a plan's executions on the card: single replays and members
            # of K-member graph launches (run_vmapped), less the one
            # replay a plan's first batch makes to check its parity
            c = compiled.COUNTS
            return (c["replay_run"] + c["batch_member"]
                    - c["batch_parity_check"])
        replays = runs()
        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(ML_CLIENTS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.perf_counter() - t0
        require(not errors, f"ml: a client failed: {errors[:1]}")
        require(len(done) == ML_REQUESTS, f"ml: {len(done)} answers")
        return done, wall, runs() - replays

    def serve():
        sched = xc.QueryScheduler(workers=4)
        try:
            t0 = time.perf_counter()
            first = sched.submit_predict(sv, mtables).result(timeout=600)
            first_s = time.perf_counter() - t0
            cold = serve_round(sched)
            # the batch graphs the first round left to capture on threads
            # of their own: warm means they are in place
            pending = compiled.wait_batch_captures()
            warm = serve_round(sched)
        finally:
            sched.shutdown()
        return first, first_s, cold, warm, pending

    first, first_s, (cold, cold_wall, _), (warm, warm_wall, replays), \
        pending = main_path(serve)
    require(compiled.COUNTS["batch_capture_failed"] == 0,
            "ml: a batch graph's background capture failed")
    # every warm request ran the compiled plan on its own: one replay, or
    # one member of a batch graph's launch, each
    require(replays == ML_REQUESTS,
            f"ml: {replays} runs for {ML_REQUESTS} warm requests")
    with compiled.device_work():
        for i, t in [(0, first)] + cold + warm:
            require(same_bits(t[0].data, oracles[i]),
                    "ml: a served prediction differs from predict_table")
    report["serve"] = dict(
        requests=1 + len(cold) + len(warm), distinct_inputs=ML_CLIENTS,
        warm_runs=replays, warm_batches=compiled.COUNTS["batch_replay"],
        first_ms=round(first_s * 1e3, 3),
        predictions_per_s=round(len(warm) * n_loans / warm_wall, 1),
        round_s=round(warm_wall, 3), first_round_s=round(cold_wall, 3),
        graph_captures=compiled.COUNTS["graph_capture"],
        batch_captures=compiled.COUNTS["batch_capture"],
        batch_deferred=compiled.COUNTS["batch_deferred"],
        captures_waited=pending)
    log(f"[ml] served: {1 + len(cold) + len(warm)} predict requests of "
        f"{n_loans} rows over {ML_CLIENTS} distinct table sets, each "
        f"bit-identical to predict_table on its set; the first (capture "
        f"run and graph) {first_s * 1e3:.1f} ms; {ML_REQUESTS} from "
        f"{ML_CLIENTS} clients, one in flight each, in {warm_wall:.3f} s "
        f"with {replays} runs of the graph (graph replays and members of "
        f"{compiled.COUNTS['batch_replay']} batch launches) "
        f"({len(warm) * n_loans / warm_wall:.0f} predictions/s); the first "
        f"round {cold_wall:.3f} s, {compiled.COUNTS['batch_deferred']} "
        f"batches replayed in turn while {compiled.COUNTS['batch_capture']} "
        f"batch graphs were captured in background [{card}]")
    log("[ml] summary " + json.dumps(report))

    # -- stream: a base file, four appends, two views ------------------------
    ss = arrays["store_sales"]

    def ss_file(lo, hi):
        cols = TW.table_columns("store_sales",
                                {k: v[lo:hi] for k, v in ss.items()})
        return W.write_parquet(cols, TW.ROW_GROUP_ROWS, codec="SNAPPY")

    t0 = time.perf_counter()
    base = ss_file(0, STREAM_BASE)
    appends = [ss_file(STREAM_BASE + i * STREAM_APPEND,
                       STREAM_BASE + (i + 1) * STREAM_APPEND)
               for i in range(STREAM_APPENDS)]
    write_s = time.perf_counter() - t0
    statics = {k: tables[k] for k in ("item", "date_dim", "store")}
    schemas = {k: tpcds_plans.TABLE_SCHEMAS[k] for k in statics}
    inc_plan, rollup_plan = stream_plans(ir)
    delta = DeltaTable("store_sales", files=[base])
    reg = ViewRegistry(delta, statics, schemas)
    inc = main_path(lambda: reg.register_view(inc_plan, name="brand_sales"))
    full = main_path(lambda: reg.register_view(rollup_plan,
                                               name="category_rollup"))
    require(inc.kind == "incremental" and inc.exact,
            f"stream: the keyed view is {inc.kind} ({inc.reason})")
    require((full.kind, full.reason) == ("full", "grouping:rollup"),
            f"stream: the rollup view is {full.kind} ({full.reason})")
    fspec = ml.FeatureSpec.of(["i_brand_id", "qty", "n", "top_cents",
                               "avg_qty"], label="low_ext")
    fv = ml.FeatureView(reg, inc_plan, fspec)
    require(fv.view is inc, "stream: the FeatureView made a second view")
    refresh = {"incremental_ms": [], "full_ms": [], "recompute_ms": []}
    sched = xc.QueryScheduler(workers=2)
    try:
        for i, blob in enumerate(appends):
            delta.append_file(blob)
            rows = STREAM_BASE + (i + 1) * STREAM_APPEND
            c_groups = metrics.counter_value("stream.delta.rowgroups")
            c_rows = metrics.counter_value("stream.delta.rows")
            t0 = time.perf_counter()
            got_inc = main_path(
                lambda: sched.submit_refresh(reg, inc).result(timeout=600))
            refresh["incremental_ms"].append(
                round((time.perf_counter() - t0) * 1e3, 3))
            t0 = time.perf_counter()
            got_full = main_path(
                lambda: sched.submit_refresh(reg, full).result(timeout=600))
            refresh["full_ms"].append(
                round((time.perf_counter() - t0) * 1e3, 3))
            groups = metrics.counter_value("stream.delta.rowgroups") \
                - c_groups
            drows = metrics.counter_value("stream.delta.rows") - c_rows
            require(groups == 1 and drows == STREAM_APPEND,
                    f"stream: append {i + 1}'s delta scan read {groups} row "
                    f"groups, {drows} rows")
            t0 = time.perf_counter()
            with compiled.device_work():
                cat = lower.TableCatalog({**statics,
                                          "store_sales": delta.scan()},
                                         reg.schemas)
                want_inc = lower.execute(inc.tree, cat, record_stats=False)
                want_full = lower.execute(full.tree, cat,
                                          record_stats=False)
                torch.cuda.synchronize()
            refresh["recompute_ms"].append(
                round((time.perf_counter() - t0) * 1e3, 3))
            with compiled.device_work():
                same_inc, _ = table_diff(got_inc, want_inc,
                                         f"stream inc {i + 1}")
                same_full, _ = table_diff(got_full, want_full,
                                          f"stream rollup {i + 1}")
                require(same_inc and same_full, f"stream: append {i + 1}'s "
                        "refresh is not bit-identical to a recompute")
                check_stream_oracle(got_inc, stream_oracle(arrays, rows),
                                    f"stream inc {i + 1}")
                want_rows = rollup_rows(arrays, rows)
                require(got_full.num_rows == want_rows,
                        f"stream: the rollup has {got_full.num_rows} rows, "
                        f"the oracle {want_rows}")
                packed = fv.current()
                want_fb = fspec.pack(want_inc, fv.names)
                require(torch.equal(packed.X, want_fb.X)
                        and torch.equal(packed.y, want_fb.y),
                        f"stream: the FeatureView after append {i + 1} "
                        "differs from a pack of the recompute")
    finally:
        sched.shutdown()
    require(fv.repacks == STREAM_APPENDS,
            f"stream: the FeatureView repacked {fv.repacks} times")
    counters = metrics.snapshot()["counters"]
    stream_report = dict(
        base_rows=STREAM_BASE, appends=[STREAM_APPEND] * STREAM_APPENDS,
        write_s=round(write_s, 2), refresh=refresh,
        incremental=counters.get("stream.refresh.incremental", 0),
        full=counters.get("stream.refresh.full", 0),
        delta_rowgroups=counters.get("stream.delta.rowgroups", 0),
        groups=inc.state.num_rows, repacks=fv.repacks, card=card)
    log(f"[stream] {STREAM_APPENDS} appends of {STREAM_APPEND} rows onto "
        f"{STREAM_BASE}: each incremental and rollup refresh bit-identical "
        f"to a recompute and the oracle; refresh ms incremental "
        f"{refresh['incremental_ms']}, full {refresh['full_ms']}, "
        f"recompute {refresh['recompute_ms']} [{card}]")
    log("[stream] summary " + json.dumps(stream_report))
    fv.close()
    reg.close()
    del delta, reg, inc, full, fv, base, appends

    # -- profiles: the 8 plan queries under explain_analyze ------------------
    encoded = PO.encode_arrays(arrays)
    profile.set_enabled(True)
    profiles = {}
    bit_identical = repeatable = 0
    try:
        for name in tpcds_plans.PLANS:
            kw = params[name]
            qfn, tree = tpcds_plans.plan_fn(name, **kw)

            def analyzed():
                return profile.analyze(tpcds_plans.PLANS[name](**kw),
                                       tpcds_plans.TABLE_SCHEMAS, tables)
            # two unprofiled runs: float sums by atomics may differ in
            # their last bits from run to run
            profile.set_enabled(False)
            want = qfn(tables)
            again = qfn(tables)
            torch.cuda.synchronize()
            same_twice, rel_twice = table_diff(again, want,
                                               f"unprofiled {name}")
            repeatable += same_twice
            profile.set_enabled(True)
            text, got, prof = main_path(analyzed)
            _, rel = table_diff(got, want, f"profile {name}")
            # with the sums in a fixed order the profiled run is the
            # unprofiled run bit for bit
            with deterministic():
                profile.set_enabled(False)
                want_det = qfn(tables)
                profile.set_enabled(True)
                _, got_det, _ = main_path(analyzed)
                same, _ = table_diff(got_det, want_det,
                                     f"profile {name}, deterministic")
            require(same, f"profile {name}: the profiled run differs in its "
                    "bits from the unprofiled run with deterministic sums")
            bit_identical += same
            rows = PO.node_rows(tree, None, encoded)
            for rec in prof.nodes():
                require(rec.out_rows == rows[rec.node_id],
                        f"profile {name}: {rec.line} observed "
                        f"{rec.out_rows} rows, the oracle {rows[rec.node_id]}")

            def profiled():
                with profile.query(name, qfn.plan_fingerprint):
                    qfn(tables)
            profile.set_enabled(False)
            plain_s = median_wall(lambda: qfn(tables), PROFILE_REPS)
            profile.set_enabled(True)
            prof_s = median_wall(profiled, PROFILE_REPS)
            profiles[name] = dict(
                nodes=sum(1 for _ in prof.nodes()),
                device_ms=round(sum(r.fence_ms or 0 for r in prof.roots), 3),
                plain_ms=round(plain_s * 1e3, 3),
                profiled_ms=round(prof_s * 1e3, 3),
                overhead=round(prof_s / plain_s, 3),
                unprofiled_twice_bit_identical=same_twice,
                unprofiled_twice_rel_err=rel_twice, profiled_rel_err=rel,
                deterministic_bit_identical=same)
            log(f"[profile] {name}: {profiles[name]}\n{text}")
    finally:
        profile.set_enabled(None)
    # the @traced names as torch.profiler ranges
    fcat = lower.FileCatalog(files)
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as tp:
        lower.execute(tpcds_plans.optimized("q3", **params["q3"]).tree,
                      fcat, record_stats=False)
        spec.pack(out, mortgage.FEATURE_COLS)
        torch.cuda.synchronize()
    keys = {a.key for a in tp.key_averages()}
    traced = ["parquet_scan_table_device", "parquet.scan.walk",
              "parquet.scan.decode", "convert_to_rows"]
    require(all(k in keys for k in traced),
            f"profile: ranges {[k for k in traced if k not in keys]} missing")
    overheads = [p["overhead"] for p in profiles.values()]
    profile_report = dict(queries=profiles, bit_identical=bit_identical,
                          unprofiled_repeatable=repeatable,
                          overhead_median=statistics.median(overheads),
                          traced_ranges=traced, card=card)
    log(f"[profile] 8 plan queries under explain_analyze, every node's rows "
        f"equal to the oracle; {repeatable} of 8 bit-identical between two "
        f"unprofiled runs (floats within {SQL_FLOAT_RTOL:g}); with "
        f"deterministic sums {bit_identical} of 8 profiled runs "
        f"bit-identical to their unprofiled runs; profiled over unprofiled "
        f"medians {overheads} [{card}]")
    log("[profile] summary " + json.dumps(profile_report))

    # -- AOT: persisted tapes, a fresh scheduler warmed up from them ---------
    qfns = {q: functools.partial(tpcds.QUERIES[q], **params[q])
            for q in ("q3", "q65")}

    def first_serve():
        sched = xc.QueryScheduler(workers=2)
        out_, first_ms = {}, {}
        try:
            for q, fn in qfns.items():
                t0 = time.perf_counter()
                out_[q] = sched.run(q, fn, tables)
                first_ms[q] = round((time.perf_counter() - t0) * 1e3, 3)
            t0 = time.perf_counter()
            out_["predict"] = sched.submit_predict(
                sv, mtables).result(timeout=600)
            first_ms["predict"] = round((time.perf_counter() - t0) * 1e3, 3)
        finally:
            sched.shutdown()
        return out_, first_ms

    def store_round(det: bool):
        """q3, q65 and the servable served by a scheduler with a fresh
        tape store, then by a new one warmed up from it with no eager
        capture run; with ``det``, under deterministic sums (as
        :func:`deterministic`).  Returns the first results, both rounds'
        first-request times, the warm results' bit-identity and the
        compile ledger."""
        os.environ["SRJT_AOT_DIR"] = tempfile.mkdtemp(prefix="srjt-aot-")
        torch.use_deterministic_algorithms(det, warn_only=True)
        metrics.reset()
        compiled.reset_counts()
        cold_out, cold_ms = main_path(first_serve)
        require(compiled.COUNTS["capture"] == 3
                and metrics.counter_value("aot.write") == 3,
                f"aot: {compiled.COUNTS['capture']} capture runs, "
                f"{metrics.counter_value('aot.write')} artifacts written")
        gc.collect()
        metrics.reset()
        compiled.reset_counts()
        artifacts.get_store()._mem.clear()
        warm_out, warm_ms = main_path(first_serve)
        require(compiled.COUNTS["capture"] == 0
                and compiled.COUNTS["rehydrate"] == 3
                and metrics.counter_value("aot.hit") == 3
                and metrics.counter_value("aot.preloaded") == 3,
                f"aot: the warmed scheduler ran {compiled.COUNTS['capture']} "
                f"capture runs, {compiled.COUNTS['rehydrate']} rehydrates, "
                f"{metrics.counter_value('aot.hit')} hits, "
                f"{metrics.counter_value('aot.preloaded')} preloaded")
        led = metrics.ledger_snapshot()
        with compiled.device_work():
            same = {k: table_diff(warm_out[k], cold_out[k], f"aot {k}")[0]
                    for k in cold_out}
        return cold_out, cold_ms, warm_ms, same, led

    # the raw value, to be put back after the phase
    old_env = os.environ.get("SRJT_AOT_DIR")  # srjt-lint: disable=knob-env
    try:
        # timed as served, float sums by atomics (floats within
        # SQL_FLOAT_RTOL); then with deterministic sums, bit for bit
        _, cold_ms, warm_ms, same_atomic, led = store_round(False)
        cold_out, det_cold_ms, det_warm_ms, same, _ = store_round(True)
        require(all(same.values()), f"aot: warmed results not bit-identical "
                f"to the first run's with deterministic sums: {same}")
        # a tampered tape: q3's first size off by one
        store = artifacts.get_store()
        path = store.path_for("q3", "", artifacts.geometry_key(tables))
        with open(path) as f:
            doc = json.load(f)
        doc["tape"][0] += 1
        with open(path, "w") as f:
            json.dump(doc, f)
        store._mem.clear()
        metrics.reset()
        compiled.reset_counts()
        sched = xc.QueryScheduler(workers=1, plan_cache=xc.PlanCache())
        try:
            stale_out = main_path(lambda: sched.run("q3", qfns["q3"],
                                                    tables))
        finally:
            sched.shutdown()
        require(metrics.counter_value("exec.plan_cache.stale") == 1
                and compiled.COUNTS["capture"] == 1
                and compiled.COUNTS["tape_mismatch"] == 1,
                "aot: the tampered tape was not recaptured once")
        with compiled.device_work():
            require(table_diff(stale_out, cold_out["q3"], "aot stale q3")[0],
                    "aot: the recaptured q3 differs from the first run's")
    finally:
        torch.use_deterministic_algorithms(False)
        if old_env is None:
            os.environ.pop("SRJT_AOT_DIR", None)
        else:
            os.environ["SRJT_AOT_DIR"] = old_env
    aot = dict(cold_first_ms=cold_ms, warm_first_ms=warm_ms,
               deterministic_cold_first_ms=det_cold_ms,
               deterministic_warm_first_ms=det_warm_ms,
               rehydrates=3, captures_after_warmup=0,
               bit_identical_atomic_sums=same_atomic,
               bit_identical_deterministic=same, stale_recaptures=1,
               ledger={k: v for k, v in led.items() if "rehydrates" in v},
               card=card)
    log(f"[aot] first served request, cold {cold_ms} ms, warmed from the "
        f"store {warm_ms} ms, with no eager capture run (bit-identical "
        f"{same_atomic}, floats within {SQL_FLOAT_RTOL:g}); with "
        f"deterministic sums cold {det_cold_ms} ms, warmed {det_warm_ms} "
        f"ms, bit-identical {same}; a tampered q3 tape recaptured once "
        f"[{card}]")
    log("[aot] summary " + json.dumps(aot))

    for name in PHASE18_KERNELS:
        require(phase_counts[name] > 0, f"phase 18: {name} never launched")

    # -- the kernels on the phase's largest inputs --------------------------
    def keep(captured, name, args):
        nb = bytes_moved(name, args)
        if name not in captured or nb > captured[name][0]:
            captured[name] = (nb, args)

    def run_all():
        t = mortgage.load_tables(mortgage_files)
        spec.pack(mortgage.etl_tables(t), mortgage.FEATURE_COLS)
        d = DeltaTable("store_sales", files=[ss_file(0, STREAM_APPEND)])
        d.append_file(ss_file(STREAM_APPEND, 2 * STREAM_APPEND))
        d.scan(since=(1,))
        profile.analyze(tpcds_plans.PLANS["q3"](**params["q3"]),
                        tpcds_plans.TABLE_SCHEMAS, tables)

    captured = record_inputs(kernels, PHASE18_KERNELS, keep, run_all)
    results = {("ML+stream", name): measure(kernels, name, args, card,
                                            "ML+stream")
               for name, (_, args) in sorted(captured.items())}
    del captured
    summary = dict(launches=dict(phase_counts),
                   phase_s=round(time.perf_counter() - t_phase, 1),
                   card=card)
    log("[ml+stream] " + json.dumps(summary))
    del mtables, out, fb, pipe, trainer, sv
    metrics.set_enabled(None)
    gc.collect()
    torch.cuda.empty_cache()
    return results


# ---------------------------------------------------------------------------
# phase 14: the Mortgage ETL
# ---------------------------------------------------------------------------

# one acquisition quarter of the Single-Family Loan Performance data on the
# order of its loans, 12 monthly records each (generate's default), and
# tools/mortgage_bench.py:53's seed
MORTGAGE_ARGS = dict(n_loans=1_000_000, periods_per_loan=12, seed=11)
# the kernels phase 14 launches: B7 and B4 in the scan, B5 -> B6 -> B2 to
# materialize the dictionary strings the parsers read, B3 for their byte
# matrices
MORTGAGE_KERNELS = ("pack_rows", "unpack_rows", "segmented_copy",
                    "extract_rows", "gather_rows", "u8_to_u32")


def phase_mortgage(kernels, card, launches) -> dict:
    """Phase 14: the Mortgage ETL on 1,000,000 loans x 12 periods, every
    feature column against the numpy oracle; the scan and the ETL timed
    and profiled; each dictionary column's materialization timed; B2-B7
    on the largest inputs the phase hands them."""
    import torch_mortgage_oracle as MO
    import torch_mortgage_parquet as MW
    from spark_rapids_jni_tpu_torch import DictColumn, Table
    from spark_rapids_jni_tpu_torch.models import mortgage

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    files, arrays = MW.mortgage_parquet(**MORTGAGE_ARGS)
    write_s = time.perf_counter() - t0
    n_loans = MORTGAGE_ARGS["n_loans"]
    n_perf = n_loans * MORTGAGE_ARGS["periods_per_loan"]
    sizes = {name: len(raw) for name, raw in files.items()}
    groups = {"perf": -(-n_perf // MW.ROW_GROUP_ROWS),
              "acq": -(-n_loans // MW.ROW_GROUP_ROWS)}
    log(f"[mortgage] {MORTGAGE_ARGS}: files written in {write_s:.2f} s: "
        f"perf {n_perf} rows in {groups['perf']} row groups, "
        f"{sizes['perf']} bytes; acq {n_loans} rows in {groups['acq']} "
        f"row group(s), {sizes['acq']} bytes")
    t0 = time.perf_counter()
    want = MO.features(arrays)
    oracle_s = time.perf_counter() - t0
    del arrays
    log(f"[mortgage] the numpy oracle built the feature table in "
        f"{oracle_s:.2f} s")

    # the main path: the scan, then the ETL, each read alone
    kernels.reset()
    t0 = time.perf_counter()
    tables = mortgage.load_tables(files)
    torch.cuda.synchronize()
    scan_first = time.perf_counter() - t0
    scan_counts = kernels.counts()
    require(all(t.device.type == "cuda" for t in tables.values()),
            "load_tables left a table off the card")
    kernels.reset()
    t0 = time.perf_counter()
    out = mortgage.etl_tables(tables)
    torch.cuda.synchronize()
    etl_first = time.perf_counter() - t0
    etl_counts = kernels.counts()
    add_counts(launches, scan_counts)
    add_counts(launches, etl_counts)
    phase_counts = collections.Counter(scan_counts)
    phase_counts.update(etl_counts)
    require(all(c.data.device.type == "cuda" for c in out.columns),
            "etl_tables left a column off the card")
    try:
        rel = MO.check(out, want)
    except AssertionError as e:
        raise SmokeFailure(f"mortgage: {e}") from None
    rows_out = out.num_rows
    del out, want
    for name in MORTGAGE_KERNELS:
        require(phase_counts[name] > 0, f"mortgage: {name} never launched")
    log(f"[mortgage] {rows_out} feature rows equal the oracle (mean_upb's "
        f"largest relative error {rel:.3e}); launches: scan {scan_counts}, "
        f"etl {etl_counts}")

    def fresh():
        """The loaded tables with unmaterialized dictionary columns (a
        DictColumn keeps its chars once built), so that each timed ETL
        call pays the materialization a first call pays."""
        return {k: Table([DictColumn(c.codes, c.dictionary, c.validity)
                          if isinstance(c, DictColumn) else c
                          for c in t.columns])
                for k, t in tables.items()}

    total = sum(sizes.values())
    scan_wall = median_wall(lambda: mortgage.load_tables(files))
    etl_wall = median_wall(lambda: mortgage.etl_tables(fresh()))
    log(f"[mortgage] load_tables: first {scan_first * 1e3:.3f} ms, median "
        f"of {PATH_REPS} {scan_wall * 1e3:.3f} ms for {total} file bytes "
        f"({total / scan_wall / 1e9:.3f} GB/s) [{card}]")
    log(f"[mortgage] etl_tables: first {etl_first * 1e3:.3f} ms, median of "
        f"{PATH_REPS} {etl_wall * 1e3:.3f} ms over {n_perf} performance "
        f"rows ({n_perf / etl_wall / 1e6:.1f} M rows/s) [{card}]")
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    mortgage.etl_tables(fresh())
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    profiles = {"etl_tables": profile_summary(
                    lambda: mortgage.etl_tables(fresh()), card),
                "load_tables": profile_summary(
                    lambda: mortgage.load_tables(files), card)}
    for what, prof in profiles.items():
        log(f"[mortgage] profile {what}: " + json.dumps(prof))

    # the dictionary columns' materialization (B5 -> B6 -> B2), which the
    # parsers pay before B3 cuts their byte matrices
    materialize = {}
    for key, cols in (("perf", mortgage.PERF_COLS),
                      ("acq", mortgage.ACQ_COLS)):
        for name, c in zip(cols, tables[key].columns):
            if isinstance(c, DictColumn):
                materialize[name] = round(1e3 * median_wall(
                    lambda c=c: DictColumn(c.codes, c.dictionary,
                                           c.validity).materialize()), 3)
    log(f"[mortgage] materialize ms (median of {PATH_REPS}): {materialize} "
        f"[{card}]")

    def keep(captured, name, args):
        nb = bytes_moved(name, args)
        if name not in captured or nb > captured[name][0]:
            captured[name] = (nb, args)

    captured = record_inputs(
        kernels, MORTGAGE_KERNELS, keep,
        lambda: mortgage.etl_tables(mortgage.load_tables(files)))
    results = {("Mortgage", name): measure(kernels, name, args, card,
                                           "Mortgage",
                                           library_call(name, args))
               for name, (_, args) in sorted(captured.items())}
    report = {"card": card, "args": MORTGAGE_ARGS, "file_bytes": sizes,
              "row_groups": groups, "write_s": round(write_s, 2),
              "oracle_s": round(oracle_s, 2),
              "load_tables_ms": round(scan_wall * 1e3, 3),
              "load_tables_first_ms": round(scan_first * 1e3, 3),
              "scan_gb_s": round(total / scan_wall / 1e9, 3),
              "etl_tables_ms": round(etl_wall * 1e3, 3),
              "etl_tables_first_ms": round(etl_first * 1e3, 3),
              "etl_peak_bytes": peak, "mean_upb_max_rel_err": rel,
              "rows_out": rows_out, "profiles": profiles,
              "materialize_ms": materialize, "launches": dict(phase_counts)}
    report["phase_s"] = round(time.perf_counter() - t_phase, 1)
    log("[mortgage] summary " + json.dumps(report))
    del tables, captured
    torch.cuda.empty_cache()
    return results, files


# ---------------------------------------------------------------------------
# phase 19: adaptive execution, the repartition join, the arena, the fault
# shim, one-launch batches, Arrow, rows above 2 GB
# ---------------------------------------------------------------------------

# the JAX package's two AQE shapes (tools/aqe_bench.py)
AQE_MISPREDICTED = dict(n=1_500_000, n_big=300_000, n_small_space=6400,
                        n_small=64, seed=13)
AQE_SKEWED = dict(n=8 * 262_144, nb=4096, groups=32, hot=0.9, seed=7,
                  shards=8)
# store_sales ⋈ item on a mesh of this many shards of the one card
REPARTITION_SHARDS = 4
# the served run under the fault shim: torch.launch faults at this percent
SHIM_PERCENT = 5
SHIM_SEED = 7
SHIM_QUERIES = ("q3", "q7", "q19", "q42", "q52", "q55")
VMAPPED_K = 4
# spark_12_2str rows whose JCUDF rows pass 2.5 GB
BIG_ROWS = 32_000_000
BIG_MIN_BYTES = 2_500_000_000
# the AQE phase's kernels: B3 and B4 (string ops), B5-B7 (scan and
# dictionary materialization), B1-B4 (rows above 2 GB)
AQE_KERNELS = ("pack_windows", "pack_rows", "unpack_rows", "segmented_copy",
               "extract_rows", "gather_rows", "u8_to_u32")
# the card phase 19 runs on
CARD = torch.device("cuda", 0)


def release() -> None:
    """Dead objects collected, dead compiled queries' graphs destroyed
    (``compiled.device_work`` buries them) and the allocator's free
    blocks returned, so that a reading of reserved memory sees the live
    tensors only."""
    from spark_rapids_jni_tpu_torch.models import compiled
    gc.collect()
    with compiled.device_work():
        pass
    torch.cuda.empty_cache()


@contextlib.contextmanager
def env(**values):
    """Environment knobs set for the block only."""
    old = {k: os.environ.get(k) for k in values}
    os.environ.update({k: str(v) for k, v in values.items()})
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def aqe_queries(card, tpcds_ctx, report) -> None:
    """The 8 plan trees and the 28 SQL texts, static and adaptive: eager
    under deterministic algorithms bit-identical, the oracle, decisions,
    medians; each adaptive qfn compiled to a graph against its eager
    run."""
    import torch_tpcds_oracle as O
    from spark_rapids_jni_tpu_torch import plan as P
    from spark_rapids_jni_tpu_torch import sql
    from spark_rapids_jni_tpu_torch.models import compiled, tpcds_plans
    from spark_rapids_jni_tpu_torch.models import tpcds_sql as TS

    tables, params, want = tpcds_ctx[:3]
    schemas = TS.TABLE_SCHEMAS
    qs = {}
    for name in tpcds_plans.PLANS:
        tree = tpcds_plans.optimized(name, **params[name]).tree
        qs[f"plan:{name}"] = (name, lambda t=tree: P.compile_plan(
            t, schemas), True)
    for name in TS.QUERY_NAMES:
        p = sql_params(TS, name, params)
        qs[f"sql:{name}"] = (name, lambda n=name, p=p: sql.compile_sql(
            TS.SQL[n], schemas, p), name in tpcds_plans.PLANS)
    out_q = {}
    decided = collections.Counter()
    for key, (name, build, oracle) in qs.items():
        with env(SRJT_AQE="0"):
            static = build()
        with env(SRJT_AQE="1"):
            adaptive = build()
        require(getattr(adaptive, "aqe_variant", "") == "aqe"
                and not hasattr(static, "aqe_variant"),
                f"aqe {key}: the variants are not tagged")
        with deterministic():
            s_out = static(tables)
            a_out = adaptive(tables)
            torch.cuda.synchronize()
        same, rel = table_diff(a_out, s_out, f"aqe {key}")
        require(same and rel == 0.0,
                f"aqe {key}: not bit-identical to its static twin")
        orel = None
        if oracle:
            try:
                orel = O.check(name, a_out, want[name])
            except AssertionError as e:
                raise SmokeFailure(f"aqe {key}: {e}") from None
        decisions = [f"{d.kind}: {d.detail}"
                     for d in adaptive.last_report.decisions()]
        decided.update(d.split(":")[0] for d in decisions)
        a_ms, s_ms = paired_medians(lambda: adaptive(tables),
                                    lambda: static(tables))
        cq = compiled.compile_query(adaptive, tables)
        table_diff(cq.run(tables), a_out, f"aqe compiled {key}")
        g_ms = median_wall(lambda: cq.run_unchecked(tables))
        out_q[key] = dict(decisions=decisions,
                          adaptive_ms=round(a_ms * 1e3, 3),
                          static_ms=round(s_ms * 1e3, 3),
                          graph_ms=round(g_ms * 1e3, 3),
                          tape_len=len(cq.tape), oracle_rel_err=orel)
        log(f"[aqe] {key}: adaptive = static bit for bit (deterministic"
            f"){'' if orel is None else f', the oracle ({orel:.3e})'}; "
            f"decisions {decisions}; median of {PATH_REPS} adaptive "
            f"{a_ms * 1e3:.3f} ms, static {s_ms * 1e3:.3f} (alternated), "
            f"the adaptive graph {g_ms * 1e3:.3f} ms, tape "
            f"{len(cq.tape)} [{card}]")
        del s_out, a_out, cq
    report["queries"] = out_q
    report["decisions"] = dict(decided)
    torch.cuda.empty_cache()


# SQL texts whose plans the adaptive executor changes (engine flips on
# the card): served static and adaptive into one small plan cache
AQE_APART = ("q3", "q42", "q55")


def aqe_served(card, tpcds_ctx, report) -> None:
    """Phase 17's mix served once with SRJT_AQE on (a plan cache of 32,
    as phase 17's), every answer equal to the oracle or the static eager
    twin; then AQE_APART's texts served static and adaptive into one
    plan cache, which holds the two variants of each apart."""
    import torch_tpcds_oracle as O
    from spark_rapids_jni_tpu_torch import exec as xc
    from spark_rapids_jni_tpu_torch import sql
    from spark_rapids_jni_tpu_torch.models import compiled, tpcds
    from spark_rapids_jni_tpu_torch.models import tpcds_sql as TS

    tables, params, want = tpcds_ctx[:3]
    schemas = TS.TABLE_SCHEMAS
    qfns = {name: functools.partial(fn, **params[name])
            for name, fn in tpcds.QUERIES.items()}
    sql_p = {name: sql_params(TS, name, params) for name in TS.QUERY_NAMES}
    with env(SRJT_AQE="0"):
        twins = {name: sql.compile_sql(TS.SQL[name], schemas,
                                       sql_p[name])(tables)
                 for name in TS.QUERY_NAMES}
    items = [("tpcds", name, qfns[name], 2) for name in tpcds.QUERIES]
    items += [("sql", name, (TS.SQL[name], sql_p[name]), 1)
              for name in TS.QUERY_NAMES]

    def check(tickets, what):
        n = 0
        with compiled.device_work():
            for (kind, name), tks in tickets.items():
                for tk in tks:
                    out = tk.result()
                    n += 1
                    if kind == "sql":
                        table_diff(out, twins[name], f"{what} sql {name}")
                        continue
                    try:
                        O.check(name, out, want[name])
                    except AssertionError as e:
                        raise SmokeFailure(f"{what} {name}: {e}") from None
        return n

    plans = xc.PlanCache()
    with env(SRJT_AQE="1"):
        sched = xc.QueryScheduler(workers=4, plan_cache=plans, device=CARD)
        try:
            tickets, wall = serve_clients(sched, items, tables, schemas)
        finally:
            sched.shutdown()
    n = check(tickets, "aqe served")
    stats = plans.stats()
    del plans, tickets
    gc.collect()
    torch.cuda.empty_cache()

    apart = xc.PlanCache(cap=2 * len(AQE_APART))
    sub = [("sql", name, (TS.SQL[name], sql_p[name]), 1)
           for name in AQE_APART]
    served = 0
    for flag in ("0", "1"):
        with env(SRJT_AQE=flag):
            sched = xc.QueryScheduler(workers=1, plan_cache=apart,
                                      device=CARD)
            try:
                tk, _ = serve_clients(sched, sub, tables, schemas)
            finally:
                sched.shutdown()
        served += check(tk, f"aqe apart {flag}")
    variants = collections.defaultdict(set)
    for key in apart._d:
        variants[key[0]].add(key[1])
    require(len(variants) == len(AQE_APART)
            and all(v == {"", "aqe"} for v in variants.values()),
            f"aqe served: the plan cache's variants {dict(variants)}")
    report["served"] = dict(requests=n, wall_s=round(wall, 3), cache=stats,
                            apart=len(apart._d))
    log(f"[aqe] served with SRJT_AQE=1: {n} requests (phase 17's mix), "
        f"every answer equal to the oracle or the static twin, in "
        f"{wall:.3f} s; plan cache {stats}; {', '.join(AQE_APART)} served "
        f"static then adaptive ({served} requests): one cache holds "
        f"{len(apart._d)} plans, the static and the +aqe variant of each "
        f"[{card}]")
    del apart, twins
    gc.collect()
    torch.cuda.empty_cache()


def aqe_shapes(card, report) -> None:
    """tools/aqe_bench.py's mispredicted_order and skewed_join on the
    card, static against adaptive, bit-identical first."""
    import spark_rapids_jni_tpu_torch as pt
    from spark_rapids_jni_tpu_torch.column import Column, Table
    from spark_rapids_jni_tpu_torch.parallel import Mesh
    from spark_rapids_jni_tpu_torch.parallel import repartition_join as rj
    from spark_rapids_jni_tpu_torch.plan import adaptive, ir, lower
    from spark_rapids_jni_tpu_torch.utils import metrics

    a = AQE_MISPREDICTED
    rng = np.random.default_rng(a["seed"])
    n, nb = a["n"], a["n_big"]
    tables = {
        "fact": Table([Column.from_numpy(rng.integers(0, nb, n)),
                       Column.from_numpy(rng.integers(
                           0, a["n_small_space"], n)),
                       Column.from_numpy(rng.integers(1, 50, n))]),
        "dim_big": Table([Column.from_numpy(np.arange(nb, dtype=np.int64)),
                          Column.from_numpy((np.arange(nb) % 23).astype(
                              np.int32))]),
        "dim_small": Table([Column.from_numpy(np.arange(a["n_small"],
                                                        dtype=np.int64)),
                            Column.from_numpy((np.arange(a["n_small"])
                                               % 5).astype(np.int32))])}
    schemas = {"fact": ["f_big_sk", "f_small_sk", "f_qty"],
               "dim_big": ["big_sk", "b_tag"],
               "dim_small": ["small_sk", "s_tag"]}
    tree = ir.FusedJoinAggregate(
        ir.Join(ir.Scan("fact"), ir.Scan("dim_big"),
                ("f_big_sk",), ("big_sk",)),
        ir.Scan("dim_small"), ("f_small_sk",), ("small_sk",),
        ("b_tag",), (("f_qty", "sum", "total"), ("f_qty", "count", "cnt")))

    def static():
        t, _ = lower._execute(tree, lower.TableCatalog(tables, schemas),
                              record_stats=False)
        return t

    def adapt(rep=None):
        return adaptive.execute_adaptive(
            tree, lower.TableCatalog(tables, schemas), record_stats=False,
            report=rep)

    def match_rows(fn):
        metrics.set_enabled(True)
        metrics.reset()
        fn()
        torch.cuda.synchronize()
        h = metrics.snapshot()["histograms"].get("join.match_rows")
        metrics.set_enabled(None)
        return int(h["total"]) if h else 0

    rep = adaptive.AdaptiveReport()
    same, _ = table_diff(adapt(rep), static(), "aqe mispredicted_order")
    require(same, "aqe mispredicted_order: adaptive differs from static")
    decisions = [f"{d.kind}: {d.detail}" for d in rep.decisions()]
    require(any(d.startswith("replan") for d in decisions),
            "aqe mispredicted_order: no replan fired")
    rows_s, rows_a = match_rows(static), match_rows(adapt)
    s_ms, a_ms = paired_medians(static, adapt)
    report["mispredicted_order"] = dict(
        static_ms=round(s_ms * 1e3, 3), adaptive_ms=round(a_ms * 1e3, 3),
        match_rows_static=rows_s, match_rows_adaptive=rows_a,
        decisions=decisions)
    log(f"[aqe] mispredicted_order ({n} fact rows, {nb}- and "
        f"{a['n_small']}-row dimensions): bit-identical; decisions "
        f"{decisions}; static {s_ms * 1e3:.3f} ms, adaptive "
        f"{a_ms * 1e3:.3f} ms (median of {PATH_REPS}, alternated); "
        f"join.match_rows {rows_s} static, {rows_a} adaptive [{card}]")
    del tables

    k = AQE_SKEWED
    rng = np.random.default_rng(k["seed"])
    n, nb, groups = k["n"], k["nb"], k["groups"]
    fk = rng.integers(0, nb, n).astype(np.int64)
    fk[rng.random(n) < k["hot"]] = 11
    fv = rng.integers(-100, 100, n).astype(np.int64)
    bk = np.arange(nb, dtype=np.int64)
    bg = rng.integers(0, groups, nb).astype(np.int32)
    dev = CARD
    fd = (torch.from_numpy(fk).to(dev), torch.from_numpy(fv).to(dev))
    bd = (torch.from_numpy(bk).to(dev), torch.from_numpy(bg).to(dev))
    fvld = torch.ones((n, 2), dtype=torch.bool, device=dev)
    bvld = torch.ones((nb, 2), dtype=torch.bool, device=dev)
    mesh = Mesh([dev] * k["shards"])

    def run(**kw):
        s, c, d = rj.repartition_join_agg_auto(
            mesh, (pt.int64, pt.int64), (pt.int64, pt.int32), 0, 0, 1, 1,
            groups, fd, fvld, bd, bvld, **kw)
        torch.cuda.synchronize()
        return s, c, int(d)

    def padded(**kw):
        metrics.set_enabled(True)
        metrics.reset()
        run(**kw)
        slots = int(metrics.counter_value("shuffle.padded_slots.fact")
                    + metrics.counter_value("shuffle.padded_slots.build"))
        fired = int(metrics.counter_value("plan.aqe.skew_split.fired"))
        metrics.set_enabled(None)
        return slots, fired, dict(rj.COUNTS)

    with env(SRJT_AQE="0"):
        s1, c1, d1 = run(salt=1)
        slots_s, _, counts_s = padded(salt=1)
        t_s = median_wall(lambda: run(salt=1))
    with env(SRJT_AQE="1"):
        s2, c2, d2 = run()
        slots_a, fired, counts_a = padded()
        t_a = median_wall(run)
    require(d1 == d2 == 0, "aqe skewed_join: rows dropped")
    require(torch.equal(s1, s2) and torch.equal(c1, c2),
            "aqe skewed_join: the salted join differs from static")
    require(fired >= 1, "aqe skewed_join: the skew split did not fire")
    ok = fk[:] >= 0
    want_s = np.zeros(groups, np.int64)
    np.add.at(want_s, bg[fk[ok]], fv[ok])
    require(np.array_equal(s1.cpu().numpy(), want_s),
            "aqe skewed_join: sums differ from numpy")
    report["skewed_join"] = dict(
        rows=n, shards=k["shards"], static_ms=round(t_s * 1e3, 3),
        adaptive_ms=round(t_a * 1e3, 3), salt=counts_a["salt"],
        padded_slots_static=slots_s, padded_slots_adaptive=slots_a,
        exchange_static=counts_s, exchange_adaptive=counts_a)
    log(f"[aqe] skewed_join ({n} rows, {k['hot']:.0%} on one key, a mesh "
        f"of {k['shards']} shards on the one card): bit-identical and equal "
        f"to numpy, 0 dropped; static (salt 1) {t_s * 1e3:.3f} ms, adaptive "
        f"(salt {counts_a['salt']}) {t_a * 1e3:.3f} ms (medians of "
        f"{PATH_REPS}); padded slots {slots_s} → {slots_a}; exchanges "
        f"{counts_s} → {counts_a} [{card}]")


def repartition_tpcds(card, tpcds_ctx, report) -> None:
    """store_sales ⋈ item → SUM(ss_sales_price_cents), COUNT(*) by
    i_category_id on a mesh of REPARTITION_SHARDS shards of the one card
    (the exchange is a copy on the card: no interconnect is measured),
    against numpy."""
    import spark_rapids_jni_tpu_torch as pt
    from spark_rapids_jni_tpu_torch.column import force_column
    from spark_rapids_jni_tpu_torch.parallel import Mesh
    from spark_rapids_jni_tpu_torch.parallel import repartition_join as rj

    tables, arrays = tpcds_ctx[0], tpcds_ctx[6]
    ss, item = tables["store_sales"], tables["item"]
    fcols = [force_column(ss[i]) for i in (1, 4)]
    bcols = [force_column(item[i]) for i in (0, 5)]
    fvalid = torch.stack([c.validity_or_true() for c in fcols], 1)
    bvalid = torch.stack([c.validity_or_true() for c in bcols], 1)
    groups = int(arrays["item"]["i_category_id"].max()) + 1
    mesh = Mesh([CARD] * REPARTITION_SHARDS)

    def run():
        s, c, d = rj.repartition_join_agg_auto(
            mesh, tuple(c.dtype for c in fcols),
            tuple(c.dtype for c in bcols), 0, 0, 1, 1, groups,
            tuple(c.data for c in fcols), fvalid,
            tuple(c.data for c in bcols), bvalid)
        torch.cuda.synchronize()
        return s, c, int(d)

    s, c, d = run()
    counts = dict(rj.COUNTS)
    cat = np.zeros(int(arrays["item"]["i_item_sk"].max()) + 1, np.int64)
    cat[arrays["item"]["i_item_sk"]] = arrays["item"]["i_category_id"]
    g = cat[arrays["store_sales"]["ss_item_sk"]]
    want_s = np.zeros(groups, np.int64)
    np.add.at(want_s, g, arrays["store_sales"]["ss_sales_price_cents"])
    want_c = np.bincount(g, minlength=groups)
    require(d == 0, f"repartition: {d} rows dropped")
    require(np.array_equal(s.cpu().numpy(), want_s)
            and np.array_equal(c.cpu().numpy(), want_c),
            "repartition: store_sales ⋈ item differs from numpy")
    wall = median_wall(run)
    report["repartition"] = dict(
        shards=REPARTITION_SHARDS, fact_rows=ss.num_rows,
        build_rows=item.num_rows, dropped=d, wall_ms=round(wall * 1e3, 3),
        **counts)
    log(f"[repartition] store_sales ⋈ item ({ss.num_rows} × "
        f"{item.num_rows} rows) by i_category_id on {REPARTITION_SHARDS} "
        f"shards of the one card (the exchange copies on the card: no "
        f"interconnect measured): equal to numpy, {d} dropped; "
        f"{counts['rows_exchanged']} rows, {counts['bytes_exchanged']} bytes "
        f"exchanged ({counts['padded_bytes']} padded bytes copied), "
        f"capacities {counts['fact_capacity']}/{counts['build_capacity']}, "
        f"key span {counts['key_span']}; median of {PATH_REPS} "
        f"{wall * 1e3:.3f} ms [{card}]")


def arena_queries(card, tpcds_ctx, report) -> None:
    """load_tables and the 50 queries with the arena on (SRJT_HBM_ARENA=1)
    against the oracle, and torch.cuda.memory_reserved with the arena off
    and on."""
    import torch_tpcds_oracle as O
    from spark_rapids_jni_tpu_torch.memory import arena, budget
    from spark_rapids_jni_tpu_torch.models import tpcds
    from spark_rapids_jni_tpu_torch.utils import metrics

    _, params, want, _, files = tpcds_ctx[:5]

    def run_all(check: bool) -> dict:
        torch.cuda.synchronize()
        release()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        tables = tpcds.load_tables(files, device=CARD)
        for name, fn in tpcds.QUERIES.items():
            out = fn(tables, **params[name])
            if check:
                try:
                    O.check(name, out, want[name])
                except AssertionError as e:
                    raise SmokeFailure(f"arena {name}: {e}") from None
            del out
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = dict(wall_s=round(wall, 3),
                   memory_reserved=torch.cuda.memory_reserved(),
                   max_memory_reserved=torch.cuda.max_memory_reserved(),
                   max_memory_allocated=torch.cuda.max_memory_allocated())
        del tables
        return got

    with env(SRJT_HBM_ARENA="0"):
        budget.set_enabled(None)
        off = run_all(False)
    with env(SRJT_HBM_ARENA="1"):
        budget.set_enabled(None)
        arena.reset()
        budget.reset()
        metrics.set_enabled(True)
        metrics.reset()
        try:
            on = run_all(True)
            counters = metrics.snapshot()["counters"]
            st = arena.stats()
        finally:
            metrics.set_enabled(None)
    budget.set_enabled(None)
    reserves = {k: v for k, v in counters.items()
                if k.startswith("arena.reserve.")}
    on.update(peak_bytes=st["budget_peak"], zeros_bytes=st["zeros_bytes"],
              reservations=reserves, spills=counters.get(
                  "arena.spill.events", 0))
    report["arena"] = dict(on=on, off=off)
    log(f"[arena] load_tables and the 50 queries with SRJT_HBM_ARENA=1: "
        f"every result equal to the oracle; arena.peak_bytes "
        f"{st['budget_peak']}, reservations {reserves}, pooled zeros "
        f"{st['zeros_bytes']} bytes, spills {on['spills']}; "
        f"memory_reserved off/on {off['memory_reserved']}/"
        f"{on['memory_reserved']} (peaks {off['max_memory_reserved']}/"
        f"{on['max_memory_reserved']}); walls {off['wall_s']}/"
        f"{on['wall_s']} s [{card}]")


def shim_served(card, tpcds_ctx, report) -> None:
    """A short served run under the torch-level fault shim: torch.launch
    faults (injected OOMs) at SHIM_PERCENT percent, seed SHIM_SEED; every
    answer equals the oracle after the replicas' retries."""
    import torch_tpcds_oracle as O
    from spark_rapids_jni_tpu_torch import exec as xc
    from spark_rapids_jni_tpu_torch.faultinj import injector as finj
    from spark_rapids_jni_tpu_torch.faultinj import torch_shim
    from spark_rapids_jni_tpu_torch.models import compiled, tpcds

    tables, params, want = tpcds_ctx[:3]
    inj = finj.get_injector()
    torch_shim.install()
    try:
        inj.load_dict({"seed": SHIM_SEED, "sites": {"torch.launch": {
            "percent": SHIM_PERCENT, "injectionType": "oom"}}})
        inj.enable()
        sched = xc.QueryScheduler(workers=2, max_retries=16,
                                  plan_cache=xc.PlanCache(), device=CARD)
        try:
            tickets = [(name, sched.submit(name, functools.partial(
                tpcds.QUERIES[name], **params[name]), tables))
                for _ in range(3) for name in SHIM_QUERIES]
            outs = [(name, tk.result()) for name, tk in tickets]
            retries = sum(r.resilient.retry_count for r in sched.replicas)
        finally:
            sched.shutdown()
    finally:
        inj.disable()
        counts = dict(torch_shim.COUNTS)
        torch_shim.uninstall()
    with compiled.device_work():
        for name, out in outs:
            try:
                O.check(name, out, want[name])
            except AssertionError as e:
                raise SmokeFailure(f"shim {name}: {e}") from None
    require(counts.get("torch.launch.injected", 0) > 0,
            "shim: no fault was injected")
    report["shim"] = dict(requests=len(outs), retries=retries,
                          interceptions=counts)
    log(f"[shim] {len(outs)} served requests under the torch shim "
        f"(torch.launch OOMs at {SHIM_PERCENT}%, seed {SHIM_SEED}): every "
        f"answer equal to the oracle after {retries} retries; interceptions "
        f"{counts} [{card}]")


def vmapped_batch(card, tpcds_ctx, report) -> None:
    """q3 over VMAPPED_K copies of the tables, store_sales rows permuted
    (the same sizes, so one tape fits all), as one launch of a K-member
    graph against K replays."""
    from spark_rapids_jni_tpu_torch.column import Column, Table
    from spark_rapids_jni_tpu_torch.models import compiled, tpcds

    tables, params = tpcds_ctx[:2]
    gen = torch.Generator(device=CARD).manual_seed(19)
    sets = []
    for _ in range(VMAPPED_K):
        ss = tables["store_sales"]
        perm = torch.randperm(ss.num_rows, generator=gen, device=CARD)
        cols = [Column(c.dtype, c.data[perm], None,
                       None if c.validity is None else c.validity[perm])
                for c in ss.columns]
        sets.append(dict(tables, store_sales=Table(cols)))
    qfn = functools.partial(tpcds.QUERIES["q3"], **params["q3"])
    cq = compiled.compile_query(qfn, sets[0])
    serial = [cq.run(t) for t in sets]
    outs = cq.run_vmapped(sets)
    require(outs is not None and len(outs) == VMAPPED_K,
            "vmapped: the batch was refused")
    # float sums add by atomics on the card: floats within SQL_FLOAT_RTOL
    bits = sum(table_diff(a, b, f"vmapped member {k}")[0]
               for k, (a, b) in enumerate(zip(outs, serial)))
    in_graph = cq._batches.get(VMAPPED_K, {}).get("launches", {})
    # one set fewer runs in the same graph, its spare member repeating
    # the last set: no other capture
    captures = compiled.COUNTS["batch_capture"]
    short = cq.run_vmapped(sets[:-1])
    require(short is not None and len(short) == VMAPPED_K - 1
            and compiled.COUNTS["batch_capture"] == captures
            and sorted(cq._batches) == [VMAPPED_K],
            f"vmapped: {VMAPPED_K - 1} sets took another graph: "
            f"{sorted(cq._batches)}")
    for k, (a, b) in enumerate(zip(short, serial)):
        table_diff(a, b, f"vmapped short member {k}")
    one = median_wall(lambda: cq.run_vmapped(sets))
    each = median_wall(lambda: [cq.run_unchecked(t) for t in sets])
    report["vmapped"] = dict(k=VMAPPED_K, batch_ms=round(one * 1e3, 3),
                             replays_ms=round(each * 1e3, 3),
                             bit_identical=bits, launches=nonzero(in_graph),
                             batch_bytes=cq.batch_bytes,
                             graph_bytes=cq.device_bytes() - cq.batch_bytes)
    log(f"[vmapped] q3 over {VMAPPED_K} permuted copies of store_sales: one "
        f"launch of a {VMAPPED_K}-member graph equal to {VMAPPED_K} checked "
        f"replays ({bits} of {VMAPPED_K} bit for bit, floats within "
        f"{SQL_FLOAT_RTOL:g}); median of {PATH_REPS} {one * 1e3:.3f} ms "
        f"against {each * 1e3:.3f} ms for the {VMAPPED_K} replays; kernels "
        f"in the batch graph {nonzero(in_graph)}; {VMAPPED_K - 1} sets ran "
        f"in the same graph; batch graph {cq.batch_bytes} bytes beside "
        f"{cq.device_bytes() - cq.batch_bytes} of the one-set graph "
        f"[{card}]")
    del cq, sets, outs, serial, short


def arrow_lineitem(card, spark_raw, report) -> None:
    """SF1 lineitem as Spark writes it (phase 11's file), scanned, through
    to_arrow_buffers → from_arrow_buffers on the card, byte-equal (the
    dictionary strings materialized by B5 → B6 → B2 on the way)."""
    from spark_rapids_jni_tpu_torch.column import force_column
    from spark_rapids_jni_tpu_torch.parquet import device_scan
    from spark_rapids_jni_tpu_torch.utils import arrow

    table = device_scan.scan_table(spark_raw, device=CARD)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bufs = [arrow.to_arrow_buffers(c) for c in table.columns]
    t_to = time.perf_counter() - t0
    t0 = time.perf_counter()
    back = [arrow.from_arrow_buffers(a, device=CARD) for a in bufs]
    torch.cuda.synchronize()
    t_from = time.perf_counter() - t0
    nbytes = sum(a.data.nbytes + (0 if a.offsets is None else a.offsets.nbytes)
                 + (0 if a.validity is None else a.validity.nbytes)
                 for a in bufs)
    for i, (c, b) in enumerate(zip(table.columns, back)):
        c = force_column(c)
        require(b.dtype == c.dtype, f"arrow column {i}: type {b.dtype}")
        require(torch.equal(b.data.contiguous().view(torch.uint8),
                            c.data.contiguous().view(torch.uint8)),
                f"arrow column {i}: data differs")
        require((b.validity is None) == (c.validity is None)
                and (b.validity is None
                     or torch.equal(b.validity, c.validity)),
                f"arrow column {i}: validity differs")
        if c.offsets is not None:
            require(torch.equal(b.offsets, c.offsets),
                    f"arrow column {i}: offsets differ")
    report["arrow"] = dict(rows=table.num_rows, columns=table.num_columns,
                           bytes=nbytes, to_ms=round(t_to * 1e3, 3),
                           from_ms=round(t_from * 1e3, 3))
    log(f"[arrow] SF1 lineitem ({table.num_rows} rows, "
        f"{table.num_columns} columns, Spark's file) through its Arrow "
        f"buffers and back: byte-equal; {nbytes} buffer bytes, to "
        f"{t_to * 1e3:.3f} ms ({nbytes / t_to / 1e9:.2f} GB/s), from "
        f"{t_from * 1e3:.3f} ms ({nbytes / t_from / 1e9:.2f} GB/s) "
        f"(first calls) [{card}]")
    del table, bufs, back


def big_rows(pt, T, convert, card, seed, report) -> None:
    """spark_12_2str at BIG_ROWS rows, made on the card from a seeded
    generator: JCUDF rows past 2.5 GB, split into batches below 2 GB
    (``convert._to_rows_strings``), every batch back through
    ``convert_from_rows`` equal to its rows of the table, byte for
    byte."""
    from spark_rapids_jni_tpu_torch.column import Column, Table

    n_cols, every, max_len = CASES["spark_12_2str"]
    n = BIG_ROWS
    gen = torch.Generator(device=CARD).manual_seed(seed + 1)
    dev = CARD
    cols = []
    for i in range(n_cols):
        valid = torch.rand(n, generator=gen, device=dev) >= NULL_FRACTION
        if every and i % every == 0:
            lens = torch.randint(0, max_len, (n,), generator=gen,
                                 device=dev) * valid
            offs = torch.zeros(n + 1, dtype=torch.int64, device=dev)
            offs[1:] = torch.cumsum(lens, 0)
            total = int(offs[-1])
            chars = torch.randint(32, 127, (total,), generator=gen,
                                  device=dev, dtype=torch.uint8)
            cols.append(Column(T.string, chars, offs.to(torch.int32), valid))
            continue
        dt = T.DType(T.TypeId[FIXED_CYCLE[i % len(FIXED_CYCLE)]])
        st = dt.torch_storage
        if dt.id == T.TypeId.FLOAT32:
            data = torch.randn(n, generator=gen, device=dev)
        elif dt.id == T.TypeId.BOOL8:
            data = torch.randint(0, 2, (n,), generator=gen, device=dev,
                                 dtype=st)
        else:
            info = torch.iinfo(st)
            data = torch.randint(info.min // 2, info.max // 2, (n,),
                                 generator=gen, device=dev, dtype=st)
        cols.append(Column(dt, data, validity=valid))
    table = Table(cols)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    batches = pt.convert_to_rows(table)
    torch.cuda.synchronize()
    t_to = time.perf_counter() - t0
    nbytes = sum(b.num_bytes for b in batches)
    require(nbytes > BIG_MIN_BYTES,
            f"big rows: {nbytes} row bytes, not past {BIG_MIN_BYTES}")
    require(len(batches) >= 2, "big rows: one batch past 2 GB")
    lo = 0
    t_from = 0.0
    for bi, b in enumerate(batches):
        require(b.num_bytes < 2 ** 31, f"big rows: batch {bi} past 2 GB")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        back = pt.convert_from_rows(b, table.schema)
        torch.cuda.synchronize()
        t_from += time.perf_counter() - t0
        check_round_trip(convert.slice_table(table, lo, lo + b.num_rows),
                         back)
        lo += b.num_rows
        del back
    require(lo == n, f"big rows: the batches hold {lo} of {n} rows")
    counts = [b.num_rows for b in batches]
    del batches
    t_med = median_wall(lambda: pt.convert_to_rows(table))
    report["big_rows"] = dict(rows=n, row_bytes=nbytes, batches=counts,
                              to_first_ms=round(t_to * 1e3, 3),
                              to_ms=round(t_med * 1e3, 3),
                              from_first_ms=round(t_from * 1e3, 3))
    log(f"[bigrows] spark_12_2str x {n} rows: {nbytes} JCUDF row bytes in "
        f"{len(counts)} batches ({counts} rows), back byte-equal; to_rows "
        f"median of {PATH_REPS} {t_med * 1e3:.3f} ms = "
        f"{nbytes / t_med / 1e9:.2f} GB/s (first {t_to * 1e3:.3f} ms), "
        f"from_rows of the batches {t_from * 1e3:.3f} ms = "
        f"{nbytes / t_from / 1e9:.2f} GB/s (first calls) [{card}]")
    del table, cols
    torch.cuda.empty_cache()


def phase_aqe(pt, T, convert, kernels, card, seed, launches, tpcds_ctx,
              spark_raw) -> None:
    """Phase 19: adaptive execution over the plan trees and SQL texts
    (eager, compiled and served), the JAX package's two AQE shapes, the
    repartition join on a mesh of the card's shards, the 50 queries with
    the arena on, a served run under the fault shim, a K-member graph,
    Arrow interchange of SF1 lineitem and rows past 2.5 GB.  The kernel
    counts are set to 0 before and read after; every kernel must launch
    in it."""
    t_phase = time.perf_counter()
    report = {"card": card}
    kernels.reset()
    for part in (lambda: aqe_queries(card, tpcds_ctx, report),
                 lambda: aqe_served(card, tpcds_ctx, report),
                 lambda: aqe_shapes(card, report),
                 lambda: repartition_tpcds(card, tpcds_ctx, report),
                 lambda: arena_queries(card, tpcds_ctx, report),
                 lambda: shim_served(card, tpcds_ctx, report),
                 lambda: vmapped_batch(card, tpcds_ctx, report),
                 lambda: arrow_lineitem(card, spark_raw, report),
                 lambda: big_rows(pt, T, convert, card, seed, report)):
        part()
        release()
    torch.cuda.synchronize()
    counts = kernels.counts()
    add_counts(launches, counts)
    for name in AQE_KERNELS:
        require(counts[name] > 0, f"phase 19: {name} never launched")
    report["launches"] = counts
    report["phase_s"] = round(time.perf_counter() - t_phase, 1)
    log("[aqe] summary " + json.dumps(report))
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 20: nested columns
# ---------------------------------------------------------------------------

# an event table as Spark's collect_list leaves it (tools/
# torch_nested_parquet.py): 8 row groups of 1,048,576 rows, about 1 GB on
# the card, as an executor holds there
NESTED_ROWS = 8 << 20
NESTED_SEED = 18
# the kernels phase 20 launches: B7 for the fixed-width element and flat
# pages, B4 for the PLAIN list strings' prefixes and their gather, B5 ->
# B6 -> B2 for the dictionary list strings' chars
NESTED_KERNELS = ("pack_rows", "segmented_copy", "extract_rows",
                  "gather_rows", "u8_to_u32")
NESTED_PREDICATE_MOD = 7          # the mask keeps the rows with id % 7 == 3
# profiled scans at most, until one window holds the slab's upload row
NESTED_PROFILE_TRIES = 4


def nested_reference(arrays) -> dict:
    """The generator's arrays on the card, which the checks hold the
    port's columns against."""
    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(CARD)

    ref = {"id": up(arrays["id"]), "flag": up(arrays["flag"]),
           "uuid": up(arrays["uuid"].reshape(-1))}
    for name in ("items", "tags", "notes"):
        lst = arrays[name]
        n = lst.offsets.shape[0] - 1
        ref[name] = dict(
            offsets=up(lst.offsets),
            valid=up(np.ones(n, bool) if lst.valid is None else lst.valid))
    items = arrays["items"]
    ref["items"].update(values=up(items.values),
                        elem_valid=up(items.elem_valid))
    vocab = arrays["tags"].vocab
    voffs = np.zeros(len(vocab) + 1, np.int64)
    np.cumsum([len(v) for v in vocab], out=voffs[1:])
    ref["tags"].update(codes=up(arrays["tags"].codes),
                       chars=up(np.frombuffer(b"".join(vocab), np.uint8)),
                       char_offsets=up(voffs))
    ref["notes"].update(chars=up(arrays["notes"].chars),
                        char_offsets=up(arrays["notes"].char_offsets))
    lat, lon, gvalid = arrays["geo"]
    ref.update(lat=up(lat), lon=up(lon), geo_valid=up(gvalid))
    return ref


def segments(starts, lens):
    """(the source index of every element of segments ``starts`` of
    ``lens`` laid back to back, their int64 offsets), on the card."""
    new = torch.zeros(lens.shape[0] + 1, dtype=torch.int64,
                      device=lens.device)
    torch.cumsum(lens, 0, out=new[1:])
    total = int(new[-1])
    idx = (torch.repeat_interleave(starts - new[:-1], lens,
                                   output_size=total)
           + torch.arange(total, device=lens.device))
    return idx, new


def check_string(col, chars, offs, what) -> None:
    """A STRING column's bytes and offsets (rebased) equal (chars, offs)."""
    from spark_rapids_jni_tpu_torch.column import force_column
    col = force_column(col)
    got = col.offsets.to(torch.int64)
    got = got - got[0]
    require(torch.equal(got, offs), f"{what}: offsets differ")
    c0 = int(col.offsets[0])
    require(torch.equal(col.data[c0:c0 + int(got[-1])], chars),
            f"{what}: chars differ")


def check_nested(table, ref, rows, what, only=None) -> None:
    """Every column of a scanned (and maybe gathered) event table, or the
    columns named in ``only``, against the generator's arrays (on the
    card, :func:`nested_reference`) at the int64 row indices ``rows``
    (None: all): offsets, validity, elements and bytes."""
    from spark_rapids_jni_tpu_torch.column import force_column

    def pick(a):
        return a if rows is None else a[rows]

    def valid_of(col):
        return force_column(col).validity_or_true()

    require(table.num_columns == 8, f"{what}: {table.num_columns} columns")
    cols = dict(zip(("id", "items", "tags", "notes", "lat", "lon", "flag",
                     "uuid"), table.columns))
    if only is not None:
        cols = {k: v for k, v in cols.items() if k in only}
    for c in cols.values():
        require(force_column(c).device.type == "cuda",
                f"{what}: a column is off the card")
    if "id" in cols:
        require(torch.equal(cols["id"].data, pick(ref["id"])),
                f"{what}: id differs")
    for name in ("items", "tags", "notes"):
        if name not in cols:
            continue
        r, col = ref[name], force_column(cols[name])
        all_offs = r["offsets"]
        lens = pick(all_offs[1:] - all_offs[:-1])
        elem, offs = segments(pick(all_offs[:-1]), lens)
        got = col.offsets.to(torch.int64)
        require(col.children[0].device.type == "cuda",
                f"{what}: {name}'s elements are off the card")
        require(torch.equal(got - got[0], offs),
                f"{what}: {name} offsets differ")
        require(torch.equal(valid_of(col), pick(r["valid"])),
                f"{what}: {name} validity differs")
        child = force_column(col.children[0])
        if name == "items":
            ev = r["elem_valid"][elem]
            require(torch.equal(valid_of(child), ev),
                    f"{what}: items element validity differs")
            want = torch.where(ev, r["values"][elem], 0)
            c0 = int(got[0])
            require(torch.equal(child.data[c0:c0 + want.shape[0]], want),
                    f"{what}: items elements differ")
            continue
        which = r["codes"][elem] if name == "tags" else elem
        co = r["char_offsets"]
        src, coffs = segments(co[:-1][which], co[1:][which] - co[:-1][which])
        check_string(child, r["chars"][src], coffs,
                     f"{what}: {name} elements")
    for name in ("lat", "lon"):
        if name not in cols:
            continue
        v = pick(ref["geo_valid"])
        require(torch.equal(valid_of(cols[name]), v),
                f"{what}: geo.{name} validity differs")
        require(torch.equal(cols[name].data[v].view(torch.int64),
                            pick(ref[name])[v].view(torch.int64)),
                f"{what}: geo.{name} differs")
    if "flag" in cols:
        require(torch.equal(cols["flag"].data, pick(ref["flag"])),
                f"{what}: flag differs")
    if "uuid" in cols:
        n = cols["uuid"].num_rows
        r16 = (torch.arange(16, device=CARD) if rows is None
               else rows[:, None] * 16 + torch.arange(16, device=CARD))
        want = (ref["uuid"] if rows is None
                else ref["uuid"][r16.reshape(-1)])
        check_string(cols["uuid"], want,
                     16 * torch.arange(n + 1, device=CARD), f"{what}: uuid")


def column_bytes(col) -> int:
    """Bytes a column holds on its device: payload, offsets, validity,
    a dictionary column's codes and entries, children."""
    from spark_rapids_jni_tpu_torch.column import as_dict_column, force_column
    d = as_dict_column(col)
    if d is not None:
        return (d.codes.numel() * 4 + column_bytes(d.dictionary)
                + (0 if d.validity is None else d.validity.numel()))
    col = force_column(col)
    out = col.data.numel() * col.data.element_size()
    for t in (col.offsets, col.validity):
        if t is not None:
            out += t.numel() * t.element_size()
    return out + sum(column_bytes(c) for c in col.children or ())


def dict_passthrough(T, convert, card, seed) -> dict:
    """``spark_12_2str`` at ROWS rows with its two string columns as
    dictionary strings (entries of 0-39 chars): through
    ``dict_encode_for_rows`` -> rows -> ``restore_dict_columns``, every
    column equal to the input."""
    from spark_rapids_jni_tpu_torch.column import Column, DictColumn, Table
    rng = np.random.default_rng(seed + 20)
    n_cols, every, max_len = CASES["spark_12_2str"]
    cols = []
    for ty, scale, data, offs, valid in make_columns(T, n_cols, every,
                                                     max_len, ROWS, rng):
        if ty == int(T.TypeId.STRING):
            entries = [bytes(rng.integers(32, 127, int(k)).astype(np.uint8))
                       .decode() for k in rng.integers(0, max_len, 4096)]
            codes = torch.from_numpy(rng.integers(0, len(entries), ROWS)
                                     .astype(np.int32)).to(CARD)
            cols.append(DictColumn(codes, Column.strings_from_list(entries),
                                   torch.from_numpy(valid).to(CARD)))
        else:
            cols.append(Column.from_numpy(data, T.DType(T.TypeId(ty), scale),
                                          valid))
    table = Table(cols)
    t0 = time.perf_counter()
    codes, dicts = convert.dict_encode_for_rows(table)
    batches = convert.convert_to_rows(codes)
    back = convert.restore_dict_columns(
        convert.convert_from_rows(batches[0], codes.schema), dicts)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    require(len(batches) == 1 and sorted(dicts) == [0, 6],
            f"dict passthrough: {len(batches)} batches, dictionaries "
            f"{sorted(dicts)}")
    for i, (a, b) in enumerate(zip(table.columns, back.columns)):
        require(torch.equal(a.validity_or_true(), b.validity_or_true()),
                f"dict passthrough column {i}: validity differs")
        if isinstance(a, DictColumn):
            require(isinstance(b, DictColumn)
                    and b.dictionary is a.dictionary
                    and torch.equal(torch.where(a.validity, a.codes, 0),
                                    torch.where(a.validity, b.codes, 0)),
                    f"dict passthrough column {i}: codes differ")
        else:
            require(torch.equal(torch.where(a.validity, a.data, 0),
                                torch.where(a.validity, b.data, 0)),
                    f"dict passthrough column {i}: data differs")
    log(f"[nested] spark_12_2str ({ROWS} rows) with dictionary strings "
        f"through dict_encode_for_rows -> {batches[0].num_bytes} row bytes "
        f"-> restore_dict_columns: equal, {wall * 1e3:.3f} ms [{card}]")
    return dict(rows=ROWS, row_bytes=batches[0].num_bytes,
                ms=round(wall * 1e3, 3))


def phase_nested(T, convert, kernels, card, seed, launches) -> dict:
    """Phase 20: the event table of ``tools/torch_nested_parquet.py`` at
    NESTED_ROWS rows: the scan of every column exact against the
    generator; a mask over ``id``, a seeded permutation's gather, two row
    groups' scans concatenated and sliced, each exact; ``items`` and
    ``tags`` through their Arrow buffers and back; the dictionary-codes
    row passthrough; the scan's wall, GB/s and profile; B2, B4, B5, B6
    and B7 on the largest inputs the phase hands them."""
    import torch_nested_parquet as NW
    from spark_rapids_jni_tpu_torch.column import (Table, as_dict_column,
                                                   force_column)
    from spark_rapids_jni_tpu_torch.ops import copying, filter as F
    from spark_rapids_jni_tpu_torch.parquet import device_scan
    from spark_rapids_jni_tpu_torch.utils import arrow

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    raw, arrays = NW.nested_parquet(NESTED_ROWS, seed + NESTED_SEED,
                                    NW.ROW_GROUP_ROWS)
    write_s = time.perf_counter() - t0
    groups = -(-NESTED_ROWS // NW.ROW_GROUP_ROWS)
    log(f"[nested] {NESTED_ROWS} rows in {groups} row groups, {len(raw)} "
        f"bytes, written in {write_s:.2f} s")

    # the main path: scan, the tags' chars, mask, gather, concat, slice,
    # Arrow and the passthrough, the counts read after
    kernels.reset()
    steps = {}
    t0 = time.perf_counter()
    table = device_scan.scan_table(raw)
    torch.cuda.synchronize()
    steps["scan_first_ms"] = round((time.perf_counter() - t0) * 1e3, 3)
    on_card = sum(column_bytes(c) for c in table.columns)
    require(as_dict_column(force_column(table[2]).children[0]) is not None,
            "nested: the tags elements are not dictionary codes")
    ref = nested_reference(arrays)
    check_nested(table, ref, None, "scan")

    ids = table[0].data
    mask = ids % NESTED_PREDICATE_MOD == 3
    t0 = time.perf_counter()
    masked = F.apply_boolean_mask(table, mask)
    check_nested(masked, ref, torch.nonzero(
        ref["id"] % NESTED_PREDICATE_MOD == 3)[:, 0], "mask")
    steps["mask_check_ms"] = round((time.perf_counter() - t0) * 1e3, 3)
    del masked, mask

    perm = torch.from_numpy(np.random.default_rng(
        seed + NESTED_SEED).permutation(NESTED_ROWS)).to(CARD)
    t0 = time.perf_counter()
    gathered = F.gather(table, perm)
    check_nested(gathered, ref, perm, "gather")
    steps["gather_check_ms"] = round((time.perf_counter() - t0) * 1e3, 3)
    del gathered

    parts = [device_scan.scan_table(raw, row_groups=[g]) for g in (0, 1)]
    both = copying.concat_tables(parts)
    check_nested(both, ref, torch.arange(2 * NW.ROW_GROUP_ROWS, device=CARD),
                 "concat")
    # a slice across the two row groups' seam
    start, length = NW.ROW_GROUP_ROWS // 8 + 1, NW.ROW_GROUP_ROWS + 3
    sliced = copying.slice_table(both, start, length)
    check_nested(sliced, ref, torch.arange(start, start + length,
                                           device=CARD), "slice")
    del parts, both, sliced

    arrow_bytes = 0
    for i, name in ((1, "items"), (2, "tags")):
        bufs = arrow.to_arrow_buffers(force_column(table[i]))
        back = arrow.from_arrow_buffers(bufs)
        require(back.children[0].device.type == "cuda",
                "nested: Arrow's elements came back off the card")
        arrow_bytes += bufs.offsets.nbytes + bufs.children[0].data.nbytes
        cols = list(table.columns)
        cols[i] = back
        check_nested(Table(cols), ref, None, f"arrow {name}", (name,))
    passthrough = dict_passthrough(T, convert, card, seed)
    torch.cuda.synchronize()
    counts = kernels.counts()
    add_counts(launches, counts)
    for name in NESTED_KERNELS:
        require(counts[name] > 0, f"nested: {name} never launched")
    log(f"[nested] scan, mask, gather, concat, slice, Arrow and the "
        f"passthrough exact; launches {nonzero(counts)}")

    file_bytes = len(raw)
    # a warm call timed, then one profiled (profile_summary's own warm-up
    # is the timed call) whose window holds the slab's upload
    wall = median_wall(lambda: device_scan.scan_table(raw), reps=1)
    prof = profile_summary(lambda: device_scan.scan_table(raw), card,
                           warm=False, need=("Memcpy HtoD",),
                           tries=NESTED_PROFILE_TRIES)
    log(f"[nested] scan_table: first {steps['scan_first_ms']:.3f} ms, "
        f"second {wall * 1e3:.3f} ms for {file_bytes} file bytes "
        f"({file_bytes / wall / 1e9:.3f} GB/s), {on_card} bytes on the card; "
        f"profile " + json.dumps(prof))

    def keep(captured, name, args):
        nb = bytes_moved(name, args)
        if name not in captured or nb > captured[name][0]:
            captured[name] = (nb, args)

    def drive():
        t = device_scan.scan_table(raw)
        force_column(t[2]).children[0].materialize()
        force_column(F.gather(t, perm[:NW.ROW_GROUP_ROWS])[3])

    captured = record_inputs(kernels, NESTED_KERNELS, keep, drive)
    results = {("nested", name): measure(kernels, name, args, card, "nested",
                                         library_call(name, args))
               for name, (_, args) in sorted(captured.items())}
    report = {"card": card, "rows": NESTED_ROWS, "row_groups": groups,
              "file_bytes": file_bytes, "bytes_on_card": on_card,
              "write_s": round(write_s, 2),
              "scan_ms": round(wall * 1e3, 3),
              "scan_gb_s": round(file_bytes / wall / 1e9, 3),
              "profile": prof, "arrow_bytes": arrow_bytes,
              "passthrough": passthrough, "launches": counts, **steps}
    report["phase_s"] = round(time.perf_counter() - t_phase, 1)
    log("[nested] summary " + json.dumps(report))
    del table, captured, raw, arrays, ref, perm
    gc.collect()
    torch.cuda.empty_cache()
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    t_run = time.perf_counter()
    card = phase_device()
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import spark_rapids_jni_tpu_torch as pt
    from spark_rapids_jni_tpu_torch import _native, bridge, interop
    from spark_rapids_jni_tpu_torch import types as T
    from spark_rapids_jni_tpu_torch.models import q6, tpch_q1
    from spark_rapids_jni_tpu_torch.parquet import device_scan
    from spark_rapids_jni_tpu_torch.rowconv import (bytepath, convert, ragged,
                                                    reference, xpack)
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                    "tools"))
    import torch_lineitem_parquet as W

    phase_build(_native)
    kernels = Kernels(xpack, ragged, bytepath)
    require(list(kernels.module_of) ==
            ["pack_windows", "pack_rows", "unpack_rows", "segmented_copy",
             "extract_rows", "gather_rows", "u8_to_u32"] == list(KERNELS),
            "the kernel table and the kernel modules disagree")

    n_cols, every, max_len = CASES["spark_12_2str"]
    table = interop.table_from_numpy(
        make_columns(T, n_cols, every, max_len, ROWS,
                     np.random.default_rng(args.seed + 1)), device="cuda")
    results = phase_kernels(pt, kernels, table, card)
    del table
    torch.cuda.empty_cache()

    launches = {name: 0 for name in KERNELS}
    phase_path(pt, T, interop, convert, reference, kernels, card, args.seed,
               ROWS, launches)
    raw, data, cols15 = phase_scan(pt, W, device_scan, kernels, card,
                                   args.seed, launches)
    phase_q6_rows(pt, W, device_scan, q6, convert, reference, kernels, card,
                  raw, data, cols15, launches)
    scan_results, scan_extra = phase_scan_kernels(device_scan, kernels, raw,
                                                  cols15, card, args.seed)
    full_scan = phase_full_table(pt, W, device_scan, convert, reference,
                                 kernels, card, raw, data, launches)
    del data
    results.update(phase_full_kernels(pt, device_scan, kernels, raw, card))
    phase_jni(pt, T, W, interop, bridge, _native, device_scan, kernels, card,
              raw, args.seed, launches)
    del raw
    results.update(phase_q1(T, W, tpch_q1, kernels, card, args.seed,
                            launches))
    spark = {}
    results.update(phase_spark(pt, W, device_scan, q6, kernels, card,
                               args.seed, launches, full_scan, spark))
    tpcds_results, tpcds_ctx = phase_tpcds(kernels, card, launches)
    results.update(tpcds_results)
    phase_compiled(kernels, card, launches, tpcds_ctx)
    mortgage_results, mortgage_files = phase_mortgage(kernels, card,
                                                      launches)
    results.update(mortgage_results)
    results.update(phase_sql(kernels, card, launches, tpcds_ctx))
    results.update(phase_exec(kernels, card, launches, tpcds_ctx))
    results.update(phase_ml_stream(kernels, card, launches, tpcds_ctx,
                                   mortgage_files))
    phase_aqe(pt, T, convert, kernels, card, args.seed, launches, tpcds_ctx,
              spark.pop("raw"))
    del tpcds_ctx, mortgage_files
    torch.cuda.empty_cache()
    results.update(phase_nested(T, convert, kernels, card, args.seed,
                                launches))

    out = []
    for name, (source, replaces, where) in KERNELS.items():
        r = scan_results[name] if where == "scan" else results[(where, name)]
        others = ([r] + scan_extra.get(name, []) if where == "scan" else [])
        others += [v for (d, k), v in results.items() if k == name]
        inputs = [{key: o[key] for key in INPUT_KEYS if key in o}
                  for o in others]
        require(launches[name] > 0, f"{name} never launched on the main path")
        entry = {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max(o["max_abs_err"] for o in others),
            "equal": all(o["equal"] for o in others),
            "ms": r["ms"], "device_ms": r["device_ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": "bytes",
            "library_ms": r["library_ms"],
            "library_device_ms": r["library_device_ms"],
            "library": LIBRARY.get(name),
            "bytes": r["bytes"], "shape": r["shape"],
            "measured_in": where}
        for extra in ("b2_same_rows_ms", "floor_ms", "starts"):
            if extra in r:
                entry[extra] = r[extra]
        if len(inputs) > 1:
            entry["inputs"] = inputs
        out.append(entry)
    log(f"[profiler] {PROFILE_COUNTS['short']} of "
        f"{PROFILE_COUNTS['windows']} profiled windows short of device rows "
        "and taken again")
    log(f"[smoke] every phase passed in {time.perf_counter() - t_run:.1f} s "
        f"[{card}]")
    log(json.dumps({"card": card, "kernels": out}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
