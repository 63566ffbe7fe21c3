"""spark_rapids_jni_tpu_torch — the PyTorch/CUDA port of the Spark
acceleration layer, for NVIDIA Hopper GPUs.

It stands beside the JAX package ``spark_rapids_jni_tpu``, which stays the
reference: the same inputs give the same bytes out of both.  This package
imports torch and numpy only, never JAX.  Its entry points run on the GPU
unless the caller passes ``device="cpu"``; without a CUDA device they raise.
The hand-written kernels are CUDA C++ sources under ``csrc/``, compiled with
``nvcc`` at first use (see ``_native.py``).

Ported so far: JCUDF row ↔ column conversion, the device Parquet scan
with TPC-H Q6 on it, the op library (``ops``) with TPC-H Q1, the join
engine with lazy columns, the 50 TPC-DS queries (``models.tpcds``) eager
and compiled to CUDA graphs (``models.compiled``), the Mortgage ETL, and
the planner and SQL front end (``plan``, ``sql``) with the fused
scan→filter, the serving runtime (``exec``) with its persistent tape
store, per-node profiles (``plan.profile``), streaming views
(``stream``) and the ETL→ML handoff (``ml``), adaptive execution,
``parallel``, the arena, Arrow and the fault shim, nested columns (LIST
and STRUCT through the column, the ops, Arrow and the scan), and the
static analysis (``analysis``, run by ``tools/torch_lint.py``): every
module of the JAX package has its port or is left out by design
(``ROADMAP.md``).
"""

from ._version import BASE_VERSION as __version__  # noqa: F401

from . import types  # noqa: F401
from .types import (  # noqa: F401
    DType, TypeId,
    int8, int16, int32, int64, uint8, uint16, uint32, uint64,
    float32, float64, bool8, string,
    timestamp_days, timestamp_seconds, timestamp_ms, timestamp_us, timestamp_ns,
    decimal32, decimal64, decimal128,
)
from .column import (Column, DictColumn, LazyColumn, Table,  # noqa: F401
                     force_column)
from .rowconv import (  # noqa: F401
    RowBatch, RowLayout, compute_row_layout, build_batches,
    convert_to_rows, convert_from_rows,
)
