"""The TPC-DS query tests' shared data, for ``tests/test_torch_tpcds*.py``.

Each test file holds its own queries of ``models.tpcds.QUERIES``, eager
and compiled (``models/compiled.py``), against the JAX package's (on
pyarrow's ``benchmarks/tpcds_data.generate(n_sales=40_000, n_items=500,
seed=7)``) and against the numpy oracle (``tools/torch_tpcds_oracle.py``,
on the arrays of the numpy writer ``tools/torch_tpcds_parquet.py``),
with the parameters the oracle picks from the data.  A file imports the
fixtures below and computes only its own queries' JAX results, once a
module (:func:`jax_results_of`).
"""

import functools
import pathlib
import sys

import numpy as np
import pytest
import torch

from benchmarks import tpcds_data
from spark_rapids_jni_tpu.models import tpcds as jtpcds

import spark_rapids_jni_tpu_torch as pt
from spark_rapids_jni_tpu_torch.column import force_column
from spark_rapids_jni_tpu_torch.models import compiled, tpcds
from spark_rapids_jni_tpu_torch.ops import join_plan

from test_torch_scan import JAX_NATIVE_LOADED
from torch_jax_columns import assert_same_table

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "tools"))
import torch_tpcds_oracle as O  # noqa: E402
import torch_tpcds_parquet as TW  # noqa: E402

CPU = "cpu"
ARGS = dict(n_sales=40_000, n_items=500, seed=7)
# FLOAT64 sums, means, deviations and ratios against the JAX package's:
# the same values summed in another order
RTOL = 1e-12


@pytest.fixture(scope="module", autouse=True)
def _jax_native_library():
    if not JAX_NATIVE_LOADED:
        pytest.fail("the JAX package's native library does not load")


@pytest.fixture(scope="module")
def data():
    """pyarrow's files, the writer's files and arrays, and each query's
    parameters."""
    files = tpcds_data.generate(**ARGS)
    mine, arrays = TW.tpcds_parquet(**ARGS)
    return files, mine, arrays, O.query_params(arrays)


@pytest.fixture(scope="module")
def port_tables(data):
    return tpcds.load_tables(data[0], device=CPU)


@pytest.fixture(scope="module")
def writer_tables(data):
    return tpcds.load_tables(data[1], device=CPU)


_JAX_TABLES: dict = {}


def jax_tables_of(data) -> dict:
    """The JAX package's tables of pyarrow's files, loaded once a
    process."""
    files = data[0]
    key = tuple(sorted((k, len(v)) for k, v in files.items()))
    if key not in _JAX_TABLES:
        _JAX_TABLES[key] = jtpcds.load_tables(files)
    return _JAX_TABLES[key]


def jax_results_of(names, data) -> dict:
    """The JAX package's result of each query of ``names``."""
    tables = jax_tables_of(data)
    params = data[3]
    return {name: jtpcds.QUERIES[name](tables, **params[name])
            for name in names}


def from_jax(table) -> pt.Table:
    """A JAX result table as a port table on the CPU, through numpy."""
    cols = []
    for c in table.columns:
        dt = pt.DType(pt.TypeId(int(c.dtype.id)), c.dtype.scale)
        valid = np.array(c.validity_or_true())
        if dt.id == pt.TypeId.STRING:
            cols.append(pt.Column.strings_from_list(c.to_pylist(),
                                                    device=CPU))
            continue
        data = (c.to_numpy() if dt.id == pt.TypeId.FLOAT64
                else np.asarray(c.data))
        cols.append(pt.Column.from_numpy(data, dt, valid, device=CPU))
    return pt.Table(cols)


def check_against_jax(name, data, jax_results, port_tables) -> None:
    """The port's query equals the JAX package's: the schema, keys,
    integers, decimals, counts and row order exactly, floats within
    ``RTOL``."""
    got = tpcds.QUERIES[name](port_tables, **data[3][name])
    want = jax_results[name]
    assert got.schema == [pt.DType(pt.TypeId(int(c.dtype.id)), c.dtype.scale)
                          for c in want.columns]
    assert_same_table(got, want, rtol=RTOL)


def check_compiled_against_jax(name, data, jax_results,
                               port_tables) -> None:
    """The port's compiled query (its checked and unchecked runs, eager
    under the tape on the CPU) equals the JAX package's query as the
    eager one does."""
    qfn = functools.partial(tpcds.QUERIES[name], **data[3][name])
    cq = compiled.compile_query(qfn, port_tables)
    want = jax_results[name]
    for got in (cq.run(port_tables), cq.run_unchecked(port_tables)):
        assert got.schema == [pt.DType(pt.TypeId(int(c.dtype.id)),
                                       c.dtype.scale)
                              for c in want.columns]
        assert_same_table(got, want, rtol=RTOL)


def check_oracle_against_jax(name, data, jax_results) -> None:
    arrays, params = data[2], data[3]
    O.check(name, from_jax(jax_results[name]),
            O.answer(name, arrays, params[name]))


def check_writer_files(name, data, tables, joins: bool = True) -> None:
    """The port's query on the writer's files equals the oracle; a query
    that joins counts at least one join engine."""
    _, _, arrays, params = data
    join_plan.reset_counts()
    out = tpcds.QUERIES[name](tables, **params[name])
    engines = sum(v for k, v in join_plan.COUNTS.items()
                  if k.startswith("engine."))
    assert (engines >= 1) if joins else (engines == 0)
    O.check(name, out, O.answer(name, arrays, params[name]))


def assert_identical(got, want):
    """Two port tables hold the same columns bit for bit: dtype,
    validity (its presence too), offsets and payload."""
    assert got.num_columns == want.num_columns
    assert got.num_rows == want.num_rows
    for i, (a, b) in enumerate(zip(got.columns, want.columns)):
        a, b = force_column(a), force_column(b)
        assert a.dtype == b.dtype, f"column {i} dtype"
        assert (a.validity is None) == (b.validity is None), f"column {i}"
        if a.validity is not None:
            assert torch.equal(a.validity, b.validity), f"column {i}"
        if a.dtype.is_variable_width:
            assert torch.equal(a.offsets, b.offsets), f"column {i}"
        da, db = a.data, b.data
        if da.dtype == torch.float64:
            da, db = da.view(torch.int64), db.view(torch.int64)
        assert torch.equal(da, db), f"column {i} payload"
