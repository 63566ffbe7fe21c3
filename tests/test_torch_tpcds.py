"""The port's 16 TPC-DS join queries against the JAX package's, on the CPU.

``spark_rapids_jni_tpu_torch.models.tpcds`` and
``spark_rapids_jni_tpu.models.tpcds`` run each query on the same files,
pyarrow's ``benchmarks/tpcds_data.generate(n_sales=40_000, n_items=500,
seed=7)``, with the parameters ``tools/torch_tpcds_oracle.py`` picks from
the data.  Keys, integer and decimal values, counts and row order must be
equal; FLOAT64 sums and means within a relative 1e-12.  The numpy writer
``tools/torch_tpcds_parquet.py`` must give pyarrow's tables, and the
numpy oracle must agree with the JAX package's results and with the
port's on the writer's files (the check ``chip_smoke.py`` makes on the
card).
"""

import io
import pathlib
import sys

import numpy as np
import pyarrow.parquet as pq
import pytest
import torch

from benchmarks import tpcds_data
from spark_rapids_jni_tpu.models import tpcds as jtpcds

import spark_rapids_jni_tpu_torch as pt
from spark_rapids_jni_tpu_torch.models import tpcds
from spark_rapids_jni_tpu_torch.ops import join_plan

from test_torch_scan import JAX_NATIVE_LOADED
from torch_jax_columns import assert_same_table

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "tools"))
import torch_tpcds_oracle as O  # noqa: E402
import torch_tpcds_parquet as TW  # noqa: E402

CPU = "cpu"
ARGS = dict(n_sales=40_000, n_items=500, seed=7)
RTOL = 1e-12
QUERIES = list(tpcds.QUERIES)


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
def jax_results(data):
    """Every query's JAX result, once a module (JAX compiles on the CPU)."""
    files, _, _, params = data
    tables = jtpcds.load_tables(files)
    return {name: jtpcds.QUERIES[name](tables, **params[name])
            for name in QUERIES}


@pytest.fixture(scope="module")
def port_tables(data):
    return tpcds.load_tables(data[0], device=CPU)


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


def test_queries_are_the_sixteen_join_queries():
    assert QUERIES == ["q3", "q42", "q52", "q55", "q_state_rollup", "q7",
                       "q19", "q62", "q52_topn", "q_brand_rev_left",
                       "q23_semi", "q16_anti", "q78_outer", "q25_two_fact",
                       "q_channel_day", "q_web_also_qty"]
    assert set(QUERIES) <= set(jtpcds.QUERIES)


@pytest.mark.parametrize("name", QUERIES)
def test_query_matches_jax(name, data, jax_results, port_tables):
    params = data[3][name]
    got = tpcds.QUERIES[name](port_tables, **params)
    want = jax_results[name]
    assert got.schema == [pt.DType(pt.TypeId(int(c.dtype.id)), c.dtype.scale)
                          for c in want.columns]
    assert_same_table(got, want, rtol=RTOL)


@pytest.mark.parametrize("name", QUERIES)
def test_oracle_matches_jax(name, data, jax_results):
    arrays, params = data[2], data[3]
    O.check(name, from_jax(jax_results[name]),
            O.answer(name, arrays, params[name]))


@pytest.mark.parametrize("name", QUERIES)
def test_query_on_writer_files_matches_oracle(name, data):
    _, mine, arrays, params = data
    tables = tpcds.load_tables(mine, device=CPU)
    join_plan.reset_counts()
    out = tpcds.QUERIES[name](tables, **params[name])
    assert sum(v for k, v in join_plan.COUNTS.items()
               if k.startswith("engine.")) >= 1
    O.check(name, out, O.answer(name, arrays, params[name]))


@pytest.mark.parametrize("table", list(TW.SCHEMA))
def test_writer_tables_equal_generate(table, data):
    files, mine, _, _ = data
    a = pq.read_table(io.BytesIO(mine[table]))
    b = pq.read_table(io.BytesIO(files[table]))
    assert a.column_names == b.column_names == TW.SCHEMA[table]
    for name in a.column_names:
        x, y = a.column(name).combine_chunks(), b.column(name).combine_chunks()
        assert x.type == y.type, name
        assert x.equals(y), name
    if table == "web_sales":
        nulls = a.column("ws_ext_sales_price").null_count
        assert 0.02 < nulls / a.num_rows < 0.04


def test_scan_of_writer_files_equals_scan_of_pyarrow_files(data,
                                                           port_tables):
    mine = tpcds.load_tables(data[1], device=CPU)
    for name, t in port_tables.items():
        for a, b in zip(t.columns, mine[name].columns):
            assert a.dtype == b.dtype, name
            assert torch.equal(a.validity_or_true(), b.validity_or_true())
            assert torch.equal(a.data, b.data), name
            if a.dtype.is_variable_width:
                assert torch.equal(a.offsets, b.offsets), name
