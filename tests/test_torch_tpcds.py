"""The port's first 16 TPC-DS queries, the join queries, against the JAX
package's, on the CPU.

``spark_rapids_jni_tpu_torch.models.tpcds`` and
``spark_rapids_jni_tpu.models.tpcds`` run each query on the same files,
pyarrow's ``benchmarks/tpcds_data.generate(n_sales=40_000, n_items=500,
seed=7)``, with the parameters ``tools/torch_tpcds_oracle.py`` picks from
the data.  Keys, integer and decimal values, counts and row order must be
equal; FLOAT64 sums and means within a relative 1e-12.  The numpy writer
``tools/torch_tpcds_parquet.py`` must give pyarrow's tables, and the
numpy oracle must agree with the JAX package's results and with the
port's on the writer's files (the check ``chip_smoke.py`` makes on the
card).  The other 34 queries are held the same way in
``tests/test_torch_tpcds_more.py`` and ``tests/test_torch_tpcds_r4r5.py``
(``tests/torch_tpcds_cases.py`` holds the shared data).
"""

import torch_one_thread  # noqa: F401  (first: one intra-op thread)
import io

import pyarrow.parquet as pq
import pytest
import torch

from spark_rapids_jni_tpu.models import tpcds as jtpcds

from spark_rapids_jni_tpu_torch.models import tpcds

from torch_tpcds_cases import (TW, _jax_native_library,  # noqa: F401
                               check_against_jax, check_compiled_against_jax,
                               check_oracle_against_jax, check_writer_files,
                               data, jax_results_of, port_tables,
                               writer_tables)

# this file's queries: the 16 join queries the port ran first
QUERIES = ["q3", "q42", "q52", "q55", "q_state_rollup", "q7", "q19", "q62",
           "q52_topn", "q_brand_rev_left", "q23_semi", "q16_anti",
           "q78_outer", "q25_two_fact", "q_channel_day", "q_web_also_qty"]


@pytest.fixture(scope="module")
def jax_results(data):
    """This file's JAX results, once a module (JAX compiles on the CPU)."""
    return jax_results_of(QUERIES, data)


def test_queries_equal_the_jax_packages():
    """The port's QUERIES are the JAX package's 50, in its order."""
    assert list(tpcds.QUERIES) == list(jtpcds.QUERIES)
    assert len(tpcds.QUERIES) == 50
    assert tpcds._NEEDS_WEB == jtpcds._NEEDS_WEB
    assert set(QUERIES) <= set(tpcds.QUERIES)


@pytest.mark.parametrize("name", QUERIES)
def test_query_matches_jax(name, data, jax_results, port_tables):
    check_against_jax(name, data, jax_results, port_tables)


@pytest.mark.parametrize("name", QUERIES)
def test_compiled_query_matches_jax(name, data, jax_results, port_tables):
    check_compiled_against_jax(name, data, jax_results, port_tables)


@pytest.mark.parametrize("name", QUERIES)
def test_oracle_matches_jax(name, data, jax_results):
    check_oracle_against_jax(name, data, jax_results)


@pytest.mark.parametrize("name", QUERIES)
def test_query_on_writer_files_matches_oracle(name, data, writer_tables):
    check_writer_files(name, data, writer_tables)


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


def test_scan_of_writer_files_equals_scan_of_pyarrow_files(port_tables,
                                                           writer_tables):
    mine = writer_tables
    for name, t in port_tables.items():
        for a, b in zip(t.columns, mine[name].columns):
            assert a.dtype == b.dtype, name
            assert torch.equal(a.validity_or_true(), b.validity_or_true())
            assert torch.equal(a.data, b.data), name
            if a.dtype.is_variable_width:
                assert torch.equal(a.offsets, b.offsets), name
