"""The TPC-DS queries of the JAX package's fourth and fifth rounds that
the port added last, against the JAX package's and the numpy oracle, on
the CPU: ROLLUP, CUBE and GROUPING SETS, band predicates and counts,
selection and multi-measure aggregates, FIRST/LAST, ROW_NUMBER and
DENSE_RANK windows, channel ratios and null shares, deviations,
INTERSECT and EXCEPT, and a two-level groupby.

As ``tests/test_torch_tpcds.py`` holds the first 16 (the data, the
parameters and the tolerances of ``tests/torch_tpcds_cases.py``): keys,
integers, decimals, counts, ranks and row order equal, FLOAT64 within a
relative 1e-12 of the JAX package's; the oracle's tolerances are its
own (``tools/torch_tpcds_oracle.py``).  ``run_all`` skips the
``web_sales`` queries without that file.
"""

import torch_one_thread  # noqa: F401  (first: one intra-op thread)
import pytest

from spark_rapids_jni_tpu_torch.models import tpcds

from torch_tpcds_cases import (CPU, _jax_native_library,  # noqa: F401
                               check_against_jax, check_compiled_against_jax,
                               check_oracle_against_jax, check_writer_files,
                               data, jax_results_of, port_tables,
                               writer_tables)

QUERIES = ["q36_rollup", "q86_rollup", "q27_cube", "q5_grouping_sets",
           "q88_counts", "q90_ratio", "q29_minmax", "q48_bands",
           "q13_avg_bands", "q96_count", "q_minmax_price", "q_multi_measure",
           "q_rollup3", "q_first_last", "q_rownum_dedup", "q_cross_ratio",
           "q_null_share", "q17_stats", "q8_intersect", "q87_except",
           "q_dense_rank_cat", "q34_baskets"]
# the queries that join no table
NO_JOIN = {"q88_counts", "q13_avg_bands", "q_minmax_price",
           "q_multi_measure", "q_first_last", "q34_baskets"}


@pytest.fixture(scope="module")
def jax_results(data):
    """This file's JAX results, once a module (JAX compiles on the CPU)."""
    return jax_results_of(QUERIES, data)


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
    check_writer_files(name, data, writer_tables, joins=name not in NO_JOIN)


def test_run_all_skips_web_queries_without_web_sales(data):
    files = {k: v for k, v in data[1].items() if k != "web_sales"}
    out = tpcds.run_all(files, device=CPU)
    assert set(out) == set(tpcds.QUERIES) - tpcds._NEEDS_WEB
    assert all(t.device.type == "cpu" for t in out.values())
