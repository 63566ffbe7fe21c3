"""Twelve more TPC-DS queries of the port against the JAX package's and
the numpy oracle, on the CPU: the aggregate-then-compare, union, window,
LIKE, distinct-count, HAVING, CASE WHEN, DISTINCT and IN queries that
follow the first join queries in the JAX package's ``QUERIES``.

As ``tests/test_torch_tpcds.py`` holds the first 16 (the data, the
parameters and the tolerances of ``tests/torch_tpcds_cases.py``): keys,
integers, decimals, counts, ranks and row order equal, FLOAT64 within a
relative 1e-12 of the JAX package's; the oracle's tolerances are its
own (``tools/torch_tpcds_oracle.py``).
"""

import torch_one_thread  # noqa: F401  (first: one intra-op thread)
import pytest

from torch_tpcds_cases import (_jax_native_library,  # noqa: F401
                               check_against_jax, check_compiled_against_jax,
                               check_oracle_against_jax, check_writer_files,
                               data, jax_results_of, port_tables,
                               writer_tables)

QUERIES = ["q65", "q_store_counts", "q67_rank", "q_like_brands",
           "q_union_channels", "q_lag_growth", "q_running_share",
           "q_nunique_items", "q_having", "q_case_when", "q_distinct_pairs",
           "q_isin_states"]
# the queries that join no table
NO_JOIN = {"q_nunique_items", "q_distinct_pairs"}


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
