"""The port's SQL front end (``spark_rapids_jni_tpu_torch.sql``) and the
28-query TPC-DS corpus (``models.tpcds_sql``) on the CPU.

Mirrors ``tests/test_sql.py``: grammar round trips, the SQL-born
optimized tree sharing the hand tree's fingerprint, typed ``SqlError``s
with caret line and column, the memo's hits, misses and cap, and the
``SRJT_SQL_MAX_LEN`` guard.  Beyond it: every corpus query's fingerprint
equals the JAX package's, byte for byte; every corpus query's result on
``tests/torch_tpcds_cases.py``'s 40,000-row tables is bit-identical to
the port's hand-fused query (the 8 ``tpcds_plans`` queries, which
``models.tpcds.QUERIES`` holds under the same name) or to its hand tree
(the other 20, whose ``QUERIES`` namesakes are other queries); its tape
under ``syncs.capture`` holds the twin's sizes; and ten queries that
together reach every node kind, ``Between``, ``IsIn``, ``Limit`` and
``ScalarAgg`` equal the JAX package's ``compile_sql`` results (exact;
FLOAT64 sums to a relative 1e-12, as in ``torch_tpcds_cases``).
"""

import torch_one_thread  # noqa: F401  (first: one intra-op thread)
import pytest

from spark_rapids_jni_tpu import sql as jsql
from spark_rapids_jni_tpu.models import tpcds_sql as JTS
from spark_rapids_jni_tpu.plan import ir as jir

from spark_rapids_jni_tpu_torch import sql as sql_fe
from spark_rapids_jni_tpu_torch.models import compiled, tpcds
from spark_rapids_jni_tpu_torch.models import tpcds_plans
from spark_rapids_jni_tpu_torch.models import tpcds_sql as TS
from spark_rapids_jni_tpu_torch.plan import ir, lower, rules
from spark_rapids_jni_tpu_torch.sql import SqlError, parse, to_sql
from spark_rapids_jni_tpu_torch.utils import syncs

from torch_jax_columns import assert_same_table, to_jax
from torch_tpcds_cases import (RTOL, _jax_native_library,  # noqa: F401
                               assert_identical, data, port_tables)

SCHEMAS = TS.TABLE_SCHEMAS
# the queries held against the JAX package's results: between them every
# node kind (Scan, Filter, Project, Join inner/semi/anti, the fused
# aggregate, Aggregate plain/rollup/sets, Window, Union, Distinct, Sort,
# Limit) and every predicate form (Cmp, Between, IsIn, ScalarAgg, Mul)
JAX_QUERIES = ["q3", "q62_range", "q52_topn", "q65", "q36_rollup",
               "q5_grouping_sets", "q67_rank", "q_union_channels",
               "q16_anti", "q_distinct_pairs"]


@pytest.fixture(autouse=True)
def _fresh_memo():
    sql_fe.clear_cache()
    yield
    sql_fe.clear_cache()


def sql_params(name, data) -> dict:
    """The corpus defaults, with the data's own parameters
    (``torch_tpcds_oracle.query_params``) where the query takes them."""
    p = dict(TS.PARAMS.get(name, {}))
    picked = data[3].get(name, {})
    p.update({k: v for k, v in picked.items() if k in p})
    return p


# --- grammar and fingerprints -------------------------------------------


@pytest.mark.parametrize("name", TS.QUERY_NAMES)
def test_roundtrip_fingerprint_stable(name):
    params = TS.PARAMS.get(name, {})
    q1 = parse(TS.SQL[name])
    rendered = to_sql(q1)
    q2 = parse(rendered)
    t1 = sql_fe.bind(q1, SCHEMAS, params, TS.SQL[name])
    t2 = sql_fe.bind(q2, SCHEMAS, params, rendered)
    assert ir.fingerprint(t1) == ir.fingerprint(t2)
    assert to_sql(q2) == rendered
    assert rendered == jsql.to_sql(jsql.parse(TS.SQL[name]))


@pytest.mark.parametrize("name", TS.QUERY_NAMES)
def test_fingerprints_match_hand_tree_and_jax(name):
    """One fingerprint for the SQL-born optimized tree, the hand tree's
    and the JAX package's SQL-born tree."""
    params = TS.PARAMS.get(name, {})
    sql_tree = sql_fe.sql_to_plan(TS.SQL[name], SCHEMAS, params)
    hand = rules.optimize(TS.hand_tree(name), SCHEMAS).tree
    jtree = jsql.sql_to_plan(JTS.SQL[name], JTS.TABLE_SCHEMAS, params)
    assert ir.fingerprint(sql_tree) == ir.fingerprint(hand)
    assert ir.fingerprint(sql_tree) == jir.fingerprint(jtree)
    assert ir.render(sql_tree) == jir.render(jtree)


# --- results --------------------------------------------------------------


@pytest.mark.parametrize("name", TS.QUERY_NAMES)
def test_corpus_bit_identical_to_twin(name, data, port_tables):
    """compile_sql's result equals the hand-fused query (the 8 plan
    queries) or the hand tree's, bit for bit, and its tape holds the
    twin's sizes: no sync added by the planner."""
    params = sql_params(name, data)
    qfn = sql_fe.compile_sql(TS.SQL[name], SCHEMAS, params)
    if name in tpcds_plans.PLANS:
        def twin(t):
            return tpcds.QUERIES[name](t, **params)
    else:
        tree = rules.optimize(TS.HAND[name](**params), SCHEMAS).tree
        cat_twin = lower.compile_plan(tree, SCHEMAS)

        def twin(t):
            return cat_twin(t)
    got_tape, want_tape = [], []
    with syncs.capture(got_tape):
        got = qfn(port_tables)
    with syncs.capture(want_tape):
        want = twin(port_tables)
    assert_identical(got, want)
    assert len(got_tape) == len(want_tape)
    assert sorted(got_tape) == sorted(want_tape)
    assert qfn.plan_output_names == list(ir.schema_of(qfn.plan_tree,
                                                      SCHEMAS))


@pytest.fixture(scope="module")
def jax_tables(port_tables):
    """The port's scanned tables as the JAX package's, through numpy (the
    scans themselves are held against each other in
    ``test_torch_tpcds.py``)."""
    return {name: to_jax(t) for name, t in port_tables.items()}


@pytest.mark.parametrize("name", JAX_QUERIES)
def test_corpus_equals_the_jax_packages(name, data, port_tables,
                                        jax_tables):
    params = sql_params(name, data)
    got = sql_fe.compile_sql(TS.SQL[name], SCHEMAS, params)(port_tables)
    want = jsql.compile_sql(JTS.SQL[name], JTS.TABLE_SCHEMAS,
                            params)(jax_tables)
    assert got.num_rows > 0 or name == "q16_anti"
    assert_same_table(got, want, rtol=RTOL)


def test_compiled_sql_query_equals_eager(data, port_tables):
    params = sql_params("q65", data)
    qfn = sql_fe.compile_sql(TS.SQL["q65"], SCHEMAS, params)
    cq = compiled.compile_query(qfn, port_tables)
    want = qfn(port_tables)
    assert_identical(cq.run(port_tables), want)
    assert_identical(cq.run_unchecked(port_tables), want)


# --- the memo ---------------------------------------------------------------


def test_sql_memo_warm_hit_and_cap(monkeypatch):
    h0, m0 = sql_fe.COUNTS["cache.hit"], sql_fe.COUNTS["cache.miss"]
    a = sql_fe.sql_to_plan(TS.SQL["q3"], SCHEMAS, TS.PARAMS["q3"])
    b = sql_fe.sql_to_plan(TS.SQL["q3"], SCHEMAS, TS.PARAMS["q3"])
    assert a is b
    assert sql_fe.cache_stats() == {"hit": h0 + 1, "miss": m0 + 1,
                                    "size": 1}
    c = sql_fe.sql_to_plan(TS.SQL["q3"], SCHEMAS,
                           {"manufact_id": 1, "moy": 12})
    assert c is not a
    assert sql_fe.COUNTS["cache.miss"] == m0 + 2
    sql_fe.clear_cache()
    # the counts outlive clear_cache, the entries do not
    assert sql_fe.cache_stats() == {"hit": h0 + 1, "miss": m0 + 2,
                                    "size": 0}
    monkeypatch.setenv("SRJT_SQL_CACHE_CAP", "2")
    for name in ("q7", "q52", "q55"):
        sql_fe.sql_to_plan(TS.SQL[name], SCHEMAS, TS.PARAMS[name])
    assert sql_fe.cache_stats()["size"] == 2
    monkeypatch.setenv("SRJT_SQL_CACHE", "0")
    d = sql_fe.sql_to_plan(TS.SQL["q55"], SCHEMAS, TS.PARAMS["q55"])
    e = sql_fe.sql_to_plan(TS.SQL["q55"], SCHEMAS, TS.PARAMS["q55"])
    assert d is not e and ir.fingerprint(d) == ir.fingerprint(e)
    assert sql_fe.COUNTS["cache.hit"] == h0 + 1


def test_params_change_fingerprint():
    p1 = dict(TS.PARAMS["q55"])
    p2 = {"manager_id": p1["manager_id"] + 1}
    t1 = sql_fe.sql_to_plan(TS.SQL["q55"], SCHEMAS, p1)
    t2 = sql_fe.sql_to_plan(TS.SQL["q55"], SCHEMAS, p2)
    assert ir.fingerprint(t1) != ir.fingerprint(t2)


# --- errors: typed SqlError with caret -------------------------------------


def _sql_error(text, schemas=None, params=None):
    before = sql_fe.COUNTS["parse_error"]
    with pytest.raises(SqlError) as ei:
        sql_fe.sql_to_plan(text, SCHEMAS if schemas is None else schemas,
                           params)
    assert sql_fe.COUNTS["parse_error"] == before + 1
    return ei.value


def test_unknown_column_caret():
    e = _sql_error("SELECT nope FROM item")
    assert "unknown column 'nope'" in e.message
    assert (e.line, e.col) == (1, 8)
    src, caret = str(e).splitlines()[-2:]
    assert src.endswith("SELECT nope FROM item")
    assert caret.index("^") == 4 + e.col - 1


def test_unknown_table_caret():
    e = _sql_error("SELECT i_brand_id FROM nosuch")
    assert "unknown table 'nosuch'" in e.message
    assert (e.line, e.col) == (1, 24)


def test_binder_error_caret_multiline():
    text = ("SELECT i_brand_id, SUM(kaboom) AS s\n"
            "FROM item\n"
            "GROUP BY i_brand_id")
    e = _sql_error(text)
    assert "unknown column 'kaboom'" in e.message
    assert e.line == 1
    assert e.col == text.splitlines()[0].index("kaboom") + 1


def test_tokenizer_error_caret_on_a_later_line():
    e = _sql_error("SELECT i_brand_id\nFROM item\nWHERE i_brand_id ? 3")
    assert "unexpected character '?'" in e.message
    assert (e.line, e.col) == (3, 18)
    assert str(e).splitlines()[-1].index("^") == 4 + 17


@pytest.mark.parametrize("text,schemas,fragment,where", [
    ("SELECT x FROM a JOIN b ON k = j", {"a": ["x", "k"], "b": ["x", "j"]},
     "share column names ['x']", None),
    ("SELECT k FROM a JOIN b ON x = j", {"a": ["x", "k"], "b": ["x", "j"]},
     "ambiguous join key 'x'", (1, 27)),
    ("SELECT i_brand_id AS b FROM item", None, "UNION ALL", None),
    ("SELECT SUM(i_item_sk) AS s FROM item", None, "GROUP BY", None),
    ("SELECT i_brand_id, COUNT(DISTINCT i_item_sk) AS a, "
     "SUM(i_item_sk) AS b FROM item GROUP BY i_brand_id", None,
     "only aggregate", None),
    ("SELECT i_brand_id, SUM(i_item_sk) AS s FROM item "
     "GROUP BY i_brand_id ORDER BY i_category_id", None, "ORDER BY", None),
    ("SELECT i_brand_id, SUM(i_item_sk) AS s FROM item "
     "GROUP BY i_brand_id UNION ALL SELECT i_brand_id FROM item", None,
     "UNION ALL arm", None),
    ("SELECT s_state FROM store WHERE s_state IN ('TN", None,
     "unterminated string", (1, 45)),
    ("SELECT i_brand_id, SUM(i_item_sk) AS s FROM item "
     "WHERE i_manager_id = :m GROUP BY i_brand_id", None,
     "unbound parameter :m", None),
])
def test_binder_and_parser_errors(text, schemas, fragment, where):
    e = _sql_error(text, schemas=schemas)
    assert fragment in e.message
    if where is not None:
        assert (e.line, e.col) == where
    with pytest.raises(jsql.SqlError) as je:
        jsql.sql_to_plan(text, SCHEMAS if schemas is None else schemas)
    assert (je.value.line, je.value.col) == (e.line, e.col)


def test_trailing_garbage_rejected():
    with pytest.raises(SqlError):
        parse("SELECT i_brand_id FROM item extra garbage here")


def test_max_len_guard(monkeypatch):
    monkeypatch.setenv("SRJT_SQL_MAX_LEN", "16")
    e = _sql_error("SELECT i_brand_id FROM item")
    assert "SRJT_SQL_MAX_LEN" in e.message


def test_or_predicate_qualified_refs_and_comments(data, port_tables):
    text = ("-- two managers\n"
            "SELECT i.i_brand_id, SUM(s.ss_ext_sales_price) AS total "
            "FROM store_sales s JOIN item i ON s.ss_item_sk = i.i_item_sk "
            "WHERE i.i_manager_id = 1 OR i.i_manager_id = 2 "
            "GROUP BY i.i_brand_id ORDER BY i.i_brand_id;")
    tree = sql_fe.sql_to_plan(text, SCHEMAS)
    hand = rules.optimize(ir.Sort(ir.Aggregate(
        ir.Filter(ir.Join(ir.Scan("store_sales"), ir.Scan("item"),
                          ("ss_item_sk",), ("i_item_sk",)),
                  ir.Or((ir.Cmp("==", ir.Col("i_manager_id"), ir.Lit(1)),
                         ir.Cmp("==", ir.Col("i_manager_id"), ir.Lit(2))))),
        ("i_brand_id",), (("ss_ext_sales_price", "sum", "total"),)),
        ("i_brand_id",)), SCHEMAS).tree
    assert ir.fingerprint(tree) == ir.fingerprint(hand)
    assert ir.fingerprint(tree) == jir.fingerprint(
        jsql.sql_to_plan(text, JTS.TABLE_SCHEMAS))
    assert_identical(lower.compile_plan(tree, SCHEMAS)(port_tables),
                     lower.compile_plan(hand, SCHEMAS)(port_tables))
