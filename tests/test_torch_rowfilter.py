"""The port's fused scan→filter (``parquet/rowfilter.py``,
``scan_table(row_predicate=)``) on the CPU.

Mirrors ``tests/test_bytepath.py``'s fused-filter tests on the same file
(6,000 rows in row groups of 1,500: int32, float64, int64, a 30-value and
a 2,000-value string column, and an int64 column 40% null), written both
as pyarrow writes it (every column dictionary-encoded) and with PLAIN
pages: the pruned scan equals the unpruned scan masked by the planner's
semantics (nulls fail), and pyarrow's own filter of the file by the
pandas mask; its kept-row count and completeness equal the JAX package's
host ``rowfilter.apply`` on the same file and conditions.  A float
literal or an ordered string compare leaves the filter incomplete,
``SRJT_FUSED_FILTER=0`` turns it off, a DELTA (host-decoded) column
aborts it, and the planner skips its mask only after a complete prune.
"""

import torch_one_thread  # noqa: F401  (first: one intra-op thread)
import io

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

from spark_rapids_jni_tpu.parquet import decode as JD
from spark_rapids_jni_tpu.parquet import device_scan as jds
from spark_rapids_jni_tpu.parquet import rowfilter as jrowfilter

from spark_rapids_jni_tpu_torch import plan as P
from spark_rapids_jni_tpu_torch.ops import apply_boolean_mask
from spark_rapids_jni_tpu_torch.parquet import device_scan
from spark_rapids_jni_tpu_torch.plan import ir, lower

from torch_tpcds_cases import CPU, assert_identical

RNG = np.random.default_rng(29)
N = 6000
CONDS = [
    [("a", "lt", 500)],
    [("a", "ge", 250), ("low", "lt", 40)],
    [("d", "eq", b"val7")],
    [("s", "eq", b"s42")],
    [("nn", "ge", 100)],                   # null-heavy: nulls must fail
    [("a", "lt", 800), ("d", "eq", b"val3"), ("nn", "lt", 900)],
]


def _table() -> pa.Table:
    nn = RNG.integers(0, 1000, N).astype(np.int64)
    return pa.table({
        "a": pa.array(RNG.integers(0, 1000, N).astype(np.int32)),
        "f": pa.array(RNG.standard_normal(N)),
        "low": pa.array(RNG.integers(0, 50, N).astype(np.int64)),
        "d": pa.array([f"val{v}" for v in RNG.integers(0, 30, N)]),
        "s": pa.array([f"s{v}" for v in RNG.integers(0, 2000, N)]),
        "nn": pa.array([None if m else int(v) for v, m in
                        zip(nn, RNG.random(N) < 0.4)], pa.int64()),
    })


def _write(t: pa.Table, **kw) -> bytes:
    buf = io.BytesIO()
    pq.write_table(t, buf, compression="NONE", row_group_size=1500, **kw)
    return buf.getvalue()


@pytest.fixture(scope="module")
def source():
    t = _table()
    return t, {"dict": _write(t), "plain": _write(t, use_dictionary=False)}


def _keep(t: pa.Table, conds) -> np.ndarray:
    """The planner's semantics by pandas: each conjunct, nulls failing."""
    df = t.to_pandas()
    keep = np.ones(len(df), bool)
    for cname, op, val in conds:
        col = df[cname]
        v = val.decode() if isinstance(val, bytes) else val
        m = {"eq": col == v, "lt": col < v, "le": col <= v,
             "gt": col > v, "ge": col >= v}[op]
        keep &= np.asarray(m.fillna(False)) & ~np.asarray(col.isna())
    return keep


def _scan(raw, monkeypatch, fused="1", **kw):
    monkeypatch.setenv("SRJT_FUSED_FILTER", fused)
    return device_scan.scan_table(raw, device=CPU, **kw)


def _jax_apply(raw, conds):
    """The JAX package's host prune on the same file: (complete, n_kept),
    or None where it prunes nothing."""
    meta = jds.parse_struct(jds.extract_footer_bytes(raw))
    leaves = JD._leaf_schema_elements(meta)
    names = [leaf.name for leaf in leaves]
    groups = list(meta.get(JD.FMD.ROW_GROUPS).values)
    want = list(range(len(leaves)))
    walked = {i: jds._walk_column(
        raw, [g.get(JD.RG.COLUMNS).values[i] for g in groups], leaves[i])
        for i in want}
    got = jrowfilter.apply(conds, walked, leaves, names, want)
    return None if got is None else (got[1], got[2])


@pytest.mark.parametrize("layout", ["dict", "plain"])
@pytest.mark.parametrize("conds", CONDS, ids=lambda c: "&".join(
    f"{n}{o}" for n, o, _ in c))
def test_fused_filter_differential(source, monkeypatch, layout, conds):
    t, files = source
    raw = files[layout]
    keep = _keep(t, conds)
    device_scan.reset_counts()
    fused = _scan(raw, monkeypatch, row_predicate=conds)
    assert fused.fused_filter_complete
    assert device_scan.COUNTS["rowfilter.rows_kept"] == keep.sum()
    assert fused.num_rows == keep.sum()
    full = _scan(raw, monkeypatch, fused="0")
    assert_identical(fused, apply_boolean_mask(full, torch.as_tensor(keep)))
    want = t.filter(pa.array(keep))
    for i, name in enumerate(t.column_names):
        assert fused[i].to_pylist() == want.column(name).to_pylist(), name
    assert _jax_apply(raw, conds) == (True, int(keep.sum()))


@pytest.mark.parametrize("conds", [
    [("a", "lt", 500), ("f", "lt", 0.0)],       # a float literal
    [("a", "lt", 500), ("d", "lt", b"val5")],   # an ordered string compare
])
def test_unsupported_conjunct_leaves_it_incomplete(source, monkeypatch,
                                                   conds):
    """The conjuncts the host handles still prune; the table says it is
    incomplete, as the JAX package's does."""
    t, files = source
    raw = files["dict"]
    got = _scan(raw, monkeypatch, row_predicate=conds)
    assert not got.fused_filter_complete
    keep = _keep(t, conds[:1])
    full = _scan(raw, monkeypatch, fused="0")
    assert_identical(got, apply_boolean_mask(full, torch.as_tensor(keep)))
    assert _jax_apply(raw, conds) == (False, int(keep.sum()))


def test_fused_filter_off_knob(source, monkeypatch):
    raw = source[1]["dict"]
    device_scan.reset_counts()
    t = _scan(raw, monkeypatch, fused="0", row_predicate=[("a", "lt", 500)])
    assert not t.fused_filter_complete
    assert t.num_rows == N
    assert device_scan.COUNTS["rowfilter.scans"] == 0


def test_host_decoded_column_aborts_the_prune(source, monkeypatch):
    t = source[0]
    raw = _write(t, use_dictionary=False,
                 column_encoding={"low": "DELTA_BINARY_PACKED"})
    got = _scan(raw, monkeypatch, row_predicate=[("a", "lt", 500)])
    assert got.host_decoded_cols == 1
    assert not got.fused_filter_complete
    assert got.num_rows == N


@pytest.mark.parametrize("layout", ["dict", "plain"])
def test_planner_skips_mask_on_full_pushdown(source, monkeypatch, layout):
    raw = source[1][layout]
    cat = P.FileCatalog({"t": raw}, device=CPU)
    tree = ir.Scan("t", columns=("a", "low", "s"),
                   predicate=ir.And((ir.Cmp("<", ir.Col("a"), ir.Lit(500)),
                                     ir.Cmp("==", ir.Col("s"),
                                            ir.Lit("s42")))))
    lower.reset_counts()
    monkeypatch.setenv("SRJT_FUSED_FILTER", "1")
    out = P.execute(tree, cat)
    assert lower.COUNTS["scan.filter_fused"] == 1
    monkeypatch.setenv("SRJT_FUSED_FILTER", "0")
    ref = P.execute(tree, cat)
    assert lower.COUNTS["scan.filter_fused"] == 1
    assert_identical(out, ref)
    # a float conjunct is no footer condition: the mask runs again
    tree_f = ir.Scan("t", columns=("a", "f"), predicate=ir.And((
        ir.Cmp("<", ir.Col("a"), ir.Lit(500)),
        ir.Cmp("<", ir.Col("f"), ir.Lit(0.0)))))
    monkeypatch.setenv("SRJT_FUSED_FILTER", "1")
    out_f = P.execute(tree_f, cat)
    assert lower.COUNTS["scan.filter_fused"] == 1
    monkeypatch.setenv("SRJT_FUSED_FILTER", "0")
    assert_identical(out_f, P.execute(tree_f, cat))
