"""The PyTorch port's types, row layout, bitmasks and columns against the
JAX package, on the CPU.

Every case builds the same input from numpy for both packages and requires
the same answer: equal layouts, equal batch geometry, equal bytes.
"""

import torch_one_thread  # noqa: F401  (first: one intra-op thread)
import ast
import pathlib
import re

import numpy as np
import pytest
import torch

import spark_rapids_jni_tpu as sr
import jax.numpy as jnp
from spark_rapids_jni_tpu.rowconv import layout as JL
from spark_rapids_jni_tpu.utils import bitmask as jbitmask

import spark_rapids_jni_tpu_torch as pt
from spark_rapids_jni_tpu_torch import interop
from spark_rapids_jni_tpu_torch.rowconv import layout as PL
from spark_rapids_jni_tpu_torch.utils import bitmask as pbitmask

REPO = pathlib.Path(__file__).resolve().parent.parent
CPU = "cpu"

ROW_TYPE_IDS = [t for t in pt.TypeId
                if t not in (pt.TypeId.EMPTY, pt.TypeId.LIST,
                             pt.TypeId.STRUCT)]


def _both(type_id, scale=0):
    return (sr.DType(sr.TypeId(int(type_id)), scale),
            pt.DType(pt.TypeId(int(type_id)), scale))


@pytest.mark.parametrize("type_id", ROW_TYPE_IDS, ids=lambda t: t.name)
def test_dtype_matches_jax(type_id):
    j, p = _both(type_id)
    assert j.id.name == p.id.name and int(j.id) == int(p.id)
    assert p.itemsize == j.itemsize
    assert p.row_alignment == j.row_alignment
    assert p.is_fixed_width == j.is_fixed_width
    assert p.is_variable_width == j.is_variable_width
    if p.is_fixed_width:
        assert p.storage == j.storage
        # the torch dtype names the same storage as the numpy one
        assert str(p.torch_storage).split(".")[-1] == p.storage.name
    elif type_id == pt.TypeId.DECIMAL128:
        assert p.torch_storage == torch.int64


def test_dtype_scale_only_for_decimals():
    with pytest.raises(ValueError):
        pt.DType(pt.TypeId.INT32, scale=-2)
    assert pt.decimal64(-4).scale == -4


def test_nested_types_rejected_by_layout():
    with pytest.raises(TypeError, match="not supported"):
        PL.compute_row_layout([pt.int32, pt.types.list_(pt.int8)])
    with pytest.raises(TypeError, match="not supported"):
        PL.compute_row_layout([pt.types.struct_(pt.int8, pt.int64)])


SCHEMAS = {
    "bool_i16_i32": ["BOOL8", "INT16", "INT32"],
    "i32_i16_bool": ["INT32", "INT16", "BOOL8"],
    "i8_str_i64": ["INT8", "STRING", "INT64"],
    "nine_i8": ["INT8"] * 9,
    "dec128_mixed": ["INT8", "DECIMAL128", "INT16", "FLOAT64", "STRING"],
    "bench_cycle_12": ["STRING", "INT32", "INT16", "INT8", "FLOAT32",
                       "BOOL8", "STRING", "INT32", "INT16", "INT8",
                       "FLOAT32", "BOOL8"],
    "unsigned": ["UINT8", "UINT64", "UINT16", "UINT32", "TIMESTAMP_DAYS"],
    "strings_only": ["STRING", "STRING", "STRING"],
}


@pytest.mark.parametrize("name", sorted(SCHEMAS))
def test_layout_matches_jax(name):
    ids = SCHEMAS[name]
    jl = JL.compute_row_layout([sr.DType(sr.TypeId[i]) for i in ids])
    pl = PL.compute_row_layout([pt.DType(pt.TypeId[i]) for i in ids])
    for field in ("column_starts", "column_sizes", "validity_offset",
                  "validity_bytes", "fixed_plus_validity", "fixed_row_size",
                  "variable_column_indices", "fixed_width_only"):
        assert getattr(pl, field) == getattr(jl, field), field


@pytest.mark.parametrize("schema,starts,voff,size", [
    # | A_0 | P | B_0 B_1 | C_0..C_3 | V0 | P*7 |  (RowConversion.java:60-90)
    (["BOOL8", "INT16", "INT32"], (0, 2, 4), 8, 16),
    (["INT32", "INT16", "BOOL8"], (0, 4, 6), 7, 8),
    (["INT8", "STRING", "INT64"], (0, 4, 16), 24, 32),
])
def test_layout_javadoc_examples(schema, starts, voff, size):
    lay = PL.compute_row_layout([pt.DType(pt.TypeId[i]) for i in schema])
    assert lay.column_starts == starts
    assert lay.validity_offset == voff
    assert lay.fixed_row_size == size


def test_row_size_limit_enforced():
    with pytest.raises(ValueError, match="1024"):
        PL.compute_row_layout([pt.int64] * 200)


@pytest.mark.parametrize("n,size,cap", [(100, 16, None), (100, 16, 1000),
                                        (1000, 24, 4096), (33, 8, 256)])
def test_build_batches_matches_jax(n, size, cap):
    rng = np.random.default_rng(n)
    sizes = (rng.integers(1, size // 8 + 2, n) * 8).astype(np.int64)
    kw = {} if cap is None else {"max_batch_bytes": cap}
    jb = JL.build_batches(sizes, **kw)
    pb = PL.build_batches(sizes, **kw)
    assert pb.row_boundaries == jb.row_boundaries
    assert pb.batch_bytes == jb.batch_bytes
    for a, b in zip(pb.row_offsets_within_batch, jb.row_offsets_within_batch):
        np.testing.assert_array_equal(a, b)


def test_build_batches_row_too_big():
    with pytest.raises(ValueError, match="single row"):
        PL.build_batches(np.full(4, 64, dtype=np.int64), max_batch_bytes=32)


def test_row_sizes_with_strings_matches_jax():
    ids = SCHEMAS["dec128_mixed"]
    jl = JL.compute_row_layout([sr.DType(sr.TypeId[i]) for i in ids])
    pl = PL.compute_row_layout([pt.DType(pt.TypeId[i]) for i in ids])
    lens = np.random.default_rng(3).integers(0, 100, 257)
    np.testing.assert_array_equal(PL.row_sizes_with_strings(pl, lens),
                                  JL.row_sizes_with_strings(jl, lens))


@pytest.mark.parametrize("cols", [1, 7, 8, 9, 33])
def test_pack_bool_matrix_matches_jax(cols):
    valid = np.random.default_rng(cols).random((53, cols)) < 0.6
    want = np.asarray(jbitmask.pack_bool_matrix(jnp.asarray(valid)))
    got = pbitmask.pack_bool_matrix(torch.from_numpy(valid))
    np.testing.assert_array_equal(got.numpy(), want)
    back = pbitmask.unpack_bool_matrix(got, cols)
    np.testing.assert_array_equal(back.numpy(), valid)


def test_pack_bits_matches_jax():
    valid = np.random.default_rng(9).random(29) < 0.5
    got = pbitmask.pack_bits(torch.from_numpy(valid)).numpy()
    np.testing.assert_array_equal(got, jbitmask.pack_bits_np(valid))
    np.testing.assert_array_equal(
        pbitmask.unpack_bits(torch.from_numpy(got), 29).numpy(), valid)


@pytest.mark.parametrize("type_id", ["INT8", "UINT32", "FLOAT64", "BOOL8",
                                     "DECIMAL64"])
def test_column_pylist_matches_jax(type_id):
    rng = np.random.default_rng(5)
    j, p = _both(pt.TypeId[type_id])
    if type_id == "BOOL8":
        arr = rng.integers(0, 2, 20).astype(np.uint8)
    elif type_id == "FLOAT64":
        arr = rng.standard_normal(20)
    else:
        arr = rng.integers(0, 100, 20).astype(p.storage)
    valid = rng.random(20) < 0.7
    jc = sr.Column.from_numpy(arr, j, valid)
    pc = pt.Column.from_numpy(arr, p, valid, device=CPU)
    assert pc.to_pylist() == jc.to_pylist()
    np.testing.assert_array_equal(pc.to_numpy(), jc.to_numpy())


def test_strings_and_decimal128_pylist_match_jax():
    strs = ["", None, "spark", "naïve 🎉", None, "x" * 40]
    assert (pt.Column.strings_from_list(strs, device=CPU).to_pylist()
            == sr.Column.strings_from_list(strs).to_pylist())
    lanes = np.array([[5, 0], [-1, -1], [0, 1]], dtype=np.int64)
    jc = sr.Column(sr.types.decimal128(-2), jnp.asarray(lanes))
    pc = pt.Column.from_numpy(lanes, pt.decimal128(-2), device=CPU)
    assert pc.to_pylist() == jc.to_pylist()


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pt.Column.from_numpy(np.zeros(3, np.int32))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        interop.table_from_numpy([(int(pt.TypeId.INT8), 0,
                                   np.zeros(2, np.int8), None, None)])


def test_interop_round_trip():
    rng = np.random.default_rng(11)
    offs = np.array([0, 3, 3, 7], dtype=np.int32)
    cols = [(int(pt.TypeId.INT16), 0, rng.integers(0, 9, 3).astype(np.int16),
             None, np.array([True, False, True])),
            (int(pt.TypeId.STRING), 0, rng.integers(97, 123, 7)
             .astype(np.uint8), offs, None),
            (int(pt.TypeId.DECIMAL128), -3,
             rng.integers(-9, 9, (3, 2)), None, None)]
    back = interop.table_to_numpy(interop.table_from_numpy(cols, device=CPU))
    for a, b in zip(cols, back):
        assert a[:2] == b[:2]
        np.testing.assert_array_equal(a[2], b[2])
        for x, y in ((a[3], b[3]), (a[4], b[4])):
            assert (x is None) == (y is None)
            if x is not None:
                np.testing.assert_array_equal(x, y)


def _imported_modules(path: pathlib.Path) -> set[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module or "")
    return names


def test_port_imports_no_jax():
    files = sorted((REPO / "spark_rapids_jni_tpu_torch").rglob("*.py"))
    files += [REPO / "chip_smoke.py", *sorted(REPO.glob("tools/torch_*.py"))]
    rel = {str(f.relative_to(REPO)) for f in files}
    assert {"spark_rapids_jni_tpu_torch/rowconv/xpack.py",
            "spark_rapids_jni_tpu_torch/parquet/device_scan.py",
            "spark_rapids_jni_tpu_torch/parquet/decode.py",
            "spark_rapids_jni_tpu_torch/_native.py",
            "spark_rapids_jni_tpu_torch/ops/filter.py",
            "spark_rapids_jni_tpu_torch/ops/sort.py",
            "spark_rapids_jni_tpu_torch/ops/strings.py",
            "spark_rapids_jni_tpu_torch/ops/decimal128.py",
            "spark_rapids_jni_tpu_torch/ops/groupby.py",
            "spark_rapids_jni_tpu_torch/ops/reductions.py",
            "spark_rapids_jni_tpu_torch/ops/copying.py",
            "spark_rapids_jni_tpu_torch/ops/hashing.py",
            "spark_rapids_jni_tpu_torch/ops/int64bits.py",
            "spark_rapids_jni_tpu_torch/models/tpch_q1.py",
            "spark_rapids_jni_tpu_torch/bridge.py",
            "spark_rapids_jni_tpu_torch/rowconv/native.py",
            "spark_rapids_jni_tpu_torch/rowconv/host.py",
            "spark_rapids_jni_tpu_torch/parquet/footer_native.py",
            "tools/torch_lineitem_parquet.py",
            "spark_rapids_jni_tpu_torch/ops/join.py",
            "spark_rapids_jni_tpu_torch/ops/join_plan.py",
            "spark_rapids_jni_tpu_torch/models/tpcds.py",
            "spark_rapids_jni_tpu_torch/ops/scan.py",
            "spark_rapids_jni_tpu_torch/ops/window.py",
            "tools/torch_tpcds_parquet.py",
            "tools/torch_tpcds_oracle.py",
            "spark_rapids_jni_tpu_torch/ops/cast.py",
            "spark_rapids_jni_tpu_torch/models/mortgage.py",
            "tools/torch_mortgage_parquet.py",
            "tools/torch_mortgage_oracle.py",
            "spark_rapids_jni_tpu_torch/utils/syncs.py",
            "spark_rapids_jni_tpu_torch/models/compiled.py",
            "spark_rapids_jni_tpu_torch/utils/knobs.py",
            "spark_rapids_jni_tpu_torch/plan/__init__.py",
            "spark_rapids_jni_tpu_torch/plan/ir.py",
            "spark_rapids_jni_tpu_torch/plan/stats.py",
            "spark_rapids_jni_tpu_torch/plan/rules.py",
            "spark_rapids_jni_tpu_torch/plan/lower.py",
            "spark_rapids_jni_tpu_torch/sql/__init__.py",
            "spark_rapids_jni_tpu_torch/sql/tokenizer.py",
            "spark_rapids_jni_tpu_torch/sql/parser.py",
            "spark_rapids_jni_tpu_torch/sql/binder.py",
            "spark_rapids_jni_tpu_torch/parquet/rowfilter.py",
            "spark_rapids_jni_tpu_torch/models/tpcds_plans.py",
            "spark_rapids_jni_tpu_torch/models/tpcds_sql.py",
            "spark_rapids_jni_tpu_torch/analysis/__init__.py",
            "spark_rapids_jni_tpu_torch/analysis/sanitize.py",
            "spark_rapids_jni_tpu_torch/utils/structured_log.py",
            "spark_rapids_jni_tpu_torch/utils/metrics.py",
            "spark_rapids_jni_tpu_torch/utils/flight.py",
            "spark_rapids_jni_tpu_torch/memory/__init__.py",
            "spark_rapids_jni_tpu_torch/memory/budget.py",
            "spark_rapids_jni_tpu_torch/memory/spill.py",
            "spark_rapids_jni_tpu_torch/faultinj/__init__.py",
            "spark_rapids_jni_tpu_torch/faultinj/injector.py",
            "spark_rapids_jni_tpu_torch/faultinj/resilience.py",
            "spark_rapids_jni_tpu_torch/exec/__init__.py",
            "spark_rapids_jni_tpu_torch/exec/errors.py",
            "spark_rapids_jni_tpu_torch/exec/admission.py",
            "spark_rapids_jni_tpu_torch/exec/placement.py",
            "spark_rapids_jni_tpu_torch/exec/plan_cache.py",
            "spark_rapids_jni_tpu_torch/exec/prefetch.py",
            "spark_rapids_jni_tpu_torch/exec/slo.py",
            "spark_rapids_jni_tpu_torch/exec/scheduler.py",
            "spark_rapids_jni_tpu_torch/_version.py",
            "spark_rapids_jni_tpu_torch/utils/tracing.py",
            "spark_rapids_jni_tpu_torch/plan/profile.py",
            "spark_rapids_jni_tpu_torch/exec/artifacts.py",
            "spark_rapids_jni_tpu_torch/stream/__init__.py",
            "spark_rapids_jni_tpu_torch/stream/delta.py",
            "spark_rapids_jni_tpu_torch/stream/view.py",
            "spark_rapids_jni_tpu_torch/ml/__init__.py",
            "spark_rapids_jni_tpu_torch/ml/prng.py",
            "spark_rapids_jni_tpu_torch/ml/features.py",
            "spark_rapids_jni_tpu_torch/ml/pipeline.py",
            "spark_rapids_jni_tpu_torch/ml/train.py",
            "spark_rapids_jni_tpu_torch/ml/serve.py",
            "tools/torch_plan_oracle.py",
            "tools/torch_ml_oracle.py"} <= rel
    for f in files:
        for mod in _imported_modules(f):
            root = mod.split(".")[0]
            assert root not in ("jax", "jaxlib", "spark_rapids_jni_tpu"), \
                f"{f.relative_to(REPO)} imports {mod}"
    # the native sources include nothing of the JAX package's and name no
    # module of it: the trampoline imports its bridge by a string, so no
    # string literal may be a JAX module and no text a dotted module name
    # of the JAX package (citations of its files, by path, stay allowed)
    sources = sorted((REPO / "spark_rapids_jni_tpu_torch" / "csrc").glob("*"))
    assert {s.name for s in sources} >= {
        "ragged.cu", "bytepath.cu", "xpack.cu", "plain_strings.cpp",
        "host_table.cpp", "rowconv_engine.cpp", "thrift_compact.cpp",
        "thrift_compact.hpp", "footer_engine.cpp", "jni_min.h",
        "jni_bridge.cpp", "device_bridge.cpp"}
    jax_module = re.compile(r"(jax|jaxlib|spark_rapids_jni_tpu)(\.|$)")
    for src in sources:
        text = src.read_text()
        for line in text.splitlines():
            if line.startswith("#include"):
                assert "spark_rapids_jni_tpu" not in line, \
                    f"{src.name}: {line}"
        for literal in re.findall(r'"([^"\n]*)"', text):
            assert not jax_module.match(literal), f"{src.name}: {literal!r}"
        assert not re.search(r"\bspark_rapids_jni_tpu\.", text), src.name
    trampoline = (REPO / "spark_rapids_jni_tpu_torch" / "csrc"
                  / "device_bridge.cpp").read_text()
    assert '"spark_rapids_jni_tpu_torch.bridge"' in trampoline
