"""The port's C++ footer engine against its Python one and the JAX
package's, on the CPU (after ``tests/test_parquet_native.py``).

``parquet/footer_native.py`` reads and filters a footer through the port's
JVM-facing library; its serialized footer must equal byte for byte what the
port's ``parquet/footer.py`` and the JAX package's native engine give, on
every scenario.
"""

import torch_one_thread  # noqa: F401  (first: one intra-op thread)
import io

import pyarrow.parquet as pq
import pytest

from spark_rapids_jni_tpu.parquet import footer_native as jnative_footer
from spark_rapids_jni_tpu.parquet import (
    StructElement as JStruct, ValueElement as JValue, ListElement as JList,
    MapElement as JMap)

from spark_rapids_jni_tpu_torch.parquet import footer_native
from spark_rapids_jni_tpu_torch.parquet.footer import (
    StructElement, ValueElement, ListElement, MapElement, extract_footer_bytes,
    read_and_filter)

from test_parquet_footer import simple_file, nested_file
from torch_jni_env import load_jax_native

JAX_NATIVE_LOADED = load_jax_native()

# (file, port schema, JAX schema, part offset, part length, ignore case)
SCENARIOS = {
    "subset": (simple_file,
               StructElement("root", ValueElement("a"), ValueElement("c")),
               JStruct("root", JValue("a"), JValue("c")), 0, -1, False),
    "case_fold": (simple_file,
                  StructElement("root", ValueElement("b"), ValueElement("D")),
                  JStruct("root", JValue("b"), JValue("D")), 0, -1, True),
    "missing_col": (simple_file,
                    StructElement("root", ValueElement("a"),
                                  ValueElement("zz")),
                    JStruct("root", JValue("a"), JValue("zz")), 0, -1, False),
    "nested": (nested_file,
               StructElement("root", StructElement("s", ValueElement("x")),
                             ValueElement("id")),
               JStruct("root", JStruct("s", JValue("x")), JValue("id")),
               0, -1, False),
    "list_map": (nested_file,
                 StructElement("root",
                               ListElement("l", ValueElement("element")),
                               MapElement("m", ValueElement("key"),
                                          ValueElement("value"))),
                 JStruct("root", JList("l", JValue("element")),
                         JMap("m", JValue("key"), JValue("value"))),
                 0, -1, False),
}


@pytest.fixture(scope="module", autouse=True)
def _jax_native_library():
    if not JAX_NATIVE_LOADED:
        pytest.fail("the JAX package's native library does not load")


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_native_matches_python_and_jax(name):
    mkfile, schema, jschema, off, length, ic = SCENARIOS[name]
    raw = extract_footer_bytes(mkfile())
    py = read_and_filter(raw, off, length, schema, ic)
    with footer_native.read_and_filter(raw, off, length, schema, ic) as nat, \
            jnative_footer.read_and_filter(raw, off, length, jschema,
                                           ic) as jnat:
        assert nat.num_rows == py.num_rows == jnat.num_rows
        assert nat.num_columns == py.num_columns == jnat.num_columns
        got = nat.serialize_thrift_file()
        assert got == py.serialize_thrift_file()
        assert got == jnat.serialize_thrift_file()


@pytest.mark.parametrize("part", ["first_half", "second_half", "whole"])
def test_native_split_filtering_matches_python(part):
    raw_file = simple_file(n=10000, row_group_size=1000)
    raw = extract_footer_bytes(raw_file)
    schema = StructElement("root", ValueElement("a"))
    half = len(raw_file) // 2
    off, length = {"first_half": (0, half),
                   "second_half": (half, len(raw_file) - half),
                   "whole": (0, len(raw_file))}[part]
    py = read_and_filter(raw, off, length, schema)
    with footer_native.read_and_filter(raw, off, length, schema) as nat:
        assert nat.num_rows == py.num_rows
        assert nat.serialize_thrift_file() == py.serialize_thrift_file()


def test_native_output_reparses_with_pyarrow():
    raw = extract_footer_bytes(simple_file())
    schema = StructElement("root", ValueElement("a"), ValueElement("c"))
    with footer_native.read_and_filter(raw, 0, -1, schema) as nat:
        md = pq.read_metadata(io.BytesIO(nat.serialize_thrift_file()))
    assert md.schema.names == ["a", "c"]


def test_native_error_on_garbage():
    schema = StructElement("root", ValueElement("a"))
    with pytest.raises(ValueError, match="footer read/filter failed"):
        footer_native.read_and_filter(b"\xff\xfe\xfd" * 100, 0, -1, schema)


def test_native_use_after_close_raises():
    raw = extract_footer_bytes(simple_file())
    nat = footer_native.read_and_filter(
        raw, 0, -1, StructElement("root", ValueElement("a")))
    nat.close()
    with pytest.raises(ValueError, match="closed"):
        _ = nat.num_rows


def test_native_malformed_rowgroup_error_not_crash():
    from spark_rapids_jni_tpu_torch.parquet.thrift import (
        Struct, Field, ListValue, TType, serialize_struct)
    root = Struct([Field(4, TType.BINARY, b"root"), Field(5, TType.I32, 1)])
    leaf = Struct([Field(1, TType.I32, 1), Field(4, TType.BINARY, b"a")])
    bad_group = Struct([Field(3, TType.I64, 7)])   # num_rows but no columns
    meta = Struct([
        Field(2, TType.LIST, ListValue(TType.STRUCT, [root, leaf])),
        Field(4, TType.LIST, ListValue(TType.STRUCT, [bad_group]))])
    schema = StructElement("root", ValueElement("a"))
    with pytest.raises(ValueError, match="malformed footer"):
        footer_native.read_and_filter(serialize_struct(meta), 0, 100, schema)
