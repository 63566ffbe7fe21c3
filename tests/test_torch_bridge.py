"""The port's C and JNI surface on its device engine, on the CPU.

The port's JVM-facing library (``_native.jni_library``, built from
``spark_rapids_jni_tpu_torch/csrc``) forwards ``srjt_to_rows_device`` /
``srjt_from_rows_device`` and the ``RowConversion`` JNI natives to
``spark_rapids_jni_tpu_torch.bridge``.  Through ``bridge.use_device("cpu")``
each result is held byte for byte against the JAX package's same entry
point on its own ``libsrjt.so`` and against the host C++ engine
(``srjt_to_rows`` / ``srjt_from_rows``), after ``tests/test_device_bridge.py``
and ``tests/test_jni_bridge.py``.  Left on its default device, the bridge
needs a GPU, so on a machine without one every JNI call must throw with the
bridge's reason: the port's JNI has no host fallback.  Tables come from
numpy with a seed; tolerance is 0.
"""

import torch_one_thread  # noqa: F401  (first: one intra-op thread)
import ctypes as C
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu import native as jnative
import spark_rapids_jni_tpu.bridge as jbridge
from spark_rapids_jni_tpu.parquet import footer as jfooter

import spark_rapids_jni_tpu_torch as pt
from spark_rapids_jni_tpu_torch import _native, bridge
from spark_rapids_jni_tpu_torch.parquet import footer as pfooter

from torch_jni_env import (Jni, MockEnv, assert_same_batches,
                           assert_same_tables, c_bytes as _bytes, jni_table,
                           load_jax_native, row_batches as _row_batches,
                           seeded_columns, table_columns as _table,
                           table_handle as _handle)

CPU = "cpu"
TESTS = pathlib.Path(__file__).resolve().parent
JAX_NATIVE_LOADED = load_jax_native()
IAE = "java/lang/IllegalArgumentException"


@pytest.fixture(scope="module")
def jlib():
    if not JAX_NATIVE_LOADED:
        pytest.fail("the JAX package's native library does not load")
    return jnative.load()


@pytest.fixture(scope="module")
def lib():
    return _native.jni_library()


@pytest.fixture(autouse=True)
def _jax_quick_rows(monkeypatch):
    # the JAX package's DMA row engine instead of xpack: its own tests hold
    # the two bit-identical (tests/test_bytepath.py), and it compiles faster
    monkeypatch.setenv("SRJT_XPACK", "0")


# ---------------------------------------------------------------------------
# tables as C handles
# ---------------------------------------------------------------------------

def _assert_columns_are_input(cols, got):
    """(data, offsets, validity) of every column of ``got`` equal the input
    columns', the validity always present (but for zero rows)."""
    assert len(cols) == len(got)
    for ci, ((_, _, data, offs, valid), (gdata, goffs, gvalid)) in enumerate(
            zip(cols, got)):
        np.testing.assert_array_equal(gdata, data.view(np.uint8).reshape(-1),
                                      err_msg=f"column {ci}")
        if offs is not None:
            np.testing.assert_array_equal(goffs, offs, err_msg=f"column {ci}")
        n = data.shape[0] if offs is None else offs.size - 1
        want = np.ones(n, np.uint8) if valid is None else valid
        np.testing.assert_array_equal(
            np.zeros(0, np.uint8) if gvalid is None else gvalid, want,
            err_msg=f"column {ci}")


def _schema(cols):
    tids = np.asarray([c[0] for c in cols], np.int32)
    scales = np.asarray([c[1] for c in cols], np.int32)
    return tids, scales


CASES = {"mixed": (257, 5), "fixed": (300, 6), "all_null_strings": (40, 7),
         "mixed_one_row": (1, 8), "mixed_empty": (0, 9)}


def _case(name):
    n, seed = CASES[name]
    return seeded_columns(name.replace("_one_row", "").replace("_empty", ""),
                    n, seed)


# ---------------------------------------------------------------------------
# the C entry points
# ---------------------------------------------------------------------------

def test_device_available_in_python_process(lib):
    assert lib.srjt_device_available() == 1


@pytest.mark.parametrize("case", list(CASES))
def test_to_rows_device_matches_jax_and_host_engine(lib, jlib, case):
    cols = _case(case)
    t, jt = _handle(lib, cols), _handle(jlib, cols)
    with bridge.use_device(CPU):
        rows = lib.srjt_to_rows_device(t)
    assert rows, lib.srjt_device_last_error()
    assert lib.srjt_device_last_error() == b""
    jrows = jlib.srjt_to_rows_device(jt)
    host = lib.srjt_to_rows(t)
    assert jrows and host
    got = _row_batches(lib, rows)
    assert_same_batches(got, _row_batches(jlib, jrows))
    assert_same_batches(got, _row_batches(lib, host))
    for h in (rows, host):
        lib.srjt_rows_free(h)
    jlib.srjt_rows_free(jrows)
    lib.srjt_table_free(t)
    jlib.srjt_table_free(jt)


@pytest.mark.parametrize("case", list(CASES))
def test_from_rows_device_matches_jax_and_host_engine(lib, jlib, case):
    cols = _case(case)
    tids, scales = _schema(cols)
    t = _handle(lib, cols)
    rows = lib.srjt_to_rows(t)
    data, offs = _row_batches(lib, rows)[0]
    data = data if data.size else np.zeros(1, np.uint8)
    jrows = jlib.srjt_rows_import(data.ctypes.data, offs[-1],
                                  offs.ctypes.data, offs.size - 1)
    with bridge.use_device(CPU):
        back = lib.srjt_from_rows_device(rows, 0, tids.ctypes.data,
                                         scales.ctypes.data, len(cols))
    assert back, lib.srjt_device_last_error()
    jback = jlib.srjt_from_rows_device(jrows, tids.ctypes.data,
                                       scales.ctypes.data, len(cols))
    host = lib.srjt_from_rows(rows, 0, tids.ctypes.data, scales.ctypes.data,
                              len(cols))
    assert jback and host
    got = _table(lib, back)
    assert_same_tables(got, _table(jlib, jback))
    assert_same_tables(got, _table(lib, host))
    assert [c[0] for c in got] == [c[0] for c in cols]
    _assert_columns_are_input(cols, [c[1:] for c in got])
    for h in (back, host, t):
        lib.srjt_table_free(h)
    jlib.srjt_table_free(jback)
    lib.srjt_rows_free(rows)
    jlib.srjt_rows_free(jrows)


def test_device_calls_need_a_gpu_by_default(lib):
    """Left on its default device the bridge is the GPU's: here it fails
    with the reason, and nothing runs on the host."""
    cols = _case("mixed")
    tids, scales = _schema(cols)
    t = _handle(lib, cols)
    assert not lib.srjt_to_rows_device(t)
    assert b"no CUDA device" in lib.srjt_device_last_error()
    rows = lib.srjt_to_rows(t)
    assert not lib.srjt_from_rows_device(rows, 0, tids.ctypes.data,
                                         scales.ctypes.data, len(cols))
    assert b"no CUDA device" in lib.srjt_device_last_error()
    with bridge.use_device(CPU):
        back = lib.srjt_from_rows_device(rows, 0, tids.ctypes.data,
                                         scales.ctypes.data, len(cols))
    assert back and lib.srjt_device_last_error() == b""
    for h in (back, t):
        lib.srjt_table_free(h)
    lib.srjt_rows_free(rows)


@pytest.mark.parametrize("batch", [0, 1, 2])
def test_from_rows_device_decodes_every_batch(lib, batch):
    """Under a 2 KB limit the host engine cuts the rows into several
    batches; the bridge decodes any of them, as the host engine does, and
    refuses an index past the last."""
    cols = _case("mixed")
    tids, scales = _schema(cols)
    t = _handle(lib, cols)
    lib.srjt_debug_set_max_batch_bytes(2048)
    try:
        rows = lib.srjt_to_rows(t)
    finally:
        lib.srjt_debug_set_max_batch_bytes(0)
    nb = lib.srjt_rows_num_batches(rows)
    assert nb > 2
    with bridge.use_device(CPU):
        back = lib.srjt_from_rows_device(rows, batch, tids.ctypes.data,
                                         scales.ctypes.data, len(cols))
        assert back, lib.srjt_device_last_error()
        assert not lib.srjt_from_rows_device(rows, nb, tids.ctypes.data,
                                             scales.ctypes.data, len(cols))
    assert lib.srjt_device_last_error() == (
        f"IndexError: batch {nb} of a handle holding {nb}".encode())
    host = lib.srjt_from_rows(rows, batch, tids.ctypes.data,
                              scales.ctypes.data, len(cols))
    assert_same_tables(_table(lib, back), _table(lib, host))
    for h in (back, host, t):
        lib.srjt_table_free(h)
    lib.srjt_rows_free(rows)


def test_bridge_imports_several_batches(lib):
    """A conversion of several batches comes back through
    srjt_rows_import and srjt_rows_import_append, batch for batch, and the
    batches together hold the host engine's rows."""
    cols = _case("mixed")
    t = _handle(lib, cols)
    table = bridge.upload(bridge.read_table(lib, t), torch.device(CPU))
    batches = bridge.download(pt.convert_to_rows(table, max_batch_bytes=2048))
    assert len(batches) > 2
    rows = bridge.import_rows(lib, batches)
    got = _row_batches(lib, rows)
    assert_same_batches(got, batches)
    host = lib.srjt_to_rows(t)
    (want, _), = _row_batches(lib, host)
    np.testing.assert_array_equal(np.concatenate([d for d, _ in got]), want)
    for h in (rows, host):
        lib.srjt_rows_free(h)
    lib.srjt_table_free(t)


def test_corrupt_rows_fail_with_the_engine_text(lib):
    cols = [seeded_columns("mixed", 4, 3)[1]]
    t = _handle(lib, cols)
    rows = lib.srjt_to_rows(t)
    data, offs = _row_batches(lib, rows)[0]
    data[4:8] = np.frombuffer(np.uint32(2**31).tobytes(), np.uint8)
    bad = lib.srjt_rows_import(data.ctypes.data, data.size, offs.ctypes.data,
                               offs.size - 1)
    tids, scales = _schema(cols)
    with bridge.use_device(CPU):
        assert not lib.srjt_from_rows_device(bad, 0, tids.ctypes.data,
                                             scales.ctypes.data, 1)
    assert lib.srjt_device_last_error().startswith(b"ValueError: corrupt row")
    for h in (rows, bad):
        lib.srjt_rows_free(h)
    lib.srjt_table_free(t)


def test_library_loads_without_a_python_runtime(lib, tmp_path):
    """In a process with no CPython (a plain JVM) the library loads and
    every device call fails with that reason."""
    src = tmp_path / "no_python.cpp"
    src.write_text(r'''
#include <cstdint>
#include <cstdio>
#include <dlfcn.h>
int main(int, char** argv) {
  void* h = dlopen(argv[1], RTLD_NOW | RTLD_LOCAL);
  if (!h) { std::puts(dlerror()); return 1; }
  auto col = reinterpret_cast<void* (*)(int32_t, int32_t, int64_t,
      const uint8_t*, const uint8_t*)>(dlsym(h, "srjt_column_fixed"));
  auto table = reinterpret_cast<void* (*)(void* const*, int32_t)>(
      dlsym(h, "srjt_table"));
  auto to_rows = reinterpret_cast<void* (*)(void*)>(
      dlsym(h, "srjt_to_rows_device"));
  auto err = reinterpret_cast<const char* (*)()>(
      dlsym(h, "srjt_device_last_error"));
  auto avail = reinterpret_cast<int32_t (*)()>(
      dlsym(h, "srjt_device_available"));
  int64_t data[4] = {1, 2, 3, 4};
  void* c = col(4, 0, 4, reinterpret_cast<const uint8_t*>(data), nullptr);
  void* t = table(&c, 1);
  bool rows = to_rows(t) != nullptr;
  std::printf("%d %d %s\n", avail(), rows, err());
  return 0;
}
''')
    exe = tmp_path / "no_python"
    subprocess.run(["c++", "-std=c++17", "-o", str(exe), str(src), "-ldl"],
                   check=True, timeout=120)
    out = subprocess.run([str(exe), _native.jni_library_path()],
                         capture_output=True, text=True, timeout=60,
                         check=True).stdout
    assert out.strip() == "0 0 no Python runtime in this process"


# ---------------------------------------------------------------------------
# the JNI natives (tests/test_jni_bridge.py on the port's library)
# ---------------------------------------------------------------------------

def _jni_columns(jni, env, t) -> list:
    """(data, offsets, validity) of every column of a JNI table, released
    one handle a column as Java's HostTable.columns does."""
    n = jni.HostTable_rowCount(env, t)
    out = []
    for h in env.objects[jni.HostTable_columns(env, t)]:
        offs = jni.HostColumn_offsetsAddress(env, h)
        valid = jni.HostColumn_validAddress(env, h)
        out.append((_bytes(jni.HostColumn_dataAddress(env, h),
                           jni.HostColumn_dataSize(env, h)),
                    _bytes(offs, n + 1, np.int32) if offs else None,
                    _bytes(valid, n) if valid else None))
        assert jni.HostColumn_rows(env, h) == n
        jni.HostColumn_close(env, h)
    return out


@pytest.mark.parametrize("case", ["mixed", "fixed", "mixed_empty"])
def test_row_conversion_round_trip_through_jni(lib, jlib, case):
    """convertToRows → convertFromRows through the mock JNIEnv: the rows
    equal the JAX library's JNI's, the columns come back exact."""
    cols = _case(case)
    tids, scales = _schema(cols)
    jni, env = Jni(lib), MockEnv()
    jjni, jenv = Jni(jlib), MockEnv()
    t = jni_table(jni, env, cols)
    jt = jni_table(jjni, jenv, cols)
    with bridge.use_device(CPU):
        rows = jni.RowConversion_convertToRows(env, t)
        assert rows and env.thrown is None
        back = jni.RowConversion_convertFromRows(
            env, rows, 0, env.int_array(tids), env.int_array(scales))
        assert back and env.thrown is None
    jrows = jjni.RowConversion_convertToRows(jenv, jt)
    assert_same_batches(_row_batches(lib, rows), _row_batches(jlib, jrows))
    _assert_columns_are_input(cols, _jni_columns(jni, env, back))
    jni.RowConversion_freeRows(env, rows)
    jjni.RowConversion_freeRows(jenv, jrows)
    for h in (t, back):
        jni.HostTable_close(env, h)
    jjni.HostTable_close(jenv, jt)


def test_jni_throws_without_a_gpu_instead_of_falling_back(lib):
    """The no-fallback check: with the bridge on its default device on a
    machine without CUDA, both natives throw with the bridge's text."""
    cols = _case("mixed")
    tids, scales = _schema(cols)
    jni, env = Jni(lib), MockEnv()
    t = jni_table(jni, env, cols)
    assert jni.RowConversion_convertToRows(env, t) == 0
    assert env.thrown[0] == IAE
    assert env.thrown[1].startswith("convertToRows failed on the device: "
                                    "RuntimeError: no CUDA device")
    env.thrown = None
    rows = lib.srjt_to_rows(t)
    assert jni.RowConversion_convertFromRows(
        env, rows, 0, env.int_array(tids), env.int_array(scales)) == 0
    assert env.thrown[0] == IAE
    assert "no CUDA device" in env.thrown[1]
    lib.srjt_rows_free(rows)
    jni.HostTable_close(env, t)


def test_jni_ignores_srjt_device_switch(lib, monkeypatch):
    """SRJT_DEVICE=0 sent the JAX library's JNI to the host engine; the
    port's has no such switch and still reaches the bridge."""
    monkeypatch.setenv("SRJT_DEVICE", "0")
    cols = _case("mixed")
    jni, env = Jni(lib), MockEnv()
    t = jni_table(jni, env, cols)
    assert lib.srjt_device_available() == 1
    assert jni.RowConversion_convertToRows(env, t) == 0
    assert "no CUDA device" in env.thrown[1]      # the bridge's reason
    env.thrown = None
    with bridge.use_device(CPU):
        rows = jni.RowConversion_convertToRows(env, t)
    assert rows and env.thrown is None
    host = lib.srjt_to_rows(t)
    assert_same_batches(_row_batches(lib, rows), _row_batches(lib, host))
    for h in (rows, host):
        lib.srjt_rows_free(h)
    jni.HostTable_close(env, t)


def test_jni_decodes_batch_one_on_the_bridge(lib):
    """A batch index of 1 goes to the bridge too (the JAX library's JNI
    sent every batch but the first to the host engine)."""
    cols = _case("mixed")
    tids, scales = _schema(cols)
    jni, env = Jni(lib), MockEnv()
    t = jni_table(jni, env, cols)
    lib.srjt_debug_set_max_batch_bytes(2048)
    try:
        rows = lib.srjt_to_rows(t)
    finally:
        lib.srjt_debug_set_max_batch_bytes(0)
    assert lib.srjt_rows_num_batches(rows) > 1
    args = (rows, 1, env.int_array(tids), env.int_array(scales))
    assert jni.RowConversion_convertFromRows(env, *args) == 0
    assert "no CUDA device" in env.thrown[1]
    env.thrown = None
    with bridge.use_device(CPU):
        back = jni.RowConversion_convertFromRows(env, *args)
    assert back and env.thrown is None
    host = lib.srjt_from_rows(rows, 1, tids.ctypes.data, scales.ctypes.data,
                              len(cols))
    assert_same_tables(_table(lib, back), _table(lib, host))
    for h in (back, host, t):
        lib.srjt_table_free(h)
    lib.srjt_rows_free(rows)


def test_row_size_limit_throws_java_exception(lib, jlib):
    """200 INT64 columns make rows over the 1 KB limit: the port's JNI
    throws from the device path, with the class the JAX library's throws."""
    data = np.zeros(8, dtype=np.int64)
    cols = [(4, 0, data, None, None)] * 200
    got = {}
    for name, l in (("port", lib), ("jax", jlib)):
        jni, env = Jni(l), MockEnv()
        t = jni_table(jni, env, cols)
        with bridge.use_device(CPU):
            assert jni.RowConversion_convertToRows(env, t) == 0
        got[name] = env.thrown
        jni.HostTable_close(env, t)
    assert got["port"][0] == got["jax"][0] == IAE
    assert "exceeds JCUDF limit" in got["port"][1]


def test_import_rows_through_jni_round_trips(lib):
    cols = _case("mixed")
    tids, scales = _schema(cols)
    jni, env = Jni(lib), MockEnv()
    t = jni_table(jni, env, cols)
    host = lib.srjt_to_rows(t)
    (data, offs), = _row_batches(lib, host)
    rows = jni.RowConversion_importRows(env, data.ctypes.data, data.size,
                                        offs.ctypes.data, offs.size - 1)
    assert rows
    with bridge.use_device(CPU):
        back = jni.RowConversion_convertFromRows(
            env, rows, 0, env.int_array(tids), None)
    assert back and env.thrown is None
    _assert_columns_are_input(cols, _jni_columns(jni, env, back))
    jni.RowConversion_freeRows(env, rows)
    lib.srjt_rows_free(host)
    for h in (t, back):
        jni.HostTable_close(env, h)


def test_parquet_footer_through_jni(lib):
    """ParquetFooter's natives on the port's library give what the port's
    footer.py and the JAX package's give."""
    from test_parquet_footer import simple_file

    data = jfooter.extract_footer_bytes(simple_file(n=10))
    schema = pfooter.StructElement("root", pfooter.ValueElement("a"),
                                   pfooter.ValueElement("c"))
    expected = pfooter.read_and_filter(data, 0, 1 << 30, schema)
    jexpected = jfooter.read_and_filter(
        data, 0, 1 << 30, jfooter.StructElement(
            "root", jfooter.ValueElement("a"), jfooter.ValueElement("c")))
    jni, env = Jni(lib), MockEnv()
    buf = np.frombuffer(data, dtype=np.uint8).copy()
    names, nc, tags = schema.flatten_depth_first()
    h = jni.ParquetFooter_readAndFilter(
        env, buf.ctypes.data, len(data), 0, 1 << 30, env.string_array(names),
        env.int_array(nc), env.int_array(tags), len(schema.children), 0)
    assert env.thrown is None and h
    assert jni.ParquetFooter_getNumRows(env, h) == expected.num_rows == 10
    assert jni.ParquetFooter_getNumColumns(env, h) == expected.num_columns == 2
    want = expected.serialize_thrift_file()
    assert want == jexpected.serialize_thrift_file()
    out = np.zeros(len(want) + 64, dtype=np.uint8)
    written = jni.ParquetFooter_serializeThriftFile(env, h, out.ctypes.data,
                                                    out.size)
    assert bytes(out[:written]) == want
    jni.ParquetFooter_close(env, h)
    # a footer it cannot parse throws
    junk = np.frombuffer(b"\xff\xfe\xfd" * 100, np.uint8).copy()
    assert jni.ParquetFooter_readAndFilter(
        env, junk.ctypes.data, junk.size, 0, -1, env.string_array(names),
        env.int_array(nc), env.int_array(tags), len(schema.children), 0) == 0
    assert env.thrown[0] == "java/lang/RuntimeException"


_TWO_LIBRARIES = r'''
import ctypes, json, sys
import jax
jax.config.update("jax_platforms", "cpu")
sys.path.insert(0, sys.argv[1])
from torch_jni_env import (Jni, MockEnv, assert_same_batches,
                           assert_same_tables, c_bytes as _bytes, jni_table,
                           load_jax_native, row_batches as _row_batches,
                           seeded_columns, table_columns as _table,
                           table_handle as _handle)
assert load_jax_native()
from spark_rapids_jni_tpu import native as jnative
# the JAX library's srjt_* names into the global scope, ahead of the port's
ctypes.CDLL(jnative._LIB_PATH, mode=ctypes.RTLD_GLOBAL)
import spark_rapids_jni_tpu.bridge as jbridge
from spark_rapids_jni_tpu_torch import _native, bridge as pbridge
import numpy as np

calls = []
for name, mod in (("jax", jbridge), ("port", pbridge)):
    def record(handle, _f=mod.to_rows_from_handle, _name=name):
        calls.append(_name)
        return _f(handle)
    mod.to_rows_from_handle = record

out = {}
data = np.arange(16, dtype=np.int64)
for name, lib in (("jax", jnative.load()), ("port", _native.jni_library())):
    jni, env = Jni(lib), MockEnv()
    col = jni.HostColumn_makeFixed(env, 4, 0, 16, data.ctypes.data, 0)
    t = jni.HostTable_makeTable(env, env.long_array([col]))
    del calls[:]
    with pbridge.use_device("cpu"):
        rows = jni.RowConversion_convertToRows(env, t)
    out[name] = [list(calls), bool(rows), env.thrown]
print(json.dumps(out))
'''


def test_each_library_reaches_its_own_bridge():
    """Both libraries in one process, the JAX package's with its srjt_*
    names in the global scope: each library's JNI still calls its own
    srjt_to_rows_device (the port's links with -Bsymbolic), so each reaches
    its own bridge."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", SRJT_XPACK="0")
    res = subprocess.run([sys.executable, "-c", _TWO_LIBRARIES, str(TESTS)],
                         capture_output=True, text=True, timeout=300,
                         env=env, cwd=str(TESTS.parent))
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out == {"jax": [["jax"], True, None], "port": [["port"], True, None]}
