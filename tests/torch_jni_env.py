"""The JNI/C surface in the port's tests: a mock JNIEnv and the JAX
package's native library.

:class:`MockEnv` is a ctypes-built JNI function table (slot numbers per the
JNI 6 spec, as ``csrc/jni_min.h`` numbers them) with an object registry
standing in for a JVM, copied from ``tests/test_jni_bridge.py``: the JNI
natives take ``env.env`` as their ``JNIEnv*`` and throw through
``ThrowNew``, which records ``(class, message)`` in ``env.thrown``.

:func:`load_jax_native` loads the JAX package's ``libsrjt.so`` under a file
lock, retrying (test processes build it with ``make`` at first use and race
on it).  The rest makes seeded test tables (:func:`seeded_columns`), and
writes and reads host tables and row batches through either library's C
accessors or JNI natives.
"""

import ctypes as C
import fcntl
import pathlib
import time

import numpy as np

REPO = pathlib.Path(__file__).resolve().parent.parent

SLOTS = 233
S_FINDCLASS, S_THROWNEW = 6, 14
S_GETSTRINGUTF, S_RELEASESTRINGUTF = 169, 170
S_GETARRAYLEN, S_GETOBJARRAYELT = 171, 173
S_NEWLONGARRAY = 180
S_GETINTREGION, S_GETLONGREGION = 203, 204
S_SETLONGREGION = 212

VOIDP = C.c_void_p
ENVP = C.POINTER(VOIDP)


class MockEnv:
    """A JNINativeInterface_ table + object registry standing in for a JVM."""

    def __init__(self):
        self.objects = {}       # id -> python object ("jobject" handles)
        self.next_id = 1
        self.thrown = None      # (class_name, message)
        self._cbs = []          # keep callbacks alive
        table = (VOIDP * SLOTS)()

        def put(slot, restype, argtypes, fn):
            cb = C.CFUNCTYPE(restype, *argtypes)(fn)
            self._cbs.append(cb)
            table[slot] = C.cast(cb, VOIDP)

        put(S_FINDCLASS, C.c_void_p, [VOIDP, C.c_char_p],
            lambda env, name: self.register(("class", name.decode())))
        put(S_THROWNEW, C.c_int32, [VOIDP, C.c_void_p, C.c_char_p],
            self._throw_new)
        put(S_GETSTRINGUTF, C.c_void_p, [VOIDP, C.c_void_p, VOIDP],
            self._get_string_utf)
        put(S_RELEASESTRINGUTF, None, [VOIDP, C.c_void_p, C.c_char_p],
            lambda env, s, chars: None)
        put(S_GETARRAYLEN, C.c_int32, [VOIDP, C.c_void_p],
            lambda env, arr: len(self.objects[arr]))
        put(S_GETOBJARRAYELT, C.c_void_p, [VOIDP, C.c_void_p, C.c_int32],
            lambda env, arr, i: self.objects[arr][i])
        put(S_NEWLONGARRAY, C.c_void_p, [VOIDP, C.c_int32],
            lambda env, n: self.register([0] * n))
        put(S_GETINTREGION, None,
            [VOIDP, C.c_void_p, C.c_int32, C.c_int32, C.POINTER(C.c_int32)],
            self._get_region)
        put(S_GETLONGREGION, None,
            [VOIDP, C.c_void_p, C.c_int32, C.c_int32, C.POINTER(C.c_int64)],
            self._get_region)
        put(S_SETLONGREGION, None,
            [VOIDP, C.c_void_p, C.c_int32, C.c_int32, C.POINTER(C.c_int64)],
            self._set_long_region)

        self._table = table
        # JNIEnv* = pointer to (pointer to table)
        self._table_p = C.cast(table, VOIDP)
        self.env = C.pointer(self._table_p)
        self._utf_bufs = []

    def register(self, obj) -> int:
        oid = self.next_id
        self.next_id += 1
        self.objects[oid] = obj
        return oid

    def _throw_new(self, env, cls, msg):
        self.thrown = (self.objects[cls][1], msg.decode())
        return 0

    def _get_string_utf(self, env, s, is_copy):
        buf = C.create_string_buffer(self.objects[s].encode())
        self._utf_bufs.append(buf)
        return C.cast(buf, VOIDP).value

    def _get_region(self, env, arr, start, n, out):
        vals = self.objects[arr]
        for i in range(n):
            out[i] = vals[start + i]

    def _set_long_region(self, env, arr, start, n, vals):
        target = self.objects[arr]
        for i in range(n):
            target[start + i] = vals[i]

    # "jarray" / "jstring" handles
    def long_array(self, vals):
        return self.register([int(v) for v in vals])

    def int_array(self, vals):
        return self.register([int(v) for v in vals])

    def string_array(self, strs):
        return self.register([self.register(s) for s in strs])


# (restype, argtypes after JNIEnv* and jclass) of the JNI natives
JNI_SIGNATURES = {
    "HostColumn_makeFixed": (C.c_int64, [C.c_int32, C.c_int32, C.c_int64,
                                         C.c_int64, C.c_int64]),
    "HostColumn_makeString": (C.c_int64, [C.c_int64, C.c_int64, C.c_int64,
                                          C.c_int64]),
    "HostColumn_close": (None, [C.c_int64]),
    "HostColumn_rows": (C.c_int64, [C.c_int64]),
    "HostColumn_dataSize": (C.c_int64, [C.c_int64]),
    "HostColumn_dataAddress": (C.c_int64, [C.c_int64]),
    "HostColumn_offsetsAddress": (C.c_int64, [C.c_int64]),
    "HostColumn_validAddress": (C.c_int64, [C.c_int64]),
    "HostTable_makeTable": (C.c_int64, [C.c_void_p]),
    "HostTable_rowCount": (C.c_int64, [C.c_int64]),
    "HostTable_columns": (C.c_void_p, [C.c_int64]),
    "HostTable_close": (None, [C.c_int64]),
    "RowConversion_convertToRows": (C.c_int64, [C.c_int64]),
    "RowConversion_importRows": (C.c_int64, [C.c_int64, C.c_int64, C.c_int64,
                                             C.c_int64]),
    "RowConversion_convertFromRows": (C.c_int64, [C.c_int64, C.c_int32,
                                                  C.c_void_p, C.c_void_p]),
    "RowConversion_freeRows": (None, [C.c_int64]),
    "ParquetFooter_readAndFilter": (C.c_int64, [
        C.c_int64, C.c_int64, C.c_int64, C.c_int64, C.c_void_p, C.c_void_p,
        C.c_void_p, C.c_int32, C.c_uint8]),
    "ParquetFooter_getNumRows": (C.c_int64, [C.c_int64]),
    "ParquetFooter_getNumColumns": (C.c_int64, [C.c_int64]),
    "ParquetFooter_serializeThriftFile": (C.c_int64, [C.c_int64, C.c_int64,
                                                      C.c_int64]),
    "ParquetFooter_close": (None, [C.c_int64]),
}


class Jni:
    """The JNI natives of one loaded library, each called as
    ``jni.<Class>_<method>(env, *args)`` (the jclass argument is null)."""

    def __init__(self, lib: C.CDLL):
        self._fns = {}
        for name, (restype, argtypes) in JNI_SIGNATURES.items():
            # a fresh function object: another binding of the same symbol
            # in this process keeps its own types
            fn = C.CFUNCTYPE(restype, ENVP, VOIDP, *argtypes)(
                ("Java_com_tpu_rapids_jni_" + name, lib))
            self._fns[name] = fn

    def __getattr__(self, name):
        fn = self._fns[name]
        return lambda env, *args: fn(env.env, None, *args)


def load_jax_native(tries: int = 30) -> bool:
    """Load the JAX package's native library, retrying until it loads.

    A loader that met a half-written library gives up for good
    (``native._tried``), so each try here holds a file lock, the processes
    that reach it build and load one at a time, and a failed try is
    forgotten before the next."""
    from spark_rapids_jni_tpu import native as jnative
    lock_path = REPO / "build" / "jax_native_load.lock"
    lock_path.parent.mkdir(parents=True, exist_ok=True)
    for _ in range(tries):
        with open(lock_path, "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            try:
                if jnative.load() is not None:
                    return True
                jnative._tried = False
            finally:
                fcntl.flock(lock, fcntl.LOCK_UN)
        time.sleep(2)
    return False


def c_bytes(ptr, n: int, dtype=np.uint8) -> np.ndarray:
    """A copy of ``n`` items of ``dtype`` at C address ``ptr``."""
    if not n:
        return np.zeros(0, dtype)
    return np.ctypeslib.as_array(C.cast(ptr, C.POINTER(C.c_uint8)),
                                 (n * np.dtype(dtype).itemsize,)
                                 ).view(dtype).copy()


def table_handle(lib, cols) -> int:
    """A host table handle of ``lib`` holding copies of ``cols``, column
    tuples (type_id, scale, data, int32 offsets or None, uint8 validity or
    None)."""
    handles = []
    for tid, scale, data, offs, valid in cols:
        vp = None if valid is None else valid.ctypes.data
        if offs is None:
            h = lib.srjt_column_fixed(tid, scale, data.shape[0],
                                      data.ctypes.data, vp)
        else:
            h = lib.srjt_column_string(offs.size - 1, offs.ctypes.data,
                                       data.ctypes.data, vp)
        assert h
        handles.append(h)
    t = lib.srjt_table((C.c_void_p * len(handles))(*handles), len(handles))
    for h in handles:
        lib.srjt_column_free(h)
    assert t
    return t


def row_batches(lib, rows) -> list:
    """(bytes, int32 offsets) of every batch of a RowBatches handle."""
    out = []
    for b in range(lib.srjt_rows_num_batches(rows)):
        n = lib.srjt_rows_batch_rows(rows, b)
        out.append((c_bytes(lib.srjt_rows_batch_data(rows, b),
                            lib.srjt_rows_batch_size(rows, b)),
                    c_bytes(lib.srjt_rows_batch_offsets(rows, b), n + 1,
                            np.int32)))
    return out


def table_columns(lib, t) -> list:
    """(type, data, offsets, validity) of every column of a table handle,
    as its C buffers hold them (None where a buffer is absent)."""
    n = lib.srjt_table_rows(t)
    out = []
    for i in range(lib.srjt_table_cols(t)):
        h = lib.srjt_table_column(t, i)
        offs = lib.srjt_column_offsets(h)
        valid = lib.srjt_column_valid(h)
        out.append((lib.srjt_column_type(h),
                    c_bytes(lib.srjt_column_data(h),
                            lib.srjt_column_data_size(h)),
                    c_bytes(offs, n + 1, np.int32) if offs else None,
                    c_bytes(valid, n) if valid else None))
        lib.srjt_column_free(h)
    return out


def _strings(rng, n, max_len, valid=None):
    lens = rng.integers(0, max_len + 1, n)
    if valid is not None:
        lens = lens * valid
    offs = np.zeros(n + 1, np.int32)
    np.cumsum(lens, out=offs[1:])
    return (24, 0, rng.integers(32, 127, int(offs[-1])).astype(np.uint8),
            offs, valid)


def seeded_columns(case: str, n: int, seed: int) -> list:
    """``interop`` column tuples (type_id, scale, data, offsets, validity
    as uint8 or None) of one test table: ``"fixed"`` (every fixed-width
    kind the host tables take), ``"all_null_strings"`` or ``"mixed"``
    (strings and fixed-width columns, with nulls)."""
    rng = np.random.default_rng(seed)

    def valid(p):
        return (rng.random(n) >= p).astype(np.uint8)

    if case == "fixed":
        return [
            (1, 0, rng.integers(-128, 128, n).astype(np.int8), None,
             valid(0.3)),
            (2, 0, rng.integers(-999, 999, n).astype(np.int16), None, None),
            (3, 0, rng.integers(-9, 9, n).astype(np.int32), None, valid(0.1)),
            (8, 0, rng.integers(0, 2**63, n, dtype=np.uint64), None, None),
            (9, 0, rng.standard_normal(n).astype(np.float32), None, None),
            (10, 0, rng.standard_normal(n), None, valid(0.2)),
            (11, 0, rng.integers(0, 2, n).astype(np.uint8), None, None),
            (12, 0, rng.integers(0, 20000, n).astype(np.int32), None, None),
            (15, 0, rng.integers(0, 2**50, n), None, valid(0.5)),
            (22, -2, rng.integers(-10**6, 10**6, n).astype(np.int32), None,
             None),
            (23, -5, rng.integers(-10**15, 10**15, n), None, valid(0.1)),
        ]
    if case == "all_null_strings":
        return [_strings(rng, n, 5, np.zeros(n, np.uint8)),
                (4, 0, rng.integers(-10**9, 10**9, n), None, None)]
    # "mixed": after tests/test_device_bridge.py's table, with more types
    return [
        (3, 0, rng.integers(-1000, 1000, n).astype(np.int32), None,
         valid(0.1)),
        _strings(rng, n, 8),
        (4, 0, rng.integers(-10**12, 10**12, n), None, None),
        (10, 0, rng.standard_normal(n), None, valid(0.3)),
        _strings(rng, n, 40, valid(0.2)),
        (11, 0, rng.integers(0, 2, n).astype(np.uint8), None, valid(0.5)),
    ]


def assert_same_batches(a, b):
    """Two :func:`row_batches` lists are equal, batch for batch."""
    assert len(a) == len(b)
    for (da, oa), (db, ob) in zip(a, b):
        np.testing.assert_array_equal(da, db)
        np.testing.assert_array_equal(oa, ob)


def assert_same_tables(a, b):
    """Two :func:`table_columns` lists are equal, buffer for buffer."""
    assert len(a) == len(b)
    for ci, (ca, cb) in enumerate(zip(a, b)):
        assert ca[0] == cb[0], ci
        for x, y in zip(ca[1:], cb[1:]):
            assert (x is None) == (y is None), ci
            if x is not None:
                np.testing.assert_array_equal(x, y, err_msg=f"column {ci}")


def jni_table(jni, env, cols) -> int:
    """A JNI host table of ``cols`` made through HostColumn.makeFixed /
    makeString and HostTable.makeTable, the column handles closed."""
    handles = []
    for tid, scale, data, offs, valid in cols:
        vp = 0 if valid is None else valid.ctypes.data
        if offs is None:
            h = jni.HostColumn_makeFixed(env, tid, scale, data.shape[0],
                                         data.ctypes.data, vp)
        else:
            h = jni.HostColumn_makeString(env, offs.size - 1,
                                          offs.ctypes.data, data.ctypes.data,
                                          vp)
        assert h and env.thrown is None
        handles.append(h)
    t = jni.HostTable_makeTable(env, env.long_array(handles))
    assert t and env.thrown is None
    for h in handles:
        jni.HostColumn_close(env, h)
    return t
