"""ctypes binding to the C++ footer engine (``csrc/footer_engine.cpp``).

The same API as ``footer.py`` over the port's JVM-facing library
(``_native.jni_library``), with the same output; the counterpart of the JAX
package's ``parquet/footer_native.py``.  The handle-based C ABI mirrors the
reference's JNI jlong-handle protocol (``NativeParquetJni.cpp:568-666``):
read_and_filter → handle; num_rows / num_columns / serialize / free operate
on the handle.
"""

from __future__ import annotations

import ctypes

from .. import _native
from .footer import SchemaNode

_ERR_BYTES = 512


class NativeParquetFooter:
    """Owning wrapper over a native footer handle (AutoCloseable analog,
    ParquetFooter.java:27,124-130)."""

    def __init__(self, handle: int, lib: ctypes.CDLL):
        self._handle = handle
        self._lib = lib

    @property
    def num_rows(self) -> int:
        self._check()
        return self._lib.srjt_footer_num_rows(self._handle)

    @property
    def num_columns(self) -> int:
        self._check()
        return self._lib.srjt_footer_num_columns(self._handle)

    def serialize_thrift_file(self) -> bytes:
        self._check()
        err = ctypes.create_string_buffer(_ERR_BYTES)
        size = self._lib.srjt_footer_serialize(self._handle, None, 0, err,
                                               _ERR_BYTES)
        if size < 0:
            raise RuntimeError(err.value.decode())
        buf = ctypes.create_string_buffer(size)
        got = self._lib.srjt_footer_serialize(self._handle, buf, size, err,
                                              _ERR_BYTES)
        if got < 0:
            raise RuntimeError(err.value.decode())
        return buf.raw[:got]

    def close(self) -> None:
        if self._handle:
            self._lib.srjt_footer_free(self._handle)
            self._handle = 0

    def _check(self):
        if not self._handle:
            raise ValueError("footer already closed")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        self.close()


def read_and_filter(buf: bytes, part_offset: int, part_length: int,
                    schema: SchemaNode,
                    ignore_case: bool = False) -> NativeParquetFooter:
    """Parse a raw footer thrift blob, prune columns, filter row groups
    (``footer.read_and_filter``'s contract); raises ValueError with the
    engine's message on a malformed footer."""
    lib = _native.jni_library()
    names, num_children, tags = schema.flatten_depth_first()
    if ignore_case:
        # the C ABI takes the expected names folded (the reference's Java
        # caller folds them before crossing JNI); the engine folds the
        # footer's own
        names = [s.lower() for s in names]
    n = len(names)
    names_arr = (ctypes.c_char_p * n)(*[s.encode("utf-8") for s in names])
    nc_arr = (ctypes.c_int32 * n)(*num_children)
    tags_arr = (ctypes.c_int32 * n)(*tags)
    err = ctypes.create_string_buffer(_ERR_BYTES)
    handle = lib.srjt_footer_read_and_filter(
        buf, len(buf), part_offset, part_length, names_arr, nc_arr, tags_arr,
        n, len(schema.children), 1 if ignore_case else 0, err, _ERR_BYTES)
    if not handle:
        raise ValueError(f"footer read/filter failed: {err.value.decode()}")
    return NativeParquetFooter(handle, lib)
