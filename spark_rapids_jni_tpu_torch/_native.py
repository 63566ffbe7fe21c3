"""Build and load the port's native code: CUDA kernels and host helpers.

Each ``csrc/*.cu`` source compiles with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, loaded with ``ctypes`` (no PyTorch headers,
so a build takes seconds).  Each of ``HOST_SOURCES`` is host code (the
Parquet scan's PLAIN string walker and Snappy decompressor) and compiles
with the host C++ compiler, so it builds on a machine without the CUDA
toolkit too; so does the JVM-facing library ``JNI_LIBRARY``, linked from
several host sources (:func:`jni_library_path`).  Libraries go to
``build/torch_kernels/`` at the root of the checkout, named by a hash of
their source and flags, and are built at first use: nothing is compiled
when a module is imported.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "torch_kernels"
SOURCES = ("ragged.cu", "bytepath.cu", "xpack.cu", "slots.cu")
HOST_SOURCES = ("plain_strings.cpp", "snappy_native.cpp")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
HOST_FLAGS = ("-std=c++17", "-O2", "-shared", "-fPIC")
# The JVM-facing library, the counterpart of the JAX package's libsrjt.so
# (native/Makefile): host tables and row batches with the host JCUDF engine
# (host_table.cpp, rowconv_engine.cpp), the Parquet footer engine
# (thrift_compact.cpp, footer_engine.cpp), the JNI natives (jni_bridge.cpp)
# and the trampoline to ``bridge.py`` (device_bridge.cpp), in one library.
# -Bsymbolic binds its calls among its own srjt_* functions to itself,
# whatever else of the same names the process has loaded.
JNI_LIBRARY = "srjt"
JNI_SOURCES = ("host_table.cpp", "rowconv_engine.cpp", "thrift_compact.cpp",
               "footer_engine.cpp", "jni_bridge.cpp", "device_bridge.cpp")
JNI_HEADERS = ("thrift_compact.hpp", "jni_min.h")
JNI_FLAGS = HOST_FLAGS + ("-Wl,-Bsymbolic",)
JNI_LINK = ("-ldl",)
BUILD_TIMEOUT_S = 600

_P = ctypes.c_void_p
_I32 = ctypes.c_int32
_I64 = ctypes.c_int64
_U64 = ctypes.c_uint64
# argument types of every C entry point, by library; CUDA entry points
# return a cudaError_t as int
SIGNATURES = {
    "ragged": {
        "srjt_pack_rows": (_P, _I64, _I64, _P, _P, _I64, _P),
        "srjt_unpack_rows": (_P, _I64, _P, _I64, _I64, _P, _P),
        "srjt_segmented_copy": (_P, _I64, _P, _P, _P, _I64, _P, _I64, _P),
    },
    "bytepath": {
        "srjt_gather_rows": (_P, _I64, _I64, _P, _I64, _P, _P),
        "srjt_u8_to_u32": (_P, _I64, _P, _P),
    },
    "xpack": {
        "srjt_pack_windows": (_P, _I64, _I64, _P, _P, _I64, _P),
    },
    "slots": {
        "srjt_pack_slots": (_P, _I32, _I64, _I32, _I64, _I32, _I32, _I32,
                            _I32, _I32, _I32, _P, _P, _P),
        "srjt_unpack_slots": (_P, _I32, _I64, _I32, _I32, _P, _P),
    },
}
# host entry points: (argument types, result type)
HOST_SIGNATURES = {
    "plain_strings": {
        "srjt_byte_array_offsets": ((_P, _I64, _I64, _P), _I64),
        "srjt_delta_byte_array": ((_P, _P, _I64, _P, _I64, _P, _I64), _I64),
    },
    "snappy_native": {
        "srjt_snappy_decompress": ((_P, _I64, _P, _I64), _I64),
    },
    # every entry point the JAX package binds on its libsrjt.so
    # (native/__init__.py) but Snappy and the BYTE_ARRAY walk, which the
    # port keeps in the two libraries above; pointers as void*
    JNI_LIBRARY: {
        # footer engine (footer_engine.cpp)
        "srjt_footer_read_and_filter": (
            (_P, _U64, _I64, _I64, _P, _P, _P, _I32, _I32, _I32, _P, _U64),
            _P),
        "srjt_footer_num_rows": ((_P,), _I64),
        "srjt_footer_num_columns": ((_P,), _I64),
        "srjt_footer_serialize": ((_P, _P, _U64, _P, _U64), _I64),
        "srjt_footer_free": ((_P,), None),
        # host JCUDF engine (rowconv_engine.cpp)
        "srjt_layout": ((_P, _P, _I32, _P, _P, _P, _P), _I32),
        "srjt_pack_fixed": ((_P, _P, _P, _P, _I32, _I64, _I32, _I32, _P),
                            None),
        "srjt_unpack_fixed": ((_P, _I64, _I32, _P, _P, _I32, _I32, _P, _P),
                              None),
        "srjt_var_row_offsets": ((_P, _I32, _I64, _I32, _P), _I64),
        "srjt_pack_var": ((_P, _P, _P, _P, _P, _P, _I32, _I64, _P, _I32,
                           _I32, _P), None),
        "srjt_unpack_var": ((_P, _P, _I64, _P, _P, _P, _I32, _I32, _P, _P,
                             _P), None),
        "srjt_gather_chars": ((_P, _P, _I64, _I32, _P, _P), None),
        # host tables and row batches (host_table.cpp)
        "srjt_column_fixed": ((_I32, _I32, _I64, _P, _P), _P),
        "srjt_column_string": ((_I64, _P, _P, _P), _P),
        "srjt_column_free": ((_P,), None),
        "srjt_column_type": ((_P,), _I32),
        "srjt_column_scale": ((_P,), _I32),
        "srjt_column_rows": ((_P,), _I64),
        "srjt_column_data": ((_P,), _P),
        "srjt_column_data_size": ((_P,), _I64),
        "srjt_column_offsets": ((_P,), _P),
        "srjt_column_valid": ((_P,), _P),
        "srjt_table": ((_P, _I32), _P),
        "srjt_table_free": ((_P,), None),
        "srjt_table_rows": ((_P,), _I64),
        "srjt_table_cols": ((_P,), _I32),
        "srjt_table_column": ((_P, _I32), _P),
        "srjt_to_rows": ((_P,), _P),
        "srjt_from_rows": ((_P, _I32, _P, _P, _I32), _P),
        "srjt_debug_set_max_batch_bytes": ((_I64,), None),
        "srjt_rows_import": ((_P, _I64, _P, _I64), _P),
        "srjt_rows_import_append": ((_P, _P, _I64, _P, _I64), _I32),
        "srjt_rows_free": ((_P,), None),
        "srjt_rows_num_batches": ((_P,), _I32),
        "srjt_rows_batch_rows": ((_P, _I32), _I64),
        "srjt_rows_batch_data": ((_P, _I32), _P),
        "srjt_rows_batch_size": ((_P, _I32), _I64),
        "srjt_rows_batch_offsets": ((_P, _I32), _P),
        # device bridge (device_bridge.cpp)
        "srjt_device_available": ((), _I32),
        "srjt_to_rows_device": ((_P,), _P),
        "srjt_from_rows_device": ((_P, _I32, _P, _P, _I32), _P),
        "srjt_device_last_error": ((), ctypes.c_char_p),
        "srjt_device_set_error": ((ctypes.c_char_p,), None),
    },
}


def _tool(name: str, fallback: str, what: str) -> str:
    found = shutil.which(name) or fallback
    if not os.path.exists(found):
        raise RuntimeError(f"{name} not found: {what}")
    return found


def _inputs(source: str) -> tuple[list[Path], tuple]:
    """The files library ``source`` is built from (its hash covers them
    all, headers included), and its compiler flags."""
    if source == JNI_LIBRARY:
        return [CSRC / f for f in JNI_SOURCES + JNI_HEADERS], JNI_FLAGS
    return [CSRC / source], NVCC_FLAGS if source.endswith(".cu") else HOST_FLAGS


def _command(source: str, out: Path) -> list[str]:
    files, flags = _inputs(source)
    srcs = [str(f) for f in files if f.suffix in (".cu", ".cpp")]
    if source.endswith(".cu"):
        nvcc = _tool("nvcc", "/usr/local/cuda/bin/nvcc",
                     "the CUDA kernels build only on a machine with the "
                     "CUDA toolkit")
        return [nvcc, *flags, "-o", str(out), *srcs]
    cxx = _tool("c++", "/usr/bin/g++", "the host helpers need a C++ compiler")
    link = JNI_LINK if source == JNI_LIBRARY else ()
    return [cxx, *flags, "-o", str(out), *srcs, *link]


def library_path(source: str) -> Path:
    files, flags = _inputs(source)
    digest = hashlib.sha256(b"".join(f.read_bytes() for f in files)
                            + " ".join(flags).encode()).hexdigest()[:16]
    stem = source if source == JNI_LIBRARY else files[0].stem
    return BUILD_DIR / f"lib{stem}_{digest}.so"


def build(sources=SOURCES + HOST_SOURCES + (JNI_LIBRARY,)) -> dict[str, str]:
    """Compile every one of ``sources`` that has no library yet, one
    compiler process per source, all started together.  Returns the
    compilers' output (with each kernel's register and shared-memory use)
    by library name, for the libraries this call built."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for source in sources:
        lib = library_path(source)
        if lib.exists():
            continue
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        proc = subprocess.Popen(_command(source, tmp), stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs.append((lib, tmp, proc))
    logs, failures = {}, []
    for lib, tmp, proc in jobs:
        try:
            out, _ = proc.communicate(timeout=BUILD_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, _ = proc.communicate()
            failures.append(f"{lib.name}: compiler timed out\n{out}")
            continue
        logs[lib.stem] = out
        if proc.returncode != 0:
            failures.append(f"{lib.name}: compiler exited {proc.returncode}"
                            f"\n{out}")
            continue
        os.replace(tmp, lib)   # atomic: a concurrent loader sees all or none
    if failures:
        raise RuntimeError("native build failed:\n" + "\n".join(failures))
    return logs


@functools.lru_cache(maxsize=None)
def library(name: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<name>.cu``, building the CUDA
    sources first if needed, with ``argtypes``/``restype`` set for every
    entry point."""
    build(SOURCES)
    lib = ctypes.CDLL(str(library_path(f"{name}.cu")))
    for fn, argtypes in SIGNATURES[name].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    lib.srjt_error_string.argtypes = (ctypes.c_int,)
    lib.srjt_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def host_library(name: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<name>.cpp`` (or, for
    ``JNI_LIBRARY``, from ``JNI_SOURCES``) with the host compiler, building
    it first if needed; raises if the build fails."""
    source = name if name == JNI_LIBRARY else f"{name}.cpp"
    build((source,))
    lib = ctypes.CDLL(str(library_path(source)))
    for fn, (argtypes, restype) in HOST_SIGNATURES[name].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = restype
    return lib


def jni_library() -> ctypes.CDLL:
    """The loaded JVM-facing library, ``JNI_LIBRARY``."""
    return host_library(JNI_LIBRARY)


def jni_library_path() -> str:
    """The JVM-facing library's file, built if needed: the path a JVM
    loads it from (``-Dsrjt.native.path=<path>``)."""
    build((JNI_LIBRARY,))
    return str(library_path(JNI_LIBRARY))


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if code != 0:
        msg = lib.srjt_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


def launch(name: str, fn: str, device, *args) -> None:
    """Call entry point ``fn`` of library ``name`` with ``args`` and the
    current stream of ``device``; raise if the launch reported an error.

    The stream comes as a raw handle (``torch.cuda.current_stream`` builds a
    Python object each call, about half of a launch's host time on the
    card), and the device is made current only when it is not already."""
    import torch
    lib = library(name)
    current = torch.cuda.current_device()
    index = current if device.index is None else device.index
    stream = torch._C._cuda_getCurrentRawStream(index)
    if index == current:
        check(lib, getattr(lib, fn)(*args, stream), fn)
    else:
        with torch.cuda.device(index):
            check(lib, getattr(lib, fn)(*args, stream), fn)
