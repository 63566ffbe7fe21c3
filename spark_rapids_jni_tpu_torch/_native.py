"""Build and load the port's native code: CUDA kernels and host helpers.

Each ``csrc/*.cu`` source compiles with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, loaded with ``ctypes`` (no PyTorch headers,
so a build takes seconds).  Each ``csrc/*.cpp`` source is host code (the
Parquet scan's PLAIN string walker and Snappy decompressor) and compiles
with the host C++ compiler, so it builds on a machine without the CUDA
toolkit too.  Libraries go to
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
SOURCES = ("ragged.cu", "bytepath.cu", "xpack.cu")
HOST_SOURCES = ("plain_strings.cpp", "snappy_native.cpp")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
HOST_FLAGS = ("-std=c++17", "-O2", "-shared", "-fPIC")
BUILD_TIMEOUT_S = 600

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
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
}


def _tool(name: str, fallback: str, what: str) -> str:
    found = shutil.which(name) or fallback
    if not os.path.exists(found):
        raise RuntimeError(f"{name} not found: {what}")
    return found


def _command(source: str, out: Path) -> list[str]:
    src = str(CSRC / source)
    if source.endswith(".cu"):
        nvcc = _tool("nvcc", "/usr/local/cuda/bin/nvcc",
                     "the CUDA kernels build only on a machine with the "
                     "CUDA toolkit")
        return [nvcc, *NVCC_FLAGS, "-o", str(out), src]
    cxx = _tool("c++", "/usr/bin/g++", "the host helpers need a C++ compiler")
    return [cxx, *HOST_FLAGS, "-o", str(out), src]


def library_path(source: str) -> Path:
    src = CSRC / source
    flags = NVCC_FLAGS if source.endswith(".cu") else HOST_FLAGS
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(flags).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{src.stem}_{digest}.so"


def build(sources=SOURCES + HOST_SOURCES) -> dict[str, str]:
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
    """The loaded library built from ``csrc/<name>.cpp`` with the host
    compiler, building it first if needed; raises if the build fails."""
    source = f"{name}.cpp"
    build((source,))
    lib = ctypes.CDLL(str(library_path(source)))
    for fn, (argtypes, restype) in HOST_SIGNATURES[name].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = restype
    return lib


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
