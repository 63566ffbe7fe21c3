"""Kernel B1 (pack windows) and the to_rows route through it, on the CPU.

On a CPU tensor ``xpack.pack_windows`` computes its plain PyTorch version.
These cases hold that version against the JAX package's two formulations
of the same function, its XLA path (``xpack.pack_windows``) and its Pallas
kernel run in interpret mode (``xpallas.try_pack_windows`` under
``SRJT_PALLAS_PACKWIN=interpret``, as ``tests/test_bytepath.py`` runs it),
and against a numpy loop.  Then the port's ``convert_to_rows`` of string
tables, which packs every batch through B1, against the JAX package's
default engine (xpack) and the numpy oracle.  Exact equality throughout.
The CUDA kernel itself is held against the plain version on the card by
``tests/test_torch_gpu.py`` and ``chip_smoke.py``.
"""

import torch_one_thread  # noqa: F401  (first: one intra-op thread)
import numpy as np
import pytest
import torch

import jax.numpy as jnp
import spark_rapids_jni_tpu as sr
from spark_rapids_jni_tpu.rowconv import xpack as jxpack
from spark_rapids_jni_tpu.rowconv import xpallas

import spark_rapids_jni_tpu_torch as pt
from spark_rapids_jni_tpu_torch import interop
from spark_rapids_jni_tpu_torch.rowconv import ragged, xpack
from spark_rapids_jni_tpu_torch.rowconv import reference as pref

CPU = "cpu"
STRING = int(pt.TypeId.STRING)


@pytest.fixture(autouse=True)
def _jax_defaults(monkeypatch):
    # the JAX package's default to_rows engine, whatever the environment
    monkeypatch.setenv("SRJT_XPACK", "1")
    monkeypatch.delenv("SRJT_PALLAS_PACKWIN", raising=False)


# ---------------------------------------------------------------------------
# pack windows
# ---------------------------------------------------------------------------

def _rows(rng, n, Mw, sizes):
    """Random word rows [n, Mw] (as uint32) zero past each row's size, and
    int64 word offsets [n+1]."""
    dense = rng.integers(0, 2**32, (n, Mw), dtype=np.int64).astype(np.uint32)
    dense[np.arange(Mw) >= np.minimum(sizes, Mw)[:, None]] = 0
    dst = np.zeros(n + 1, np.int64)
    np.cumsum(sizes, out=dst[1:])
    return dense, dst


def _pack_np(dense, dst, total_w):
    out = np.zeros(total_w, np.uint32)
    for r in range(dense.shape[0]):
        k = min(int(dst[r + 1] - dst[r]), dense.shape[1])
        k = max(min(k, total_w - int(dst[r])), 0)
        out[dst[r]:dst[r] + k] = dense[r, :k]
    return out


def _port_pack(dense, dst, total_w):
    got = xpack.pack_windows(torch.from_numpy(dense.view(np.int32)),
                             torch.from_numpy(dst), total_w)
    assert got.dtype == torch.int32 and got.shape == (total_w,)
    return got.numpy().view(np.uint32)


# (name, rows, Mw, sizes in words): rows are 8-byte aligned, so even
JAX_CASES = {
    # many rows per 4 KiB block, rows spanning block boundaries, a total
    # that is not a multiple of 1024 words
    "spanning": (512, 40, lambda rng, n: 2 * rng.integers(8, 21, n)),
    "single": (1, 16, lambda rng, n: np.array([10])),
    # rows wider than a block: block 1 holds no row start
    "wide": (5, 2100, lambda rng, n: np.array([2100, 1500, 2, 2098, 4])),
    # empty rows among short ones
    "empty_rows": (300, 8, lambda rng, n: 2 * rng.integers(0, 5, n)),
    # a total of exactly two blocks, every block starting on a row
    "whole_blocks": (256, 8, lambda rng, n: np.full(n, 8)),
}


@pytest.mark.parametrize("case", list(JAX_CASES))
def test_pack_windows_matches_jax(case, monkeypatch):
    n, Mw, sizes = JAX_CASES[case]
    rng = np.random.default_rng(n + Mw)
    dense, dst = _rows(rng, n, Mw, sizes(rng, n))
    total_w = int(dst[-1])
    got = _port_pack(dense, dst, total_w)
    np.testing.assert_array_equal(got, _pack_np(dense, dst, total_w))

    jdense, jdst = jnp.asarray(dense), jnp.asarray(dst.astype(np.int32))
    nwin = -(-total_w // jxpack.WIN_W)
    P = int(np.bincount(dst[:-1] // jxpack.WIN_W, minlength=nwin).max()) + 1
    lax = np.asarray(jxpack.pack_windows(jdense, jdst, total_w, P, nwin))
    np.testing.assert_array_equal(got, lax)
    monkeypatch.setenv("SRJT_PALLAS_PACKWIN", "interpret")
    kernel = xpallas.try_pack_windows(jdense, jdst, total_w, P, nwin)
    if Mw > xpallas._B_PACK // 4:
        # rows wider than the Pallas kernel's VMEM window: outside its
        # envelope, the JAX package packs them on its XLA path
        assert kernel is None
    else:
        np.testing.assert_array_equal(got, np.asarray(kernel))


# (rows, Mw, smallest and largest size in words, extra words past the
# last row): many and few rows a block, rows longer than Mw (their tail
# is zero), empty rows, one row, trailing words past the last row
ORACLE_CASES = [(1000, 8, 2, 8, 0), (300, 64, 2, 64, 7), (97, 256, 2, 256, 0),
                (50, 300, 250, 300, 1), (3, 1024, 1024, 1024, 0),
                (2, 3000, 3000, 3000, 5), (7, 16, 20, 40, 0),
                (400, 12, 0, 6, 3), (1, 2, 2, 2, 0), (1, 4, 0, 0, 10),
                (2049, 2, 2, 2, 1), (600, 40, 0, 40, 1024)]


@pytest.mark.parametrize("n,Mw,lo,hi,extra", ORACLE_CASES)
def test_pack_windows_matches_numpy(n, Mw, lo, hi, extra):
    rng = np.random.default_rng(n * 7 + Mw)
    sizes = rng.integers(lo // 2, hi // 2 + 1, n) * 2
    dense, dst = _rows(rng, n, Mw, sizes)
    total_w = int(dst[-1]) + extra
    np.testing.assert_array_equal(_port_pack(dense, dst, total_w),
                                  _pack_np(dense, dst, total_w))


def test_pack_windows_checks_its_arguments():
    dense = torch.zeros((3, 4), dtype=torch.int32)
    dst = torch.tensor([0, 2, 4, 6])
    with pytest.raises(TypeError, match="int32"):
        xpack.pack_windows(dense.to(torch.int64), dst, 6)
    with pytest.raises(TypeError, match="int64"):
        xpack.pack_windows(dense, dst.to(torch.int32), 6)
    with pytest.raises(ValueError, match="entries"):
        xpack.pack_windows(dense, dst[:3], 6)
    with pytest.raises(ValueError, match="total_w"):
        xpack.pack_windows(dense, dst, -1)
    with pytest.raises(ValueError, match="contiguous"):
        xpack.pack_windows(torch.zeros((4, 3), dtype=torch.int32).t(), dst, 6)
    empty = xpack.pack_windows(torch.zeros((0, 4), dtype=torch.int32),
                               torch.zeros(1, dtype=torch.int64), 5)
    assert empty.tolist() == [0] * 5
    assert xpack.KERNELS == (xpack.pack_windows,)
    assert xpack.launch_counts() == {"pack_windows": 0}     # CPU: no launch


# ---------------------------------------------------------------------------
# to_rows through B1, against the JAX package's default engine
# ---------------------------------------------------------------------------

FIXED = ["INT64", "INT32", "INT16", "INT8", "FLOAT32", "BOOL8"]


def _column(rng, kind, n, null_share, max_len):
    valid = None if null_share == 0 else rng.random(n) >= null_share
    if kind == "STRING":
        lens = rng.integers(0, max_len + 1, n)
        offs = np.zeros(n + 1, np.int32)
        np.cumsum(lens, out=offs[1:])
        chars = rng.integers(32, 127, int(offs[-1])).astype(np.uint8)
        return (STRING, 0, chars, offs, valid)
    st = pt.DType(pt.TypeId[kind]).storage
    if st.kind == "f":
        data = rng.standard_normal(n).astype(st)
    elif kind == "BOOL8":
        data = rng.integers(0, 2, n).astype(np.uint8)
    else:
        data = rng.integers(-100, 100, n).astype(st)
    return (int(pt.TypeId[kind]), 0, data, None, valid)


def _jax_table(cols):
    out = []
    for tid, scale, data, offs, valid in cols:
        v = None if valid is None else jnp.asarray(valid)
        if tid == STRING:
            out.append(sr.Column(sr.DType(sr.TypeId(tid)), jnp.asarray(data),
                                 jnp.asarray(offs), v))
        else:
            out.append(sr.Column.from_numpy(data, sr.DType(sr.TypeId(tid)),
                                            valid))
    return sr.Table(out)


def _string_table(case, n, nvar, max_len, null_share):
    """nvar string columns, each followed by a fixed-width one."""
    rng = np.random.default_rng(len(case) * 31 + nvar)
    cols = []
    for i in range(nvar):
        cols.append(_column(rng, "STRING", n, null_share, max_len))
        cols.append(_column(rng, FIXED[i % len(FIXED)], n, null_share, 0))
    return cols


def _spy_packs(monkeypatch) -> dict:
    """Count the calls of B1's and B2's wrappers."""
    calls = {"pack_windows": 0, "pack_rows": 0}
    for module, name in ((xpack, "pack_windows"), (ragged, "pack_rows")):
        def wrapper(*args, _fn=getattr(module, name), _name=name):
            calls[_name] += 1
            return _fn(*args)
        monkeypatch.setattr(module, name, wrapper)
    return calls


# (rows, string columns, longest string, null share): one, several and
# more than 8 string columns; rows near the 1 KiB row limit, which the JAX
# package's xpack engine hands to its XLA path (xpack.py:533) and B1 packs
# like any other; every value null; every string empty
ROW_CASES = {
    "one_string": (150, 1, 39, 0.1),
    "three_strings": (120, 3, 20, 0.3),
    "ten_strings": (80, 10, 9, 0.1),
    "near_1kib_rows": (40, 2, 450, 0.0),
    "all_null_strings": (100, 2, 20, 1.0),
    "empty_strings": (100, 3, 0, 0.0),
}


@pytest.mark.parametrize("case", list(ROW_CASES))
def test_to_rows_matches_jax_xpack_and_oracle(case, monkeypatch):
    cols = _string_table(case, *ROW_CASES[case])
    table = interop.table_from_numpy(cols, device=CPU)
    calls = _spy_packs(monkeypatch)
    got = pt.convert_to_rows(table)
    # the routing rule: B1 packs every JCUDF row batch, B2 none
    assert calls == {"pack_windows": 1, "pack_rows": 0}
    want = sr.convert_to_rows(_jax_table(cols))
    assert len(got) == len(want) == 1
    assert got[0].data.dtype == torch.uint8
    np.testing.assert_array_equal(got[0].host_bytes(), want[0].host_bytes())
    np.testing.assert_array_equal(got[0].offsets.numpy(),
                                  np.asarray(want[0].offsets))
    oracle, oracle_offs = pref.to_rows_np(table)
    np.testing.assert_array_equal(got[0].host_bytes(), oracle)
    np.testing.assert_array_equal(got[0].offsets.numpy(), oracle_offs)
    back = interop.table_to_numpy(pt.convert_from_rows(got[0], table.schema))
    for a, b in zip(cols, back):
        np.testing.assert_array_equal(a[2], b[2])
        if a[3] is not None:
            np.testing.assert_array_equal(a[3], b[3])


@pytest.mark.parametrize("cap", [1024, 2048, 4096])
def test_to_rows_batches_each_packed_by_b1(cap, monkeypatch):
    """Several batches: one B1 pack each, and together the oracle's rows
    (the JAX comparison of several batches is in test_torch_rowconv.py)."""
    cols = _string_table("batches", 200, 3, 20, 0.3)
    table = interop.table_from_numpy(cols, device=CPU)
    calls = _spy_packs(monkeypatch)
    got = pt.convert_to_rows(table, cap)
    assert len(got) > 2
    assert calls == {"pack_windows": len(got), "pack_rows": 0}
    oracle, _ = pref.to_rows_np(table)
    np.testing.assert_array_equal(
        np.concatenate([g.host_bytes() for g in got]), oracle)
    assert all(g.num_bytes <= cap for g in got)


def test_rows_over_1kib_raise_in_both_packages():
    n = 4
    lens = np.array([10, 1100, 3, 0])
    offs = np.zeros(n + 1, np.int32)
    np.cumsum(lens, out=offs[1:])
    cols = [(STRING, 0, np.full(int(offs[-1]), 65, np.uint8), offs, None)]
    with pytest.raises(ValueError, match="exceeds JCUDF limit"):
        pt.convert_to_rows(interop.table_from_numpy(cols, device=CPU))
    with pytest.raises(ValueError):
        sr.convert_to_rows(_jax_table(cols))
