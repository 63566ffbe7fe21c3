"""The port's Mortgage ETL against the JAX package's, on the CPU.

``spark_rapids_jni_tpu_torch.models.mortgage`` and
``spark_rapids_jni_tpu.models.mortgage`` run on the same files, pyarrow's
``benchmarks/mortgage_data.generate(n_loans=500, periods_per_loan=8,
seed=3)``, the JAX tests' size: every feature column must be equal, but
``mean_upb``, within a relative 1e-12 (the same cents summed in another
order), and so must ``feature_matrix``.  The JAX ETL runs once for the
module (it compiles on the CPU).  The numpy writer
``tools/torch_mortgage_parquet.py`` must write the tables ``generate``
writes, and the numpy oracle ``tools/torch_mortgage_oracle.py`` must give
the JAX package's result and the port's on the writer's files (the check
``chip_smoke.py`` makes on the card).
"""

import torch_one_thread  # noqa: F401  (first: one intra-op thread)
import pathlib
import sys

import numpy as np
import pytest
import torch

from benchmarks import mortgage_data
from spark_rapids_jni_tpu.models import mortgage as jmortgage

import spark_rapids_jni_tpu_torch as pt
from spark_rapids_jni_tpu_torch.models import mortgage
from spark_rapids_jni_tpu_torch.parquet import device_scan

from torch_jax_columns import assert_same, payload
from torch_jni_env import load_jax_native

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "tools"))
import torch_mortgage_oracle as MO  # noqa: E402
import torch_mortgage_parquet as MW  # noqa: E402

CPU = "cpu"
ARGS = (500, 8, 3)
MEAN_RTOL = 1e-12

# at import, as tests/test_torch_scan.py does: a worker holds the library
# before any JAX test reaches for it
JAX_NATIVE_LOADED = load_jax_native()


@pytest.fixture(scope="module", autouse=True)
def _jax_native_library():
    if not JAX_NATIVE_LOADED:
        pytest.fail("the JAX package's native library does not load")


@pytest.fixture(scope="module")
def files():
    return mortgage_data.generate(*ARGS)


@pytest.fixture(scope="module")
def writer():
    """The numpy writer's files and source numbers for the same
    arguments."""
    return MW.mortgage_parquet(*ARGS)


@pytest.fixture(scope="module")
def jax_etl(files):
    return jmortgage.etl(files)


@pytest.fixture(scope="module")
def port_etl(files):
    return mortgage.etl(files, device=CPU)


def test_columns_equal_the_jax_packages():
    assert mortgage.PERF_COLS == jmortgage.PERF_COLS
    assert mortgage.ACQ_COLS == jmortgage.ACQ_COLS
    assert mortgage.FEATURE_COLS == jmortgage.FEATURE_COLS == MO.FEATURE_COLS


@pytest.mark.parametrize("name", mortgage.FEATURE_COLS)
def test_etl_column_matches_jax(name, port_etl, jax_etl):
    i = mortgage.FEATURE_COLS.index(name)
    assert port_etl.num_rows == jax_etl.num_rows == ARGS[0]
    assert_same(port_etl[i], jax_etl[i],
                MEAN_RTOL if name == "mean_upb" else None, what=name)


def test_parsed_tables_match_jax(files):
    """The parse stage alone, on the scanned tables: perf's dates, cents
    and delinquencies, acq's rates, UPBs, dates and codes."""
    from spark_rapids_jni_tpu.parquet import device_scan as jscan
    tables = mortgage.load_tables(files, device=CPU)
    assert isinstance(tables["perf"][1], pt.DictColumn)
    jtables = {"perf": jscan.read_table(files["perf"],
                                        columns=jmortgage.PERF_COLS),
               "acq": jscan.read_table(files["acq"],
                                       columns=jmortgage.ACQ_COLS)}
    for parse, jparse, key in ((mortgage._parse_perf, jmortgage._parse_perf,
                                "perf"),
                               (mortgage._parse_acq, jmortgage._parse_acq,
                                "acq")):
        got, want = parse(tables[key]), jparse(jtables[key])
        for k, (g, w) in enumerate(zip(got.columns, want.columns)):
            assert_same(g, w, what=f"{key} column {k}")


def test_feature_matrix_matches_jax(files, jax_etl):
    ids, mat = mortgage.feature_matrix(files, device=CPU)
    jids, jmat = jmortgage.feature_matrix(files)
    assert mat.dtype == torch.float32 and mat.device.type == CPU
    assert tuple(mat.shape) == (ARGS[0], len(mortgage.FEATURE_COLS) - 1)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    jmat = np.asarray(jmat)
    mean = mortgage.FEATURE_COLS.index("mean_upb") - 1
    others = [k for k in range(mat.shape[1]) if k != mean]
    np.testing.assert_array_equal(mat.numpy()[:, others], jmat[:, others])
    # float32 of two float64 means within 1e-12 of each other
    np.testing.assert_allclose(mat.numpy()[:, mean], jmat[:, mean],
                               rtol=2.0 ** -23, atol=0)
    assert not np.isnan(mat.numpy()).any()


@pytest.mark.parametrize("table", ["perf", "acq"])
def test_writer_files_scan_like_generate(table, files, writer):
    mine, _ = writer
    cols = mortgage.PERF_COLS if table == "perf" else mortgage.ACQ_COLS
    a = device_scan.scan_table(mine[table], device=CPU)
    b = device_scan.scan_table(files[table], device=CPU)
    assert a.num_columns == b.num_columns == len(cols)
    for k, name in enumerate(cols):
        assert a[k].dtype == b[k].dtype, name
        assert a[k].to_pylist() == b[k].to_pylist(), name
        assert isinstance(a[k], pt.DictColumn) == isinstance(
            b[k], pt.DictColumn), name


def test_oracle_matches_jax(writer, jax_etl):
    _, arrays = writer
    cols, valid = MO.features(arrays)
    for i, name in enumerate(MO.FEATURE_COLS):
        j = jax_etl[i]
        np.testing.assert_array_equal(np.asarray(j.validity_or_true()),
                                      valid[name], err_msg=name)
        got = payload(j)
        if name == "mean_upb":
            np.testing.assert_allclose(got[valid[name]],
                                       cols[name][valid[name]],
                                       rtol=MO.MEAN_RTOL, atol=0)
        else:
            np.testing.assert_array_equal(got, cols[name], err_msg=name)


@pytest.mark.parametrize("args", [ARGS, (3000, 12, 11)])
def test_etl_on_writer_files_matches_oracle(args, writer):
    files, arrays = writer if args == ARGS else MW.mortgage_parquet(*args)
    rel = MO.check(mortgage.etl(files, device=CPU), MO.features(arrays))
    assert rel <= MEAN_RTOL


def test_oracle_rejects_a_wrong_table(writer):
    files, arrays = writer
    out = mortgage.etl(files, device=CPU)
    bad = pt.Table(list(out.columns))
    k = MO.FEATURE_COLS.index("max_delinquency")
    data = bad[k].data.clone()
    data[7] += 1
    bad.columns[k] = pt.Column(bad[k].dtype, data, validity=bad[k].validity)
    with pytest.raises(AssertionError):
        MO.check(bad, MO.features(arrays))


def test_scaled_half_even_matches_python_format():
    rng = np.random.default_rng(12)
    x = np.concatenate([rng.uniform(2.5, 8.0, 20000),
                        rng.uniform(10_000, 900_000, 20000),
                        [2.5, 7.99995, 2.50005, 2.00125, 10000.125,
                         10000.375, 899999.995]])
    for k, fmt in ((4, "{:.4f}"), (2, "{:.2f}")):
        units = MW._scaled_half_even(x, k)
        chars, offs = MW.number_text(units, k)
        text = chars.tobytes().decode()
        got = [text[offs[i]:offs[i + 1]] for i in range(x.shape[0])]
        assert got == [fmt.format(v) for v in x.tolist()]


def test_load_tables_defaults_to_the_card(files):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mortgage.load_tables(files)
