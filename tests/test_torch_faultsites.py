"""The port's four entry-point fault sites against the JAX package's, on
the CPU.

The JAX package marks ``convert_to_rows``, ``convert_from_rows``,
``parquet_read_table`` (``parquet.decode.read_table``) and
``parquet_read_and_filter`` (``parquet.footer.read_and_filter``) with
``faultinj.fault_site``; the port marks the same entry points
(``parquet.device_scan.read_table`` for the third).  The cases of
``tests/test_faultinj.py`` run on each of the four: a rule naming the
site, a rule naming another, the wildcard, the interception budget,
seeded dice (the same decisions as the JAX package's injector given the
same config), a substituted result and the config path from the
environment; the hot reload on one site.
"""

import torch_one_thread  # noqa: F401  (first: one intra-op thread)
import io
import json
import os
import time

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from spark_rapids_jni_tpu import convert_from_rows as jconvert_from_rows
from spark_rapids_jni_tpu import convert_to_rows as jconvert_to_rows
from spark_rapids_jni_tpu.faultinj import injector as jinjector
from spark_rapids_jni_tpu.parquet import decode as jdecode
from spark_rapids_jni_tpu.parquet import footer as jfooter

from spark_rapids_jni_tpu_torch import (Column, Table, convert_from_rows,
                                        convert_to_rows, faultinj)
from spark_rapids_jni_tpu_torch.faultinj.injector import (InjectedDeviceError,
                                                          InjectedOomError)
from spark_rapids_jni_tpu_torch.parquet import device_scan, footer

CPU = "cpu"
SITES = ("convert_to_rows", "convert_from_rows", "parquet_read_table",
         "parquet_read_and_filter")


@pytest.fixture(autouse=True)
def clean_injector():
    yield
    faultinj.disable()


def _raw() -> bytes:
    buf = io.BytesIO()
    pq.write_table(pa.table({"a": pa.array(np.arange(10, dtype=np.int64)),
                             "b": pa.array([f"v{i}" for i in range(10)])}),
                   buf)
    return buf.getvalue()


@pytest.fixture(scope="module")
def calls() -> dict:
    """A call of each site's entry point on small CPU inputs."""
    table = Table([Column.from_numpy(np.arange(10, dtype=np.int64),
                                     device=CPU)])
    batch = convert_to_rows(table)[0]       # made before any rule
    raw = _raw()
    tail = footer.extract_footer_bytes(raw)
    schema = footer.StructElement("root", footer.ValueElement("a"))
    return {
        "convert_to_rows": lambda: convert_to_rows(table),
        "convert_from_rows": lambda: convert_from_rows(batch, table.schema),
        "parquet_read_table": lambda: device_scan.read_table(raw,
                                                             device=CPU),
        "parquet_read_and_filter": lambda: footer.read_and_filter(
            tail, 0, 1 << 30, schema),
    }


def write_cfg(tmp_path, cfg) -> str:
    p = tmp_path / "faultinj.json"
    p.write_text(json.dumps(cfg))
    return str(p)


def test_sites_are_the_jax_packages():
    mine = [convert_to_rows, convert_from_rows, device_scan.read_table,
            footer.read_and_filter]
    theirs = [jconvert_to_rows, jconvert_from_rows, jdecode.read_table,
              jfooter.read_and_filter]
    assert [f.__fault_site__ for f in mine] == list(SITES)
    assert [f.__fault_site__ for f in theirs] == list(SITES)
    assert not hasattr(device_scan.scan_table, "__fault_site__")


@pytest.mark.parametrize("site", SITES)
def test_injects_on_named_site(tmp_path, calls, site):
    faultinj.enable(write_cfg(tmp_path, {
        "sites": {site: {"percent": 100, "injectionType": "device_error"}}}))
    with pytest.raises(InjectedDeviceError, match=site):
        calls[site]()
    for other in SITES:
        if other != site:
            assert calls[other]() is not None
    assert faultinj.get_injector().injected_count == 1


@pytest.mark.parametrize("site", SITES)
def test_untargeted_site_unaffected(tmp_path, calls, site):
    other = "convert_to_rows" if site != "convert_to_rows" \
        else "parquet_read_table"
    faultinj.enable(write_cfg(tmp_path, {
        "sites": {other: {"percent": 100}}}))
    assert calls[site]() is not None
    assert faultinj.get_injector().injected_count == 0


@pytest.mark.parametrize("site", SITES)
def test_wildcard_matches_everything(tmp_path, calls, site):
    faultinj.enable(write_cfg(tmp_path, {
        "sites": {"*": {"percent": 100, "injectionType": "oom"}}}))
    with pytest.raises(InjectedOomError, match=site):
        calls[site]()


@pytest.mark.parametrize("site", SITES)
def test_interception_count_budget(tmp_path, calls, site):
    faultinj.enable(write_cfg(tmp_path, {
        "sites": {site: {"percent": 100, "interceptionCount": 2}}}))
    for _ in range(2):
        with pytest.raises(InjectedDeviceError):
            calls[site]()
    assert calls[site]() is not None          # the budget is spent
    assert faultinj.get_injector().injected_count == 2


@pytest.mark.parametrize("site", SITES)
def test_percent_dice_seeded(tmp_path, calls, site):
    cfg = {"seed": 7, "sites": {site: {"percent": 50}}}
    faultinj.enable(write_cfg(tmp_path, cfg))
    got = []
    for _ in range(40):
        try:
            calls[site]()
            got.append(False)
        except InjectedDeviceError:
            got.append(True)
    theirs = jinjector.FaultInjector()
    theirs.load_dict(cfg)
    theirs.enable()
    want = []
    for _ in range(40):
        try:
            want.append(theirs.check(site) is not None)
        except jinjector.InjectedDeviceError:
            want.append(True)
    assert got == want
    assert 5 < sum(got) < 35


@pytest.mark.parametrize("site", SITES)
def test_substitute_result(tmp_path, calls, site):
    faultinj.enable(write_cfg(tmp_path, {
        "sites": {site: {"percent": 100, "injectionType": "substitute",
                         "substituteResult": []}}}))
    assert calls[site]() == []


@pytest.mark.parametrize("site", SITES)
def test_env_var_config(tmp_path, monkeypatch, calls, site):
    path = write_cfg(tmp_path, {"sites": {site: {"percent": 100}}})
    monkeypatch.setenv("FAULT_INJECTOR_CONFIG_PATH", path)
    faultinj.enable()       # the path from the environment
    with pytest.raises(InjectedDeviceError):
        calls[site]()


def test_plain_scan_table_is_not_intercepted(tmp_path):
    raw = _raw()
    faultinj.enable(write_cfg(tmp_path, {
        "sites": {"parquet_read_table": {"percent": 100}}}))
    assert device_scan.scan_table(raw, device=CPU).num_rows == 10
    with pytest.raises(InjectedDeviceError):
        device_scan.read_table(raw, device=CPU)


def test_hot_reload(tmp_path, calls):
    path = write_cfg(tmp_path, {"dynamic": True, "sites": {}})
    faultinj.enable(path)
    assert calls["convert_from_rows"]() is not None
    time.sleep(0.05)
    with open(path, "w") as f:
        json.dump({"dynamic": True,
                   "sites": {"convert_from_rows": {"percent": 100}}}, f)
    os.utime(path)
    deadline = time.time() + 2
    fired = False
    while time.time() < deadline:
        try:
            calls["convert_from_rows"]()
        except InjectedDeviceError:
            fired = True
            break
        time.sleep(0.05)
    assert fired, "the hot reload did not pick up the new config"
