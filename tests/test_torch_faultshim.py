"""The torch-level fault shim (``faultinj/torch_shim.py``) against the
JAX package's shim and injector, on the CPU.

Mirrors ``tests/test_faultinj.py``'s shim tests: ``install`` is
idempotent and names its sites, ``uninstall`` restores every seam, a
rule at a site raises there and its budget runs out, the resilient
executor retries transient faults and quarantines on fatal ones.  The
seams here are the port's own (``torch.h2d``: the column constructors'
and the scan staging's uploads; ``torch.build``: kernel builds and
loads; ``torch.launch``: kernel launches and graph replays, faked on the
CPU where nothing launches).  The fault schedule of a seeded rule is the
JAX package's injector's, decision for decision, and results under the
shim equal results without it.
"""

import torch_one_thread  # noqa: F401  (first: one intra-op thread)
import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu.faultinj import injector as jinjector
from spark_rapids_jni_tpu.faultinj import jax_shim

from spark_rapids_jni_tpu_torch import _native, column
from spark_rapids_jni_tpu_torch.column import Column
from spark_rapids_jni_tpu_torch.faultinj import injector, torch_shim
from spark_rapids_jni_tpu_torch.faultinj.injector import (
    InjectedDeviceError, InjectedOomError)
from spark_rapids_jni_tpu_torch.faultinj.resilience import (
    DeviceQuarantined, ResilientExecutor)
from spark_rapids_jni_tpu_torch.models import compiled
from spark_rapids_jni_tpu_torch.parquet import staging

CPU = "cpu"


@pytest.fixture
def shim():
    sites = torch_shim.install()
    yield sites
    torch_shim.uninstall()
    injector.disable()


def _rules(site, **rule):
    injector.get_injector().load_dict({"seed": 7, "sites": {site: rule}})
    injector.enable()


def _upload():
    return Column.from_numpy(np.arange(64, dtype=np.int64), device=CPU)


def test_install_idempotent_and_uninstall_restores():
    before = (column.upload, staging.Slab.upload, _native.build,
              _native.library, _native.launch, compiled.graph_replay)
    try:
        sites = torch_shim.install()
        assert sites == ["torch.build", "torch.h2d", "torch.launch"]
        assert torch_shim.install() == sites and torch_shim.installed()
        assert column.upload is not before[0]
        assert _native.library.cache_info() is not None
    finally:
        torch_shim.uninstall()
    assert not torch_shim.installed()
    assert (column.upload, staging.Slab.upload, _native.build,
            _native.library, _native.launch, compiled.graph_replay) == before
    assert jax_shim.installed() is False        # the JAX shim untouched


def test_h2d_rule_raises_then_budget_runs_out(shim):
    _rules("torch.h2d", percent=100, interceptionCount=1,
           injectionType="device_error")
    with pytest.raises(InjectedDeviceError):
        _upload()
    col = _upload()                             # the budget is spent
    assert col.data.tolist() == list(range(64))
    assert torch_shim.COUNTS["torch.h2d"] == 2
    assert torch_shim.COUNTS["torch.h2d.injected"] == 1


def test_staging_upload_and_strings_are_seams(shim):
    _rules("*", percent=0)
    slab = staging.Slab()
    slab.add(b"abcdef")
    data, meta = slab.upload(torch.device(CPU))
    assert bytes(data[:6].tolist()) == b"abcdef"
    s = Column.strings_from_list(["x", None, "yz"], device=CPU)
    assert s.to_pylist() == ["x", None, "yz"]
    # the slab once; the strings' offsets, chars and validity
    assert torch_shim.COUNTS["torch.h2d"] == 4


def test_schedule_equals_jax_injector(shim):
    """A seeded percent rule injects on the same interceptions as the JAX
    package's injector given the same rule (the shim adds no dice)."""
    cfg = {"seed": 7, "sites": {"torch.h2d": {"percent": 30,
                                              "injectionType": "oom"}}}
    injector.get_injector().load_dict(cfg)
    injector.enable()
    got = []
    for _ in range(60):
        try:
            _upload()
            got.append(False)
        except InjectedOomError:
            got.append(True)
    theirs = jinjector.FaultInjector()
    theirs.load_dict(cfg)
    theirs.enable()
    want = []
    for _ in range(60):
        try:
            want.append(theirs.check("torch.h2d") is not None)
        except jinjector.InjectedOomError:
            want.append(True)
    assert got == want and any(got) and not all(got)


def test_launch_and_graph_replay_seams(monkeypatch):
    """``torch.launch`` covers every kernel launch and graph replay (fakes
    on the CPU: nothing launches here), and passes the call through."""
    calls = []
    monkeypatch.setattr(_native, "launch",
                        lambda name, fn, dev, *a: calls.append((name, fn)))

    class Graph:
        def replay(self):
            calls.append(("graph", "replay"))
    torch_shim.install()
    try:
        _rules("torch.launch", percent=100, interceptionCount=2,
               injectionType="oom")
        for _ in range(2):
            with pytest.raises(InjectedOomError):
                _native.launch("ragged", "srjt_unpack_rows", None)
        _native.launch("ragged", "srjt_unpack_rows", None)
        compiled.graph_replay(Graph())
        assert calls == [("ragged", "srjt_unpack_rows"), ("graph", "replay")]
        assert torch_shim.COUNTS["torch.launch"] == 4
        assert torch_shim.COUNTS["torch.launch.injected"] == 2
    finally:
        torch_shim.uninstall()
        injector.disable()


def test_build_seam_raises_before_building(shim):
    _rules("torch.build", percent=100, injectionType="substitute",
           substituteResult=0)
    with pytest.raises(InjectedDeviceError):    # a substitute escalates
        _native.build(("plain_strings.cpp",))
    with pytest.raises(InjectedDeviceError):
        _native.library("ragged")


def test_executor_retries_transient_then_succeeds(shim):
    _rules("torch.h2d", percent=100, interceptionCount=2,
           injectionType="oom")
    ex = ResilientExecutor(max_retries=3)
    col = ex.submit(_upload)
    assert col.data.tolist() == list(range(64))
    assert ex.retry_count == 2 and not ex.quarantined


def test_executor_quarantines_on_fatal(shim):
    _rules("torch.h2d", percent=100, interceptionCount=1,
           injectionType="device_error")
    ex = ResilientExecutor(max_retries=3)
    with pytest.raises(DeviceQuarantined):
        ex.submit(_upload)
    assert ex.quarantined
