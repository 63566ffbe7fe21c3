"""The port's scan staging tier (``parquet/staging.py`` and the scan's
walk/stage pipeline, donation, arena and spill hooks and counters)
against the JAX package, on the CPU.

One pyarrow file (the one of ``tests/test_bytepath.py``: 6000 rows of
int32, float64, low-cardinality int64, dictionary strings, PLAIN-sized
strings and 40%-null int64, row groups of 1500) is scanned once by the
JAX package's ``scan_table``; the port's ``scan_table`` must give the same
bytes (data, offsets, validity; dictionary columns materialized) in every
staging mode: ``SRJT_STAGE_SLABS`` × ``SRJT_STAGE_PIPELINE`` × the slab
cap × ``SRJT_SCAN_DONATE``.  The 4096-byte cap lies under the stager's
1 MiB floor, so those cases lower the floor (``staging.MIN_SLAB_BYTES``)
to let many small waves form on this small file.
"""

import torch_one_thread  # noqa: F401  (first: one intra-op thread)
import io
import itertools
import math
import threading

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

import jax.numpy as jnp  # noqa: F401  (JAX on the CPU, set by conftest)
from spark_rapids_jni_tpu.column import DictColumn as JDictColumn
from spark_rapids_jni_tpu.parquet import decode as jdecode
from spark_rapids_jni_tpu.parquet import device_scan as jscan
from spark_rapids_jni_tpu.utils import metrics as jmetrics

import spark_rapids_jni_tpu_torch as pt
from spark_rapids_jni_tpu_torch.exec.prefetch import Prefetcher
from spark_rapids_jni_tpu_torch.memory import budget
from spark_rapids_jni_tpu_torch.parquet import device_scan as pscan
from spark_rapids_jni_tpu_torch.parquet import staging
from spark_rapids_jni_tpu_torch.utils import flight, metrics
from torch_jax_columns import payload
from torch_jni_env import load_jax_native

CPU = "cpu"
N = 6000
SMALL_CAP = 4096

# the JAX package's scan may reach its native library: load it at import,
# as tests/test_torch_scan.py does (workers race to build it)
JAX_NATIVE_LOADED = load_jax_native()

# the counters the page walk adds, named as the JAX package names them
WALK_COUNTERS = ("parquet.chunks", "parquet.bytes.compressed",
                 "parquet.bytes.uncompressed", "parquet.pages.dict",
                 "parquet.pages.data", "parquet.codec.uncompressed.chunks")


def _write(t: pa.Table, **kw) -> bytes:
    buf = io.BytesIO()
    pq.write_table(t, buf, **kw)
    return buf.getvalue()


@pytest.fixture(scope="module")
def raw() -> bytes:
    rng = np.random.default_rng(29)
    nn = rng.integers(0, 1000, N).astype(np.int64)
    t = pa.table({
        "a": pa.array(rng.integers(0, 1000, N).astype(np.int32)),
        "f": pa.array(rng.standard_normal(N)),
        "low": pa.array(rng.integers(0, 50, N).astype(np.int64)),
        "d": pa.array([f"val{v}" for v in rng.integers(0, 30, N)]),
        "s": pa.array([f"s{v}" for v in rng.integers(0, 2000, N)]),
        "nn": pa.array([None if m else int(v) for v, m in
                        zip(nn, rng.random(N) < 0.4)], pa.int64()),
    })
    return _write(t, compression="NONE", row_group_size=1500)


@pytest.fixture(scope="module")
def jax_scan(raw):
    """The JAX package's scan of the file, and the counters it recorded."""
    if not JAX_NATIVE_LOADED:
        pytest.fail("the JAX package's native library does not load")
    was = jmetrics.enabled()
    jmetrics.set_enabled(True)
    jmetrics.reset()
    try:
        table = jscan.scan_table(raw)
        counters = dict(jmetrics.snapshot()["counters"])
    finally:
        jmetrics.set_enabled(was)
    return table, counters


@pytest.fixture
def env(monkeypatch):
    """Sets staging knobs for one test (and lowers the cap's floor)."""
    def set_env(**values):
        for k, v in values.items():
            monkeypatch.setenv(k, v)
    monkeypatch.setattr(staging, "MIN_SLAB_BYTES", 1)
    return set_env


@pytest.fixture
def recording():
    """Metrics and the flight recorder on, and reset, for one test."""
    was_m, was_f = metrics.enabled(), flight.enabled()
    metrics.set_enabled(True)
    metrics.reset()
    flight.set_enabled(True)
    flight.reset()
    yield
    metrics.set_enabled(was_m)
    flight.set_enabled(was_f)


def _plain(col):
    return col.materialize() if isinstance(col, pt.DictColumn) else col


def _jplain(col):
    return col.materialize() if isinstance(col, JDictColumn) else col


def assert_same_bytes(got: pt.Table, want) -> None:
    """The port's table holds the JAX table's bytes: dtypes, validity,
    offsets and payload (FLOAT64 as its 8 bytes a value in both)."""
    assert got.num_columns == want.num_columns
    for i, (p, j) in enumerate(zip(got.columns, want.columns)):
        p, j = _plain(p), _jplain(j)
        assert (int(p.dtype.id), p.dtype.scale) == (int(j.dtype.id),
                                                    j.dtype.scale), i
        np.testing.assert_array_equal(p.validity_or_true().numpy(),
                                      np.asarray(j.validity_or_true()),
                                      err_msg=f"column {i}: validity")
        if p.offsets is not None:
            np.testing.assert_array_equal(p.offsets.numpy(),
                                          np.asarray(j.offsets),
                                          err_msg=f"column {i}: offsets")
            want_data = np.asarray(j.data)
        else:
            want_data = payload(j)
        np.testing.assert_array_equal(
            np.ascontiguousarray(p.data.numpy()).view(np.uint8).reshape(-1),
            np.ascontiguousarray(want_data).view(np.uint8).reshape(-1),
            err_msg=f"column {i}: data")


MODES = list(itertools.product(("0", "1"), ("0", "1"),
                               (str(SMALL_CAP), "64m"), ("0", "1")))


@pytest.mark.parametrize("slabs,pipeline,cap,donate", MODES)
def test_every_staging_mode_equals_jax(raw, jax_scan, env, slabs, pipeline,
                                       cap, donate):
    env(SRJT_STAGE_SLABS=slabs, SRJT_STAGE_PIPELINE=pipeline,
        SRJT_STAGE_SLAB_BYTES=cap, SRJT_SCAN_DONATE=donate)
    assert_same_bytes(pscan.scan_table(raw, device=CPU), jax_scan[0])


def test_flush_and_overlap_events(raw, env, recording):
    env(SRJT_STAGE_SLABS="1", SRJT_STAGE_PIPELINE="1")
    pscan.scan_table(raw, device=CPU)
    evs = flight.events()
    flushes = [e for e in evs if e["kind"] == "parquet.stage.flush"]
    assert flushes and sum(e["slabs"] for e in flushes) >= 1
    assert flushes[-1]["bytes"] == metrics.counter_value(
        "parquet.stage.slab_bytes") > 0
    assert flushes[-1]["buffers"] == metrics.counter_value(
        "parquet.stage.buffers") > 0
    overlap = [e for e in evs if e["kind"] == "parquet.stage.overlap"]
    assert overlap and overlap[-1]["columns"] > 1
    assert overlap[-1]["overlap_ms"] >= 0 and overlap[-1]["walk_ms"] > 0


def _spy_stagers(monkeypatch) -> list:
    made = []

    class Spy(staging.SlabStager):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            made.append(self)
    monkeypatch.setattr(pscan, "SlabStager", Spy)
    return made


@pytest.mark.parametrize("pipeline", ["0", "1"])
def test_small_cap_waves(raw, jax_scan, env, recording, monkeypatch,
                         pipeline):
    env(SRJT_STAGE_SLABS="1", SRJT_STAGE_PIPELINE=pipeline,
        SRJT_STAGE_SLAB_BYTES=str(SMALL_CAP))
    made = _spy_stagers(monkeypatch)
    assert_same_bytes(pscan.scan_table(raw, device=CPU), jax_scan[0])
    (st,) = made
    assert st.slab_cap == SMALL_CAP
    # no wave passes the cap but one holding a single range; so the
    # transfers are at least ⌈bytes / cap⌉ over the waves within the cap,
    # plus one for each range longer than the cap (a range is never split)
    for nbytes, items in zip(st.wave_bytes, st.wave_items):
        assert nbytes <= SMALL_CAP or items == 1, (nbytes, items)
    capped = [b for b in st.wave_bytes if b <= SMALL_CAP]
    alone = len(st.wave_bytes) - len(capped)
    assert st.transfers == len(st.wave_bytes) >= (
        math.ceil(sum(capped) / SMALL_CAP) + alone)
    assert alone and max(st.wave_items) > 1
    assert metrics.counter_value("parquet.stage.transfers") == st.transfers


def test_stager_never_splits_a_range(env):
    env(SRJT_STAGE_SLABS="1")
    st = staging.SlabStager(torch.device(CPU), slab_cap=64)
    rng = np.random.default_rng(3)
    parts = [rng.integers(0, 256, n, dtype=np.uint8) for n in (10, 40, 100,
                                                              5, 0, 30)]
    refs = [st.add([p[:len(p) // 2], p[len(p) // 2:]]) for p in parts]
    table = np.arange(12, dtype=np.int64)
    tref = st.add_meta(table)
    st.flush()
    for p, r in zip(parts, refs):
        assert r.get().numpy().tobytes() == p.tobytes()
    assert tref.get().tolist() == table.tolist()
    # 10 + 40 fit; 100 ships alone; 5 + 30 and the 96-byte table don't
    assert st.wave_items == [2, 1, 2, 1]
    assert st.wave_bytes[1] == 104 and st.wave_bytes[3] == 96
    assert st.transfers == 4 and st.buffers == 6


def test_stager_per_range_mode_uploads_through_the_funnel(env, monkeypatch):
    env(SRJT_STAGE_SLABS="0")
    calls = []
    real = pt.column.upload
    monkeypatch.setattr(pt.column, "upload",
                        lambda host, dev: calls.append(len(host)) or
                        real(host, dev))
    st = staging.SlabStager(torch.device(CPU))
    a = st.add([b"abc", b"de"])
    t = st.add_meta(np.array([7, 8], np.int64))
    assert st.flush() == 2 and calls == [5, 2]
    assert bytes(a.get().tolist()) == b"abcde" and t.get().tolist() == [7, 8]
    assert st.transfers == 2 and st.wave_bytes == [5, 16]


def test_producer_error_reaches_caller(raw, env, monkeypatch):
    env(SRJT_STAGE_SLABS="1", SRJT_STAGE_PIPELINE="1")
    monkeypatch.setattr(pscan, "PIPELINE_DEPTH", 1)
    walk = pscan._walk_chunk
    seen = []

    def failing(mv, chunk, leaf, rec=False):
        seen.append(leaf.name)
        if leaf.name == "d":
            raise OSError("walk failed on d")
        return walk(mv, chunk, leaf, rec)
    monkeypatch.setattr(pscan, "_walk_chunk", failing)
    with pytest.raises(OSError, match="walk failed on d"):
        pscan.scan_table(raw, device=CPU)
    assert "d" in seen
    assert not [t for t in threading.enumerate()
                if t.name == "srjt-scan-walk" and t.is_alive()]


def test_staging_error_stops_the_producer(raw, env, monkeypatch):
    env(SRJT_STAGE_SLABS="1", SRJT_STAGE_PIPELINE="1")
    monkeypatch.setattr(pscan, "PIPELINE_DEPTH", 1)
    stage = pscan._stage_column

    def failing(walks, leaf, st):
        if leaf.name == "f":
            raise ValueError("staging failed on f")
        return stage(walks, leaf, st)
    monkeypatch.setattr(pscan, "_stage_column", failing)
    with pytest.raises(ValueError, match="staging failed on f"):
        pscan.scan_table(raw, device=CPU)
    assert not [t for t in threading.enumerate()
                if t.name == "srjt-scan-walk" and t.is_alive()]


@pytest.fixture
def ledger(monkeypatch):
    """The memory ledger on for one test."""
    monkeypatch.setenv("SRJT_HBM_BUDGET", "1g")
    budget.set_enabled(None)
    budget.reset()
    yield
    monkeypatch.delenv("SRJT_HBM_BUDGET", raising=False)
    budget.set_enabled(None)
    budget.reset()


def test_scan_reserves_arena_range(raw, env, recording, ledger,
                                   monkeypatch):
    env(SRJT_STAGE_SLABS="1")
    held = []
    charge = budget.charge

    def spy(nbytes, tag="buf", **kw):
        held.append((tag, nbytes, budget.in_use()))
        return charge(nbytes, tag=tag, **kw)
    monkeypatch.setattr(budget, "charge", spy)
    made = _spy_stagers(monkeypatch)
    pscan.scan_table(raw, device=CPU)
    scans = [(n, before) for tag, n, before in held if tag == "parquet.scan"]
    assert scans == [(made[0].staged_bytes, 0)]
    assert 0 < made[0].staged_bytes <= made[0].slab_bytes
    assert metrics.counter_value("arena.reserve.parquet.scan") == 1
    assert budget.in_use() == 0                 # released after the decode


def test_scan_output_registered_for_spill(raw, ledger, monkeypatch):
    calls = []
    register = pscan.mspill.register_table

    def spy(table, tag):
        calls.append((table, tag))
        return register(table, tag)
    monkeypatch.setattr(pscan.mspill, "register_table", spy)
    out = pscan.scan_table(raw, device=CPU)
    assert [(t is out, tag) for t, tag in calls] == [(True,
                                                      "parquet.scan_out")]


@pytest.mark.parametrize("pipeline", ["0", "1"])
def test_scan_counts_equal_jax_read_table(raw, jax_scan, env, recording,
                                          pipeline):
    env(SRJT_STAGE_SLABS="1", SRJT_STAGE_PIPELINE=pipeline)
    pscan.scan_table(raw, device=CPU)
    mine = metrics.snapshot()["counters"]
    was = jmetrics.enabled()
    jmetrics.set_enabled(True)
    jmetrics.reset()
    try:
        jdecode.read_table(raw)
        theirs = jmetrics.snapshot()["counters"]
    finally:
        jmetrics.set_enabled(was)
    for name in WALK_COUNTERS:
        assert mine.get(name) == theirs.get(name), name
    assert mine["parquet.chunks"] == 24
    for name in ("parquet.device_cols", "parquet.host_fallback_cols"):
        assert mine.get(name, 0) == jax_scan[1].get(name, 0), name


def test_prefetch_ingest_attribution(raw, env, recording):
    env(SRJT_STAGE_SLABS="1")
    p = Prefetcher(depth=1)
    try:
        assert p.stage("k", lambda: pscan.scan_table(raw, device=CPU))
        # wait for the staging thread's load: taking earlier would race
        # it and run the loader inline (a miss, unattributed)
        p._slots["k"]["done"].wait(timeout=60)
        assert p.take("k").num_rows == N
    finally:
        p.close()
    evs = [e for e in flight.events() if e["kind"] == "exec.prefetch.ingest"]
    assert evs, "the prefetch load did not attribute its staging work"
    assert evs[-1]["slab_bytes"] > 0 and evs[-1]["transfers"] >= 1


@pytest.mark.parametrize("pipeline", ["0", "1"])
def test_forced_donation_strict_sanitizer(raw, jax_scan, env, recording,
                                          pipeline):
    from spark_rapids_jni_tpu_torch.analysis import sanitize
    env(SRJT_SCAN_DONATE="1", SRJT_SANITIZE="strict",
        SRJT_STAGE_PIPELINE=pipeline, SRJT_STAGE_SLAB_BYTES=str(SMALL_CAP))
    sanitize.reset()
    try:
        donated = pscan.scan_table(raw, device=CPU)
    finally:
        sanitize.reset()
    assert_same_bytes(donated, jax_scan[0])
    (ev,) = [e for e in flight.events() if e["kind"] == "parquet.scan.donate"]
    assert ev["buffers"] > 1 and ev["bytes"] == metrics.counter_value(
        "parquet.scan.donated_bytes") > 0


def test_alias_of_a_dropped_wave_is_caught(monkeypatch):
    """The strict sanitizer's check that donation relies on: a decoded
    column holding a wave's storage raises."""
    monkeypatch.setenv("SRJT_SANITIZE", "strict")
    wave = torch.arange(64, dtype=torch.uint8)
    owned = pt.Column(pt.uint8, wave[8:16].clone())
    aliased = pt.Column(pt.uint8, wave[8:16])
    addr = wave.untyped_storage().data_ptr()
    pscan._check_no_alias([owned], [(addr, 64)])
    with pytest.raises(RuntimeError, match="alias a donated slab wave"):
        pscan._check_no_alias([owned, aliased], [(addr, 64)])
    monkeypatch.setenv("SRJT_SANITIZE", "0")
    pscan._check_no_alias([aliased], [(addr, 64)])      # off: no check


def test_donate_knob_resolution(monkeypatch):
    for raw_value, cpu, cuda in (("auto", False, True), ("1", True, True),
                                 ("0", False, False), ("off", False, False)):
        monkeypatch.setenv("SRJT_SCAN_DONATE", raw_value)
        assert staging.donate_enabled(torch.device("cpu")) is cpu
        assert staging.donate_enabled(torch.device("cuda")) is cuda


def test_one_column_is_not_pipelined(raw, env, recording):
    env(SRJT_STAGE_SLABS="1", SRJT_STAGE_PIPELINE="1")
    pscan.scan_table(raw, columns=["s"], device=CPU)
    assert not [e for e in flight.events()
                if e["kind"] == "parquet.stage.overlap"]
    assert [e["kind"] for e in flight.events()].count(
        "parquet.stage.flush") == 1


def test_pipeline_is_off_by_default(raw, env, recording, monkeypatch):
    """Without the knob a scan of many columns walks then stages on the
    calling thread: no producer, no overlap event."""
    monkeypatch.delenv("SRJT_STAGE_PIPELINE", raising=False)
    env(SRJT_STAGE_SLABS="1")
    started = []
    thread = threading.Thread

    class Spy(thread):
        def start(self):
            started.append(self.name)
            super().start()
    monkeypatch.setattr(threading, "Thread", Spy)
    pscan.scan_table(raw, device=CPU)
    assert "srjt-scan-walk" not in started
    assert not [e for e in flight.events()
                if e["kind"] == "parquet.stage.overlap"]


def test_ref_read_before_its_wave_ships_raises(env):
    """A range is read only after a flush: reading it while its wave
    still fills raises and ships nothing."""
    st = staging.SlabStager(torch.device(CPU))
    ref = st.add([b"early"])
    with pytest.raises(RuntimeError, match="before it shipped"):
        ref.get()
    assert st.transfers == 0
    st.flush()
    assert bytes(ref.get().tolist()) == b"early"
    st.release()


def test_no_wave_outlives_the_scan(raw, env, monkeypatch):
    """Without donation every ref's view goes when the scan returns, and
    a ref read after that raises."""
    env(SRJT_STAGE_SLABS="1", SRJT_SCAN_DONATE="0")
    made = _spy_stagers(monkeypatch)
    pscan.scan_table(raw, device=CPU)
    (st,) = made
    assert not st.dropped_bytes and st.dropped == set(range(st.transfers))
    assert not st._refs
    other = staging.SlabStager(torch.device(CPU))
    ref = other.add([b"late"])
    other.flush()
    assert bytes(ref.get().tolist()) == b"late"
    other.release()
    with pytest.raises(RuntimeError, match="dropped"):
        ref.get()


def test_concurrent_pipelined_scans_stress(raw, jax_scan, env, monkeypatch):
    """More pipelined scans at once than cores, the interpreter switching
    threads every microsecond: each scan's producer and queue are its
    own, so every table still holds the JAX package's bytes."""
    import os
    import sys
    env(SRJT_STAGE_SLABS="1", SRJT_STAGE_PIPELINE="1",
        SRJT_STAGE_SLAB_BYTES=str(SMALL_CAP))
    monkeypatch.setattr(pscan, "PIPELINE_DEPTH", 1)
    want = [jax_scan[0].columns[i] for i in (0, 4)]
    results, errors = [], []

    def scan():
        try:
            results.append(pscan.scan_table(raw, columns=["a", "s"],
                                            device=CPU))
        except Exception as e:     # reported by the assertion below
            errors.append(e)

    n = (os.cpu_count() or 1) + 1
    was = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=scan) for _ in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(was)
    assert not any(t.is_alive() for t in threads)
    assert not errors and len(results) == n
    for got in results:
        assert_same_bytes(got, type(jax_scan[0])(want))
