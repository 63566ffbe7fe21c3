"""The port's HBM arena (``memory/arena.py``) and host-mirror cache
(``utils/hostcache.py``) against the JAX package's, on the CPU.

Mirrors ``tests/test_memory_arena.py``: size classes and slab identity
reuse, the pooled zeros, typed budget exhaustion, soft reservations,
query budgets, spill and fault-back bit for bit through the join's
build-index cache, ``SRJT_INDEX_CACHE_CAP`` eviction, and joins under a
tiny budget equal to unbudgeted ones bit for bit with spills recorded.
The pooled zeros are shared, so no op may write them in place: their
``_version`` stays put across joins, groupbys and gathers that take
them.  The host mirrors key on weak identity and ``_version``, with an
LRU byte cap (``SRJT_HOSTCACHE_CAP``).  Results are held against the
JAX package's joins on the same seeded numpy inputs, exactly.
"""

import torch_one_thread  # noqa: F401  (first: one intra-op thread)
import os

import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu.memory import arena as jarena
from spark_rapids_jni_tpu.ops import inner_join as jinner_join
from spark_rapids_jni_tpu.ops import left_join as jleft_join
from spark_rapids_jni_tpu.utils import hostcache as jhostcache

from spark_rapids_jni_tpu_torch.column import Column, Table
from spark_rapids_jni_tpu_torch.memory import (HbmBudgetExceeded, arena,
                                               budget, spill)
from spark_rapids_jni_tpu_torch.ops import groupby_aggregate, join_plan
from spark_rapids_jni_tpu_torch.ops.join import (inner_join, join_indices,
                                                left_join)
from spark_rapids_jni_tpu_torch.rowconv.convert import slice_table
from spark_rapids_jni_tpu_torch.utils import hostcache, metrics

from torch_jax_columns import assert_same_table, to_jax

CPU = "cpu"
KNOBS = ("SRJT_HBM_ARENA", "SRJT_HBM_BUDGET", "SRJT_INDEX_CACHE_CAP",
         "SRJT_ARENA_ZEROS_CAP", "SRJT_HOSTCACHE_CAP")


@pytest.fixture(autouse=True)
def _arena_clean():
    """Each test starts with a clean, enabled arena and leaves no trace."""
    saved = {k: os.environ.get(k) for k in KNOBS}
    os.environ["SRJT_HBM_ARENA"] = "1"
    os.environ.pop("SRJT_HBM_BUDGET", None)
    budget.set_enabled(None)
    arena.reset()
    spill.reset()
    budget.reset()
    metrics.reset()
    join_plan._INDEX_CACHE.clear()
    yield
    for k, v in saved.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    join_plan._INDEX_CACHE.clear()
    arena.reset()
    spill.reset()
    budget.reset()
    metrics.reset()
    metrics.set_enabled(None)
    budget.set_enabled(None)


def _col(a):
    return Column.from_numpy(np.asarray(a), device=CPU)


# --- slabs and zeros ---------------------------------------------------------


@pytest.mark.parametrize("n", [1, 255, 256, 257, 1000, 5000, 123456, 1 << 20])
def test_size_class_equals_jax(n):
    cls = arena.size_class(n)
    assert cls == jarena.size_class(n)
    assert cls >= n and cls % 256 == 0


def test_slab_identity_reuse_and_trim():
    s1 = arena.alloc(1000, tag="t", device=CPU)
    assert s1.nbytes == 1024 and s1.data.numel() == 1024
    buf = s1.data
    buf.fill_(7)
    arena.free(s1)
    arena.free(s1)                              # a second free: no-op
    s2 = arena.alloc(900, tag="t", device=CPU)  # same class, same tensor
    assert s2.data is buf and not bool(s2.data.any())   # zeroed again
    arena.free(s2)
    st = arena.stats()
    assert st["pooled_bytes"] == 1024 and st["free_slabs"] == {"1024@cpu": 1}
    assert st["peak_bytes"] == 1024
    assert arena.trim() == 1024
    assert arena.stats()["pooled_bytes"] == 0


def test_zeros_pooling_identity_and_cap():
    a = arena.zeros(128, torch.int32, CPU)
    assert arena.zeros(128, torch.int32, CPU) is a
    assert not bool(a.any())
    assert arena.zeros((128,), torch.int64, CPU) is not a
    os.environ["SRJT_ARENA_ZEROS_CAP"] = "0"
    assert arena.zeros(64, torch.int32, CPU) is not arena.zeros(
        64, torch.int32, CPU)                   # pooling off
    budget.set_enabled(False)
    assert arena.zeros(128, torch.int32, CPU) is not a      # arena off


def test_pooled_zeros_never_written_by_joins():
    """A left join against an empty build side nulls every build column
    with the pooled zeros; the ops downstream (gather, groupby, a second
    join) never write them: their ``_version`` stays put, and the result
    is the JAX package's."""
    rng = np.random.default_rng(3)
    left = Table([_col(rng.integers(0, 50, 400).astype(np.int64)),
                  _col(rng.integers(0, 9, 400).astype(np.int32))])
    right = Table([_col(np.zeros(0, np.int64)), _col(np.zeros(0, np.int64)),
                   Column.strings_from_list([], device=CPU)])
    out = left_join(left, right, 0, 0)
    pooled = arena.pooled_zeros()
    assert pooled and all(any(t is p for p in pooled)
                          for t in (out[2].data, out[2].validity))
    versions = [p._version for p in pooled]
    g = groupby_aggregate(out, [1], [(3, "sum"), (2, "count")])
    again = left_join(out, right, 1, 0)
    inner_join(out, Table([_col(np.arange(9, dtype=np.int32))]), 1, 0)
    assert [p._version for p in pooled] == versions
    assert again.num_columns == 8 and again[5].validity is not None
    want = jleft_join(to_jax(left), to_jax(right), 0, 0)
    assert_same_table(out, want)
    assert g.num_rows == len(np.unique(left[1].data.numpy()))


# --- budgets and reservations ------------------------------------------------


def test_budget_exhaustion_raises_typed():
    os.environ["SRJT_HBM_BUDGET"] = "4k"
    with pytest.raises(HbmBudgetExceeded) as ei:
        arena.alloc(1 << 20, tag="big", device=CPU)
    err = ei.value
    assert (err.requested, err.limit, err.tag) == (1 << 20, 4096, "arena.big")
    assert budget.in_use() == 0


def test_soft_reserve_completes_over_budget():
    os.environ["SRJT_HBM_BUDGET"] = "1k"
    metrics.set_enabled(True)
    with arena.reserve(1 << 20, tag="join.expand"):
        assert budget.in_use() == 1 << 20
    assert budget.in_use() == 0
    snap = metrics.snapshot()["counters"]
    assert snap.get("arena.budget.soft_over", 0) >= 1
    assert snap.get("arena.reserve.join.expand", 0) == 1


def test_query_budget_scopes_limit():
    with budget.query_budget("q", limit_bytes="2k") as q:
        assert budget.limit_now() == 2048
        with pytest.raises(HbmBudgetExceeded) as ei:
            arena.alloc(8192, tag="x", device=CPU)
        assert ei.value.query == "q" and q.peak == 0


def test_reserve_noop_when_disabled_and_arena_knob_enables():
    budget.set_enabled(False)
    assert arena.reserve(1 << 30) is arena.reserve(1 << 30)
    with arena.reserve(1 << 30):
        assert budget.in_use() == 0
    os.environ["SRJT_HBM_ARENA"] = "0"
    budget.set_enabled(None)
    assert not budget.enabled()
    os.environ["SRJT_HBM_ARENA"] = "1"
    budget.set_enabled(None)
    assert budget.enabled()


# --- spill and fault-back through the build-index cache ----------------------


def test_join_index_spill_faultback_identical():
    keys = torch.arange(4096, dtype=torch.int64) % 97
    ix1 = join_plan.build_index(keys, None, True)
    assert join_plan.build_index(keys, None, True) is ix1
    assert spill.resident_count() == 1
    assert spill.reclaim(1) > 0
    assert join_plan._INDEX_CACHE.nbytes == 0
    ix2 = join_plan.build_index(keys, None, True)
    assert ix2 is not ix1
    assert (ix2.kind, ix2.n_valid, ix2.kmin, ix2.span, ix2.unique) == \
        (ix1.kind, ix1.n_valid, ix1.kmin, ix1.span, ix1.unique)
    for lane in ("row_ids", "sorted_keys", "lut_lo", "lut_cnt"):
        a, b = getattr(ix1, lane), getattr(ix2, lane)
        assert (a is None) == (b is None)
        if a is not None:
            assert torch.equal(a, b)
    assert join_plan.build_index(keys, None, True) is ix2
    assert join_plan.COUNTS["build_index.faultback"] >= 1
    assert join_plan._INDEX_CACHE.nbytes == join_plan._index_nbytes(ix2)


def test_index_cache_capacity_eviction_by_knob():
    os.environ["SRJT_INDEX_CACHE_CAP"] = "1k"
    join_plan.reset_counts()
    k1 = torch.arange(4096, dtype=torch.int64) % 31
    k2 = torch.arange(4096, dtype=torch.int64) % 13
    join_plan.build_index(k1, None, True)
    join_plan.build_index(k2, None, True)
    assert join_plan.COUNTS["build_index.evictions"] >= 1
    assert join_plan._INDEX_CACHE.nbytes <= join_plan._index_nbytes(
        join_plan.build_index(k2, None, True))
    del os.environ["SRJT_INDEX_CACHE_CAP"]
    assert join_plan._index_cache_cap() == join_plan.INDEX_CACHE_CAP


def test_index_cache_takes_its_own_lock_with_the_budget_off():
    """With the budget off the build-index cache takes only its own lock:
    a join goes on while another thread holds the budget's.  With the
    budget on, the budget's lock comes first (the spiller's order), so
    four threads joining while a fifth reclaims all finish, each result
    equal to the serial one."""
    import threading
    assert join_plan._INDEX_CACHE._mu is not budget._LOCK
    budget.set_enabled(False)
    held, done = threading.Event(), threading.Event()

    def holder():
        with budget._LOCK:
            held.set()
            done.wait(30)
    th = threading.Thread(target=holder, daemon=True)
    th.start()
    assert held.wait(30)
    got = []
    worker = threading.Thread(target=lambda: got.append(
        join_plan.build_index(torch.arange(300) % 17, None, True)),
        daemon=True)
    worker.start()
    worker.join(30)
    done.set()
    th.join(30)
    assert got and not worker.is_alive()

    budget.set_enabled(True)
    rng = np.random.default_rng(8)
    builds = [_col(rng.integers(0, 50, 400)) for _ in range(4)]
    probe = _col(rng.integers(0, 50, 2000))
    want = [join_indices(probe, b) for b in builds]
    join_plan._INDEX_CACHE.clear()
    errors, outs = [], {}

    def joiner(i):
        try:
            for _ in range(20):
                outs[i] = join_indices(probe, builds[i])
        except BaseException as e:          # pragma: no cover
            errors.append(e)

    def reclaimer():
        for _ in range(40):
            with budget._LOCK:
                spill.reclaim(1 << 30)
    threads = [threading.Thread(target=joiner, args=(i,), daemon=True)
               for i in range(4)]
    threads.append(threading.Thread(target=reclaimer, daemon=True))
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert not any(t.is_alive() for t in threads), "a lock cycle"
    assert not errors, errors
    for i, w in enumerate(want):
        for a, b in zip(outs[i], w):
            assert torch.equal(a, b)


def test_joins_under_tiny_budget_equal_unbudgeted_and_jax():
    """Two joins (a duplicated build side, so the pair expansion reserves)
    under a 256-byte budget: the second index's registration spills the
    first, and the results equal unbudgeted runs bit for bit and the JAX
    package's joins."""
    rng = np.random.default_rng(5)
    fact = Table([_col(rng.integers(0, 60, 3000).astype(np.int64)),
                  _col(rng.integers(0, 40, 3000).astype(np.int64)),
                  _col(rng.integers(1, 99, 3000).astype(np.int64))])
    d1 = Table([_col(rng.integers(0, 60, 200).astype(np.int64)),
                _col(rng.integers(0, 5, 200).astype(np.int32))])
    d2 = Table([_col(np.arange(40, dtype=np.int64)),
                _col((np.arange(40) % 3).astype(np.int32))])

    def run():
        a = inner_join(fact, d1, 0, 0)
        return a, inner_join(a, d2, 1, 0)

    os.environ["SRJT_HBM_BUDGET"] = "256"
    budget.set_enabled(None)
    metrics.set_enabled(True)
    with budget.query_budget("two_joins"):
        got = run()
    snap = metrics.snapshot()["counters"]
    assert snap.get("arena.spill.events", 0) >= 1, snap
    assert snap.get("arena.reserve.join.expand", 0) >= 1, snap
    budget.set_enabled(False)
    want = run()
    for g, w in zip(got, want):
        for a, b in zip(g.columns, w.columns):
            assert torch.equal(a.data, b.data)
    assert_same_table(got[0], jinner_join(to_jax(fact), to_jax(d1), 0, 0))


# --- the host-mirror cache ---------------------------------------------------


def test_host_mirror_seeded_at_birth_and_keyed_on_version():
    col = Column.strings_from_list(["ab", None, "cde", ""], device=CPU)
    h = hostcache.peek(col.offsets)
    assert h is not None and h.tolist() == [0, 2, 2, 5, 5]
    assert col.to_pylist() == ["ab", None, "cde", ""]
    sliced = slice_table(Table([col]), 2, 4)[0]
    assert sliced.to_pylist() == ["cde", ""]
    col.offsets.add_(0)                       # an in-place write
    assert hostcache.peek(col.offsets) is None
    t = torch.arange(10, dtype=torch.int32)
    assert hostcache.host_i64(t).dtype == np.int64
    assert hostcache.peek(t) is not None


def test_host_mirror_byte_cap_equals_jax_lru():
    """The byte-capped LRU evicts what the JAX package's evicts, and each
    eviction counts."""
    metrics.set_enabled(True)
    evicted = []
    mine = hostcache.WeakIdMemo(cap_bytes=4000,
                                on_evict=lambda: evicted.append(1))
    theirs = jhostcache.WeakIdMemo(cap_bytes=4000)
    keys = [torch.zeros(1) for _ in range(6)]
    jkeys = [np.zeros(1) for _ in range(6)]
    # numpy arrays are weak-referenceable keys for the JAX package's memo
    for i, (k, jk) in enumerate(zip(keys, jkeys)):
        mine.put((k,), np.zeros(100 * (i + 1), np.int64))
        theirs.put((jk,), np.zeros(100 * (i + 1), np.int64))
        if i == 1:                      # a read is a use: key 0 goes last
            assert mine.get((keys[0],)) is not None
            assert theirs.get((jkeys[0],)) is not None
    held = [mine.get((k,)) is not None for k in keys]
    assert held == [theirs.get((k,)) is not None for k in jkeys]
    assert mine.nbytes() == theirs.nbytes() <= 4000 + 4800
    assert len(evicted) == held.count(False)
    os.environ["SRJT_HOSTCACHE_CAP"] = "1k"
    before = metrics.counter_value("arena.hostcache.evictions")
    alive = [torch.zeros(1) for _ in range(3)]
    for t in alive:
        hostcache.seed(t, np.zeros(100, np.int64))
    assert metrics.counter_value("arena.hostcache.evictions") > before


def test_host_mirror_drops_with_tensor():
    t = torch.arange(5)
    hostcache.seed(t, np.arange(5))
    n = hostcache.stats()["entries"]
    del t
    import gc
    gc.collect()
    assert hostcache.stats()["entries"] == n - 1


def test_spill_reuses_matching_mirror():
    from spark_rapids_jni_tpu_torch.memory.spill import _host_copy
    metrics.set_enabled(True)
    t = torch.arange(8, dtype=torch.int64)
    mirror = np.arange(8, dtype=np.int64)
    hostcache.seed(t, mirror)
    h = _host_copy(t)
    assert np.shares_memory(h.numpy(), mirror)
    assert metrics.counter_value("arena.spill.mirror_reuse") == 1
    other = torch.arange(8, dtype=torch.int32)
    hostcache.seed(other, mirror)         # an int64 mirror: cast on the host
    h = _host_copy(other)
    assert h.dtype == torch.int32 and torch.equal(h, other)
    assert metrics.counter_value("arena.spill.mirror_reuse") == 2
    short = torch.arange(4, dtype=torch.int64)
    hostcache.seed(short, mirror)                 # shape differs: a copy
    assert torch.equal(_host_copy(short), short)
    assert metrics.counter_value("arena.spill.mirror_reuse") == 2


def test_spill_reuses_mirror_seeded_by_strings_from_arrays():
    """The offsets of a STRING column born on the host are int32 on the
    device with the int64 mirror ``strings_from_arrays`` seeded: their
    spill copy comes from that mirror, and equals them."""
    from spark_rapids_jni_tpu_torch.memory.spill import _host_copy
    metrics.set_enabled(True)
    rng = np.random.default_rng(17)
    lens = rng.integers(0, 9, 50)
    offsets = np.zeros(51, np.int32)
    np.cumsum(lens, out=offsets[1:])
    chars = rng.integers(97, 123, int(offsets[-1])).astype(np.uint8)
    col = Column.strings_from_arrays(chars, offsets, device=CPU)
    assert col.offsets.dtype == torch.int32
    before = metrics.counter_value("arena.spill.mirror_reuse")
    h = _host_copy(col.offsets)
    assert metrics.counter_value("arena.spill.mirror_reuse") == before + 1
    assert h.dtype == torch.int32
    assert np.array_equal(h.numpy(), offsets)
