"""The sync funnel (``utils/syncs.py``) and whole-query compilation
(``models/compiled.py``) of the PyTorch port, on the CPU.

On the CPU a compiled query has no graph: ``run`` and ``run_unchecked``
run it eagerly under its tape, and ``run`` holds the sizes it saw against
the tape.  Every TPC-DS query, compiled, equals the port's eager result
bit for bit here (and the JAX package's within ``RTOL``, in the
``test_torch_tpcds*.py`` files, beside their JAX results).  A replay that
would synchronise with the device on the card is caught here by
:class:`NoHostSync`, which refuses the calls that read the device or copy
from the host; a stale or perturbed tape must give ``StaleTapeError`` and
nothing else, the CPU's stand-in for memory safety on the card (an index
out of bounds raises here where it would fault there).
"""

import torch_one_thread  # noqa: F401  (first: one intra-op thread)
import functools
import sys
import threading

import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

import spark_rapids_jni_tpu_torch as pt
from spark_rapids_jni_tpu_torch.models import compiled, tpcds
from spark_rapids_jni_tpu_torch.ops import join_plan
from spark_rapids_jni_tpu_torch.ops.filter import sized_repeat
from spark_rapids_jni_tpu_torch.utils import syncs

from torch_tpcds_cases import (ARGS, CPU, O, TW,  # noqa: F401
                               _jax_native_library, data, port_tables)

_T = torch.Tensor
# the calls that read the device, or copy from the host, on the card
_SYNCING = {_T.item, _T.tolist, _T.__int__, _T.__bool__, _T.__float__,
            _T.__index__, _T.nonzero, torch.nonzero, torch.unique, _T.unique,
            torch.unique_consecutive, torch.masked_select, _T.masked_select,
            torch.argwhere, torch.bincount, _T.bincount, torch.isin,
            torch.tensor, torch.as_tensor, torch.frombuffer, _T.cpu,
            _T.numpy}


class NoHostSync(TorchFunctionMode):
    """Raise on a call that would synchronise with the device or copy from
    pageable host memory on the card: a read of a value, a boolean mask
    index, an output sized by its data, a tensor built from host data."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _SYNCING:
            raise AssertionError(f"host synchronisation: {func.__name__}")
        if func in (_T.__getitem__, _T.__setitem__):
            index = args[1] if isinstance(args[1], tuple) else (args[1],)
            if any(isinstance(i, torch.Tensor) and i.dtype == torch.bool
                   for i in index):
                raise AssertionError("host synchronisation: bool mask index")
        if (func in (torch.repeat_interleave, _T.repeat_interleave)
                and kwargs.get("output_size") is None):
            raise AssertionError("host synchronisation: repeat_interleave "
                                 "without output_size")
        if func is torch.where and len(args) == 1:
            raise AssertionError("host synchronisation: where(cond)")
        return func(*args, **kwargs)


def _query(name, data):
    return functools.partial(tpcds.QUERIES[name], **data[3][name])


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int64) if t.dtype == torch.float64 else t


def assert_bit_equal(got, want):
    """Two results hold the same structure and the same bits."""
    gt, wt = [], []
    assert compiled._flatten(got, gt) == compiled._flatten(want, wt)
    for g, w in zip(gt, wt):
        assert torch.equal(_bits(g), _bits(w))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this module: its 40,000-row queries gain
    little from more, and the suite runs beside other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def stale_tables():
    """The writer's tables at seed 77: the shapes of ``data``'s but for
    two string columns' chars, other sizes."""
    files, arrays = TW.tpcds_parquet(**{**ARGS, "seed": 77})
    return tpcds.load_tables(files, device=CPU), arrays


@pytest.mark.parametrize("name", list(tpcds.QUERIES))
def test_compiled_query_bit_equal_to_eager(name, data, port_tables):
    """Compiled, each query's checked and unchecked runs equal its eager
    run bit for bit; the unchecked run counts no sync and makes no call
    that would synchronise on the card; the replay consumes its tape
    exactly (``run`` raises otherwise)."""
    qfn = _query(name, data)
    want = qfn(port_tables)
    cq = compiled.compile_query(qfn, port_tables)
    assert cq.name == name and not cq.rehydrated
    assert_bit_equal(cq.expected, want)
    assert_bit_equal(cq.run(port_tables), want)
    before = syncs.sync_count()
    with NoHostSync():
        got = cq.run_unchecked(port_tables)
    assert syncs.sync_count() == before
    assert_bit_equal(got, want)


def test_eager_query_syncs_through_the_funnel(data, port_tables):
    """q3's eager run counts one sync a size on its tape, and its tape
    replays with no sync counted."""
    qfn = _query("q3", data)
    tape: list = []
    before = syncs.sync_count()
    with syncs.capture(tape):
        compiled._materialized(qfn(port_tables))
    assert len(tape) > 0 and syncs.sync_count() - before == len(tape)
    before = syncs.sync_count()
    with syncs.replay(tape), NoHostSync():
        compiled._materialized(qfn(port_tables))
    assert syncs.sync_count() == before


def test_stale_tape_raises_then_recompiles(data, port_tables, stale_tables):
    """q3 compiled on seed 7's tables and run on seed 77's raises
    StaleTapeError; compiled on them it equals the oracle."""
    tables2, arrays2 = stale_tables
    qfn = _query("q3", data)
    cq = compiled.compile_query(qfn, port_tables)
    mismatches = compiled.COUNTS["tape_mismatch"]
    with pytest.raises(compiled.StaleTapeError, match="stale"):
        cq.run(tables2)
    assert compiled.COUNTS["tape_mismatch"] == mismatches + 1
    fresh = compiled.compile_query(qfn, tables2)
    assert fresh.tape != cq.tape
    O.check("q3", fresh.run(tables2),
            O.answer("q3", arrays2, data[3]["q3"]))


def test_replay_of_a_short_or_long_tape_raises(data, port_tables):
    qfn = _query("q3", data)
    cq = compiled.compile_query(qfn, port_tables)
    for tape in (cq.tape[:-1], cq.tape + (0,)):
        with pytest.raises(syncs.TapeDivergence):
            with syncs.replay(tape):
                compiled._materialized(qfn(port_tables))
        assert syncs.mode() == "normal"
        with pytest.raises(compiled.StaleTapeError):
            compiled.rehydrate_query(qfn, tape).run(port_tables)


@pytest.mark.parametrize("name", list(tpcds.QUERIES))
def test_each_size_moved_by_one_raises_stale_tape(name, data, port_tables):
    """Each size of the tape moved by -1 and +1 in turn: the checked run
    raises StaleTapeError and nothing else (no index out of bounds); a
    query with an empty tape refuses a tape of one size."""
    qfn = _query(name, data)
    cq = compiled.compile_query(qfn, port_tables)
    tapes = []
    for i in range(len(cq.tape)):
        for step in (-1, 1):
            tape = list(cq.tape)
            tape[i] += step
            tapes.append(tape)
    for tape in tapes or [[0]]:
        with pytest.raises(compiled.StaleTapeError):
            compiled.rehydrate_query(qfn, tape).run(port_tables)


def test_rehydrated_tape_runs_checked(data, port_tables):
    qfn = _query("q36_rollup", data)
    cq = compiled.compile_query(qfn, port_tables)
    rq = compiled.rehydrate_query(qfn, list(cq.tape))
    assert rq.rehydrated and rq.expected is None and rq.tape == cq.tape
    assert_bit_equal(rq.run(port_tables), cq.expected)


def test_build_index_cache_neither_hit_nor_filled(data, port_tables):
    """Under capture and replay the build-index cache is bypassed: a
    warm cache is not read, and nothing is put in it.  (q52's second
    join builds on the item table's key, which outlives the query.)"""
    qfn = _query("q52", data)
    join_plan._INDEX_CACHE.clear()
    join_plan.reset_counts()
    qfn(port_tables)                          # warm the cache
    assert join_plan.index_cache_stats()["entries"] > 0
    assert join_plan.COUNTS["build_index.cache_miss"] == 2
    join_plan._INDEX_CACHE.clear()
    join_plan.reset_counts()
    cq = compiled.compile_query(qfn, port_tables)
    cq.run(port_tables)
    cq.run_unchecked(port_tables)
    assert join_plan.index_cache_stats()["entries"] == 0
    assert join_plan.COUNTS["build_index.cache_hit"] == 0
    assert join_plan.COUNTS["build_index.cache_miss"] == 0
    assert join_plan.COUNTS["build_index.cache_bypass"] == 6


def test_memos_disabled_under_capture_and_replay():
    col = pt.Column.strings_from_list(["a", "bcd", None, "ef"], device=CPU)
    offs = col.offsets
    syncs.memo_put("t", (offs,), 4)
    assert syncs.memo_get("t", (offs,)) == 4
    with syncs.capture([]):
        assert syncs.memo_get("t", (offs,)) is None
        syncs.memo_put("t2", (offs,), 5)
    assert syncs.memo_get("t2", (offs,)) is None
    with syncs.replay([]):
        assert syncs.memo_get("t", (offs,)) is None
    offs.add_(0)                              # an in-place write: a miss
    assert syncs.memo_get("t", (offs,)) is None


def test_string_width_is_memoized_eagerly():
    from spark_rapids_jni_tpu_torch.ops import strings
    col = pt.Column.strings_from_list(["a", "bcdef", "gh"], device=CPU)
    before = syncs.sync_count()
    assert strings._max_len(col) == 5
    assert strings._max_len(col) == 5
    assert syncs.sync_count() == before + 1


def test_capture_mode_is_thread_local():
    seen = {}
    entered, release = threading.Event(), threading.Event()

    def other():
        entered.wait(timeout=60)
        seen["mode"] = syncs.mode()
        release.set()

    t = threading.Thread(target=other)
    t.start()
    with syncs.capture([]):
        assert syncs.mode() == "capture"
        entered.set()
        release.wait(timeout=60)
    t.join(timeout=60)
    assert not t.is_alive()
    assert seen["mode"] == "normal" and syncs.mode() == "normal"
    with syncs.capture([]):
        with pytest.raises(RuntimeError):
            with syncs.replay([]):
                pass


def test_replay_collects_what_arrived():
    seen: list = []
    x = torch.tensor(7)
    with syncs.replay([3, 4], collect=seen):
        assert syncs.scalar(x) == 3
        assert syncs.size(x + 1, upper=2) == 2
        x.add_(100)                           # the collected value is a copy
    assert [int(v) for v in seen] == [7, 8]


def test_plan_key_identity_and_size_modes(port_tables):
    key, objects = compiled.plan_key(port_tables)
    assert key == compiled.plan_key(port_tables)[0]
    assert all(isinstance(o, torch.Tensor) for o in objects)
    copy = {name: pt.Table([pt.Column(c.dtype, c.data.clone(),
                                      None if c.offsets is None
                                      else c.offsets.clone(),
                                      None if c.validity is None
                                      else c.validity.clone())
                            for c in t.columns])
            for name, t in port_tables.items()}
    assert compiled.plan_key(copy)[0] != key
    by_size = compiled.plan_key(port_tables, by_size=True)[0]
    assert compiled.plan_key(copy, by_size=True)[0] == by_size
    table = copy["store"]
    before = compiled.plan_key(table)[0]
    table[0].data.add_(0)                     # in-place: new data
    assert compiled.plan_key(table)[0] != before
    assert compiled.plan_key(table, by_size=True)[0] == \
        compiled.plan_key(copy["store"], by_size=True)[0]


def test_plan_key_never_forces_a_lazy_column():
    col = pt.Column.from_numpy(np.arange(10, dtype=np.int64), device=CPU)
    lazy = pt.column.LazyColumn(col.dtype, 10, CPU, lambda: col)
    key, objects = compiled.plan_key(pt.Table([lazy]))
    assert not lazy.forced and lazy in objects
    lazy2 = pt.column.LazyColumn(col.dtype, 10, CPU, lambda: col)
    assert compiled.plan_key(pt.Table([lazy2]))[0] != key
    assert compiled.plan_key(pt.Table([lazy2]), by_size=True)[0] == \
        compiled.plan_key(pt.Table([lazy]), by_size=True)[0]


def test_materialized_dict_column_keeps_the_tape_aligned():
    """A DictColumn materialized before the capture resolves its sizes
    again under capture, so that a fresh copy of it replays the tape
    exactly (the JAX package's rule): its longest entry, its codes'
    least and greatest (B6's bounds check) and its chars total."""
    words = ["alpha", "b", None, "gamma", "b"] * 4
    dictionary = pt.Column.strings_from_list(["alpha", "b", "gamma"],
                                             device=CPU)
    codes = torch.tensor([0, 1, 0, 2, 1] * 4, dtype=torch.int32)
    valid = torch.tensor([w is not None for w in words])
    col = pt.DictColumn(codes, dictionary, valid)
    col.materialize()

    def qfn(t):
        from spark_rapids_jni_tpu_torch.ops import strings
        return pt.Table([strings.upper(pt.column.force_column(t[0])
                                       .materialize())])

    cq = compiled.compile_query(qfn, pt.Table([col]))
    fresh = pt.DictColumn(codes, dictionary, valid)
    assert cq.tape == (5, 0, 2, 48)
    assert_bit_equal(cq.run(pt.Table([fresh])), cq.expected)
    assert cq.expected[0].to_pylist() == [w and w.upper() for w in words]


@pytest.mark.parametrize("counts,total", [([2, 0, 3], 5), ([2, 0, 3], 3),
                                          ([2, 0, 3], 9), ([0, 0], 4),
                                          ([1], 0)])
def test_sized_repeat_stays_in_bounds(counts, total):
    c = torch.tensor(counts, dtype=torch.int64)
    got = sized_repeat(c, total)
    assert got.shape == (total,)
    assert bool(((got >= 0) & (got < len(counts))).all())
    if total == sum(counts):
        assert torch.equal(got, torch.repeat_interleave(c))


def test_sync_count_is_thread_safe():
    """More threads than cores, switching often: no count is lost."""
    before = syncs.sync_count()

    def work():
        for _ in range(2000):
            syncs.note_sync()

    threads = [threading.Thread(target=work) for _ in range(16)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert syncs.sync_count() - before == 16 * 2000


# --- batches of K table sets (run_vmapped) and lower_text -------------------


def _gb_tables(k):
    """K table sets of different data but the same sizes (every row
    passes the filter, every set holds the 7 groups: the tape fits each,
    as the sets a plan cache batches are verified to), port and JAX
    twins."""
    from spark_rapids_jni_tpu.column import Column as JColumn, Table as JTable
    out, jout = [], []
    for i in range(k):
        rng = np.random.default_rng(40 + i)
        keys = rng.permutation(np.arange(3000) % 7).astype(np.int32)
        vals = rng.integers(-49, 99, 3000).astype(np.int64)
        valid = rng.random(3000) < 0.9
        out.append({"t": pt.Table([
            pt.Column.from_numpy(vals, validity=valid, device=CPU),
            pt.Column.from_numpy(keys, device=CPU)])})
        jout.append({"t": JTable([JColumn.from_numpy(vals, validity=valid),
                                  JColumn.from_numpy(keys)])})
    return out, jout


def _q_gb(tables):
    from spark_rapids_jni_tpu_torch.ops import groupby_aggregate
    f = pt.ops.filter.apply_boolean_mask(
        tables["t"], tables["t"][0].data > -50)
    return groupby_aggregate(f, [1], [(0, "sum"), (0, "count"),
                                      (0, "max")])


def _jq_gb(tables):
    from spark_rapids_jni_tpu.ops import apply_boolean_mask, groupby_aggregate
    f = apply_boolean_mask(tables["t"], tables["t"][0].data > -50)
    return groupby_aggregate(f, [1], [(0, "sum"), (0, "count"),
                                      (0, "max")])


def test_run_vmapped_runs_k_sets_as_one_batch_equal_to_jax():
    """K same-shape table sets through ``run_vmapped``: each result equals
    its own run bit for bit and the JAX package's ``run_vmapped`` element
    exactly; the first batch checks parity once; sets of another shape
    make it return None (the caller then runs each)."""
    from spark_rapids_jni_tpu.models import compiled as jcompiled
    from torch_jax_columns import assert_same_table
    tabs, jtabs = _gb_tables(4)
    compiled.reset_counts()
    cq = compiled.compile_query(_q_gb, tabs[0])
    outs = cq.run_vmapped(tabs)
    assert len(outs) == 4
    for t, o in zip(tabs, outs):
        assert_bit_equal(o, cq.run_unchecked(t))
        assert_bit_equal(o, _q_gb(t))
    assert compiled.COUNTS["batch_replay"] == 1
    assert compiled.COUNTS["batch_parity_check"] == 1
    assert cq.run_vmapped(tabs[:2]) is not None      # parity checked once
    assert compiled.COUNTS["batch_parity_check"] == 1
    other = {"t": pt.Table([c for c in tabs[0]["t"].columns][::-1])}
    assert cq.run_vmapped([tabs[0], other]) is None
    assert compiled.COUNTS["batch_unsupported"] == 1
    jcq = jcompiled.compile_query(_jq_gb, jtabs[0])
    jouts = jcq.run_vmapped(jtabs)
    if jouts is None:                     # the JAX package refused to batch
        jouts = [_jq_gb(t) for t in jtabs]
    for o, j in zip(outs, jouts):
        assert_same_table(o, j)


def test_batch_chunks_bound_the_batch_graphs():
    """K sets run in chunks of at most ``BATCH_MAX``, each on a graph of
    the power of two at or above its size, so a plan holds at most three
    batch graphs (widths 2, 4 and 8) whatever K the server sends; on the
    CPU, nine sets in the background mode each equal their own run."""
    widths = set()
    for k in range(1, 40):
        chunks = compiled.batch_chunks(k)
        assert chunks[0][0] == 0 and chunks[-1][1] == k
        for (lo, hi, w), nxt in zip(chunks, chunks[1:] + [(k, k, 0)]):
            assert hi == nxt[0] and 0 < hi - lo <= w <= compiled.BATCH_MAX
            assert w & (w - 1) == 0 and w < 2 * (hi - lo)
            widths.add(w)
    assert widths == {1, 2, 4, 8}
    assert compiled.batch_chunks(3) == [(0, 3, 4)]
    assert compiled.batch_chunks(9) == [(0, 8, 8), (8, 9, 1)]
    tabs, _ = _gb_tables(9)
    cq = compiled.compile_query(_q_gb, tabs[0])
    outs = cq.run_vmapped(tabs, background=True)
    assert len(outs) == 9
    for t, o in zip(tabs, outs):
        assert_bit_equal(o, cq.run_unchecked(t))
    assert cq.batch_bytes == 0 and cq.device_bytes() == 0
    assert compiled.wait_batch_captures() == 0


def test_lower_text_lists_the_tape():
    tabs, _ = _gb_tables(1)
    cq = compiled.compile_query(_q_gb, tabs[0])
    text = cq.lower_text(tabs[0])
    assert text.splitlines()[0] == f"compiled query {cq.name}"
    assert f"tape ({len(cq.tape)} sizes): {list(cq.tape)}" in text
    assert "graph: none" in text
