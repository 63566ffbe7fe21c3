"""The port's join engine against the JAX package's, on the CPU.

``ops/join.py`` and ``ops/join_plan.py`` of ``spark_rapids_jni_tpu_torch``
take the same numpy-seeded key columns as their JAX counterparts
(``tests/test_join_v2.py``'s cases, without capture/replay, repartition or
the environment knob): ``join_indices`` must equal the JAX package's
element for element in every ``how``, with each engine pinned by
``force_engine``, for single, composite, fingerprinted (collisions
included), string, decimal128 and float keys; the table joins (inner,
left, right, full outer, semi, anti) and each ``join_aggregate`` path
must give the JAX package's tables, float sums to a relative 1e-12.
The build-index cache evicts past a lowered byte cap with unchanged
joins.
"""

import torch_one_thread  # noqa: F401  (first: one intra-op thread)
import threading

import numpy as np
import pandas as pd
import pytest
import torch

import jax.numpy as jnp
from spark_rapids_jni_tpu import ops as jops
from spark_rapids_jni_tpu.ops import decimal128 as jd128
from spark_rapids_jni_tpu.ops import hashing as jhashing
from spark_rapids_jni_tpu.ops import join_plan as jplan
from spark_rapids_jni_tpu.ops.join import join_indices as jjoin_indices

import spark_rapids_jni_tpu_torch as pt
from spark_rapids_jni_tpu_torch import ops
from spark_rapids_jni_tpu_torch.ops import hashing, join_plan
from spark_rapids_jni_tpu_torch.ops.join import join_indices

from torch_jax_columns import assert_same_table, to_jax

CPU = "cpu"
HOWS = ["inner", "left", "semi", "anti"]
ENGINES = ["dense", "sorted"]
RTOL = 1e-12


def col(vals, validity=None, dt=None):
    return pt.Column.from_numpy(np.asarray(vals), dt, validity, device=CPU)


def strings(values):
    return pt.Column.strings_from_list(values, device=CPU)


def _np(x):
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)


def assert_same_indices(got, want):
    """Port indices equal the JAX package's, element for element."""
    if isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(_np(g), _np(w))
    else:
        np.testing.assert_array_equal(_np(got), _np(want))


def both(lcols, rcols, how, engine=None):
    """(port indices, JAX indices) of the same keys, with ``engine``
    pinned in both packages."""
    jl = [to_jax(c) for c in lcols] if isinstance(lcols, list) \
        else to_jax(lcols)
    jr = [to_jax(c) for c in rcols] if isinstance(rcols, list) \
        else to_jax(rcols)
    with join_plan.force_engine(engine), jplan.force_engine(engine):
        return join_indices(lcols, rcols, how), jjoin_indices(jl, jr, how)


def check_engines(lcols, rcols, how):
    """Each engine equals the JAX package's, and the two engines agree."""
    out = {}
    for engine in ENGINES:
        got, want = both(lcols, rcols, how, engine)
        assert_same_indices(got, want)
        out[engine] = got
    assert_same_indices(out["dense"], out["sorted"])


# -- single keys, both engines ------------------------------------------


@pytest.mark.parametrize("how", HOWS)
def test_engines_match_jax_random(how):
    rng = np.random.default_rng(1)
    check_engines(col(rng.integers(0, 400, 3000, dtype=np.int64)),
                  col(rng.integers(0, 400, 500, dtype=np.int64)), how)


@pytest.mark.parametrize("how", HOWS)
def test_engines_match_jax_null_keys(how):
    rng = np.random.default_rng(2)
    check_engines(
        col(rng.integers(0, 50, 600, dtype=np.int64), rng.random(600) < 0.85),
        col(rng.integers(0, 50, 200, dtype=np.int64), rng.random(200) < 0.85),
        how)


@pytest.mark.parametrize("how", HOWS)
def test_engines_match_jax_unique_build(how):
    rng = np.random.default_rng(3)
    rk = rng.permutation(np.arange(1000, 2000, dtype=np.int64))[:700]
    lk = np.where(rng.random(4000) < 0.8, rk[rng.integers(0, 700, 4000)],
                  rng.integers(5000, 6000, 4000)).astype(np.int64)
    check_engines(col(lk), col(rk), how)


@pytest.mark.parametrize("how", HOWS)
def test_engines_match_jax_empty_build(how):
    check_engines(col(np.asarray([1, 2, 3], np.int64)),
                  col(np.zeros(0, np.int64)), how)


@pytest.mark.parametrize("how", HOWS)
def test_engines_match_jax_int32_keys_and_empty_probe(how):
    rng = np.random.default_rng(4)
    check_engines(col(rng.integers(-20, 20, 300).astype(np.int32)),
                  col(rng.integers(-20, 20, 90).astype(np.int32),
                      rng.random(90) < 0.9), how)
    check_engines(col(np.zeros(0, np.int32)),
                  col(np.arange(5, dtype=np.int32)), how)


def test_planner_picks_dense_for_dense_keys_only():
    rng = np.random.default_rng(5)
    dense = torch.arange(100, 1100, dtype=torch.int64)
    sparse = torch.from_numpy(rng.integers(0, 2**60, 1000, dtype=np.int64))
    assert join_plan.build_index(dense, None, True).kind == "dense"
    assert join_plan.build_index(sparse, None, True).kind == "sorted"
    assert not join_plan.dense_eligible(col(np.asarray([1.0, 2.0])))
    assert not join_plan.dense_eligible(col(np.asarray([1, 2], np.uint64)))
    assert join_plan.dense_eligible(col(np.asarray([1, 2], np.int32)))
    with join_plan.force_engine("sorted"):
        assert join_plan.build_index(dense, None, True).kind == "sorted"


def test_build_index_cache_keys_on_identity_and_version():
    data = torch.arange(10, 500, dtype=torch.int64)
    ix1 = join_plan.build_index(data, None, True)
    assert join_plan.build_index(data, None, True) is ix1
    # equal contents in another tensor are another build side
    assert join_plan.build_index(torch.arange(10, 500), None, True) \
        is not ix1
    # an in-place write misses the cache, and the new index sees it
    data[0] = 7
    ix2 = join_plan.build_index(data, None, True)
    assert ix2 is not ix1 and ix2.kmin == 7


def test_cache_hit_join_indices_identical():
    rng = np.random.default_rng(6)
    rt = col(rng.permutation(np.arange(300, dtype=np.int64)))
    lt = col(rng.integers(0, 300, 2000, dtype=np.int64))
    join_plan.reset_counts()
    a = join_indices(lt, rt, "inner")
    b = join_indices(lt, rt, "inner")
    assert_same_indices(a, b)
    assert join_plan.COUNTS["build_index.cache_hit"] >= 1


@pytest.mark.parametrize("engine", ENGINES)
def test_index_cache_evicts_past_a_lowered_byte_cap(engine, monkeypatch):
    """Past ``INDEX_CACHE_CAP`` the least recently used indexes go (the
    newest stays), the bytes held never pass the cap, each eviction
    counts, and every join gives the indices it gave uncapped, which are
    the JAX package's."""
    rng = np.random.default_rng(8)
    builds = [col(rng.permutation(np.arange(400 + 50 * k, dtype=np.int64)))
              for k in range(6)]
    probe = col(rng.integers(0, 700, 3000, dtype=np.int64))
    join_plan._INDEX_CACHE.clear()
    want = []
    for b in builds:
        got, jax_want = both(probe, b, "inner", engine)
        assert_same_indices(got, jax_want)
        want.append(got)
    # uncapped (512 MiB), all six stay
    assert join_plan.index_cache_stats()["entries"] == 6
    assert join_plan.INDEX_CACHE_CAP == 512 << 20
    with join_plan.force_engine(engine):
        sizes = [join_plan._index_nbytes(join_plan.build_index(
            b.data, None, True)) for b in builds]
    cap = sizes[-1] + sizes[-2]
    monkeypatch.setattr(join_plan, "INDEX_CACHE_CAP", cap)
    join_plan._INDEX_CACHE.clear()
    join_plan.reset_counts()
    before = join_plan.index_cache_stats()["evictions"]
    with join_plan.force_engine(engine):
        for _ in range(2):
            for b, w in zip(builds, want):
                assert_same_indices(join_indices(probe, b, "inner"), w)
                assert join_plan._INDEX_CACHE.nbytes <= cap
    stats = join_plan.index_cache_stats()
    evicted = stats["evictions"] - before
    # LRU over a cycle of six builds, two at most held: every call misses
    assert join_plan.COUNTS["build_index.cache_miss"] == 12
    assert evicted >= 12 - 2
    assert join_plan.COUNTS["build_index.evictions"] == evicted
    assert 1 <= stats["entries"] <= 2 and stats["bytes"] <= cap
    # the newest entry stays even when it alone passes the cap
    monkeypatch.setattr(join_plan, "INDEX_CACHE_CAP", 1)
    with join_plan.force_engine(engine):
        assert_same_indices(join_indices(probe, builds[0], "inner"), want[0])
    assert join_plan.index_cache_stats()["entries"] == 1
    assert join_plan._INDEX_CACHE.nbytes == sizes[0]


def test_index_cache_bytes_follow_entries_dying():
    """An entry that dies with its key tensor takes its bytes along."""
    join_plan._INDEX_CACHE.clear()
    data = torch.arange(10, 5000, dtype=torch.int64)
    ix = join_plan.build_index(data, None, True)
    assert join_plan._INDEX_CACHE.nbytes == join_plan._index_nbytes(ix) > 0
    del data, ix
    assert join_plan.index_cache_stats() == {
        "entries": 0, "bytes": 0,
        "evictions": join_plan._INDEX_CACHE.evictions}


def test_force_engine_is_per_thread():
    seen = []
    with join_plan.force_engine("sorted"):
        t = threading.Thread(target=lambda: seen.append(
            join_plan.forced_engine()))
        t.start()
        t.join()
        assert join_plan.forced_engine() == "sorted"
    assert seen == [None] and join_plan.forced_engine() is None


def test_extend_build_index_equals_rebuild():
    rng = np.random.default_rng(7)
    base = torch.from_numpy(rng.integers(0, 60, 400, dtype=np.int64))
    delta = torch.from_numpy(rng.integers(0, 60, 150, dtype=np.int64))
    dvalid = torch.from_numpy(rng.random(150) < 0.9)
    ix = join_plan._build_index(base, None, True, False)
    ext = join_plan.extend_build_index(ix, delta, dvalid, 400)
    full = join_plan._build_index(
        torch.cat([base, delta]),
        torch.cat([torch.ones(400, dtype=torch.bool), dvalid]), True, False)
    for a, b in zip(ext, full):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a.to(torch.int64), b.to(torch.int64))
        else:
            assert a == b
    # against the JAX package's extension of the same index
    jix = jplan._build_index(jnp.asarray(base.numpy()), None, True, False)
    jext = jplan.extend_build_index(jix, jnp.asarray(delta.numpy()),
                                    jnp.asarray(dvalid.numpy()), 400)
    np.testing.assert_array_equal(ext.row_ids.numpy(),
                                  np.asarray(jext.row_ids))
    # a key outside the window makes the caller rebuild
    assert join_plan.extend_build_index(
        ix, torch.tensor([999], dtype=torch.int64), None, 400) is None


def test_skew_stats_match_jax():
    rng = np.random.default_rng(8)
    keys = rng.integers(0, 100, 1000, dtype=np.int64)
    keys[:300] = 5
    ix = join_plan._build_index(torch.from_numpy(keys), None, True, False)
    jix = jplan._build_index(jnp.asarray(keys), None, True, False)
    assert join_plan.skew_stats(ix) == jplan.skew_stats(jix)
    sorted_ix = join_plan._build_index(torch.from_numpy(keys), None, False,
                                       False)
    assert join_plan.skew_stats(sorted_ix) is None


# -- table joins -------------------------------------------------------


def _tables(rng, nl=900, nr=250, span=120):
    lk = rng.integers(0, span, nl, dtype=np.int64)
    rk = rng.integers(0, span, nr, dtype=np.int64)
    words = [f"w{i % 37}" for i in range(nr)]
    left = pt.Table([col(lk, rng.random(nl) < 0.9),
                     col(np.arange(nl, dtype=np.int32)),
                     col(rng.random(nl))])
    right = pt.Table([col(rk), strings(words),
                      col(rng.integers(0, 9, nr).astype(np.int16),
                          rng.random(nr) < 0.8)])
    return left, right


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("kind", ["inner_join", "left_join", "right_join",
                                  "full_outer_join", "semi_join",
                                  "anti_join"])
def test_table_joins_match_jax(kind, engine):
    left, right = _tables(np.random.default_rng(9))
    with join_plan.force_engine(engine), jplan.force_engine(engine):
        got = getattr(ops, kind)(left, right, 0, 0)
        want = getattr(jops, kind)(to_jax(left), to_jax(right), 0, 0)
    assert all(isinstance(c, pt.LazyColumn) for c in got.columns[:1])
    assert_same_table(got, want)


def test_left_join_empty_build_matches_jax():
    left, right = _tables(np.random.default_rng(10))
    empty = pt.Table([col(np.zeros(0, np.int64)), strings([]),
                      col(np.zeros(0, np.int16))])
    got = ops.left_join(left, empty, 0, 0)
    want = jops.left_join(to_jax(left), to_jax(empty), 0, 0)
    assert_same_table(got, want)


def test_inner_join_vs_pandas():
    rng = np.random.default_rng(11)
    lk = rng.integers(0, 120, 2000, dtype=np.int64)
    rk = rng.integers(0, 120, 300, dtype=np.int64)
    lv = np.arange(2000, dtype=np.int32)
    rv = np.arange(300, dtype=np.int32) + 7000
    with join_plan.force_engine("dense"):
        out = ops.inner_join(pt.Table([col(lk), col(lv)]),
                             pt.Table([col(rk), col(rv)]), 0, 0)
    got = sorted(zip(out[0].to_pylist(), out[1].to_pylist(),
                     out[3].to_pylist()))
    df = pd.merge(pd.DataFrame({"k": lk, "lv": lv}),
                  pd.DataFrame({"k": rk, "rv": rv}), on="k")
    assert got == sorted(zip(df["k"], df["lv"], df["rv"]))


# -- multi-column, string, float and decimal128 keys ---------------------


@pytest.mark.parametrize("how", HOWS)
def test_composite_2key_matches_jax(how):
    rng = np.random.default_rng(12)
    n, m = 1500, 400
    lt = [col(rng.integers(0, 40, n, dtype=np.int64), rng.random(n) < 0.9),
          col(rng.integers(0, 30, n).astype(np.int32))]
    rt = [col(rng.integers(0, 40, m, dtype=np.int64)),
          col(rng.integers(0, 30, m).astype(np.int32), rng.random(m) < 0.9)]
    plan = join_plan.plan_keys(lt, rt)
    assert plan.mode == "composite" and plan.dense_ok and not plan.verify
    check_engines(lt, rt, how)


@pytest.mark.parametrize("how", ["inner", "left"])
def test_composite_3key_matches_jax(how):
    rng = np.random.default_rng(13)
    n, m = 2000, 500
    lt = [col(rng.integers(0, 12, n, dtype=np.int64), rng.random(n) < 0.92),
          col(rng.integers(0, 12, n, dtype=np.int64)),
          col(rng.integers(0, 12, n, dtype=np.int64))]
    rt = [col(rng.integers(0, 12, m, dtype=np.int64)) for _ in range(3)]
    assert join_plan.plan_keys(lt, rt).mode == "composite"
    check_engines(lt, rt, how)


@pytest.mark.parametrize("how", HOWS)
def test_string_and_int_composite_matches_jax(how):
    rng = np.random.default_rng(14)
    cats = [f"s{i}" for i in range(9)]
    n, m = 1200, 300
    lt = [strings([cats[i] for i in rng.integers(0, 9, n)]),
          col(rng.integers(0, 25, n, dtype=np.int64))]
    rt = [strings([cats[i] for i in rng.integers(0, 9, m)]),
          col(rng.integers(0, 25, m, dtype=np.int64))]
    assert join_plan.plan_keys(lt, rt).mode == "composite"
    got, want = both(lt, rt, how)
    assert_same_indices(got, want)


@pytest.mark.parametrize("how", HOWS)
def test_string_key_with_dictionary_side_matches_jax(how):
    rng = np.random.default_rng(15)
    words = ["", "a", "ab", "abc", "zz", "b"]
    dictionary = strings(words)
    codes = torch.from_numpy(rng.integers(0, 6, 700).astype(np.int32))
    dv = torch.from_numpy(rng.random(700) < 0.9)
    left = pt.DictColumn(codes, dictionary, dv)
    right = strings([words[i] if i < 6 else "q" for i in
                     rng.integers(0, 7, 200)])
    join_plan.reset_counts()
    got, want = both(left, right, how)
    assert join_plan.COUNTS["dict_keys"] == 1
    assert_same_indices(got, want)


@pytest.mark.parametrize("how", HOWS)
def test_fingerprint_overflow_matches_jax(how):
    rng = np.random.default_rng(16)
    n, m = 900, 250
    base = rng.integers(-2**61, 2**61, 60, dtype=np.int64)
    lt = [col(base[rng.integers(0, 60, n)], rng.random(n) < 0.9),
          col(base[rng.integers(0, 60, n)])]
    rt = [col(base[rng.integers(0, 60, m)]), col(base[rng.integers(0, 60, m)])]
    plan = join_plan.plan_keys(lt, rt)
    assert plan.mode == "fingerprint" and plan.verify and not plan.dense_ok
    got, want = both(lt, rt, how)
    assert_same_indices(got, want)


@pytest.mark.parametrize("how", HOWS)
def test_fingerprint_collisions_are_rejected(how, monkeypatch):
    # five buckets in both packages: every probe drowns in collisions,
    # and verification must reject each one
    monkeypatch.setattr(hashing, "fingerprint64",
                        lambda lanes: lanes[0].to(torch.int64) % 5)
    monkeypatch.setattr(jhashing, "fingerprint64",
                        lambda lanes: (lanes[0].astype(jnp.int64) % 5 + 5) % 5)
    rng = np.random.default_rng(17)
    n, m = 400, 120
    la = rng.integers(-2**61, 2**61, n, dtype=np.int64)
    ra = np.concatenate([la[rng.integers(0, n, 60)],
                         rng.integers(-2**61, 2**61, m - 60, dtype=np.int64)])
    lt = [col(la), col(rng.integers(0, 4, n, dtype=np.int64))]
    rt = [col(ra), col(rng.integers(0, 4, m, dtype=np.int64))]
    got, want = both(lt, rt, how)
    assert_same_indices(got, want)


@pytest.mark.parametrize("how", HOWS)
def test_float_keys_match_jax(how):
    rng = np.random.default_rng(18)
    pool = np.array([-0.0, 0.0, np.nan, 1.5, -2.5, np.inf, -np.inf, 3.25])
    lf = pt.Column.from_numpy(rng.choice(pool, 500), validity=rng.random(500)
                              < 0.9, device=CPU)
    rf = pt.Column.from_numpy(rng.choice(pool, 120), device=CPU)
    # one float key: the sorted engine on the ordered int64 key
    got, want = both(lf, rf, how)
    assert_same_indices(got, want)
    # with an int lane: the hashed fallback, verified
    lt = [lf, col(rng.integers(0, 3, 500, dtype=np.int64))]
    rt = [rf, col(rng.integers(0, 3, 120, dtype=np.int64))]
    assert join_plan.plan_keys(lt, rt).mode == "fallback"
    got, want = both(lt, rt, how)
    assert_same_indices(got, want)


@pytest.mark.parametrize("how", HOWS)
def test_decimal128_keys_match_jax(how):
    values_l = [5, 5 + 2**64, None, 9, 2**70, -2**70, 3, 9]
    values_r = [5, 9, None, 5 + 2**64, -2**70, 9, 11]

    def dcol(values):
        jc = jd128.from_pyints(values, scale=0)
        return pt.Column(pt.decimal128(0),
                         torch.from_numpy(np.asarray(jc.data).copy()),
                         validity=torch.from_numpy(
                             np.asarray(jc.validity_or_true()).copy()))

    lc, rc = dcol(values_l), dcol(values_r)
    plan = join_plan.plan_keys([lc], [rc])
    assert plan.mode == "fallback" and len(plan.verify) == 2
    got, want = both(lc, rc, how)
    assert_same_indices(got, want)


def test_single_key_list_equals_scalar_key():
    rng = np.random.default_rng(19)
    lk = col(rng.integers(0, 90, 700, dtype=np.int64))
    rk = col(rng.integers(0, 90, 200, dtype=np.int64))
    assert_same_indices(join_indices([lk], [rk], "inner"),
                        join_indices(lk, rk, "inner"))
    assert join_plan.plan_keys([lk], [rk]).mode == "single"


def test_multikey_pack_counters_and_cache_hits():
    rng = np.random.default_rng(20)
    lt = [col(rng.integers(0, 50, 1000, dtype=np.int64)),
          col(rng.integers(0, 20, 1000, dtype=np.int64))]
    rt = [col(rng.integers(0, 50, 300, dtype=np.int64)),
          col(rng.integers(0, 20, 300, dtype=np.int64))]
    join_plan.reset_counts()
    a = join_indices(lt, rt, "inner")
    b = join_indices(lt, rt, "inner")
    assert_same_indices(a, b)
    assert join_plan.COUNTS["pack.composite"] == 1
    assert join_plan.COUNTS["pack.cache_hit"] >= 1
    assert join_plan.COUNTS["build_index.cache_hit"] >= 1


# -- join_aggregate ------------------------------------------------------


def fused_matches(lt, rt, left_on, right_on, keys, aggs, how, path):
    """The fused result equals the JAX package's fused result and the
    port's unfused join + groupby; ``path`` is the one it took."""
    join_plan.reset_counts()
    got = ops.join_aggregate(lt, rt, left_on, right_on, keys, aggs, how=how)
    assert join_plan.COUNTS[f"fused.{path}"] == 1, dict(join_plan.COUNTS)
    want = jops.join_aggregate(to_jax(lt), to_jax(rt), left_on, right_on,
                               keys, aggs, how=how)
    ks = list(range(len(keys)))
    assert_same_table(ops.sort_table(got, ks), jops.sort_table(want, ks),
                      rtol=RTOL)
    j = (ops.inner_join if how == "inner" else ops.left_join)(
        lt, rt, left_on, right_on)
    ref = ops.groupby_aggregate(j, keys, aggs)
    assert_same_table(ops.sort_table(got, ks), to_jax(ops.sort_table(ref, ks)),
                      rtol=RTOL)


ALL_AGGS = ["sum", "count", "mean", "min", "max"]


@pytest.mark.parametrize("how", ["inner", "left"])
def test_fused_unique_build_all_aggs(how):
    rng = np.random.default_rng(21)
    n, nd = 5000, 400
    dim_sk = np.arange(10, 10 + nd, dtype=np.int64)
    fk = np.where(rng.random(n) < 0.9, dim_sk[rng.integers(0, nd, n)],
                  rng.integers(9000, 9500, n)).astype(np.int64)
    lt = pt.Table([col(fk), col(rng.integers(-50, 50, n, dtype=np.int64),
                                rng.random(n) < 0.9),
                   col(rng.random(n) * 100)])
    rt = pt.Table([col(dim_sk), col(rng.integers(0, 9, nd, dtype=np.int64))])
    fused_matches(lt, rt, 0, 0, [4],
                  [(1, a) for a in ALL_AGGS] + [(2, "sum"), (2, "mean")],
                  how, "unique_gather")


def test_fused_unique_build_left_side_and_string_keys():
    rng = np.random.default_rng(22)
    n, nd = 3000, 64
    dim_sk = np.arange(0, nd, dtype=np.int64)
    cats = strings([f"cat{i % 7}" for i in range(nd)])
    lt = pt.Table([col(dim_sk[rng.integers(0, nd, n)]),
                   col(rng.integers(0, 6, n, dtype=np.int64)),
                   col(rng.integers(0, 100, n, dtype=np.int64))])
    rt = pt.Table([col(dim_sk), cats])
    fused_matches(lt, rt, 0, 0, [1], [(2, "sum"), (2, "mean")], "inner",
                  "unique_gather")
    fused_matches(lt, rt, 0, 0, [4], [(2, "sum"), (2, "count")], "inner",
                  "unique_gather")


@pytest.mark.parametrize("how", ["inner", "left"])
def test_fused_weighted_duplicate_build(how):
    rng = np.random.default_rng(23)
    n, nb = 2500, 300
    base = np.arange(50, 150, dtype=np.int64)
    bk = base[rng.integers(0, 100, nb)].astype(np.int64)
    fk = np.where(rng.random(n) < 0.8, base[rng.integers(0, 100, n)],
                  rng.integers(700, 900, n)).astype(np.int64)
    lt = pt.Table([col(fk), col(rng.integers(0, 5, n, dtype=np.int64)),
                   col(rng.integers(-9, 9, n, dtype=np.int64),
                       rng.random(n) < 0.85),
                   col(rng.random(n))])
    rt = pt.Table([col(bk)])
    fused_matches(lt, rt, 0, 0, [1],
                  [(2, a) for a in ALL_AGGS] + [(3, "sum"), (3, "mean")],
                  how, "weighted_groupby")


def test_fused_fallback_right_side_keys_duplicate_build():
    rng = np.random.default_rng(24)
    n, nb = 800, 120
    base = np.arange(0, 40, dtype=np.int64)
    lt = pt.Table([col(base[rng.integers(0, 40, n)]),
                   col(rng.integers(0, 20, n, dtype=np.int64))])
    rt = pt.Table([col(base[rng.integers(0, 40, nb)]),
                   col(rng.integers(0, 4, nb, dtype=np.int64))])
    for how in ("inner", "left"):
        fused_matches(lt, rt, 0, 0, [3], [(1, "sum")], how, "fallback_join")


@pytest.mark.parametrize("how", ["inner", "left"])
def test_fused_composite_and_fingerprint(how):
    rng = np.random.default_rng(25)
    n, nd = 2500, 160
    lt = pt.Table([col(np.where(rng.random(n) < 0.85, rng.integers(0, 40, n),
                                rng.integers(90, 120, n)).astype(np.int64)),
                   col(rng.integers(0, 4, n, dtype=np.int64)),
                   col(rng.integers(0, 50, n, dtype=np.int64))])
    rt = pt.Table([col(np.repeat(np.arange(40, dtype=np.int64), 4)),
                   col(np.tile(np.arange(4, dtype=np.int64), 40)),
                   col(rng.integers(0, 6, nd, dtype=np.int64))])
    fused_matches(lt, rt, [0, 1], [0, 1], [5], [(2, "sum"), (2, "count")],
                  how, "unique_gather")
    base = rng.integers(-2**61, 2**61, 50, dtype=np.int64)
    lt = pt.Table([col(base[rng.integers(0, 50, 600)]),
                   col(base[rng.integers(0, 50, 600)]),
                   col(rng.integers(0, 4, 600, dtype=np.int64)),
                   col(rng.integers(0, 9, 600, dtype=np.int64))])
    rt = pt.Table([col(base[rng.integers(0, 50, 100)]),
                   col(base[rng.integers(0, 50, 100)])])
    fused_matches(lt, rt, [0, 1], [0, 1], [2], [(3, "sum"), (3, "count")],
                  how, "fallback_join")


def test_fused_empty_probe():
    lt = pt.Table([col(np.zeros(0, np.int64)), col(np.zeros(0, np.int64))])
    rt = pt.Table([col(np.arange(5, dtype=np.int64))])
    out = ops.join_aggregate(lt, rt, 0, 0, [0], [(1, "sum")])
    assert out.num_rows == 0 and out.schema == [pt.int64, pt.int64]
