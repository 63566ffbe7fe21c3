"""The port's ``parallel/`` (meshes, the row shuffle, the distributed star
aggregate, the repartition join) against the JAX package's, on the CPU.

Mirrors ``tests/test_shuffle.py``, ``test_dist_query.py``,
``test_repartition_join.py`` and ``test_aqe.py``'s salted sub-join.  The
JAX package's mesh is conftest's 8 CPU devices; the port's is 8 CPU
replicas (``make_mesh(8, device="cpu")``).  The same seeded numpy inputs
go through both: sums, counts, ``dropped``, bucket contents and counts,
salted destinations and the capacities the count pass picks are equal
exactly (integers throughout), and each result equals a pandas oracle.
The JAX package's runs share one module fixture, a run per case.
"""

import torch_one_thread  # noqa: F401  (first: one intra-op thread)
import numpy as np
import pandas as pd
import pytest
import torch
import jax.numpy as jnp

import spark_rapids_jni_tpu as sr
from spark_rapids_jni_tpu.ops.hashing import murmur3_32 as jmurmur
from spark_rapids_jni_tpu.parallel import make_mesh as jmake_mesh
from spark_rapids_jni_tpu.parallel import dist_query as jdq
from spark_rapids_jni_tpu.parallel import repartition_join as jrj
from spark_rapids_jni_tpu.parallel import shuffle as jsh

import spark_rapids_jni_tpu_torch as pt
from spark_rapids_jni_tpu_torch.column import Column
from spark_rapids_jni_tpu_torch.ops.hashing import (hash_partition,
                                                    murmur3_32)
from spark_rapids_jni_tpu_torch.parallel import dist_query as dq
from spark_rapids_jni_tpu_torch.parallel import make_2d_mesh, make_mesh
from spark_rapids_jni_tpu_torch.parallel import repartition_join as rj
from spark_rapids_jni_tpu_torch.parallel import shuffle as sh
from spark_rapids_jni_tpu_torch.utils import metrics

N_DEV = 8
CPU = "cpu"


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(N_DEV, device=CPU)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _j(a):
    return jnp.asarray(a)


# --- cases --------------------------------------------------------------------


def _case(n_fact=4096, n_item=512, n_cat=7, null_keys=False, seed=0):
    """The q65 shape: store_sales ⋈ item on item_sk, by category."""
    rng = np.random.default_rng(seed)
    item_sk = rng.permutation(np.arange(10_000, dtype=np.int64))[:n_item]
    item_cat = rng.integers(0, n_cat, n_item).astype(np.int32)
    fact_sk = np.where(rng.random(n_fact) < 0.85,
                       item_sk[rng.integers(0, n_item, n_fact)],
                       rng.integers(20_000, 30_000, n_fact)).astype(np.int64)
    fact_qty = rng.integers(1, 100, n_fact).astype(np.int64)
    fv = np.ones((n_fact, 2), dtype=bool)
    iv = np.ones((n_item, 2), dtype=bool)
    if null_keys:
        fv[:, 0] = rng.random(n_fact) < 0.9
        iv[:, 0] = rng.random(n_item) < 0.95
    return item_sk, item_cat, fact_sk, fact_qty, fv, iv


def _dup_case():
    """About three build rows a key, in different categories, with null
    keys on both sides."""
    rng = np.random.default_rng(13)
    n_fact, n_item = 1024, 256
    base = np.arange(10, 110, dtype=np.int64)
    item_sk = rng.choice(base, n_item).astype(np.int64)
    item_cat = rng.integers(0, 5, n_item).astype(np.int32)
    fact_sk = base[rng.integers(0, base.shape[0], n_fact)].astype(np.int64)
    fact_qty = rng.integers(1, 9, n_fact).astype(np.int64)
    fv = np.ones((n_fact, 2), bool)
    iv = np.ones((n_item, 2), bool)
    fv[:, 0] = rng.random(n_fact) < 0.9
    iv[:, 0] = rng.random(n_item) < 0.9
    return item_sk, item_cat, fact_sk, fact_qty, fv, iv


def _skew_case():
    """60% of the fact rows on one key."""
    rng = np.random.default_rng(9)
    n_fact, n_item = 2048, 64
    item_sk = np.arange(100, 100 + n_item, dtype=np.int64)
    item_cat = rng.integers(0, 5, n_item).astype(np.int32)
    fact_sk = np.where(rng.random(n_fact) < 0.6, item_sk[7],
                       item_sk[rng.integers(0, n_item, n_fact)]).astype(
                           np.int64)
    fact_qty = rng.integers(1, 10, n_fact).astype(np.int64)
    return (item_sk, item_cat, fact_sk, fact_qty, np.ones((n_fact, 2), bool),
            np.ones((n_item, 2), bool))


def _max_key_case():
    """A key equal to the int64 maximum, the dead slots' sentinel."""
    n_fact = 256
    item_sk = np.asarray([5, 9, np.iinfo(np.int64).max, 0, 0, 0, 0, 0],
                         np.int64)
    item_cat = np.asarray([0, 1, 2, 0, 0, 0, 0, 0], np.int32)
    iv = np.zeros((8, 2), bool)
    iv[:3] = True
    fact_sk = np.asarray([5, np.iinfo(np.int64).max] * (n_fact // 2),
                         np.int64)
    return (item_sk, item_cat, fact_sk, np.ones(n_fact, np.int64),
            np.ones((n_fact, 2), bool), iv)


def _zipf_case():
    rng = np.random.default_rng(17)
    n, nb, G = 16_384, 512, 16
    fk = (np.minimum(rng.zipf(2.0, n), nb) - 1).astype(np.int64)
    fv = rng.integers(-30, 30, n).astype(np.int64)
    bk = np.arange(nb, dtype=np.int64)
    bg = rng.integers(0, G, nb).astype(np.int32)
    fvld = np.ones((n, 2), bool)
    fvld[:, 0] = rng.random(n) < 0.95
    return bk, bg, fk, fv, fvld, np.ones((nb, 2), bool)


def _multi_case():
    rng = np.random.default_rng(17)
    n_fact, n_item = 2048, 256
    item = [rng.integers(100, 160, n_item).astype(np.int64),
            rng.integers(0, 12, n_item).astype(np.int32),
            rng.integers(0, 6, n_item).astype(np.int32)]
    fact = [np.where(rng.random(n_fact) < 0.8,
                     rng.integers(100, 160, n_fact),
                     rng.integers(900, 950, n_fact)).astype(np.int64),
            rng.integers(0, 12, n_fact).astype(np.int32),
            rng.integers(1, 30, n_fact).astype(np.int64)]
    fv = np.ones((n_fact, 3), bool)
    iv = np.ones((n_item, 3), bool)
    fv[:, 0] = rng.random(n_fact) < 0.9
    iv[:, 1] = rng.random(n_item) < 0.9
    return fact, fv, item, iv


def _oracle(item_sk, item_cat, fact_sk, fact_qty, fv, iv, n_cat):
    df_i = pd.DataFrame({"sk": item_sk, "cat": item_cat})[iv[:, 0]]
    df_f = pd.DataFrame({"sk": fact_sk, "qty": fact_qty})[fv[:, 0]]
    g = df_f.merge(df_i, on="sk").groupby("cat")["qty"].agg(["sum", "count"])
    sums = np.zeros(n_cat, np.int64)
    cnts = np.zeros(n_cat, np.int64)
    sums[g.index.to_numpy()] = g["sum"].to_numpy()
    cnts[g.index.to_numpy()] = g["count"].to_numpy()
    return sums, cnts


# (case, n_cat, fact capacity, build capacity); None: the auto path
FIXED = {
    "q65": (lambda: _case(), 7, 2 * 4096 // 64 + 64, 2 * 512 // 64 + 64),
    "nulls": (lambda: _case(null_keys=True, seed=3), 7, 2 * 4096 // 64 + 64,
              2 * 512 // 64 + 64),
    "overflow": (lambda: _case(seed=5), 7, 2, 2 * 512 // 64 + 64),
    "skew": (_skew_case, 5, 2 * 2048 // 8, 2 * 64 // 64 + 64),
    "duplicates": (_dup_case, 5, 1024, 256),
    "max_key": (_max_key_case, 3, 256, 8),
}
AUTO = {"auto_skew": (_skew_case, 5), "auto_q65": (lambda: _case(), 7)}


def _jax_fixed(case, n_cat, fcap, bcap):
    item_sk, item_cat, fact_sk, fact_qty, fv, iv = case
    spec = jrj.JoinAggSpec((sr.int64, sr.int64), (sr.int64, sr.int32),
                           0, 0, 1, 1, n_cat, fcap, bcap)
    s, c, d = jrj.repartition_join_agg(
        jmake_mesh(N_DEV), spec, (_j(fact_sk), _j(fact_qty)), _j(fv),
        (_j(item_sk), _j(item_cat)), _j(iv))
    return np.asarray(s), np.asarray(c), int(np.asarray(d))


def _capturing_auto(*args, **kw):
    """The JAX package's auto path, and the spec its count pass chose."""
    seen = []
    orig = jrj.repartition_join_agg

    def spy(mesh, spec, *a, **k):
        seen.append(spec)
        return orig(mesh, spec, *a, **k)
    jrj.repartition_join_agg = spy
    try:
        s, c, d = jrj.repartition_join_agg_auto(*args, **kw)
    finally:
        jrj.repartition_join_agg = orig
    return (np.asarray(s), np.asarray(c), int(np.asarray(d))), seen[-1]


@pytest.fixture(scope="module")
def jax_out():
    out = {}
    jm = jmake_mesh(N_DEV)
    for name, (case_of, n_cat, fcap, bcap) in FIXED.items():
        out[name] = _jax_fixed(case_of(), n_cat, fcap, bcap)
    for name, (case_of, n_cat) in AUTO.items():
        item_sk, item_cat, fact_sk, fact_qty, fv, iv = case_of()
        out[name] = _capturing_auto(
            jm, (sr.int64, sr.int64), (sr.int64, sr.int32), 0, 0, 1, 1,
            n_cat, (_j(fact_sk), _j(fact_qty)), _j(fv),
            (_j(item_sk), _j(item_cat)), _j(iv))
    fact, fv, item, iv = _multi_case()
    out["multi"] = _capturing_auto(
        jm, (sr.int64, sr.int32, sr.int64), (sr.int64, sr.int32, sr.int32),
        [0, 1], [0, 1], 2, 2, 6, tuple(_j(a) for a in fact), _j(fv),
        tuple(_j(a) for a in item), _j(iv))
    return out


def _port_fixed(mesh, case, n_cat, fcap, bcap):
    item_sk, item_cat, fact_sk, fact_qty, fv, iv = case
    spec = rj.JoinAggSpec((pt.int64, pt.int64), (pt.int64, pt.int32),
                          0, 0, 1, 1, n_cat, fcap, bcap)
    s, c, d = rj.repartition_join_agg(
        mesh, spec, (_t(fact_sk), _t(fact_qty)), _t(fv),
        (_t(item_sk), _t(item_cat)), _t(iv))
    return s.numpy(), c.numpy(), int(d)


def _spec_fields(spec):
    return (spec.fact_capacity, spec.build_capacity, spec.key_min,
            spec.key_span, spec.key_mins, spec.key_spans, spec.salt)


def _port_spec():
    return (rj.COUNTS["fact_capacity"], rj.COUNTS["build_capacity"],
            rj.COUNTS["key_span"], rj.COUNTS["salt"])


# --- the repartition join -------------------------------------------------------


@pytest.mark.parametrize("name", list(FIXED))
def test_fixed_capacity_join_equals_jax(name, mesh, jax_out):
    """Sums, counts and ``dropped`` equal the JAX package's; where nothing
    dropped, the pandas oracle's."""
    case_of, n_cat, fcap, bcap = FIXED[name]
    case = case_of()
    got = _port_fixed(mesh, case, n_cat, fcap, bcap)
    want = jax_out[name]
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2] == want[2]
    if name == "overflow":
        assert got[2] > 0
        return
    assert got[2] == 0
    ws, wc = _oracle(*case, n_cat)
    np.testing.assert_array_equal(got[0], ws)
    np.testing.assert_array_equal(got[1], wc)


@pytest.mark.parametrize("name", list(AUTO))
def test_auto_capacity_equals_jax(name, mesh, jax_out):
    """The count pass picks the JAX package's capacities, window and
    salt, and nothing drops."""
    case_of, n_cat = AUTO[name]
    item_sk, item_cat, fact_sk, fact_qty, fv, iv = case_of()
    s, c, d = rj.repartition_join_agg_auto(
        mesh, (pt.int64, pt.int64), (pt.int64, pt.int32), 0, 0, 1, 1,
        n_cat, (_t(fact_sk), _t(fact_qty)), _t(fv),
        (_t(item_sk), _t(item_cat)), _t(iv))
    (ws, wc, wd), jspec = jax_out[name]
    np.testing.assert_array_equal(s.numpy(), ws)
    np.testing.assert_array_equal(c.numpy(), wc)
    assert int(d) == wd == 0
    assert _port_spec() == (jspec.fact_capacity, jspec.build_capacity,
                            jspec.key_span, jspec.salt)
    os_, oc = _oracle(item_sk, item_cat, fact_sk, fact_qty, fv, iv, n_cat)
    np.testing.assert_array_equal(s.numpy(), os_)


def test_multikey_composite_auto_equals_jax(mesh, jax_out):
    fact, fv, item, iv = _multi_case()
    s, c, d = rj.repartition_join_agg_auto(
        mesh, (pt.int64, pt.int32, pt.int64), (pt.int64, pt.int32, pt.int32),
        [0, 1], [0, 1], 2, 2, 6, tuple(_t(a) for a in fact), _t(fv),
        tuple(_t(a) for a in item), _t(iv))
    (ws, wc, wd), jspec = jax_out["multi"]
    np.testing.assert_array_equal(s.numpy(), ws)
    np.testing.assert_array_equal(c.numpy(), wc)
    assert int(d) == wd == 0
    assert rj.COUNTS["key_span"] == jspec.key_span > 0
    df_i = pd.DataFrame({"a": item[0], "b": item[1],
                         "cat": item[2]})[iv[:, 0] & iv[:, 1]]
    df_f = pd.DataFrame({"a": fact[0], "b": fact[1],
                         "qty": fact[2]})[fv[:, 0] & fv[:, 1]]
    g = df_f.merge(df_i, on=["a", "b"]).groupby("cat")["qty"].sum()
    want = np.zeros(6, np.int64)
    want[g.index.to_numpy()] = g.to_numpy()
    np.testing.assert_array_equal(s.numpy(), want)


def test_multikey_overflow_and_salt_validation_raise(mesh):
    big = _t(np.asarray([-2**61, 2**61] * 4, np.int64))
    fd = (big, big, _t(np.ones(8, np.int64)))
    bd = (big, big, _t(np.zeros(8, np.int32)))
    v = torch.ones((8, 3), dtype=torch.bool)
    sch_f = (pt.int64, pt.int64, pt.int64)
    sch_b = (pt.int64, pt.int64, pt.int32)
    with pytest.raises(ValueError, match="63"):
        rj.repartition_join_agg_auto(mesh, sch_f, sch_b, [0, 1], [0, 1],
                                     2, 2, 2, fd, v, bd, v)
    with pytest.raises(ValueError, match="power of two"):
        rj.repartition_join_agg_auto(mesh, sch_f, sch_b, 0, 0, 2, 2, 2,
                                     fd, v, bd, v, salt=3)
    with pytest.raises(ValueError, match="divide"):
        rj.repartition_join_agg_auto(mesh, sch_f, sch_b, 0, 0, 2, 2, 2,
                                     tuple(a[:7] for a in fd), v[:7], bd, v)


@pytest.mark.parametrize("salt,aqe", [(1, "0"), (4, "0"), (None, "1")])
def test_salted_subjoin_zipf_equals_jax(salt, aqe, mesh, monkeypatch):
    """The AQE skew split (``test_aqe.py``'s Zipf case): every salt gives
    the unsalted result bit for bit, and the salt, capacities and result
    are the JAX package's."""
    bk, bg, fk, fv, fvld, bvld = _zipf_case()
    monkeypatch.setenv("SRJT_AQE", aqe)
    metrics.set_enabled(True)
    metrics.reset()
    try:
        s, c, d = rj.repartition_join_agg_auto(
            mesh, (pt.int64, pt.int64), (pt.int64, pt.int32), 0, 0, 1, 1, 16,
            (_t(fk), _t(fv)), _t(fvld), (_t(bk), _t(bg)), _t(bvld),
            salt=salt)
        fired = metrics.counter_value("plan.aqe.skew_split.fired")
    finally:
        metrics.set_enabled(None)
    (ws, wc, wd), jspec = _capturing_auto(
        jmake_mesh(N_DEV), (sr.int64, sr.int64), (sr.int64, sr.int32),
        0, 0, 1, 1, 16, (_j(fk), _j(fv)), _j(fvld), (_j(bk), _j(bg)),
        _j(bvld), salt=salt)
    np.testing.assert_array_equal(s.numpy(), ws)
    np.testing.assert_array_equal(c.numpy(), wc)
    assert int(d) == wd == 0
    assert _port_spec() == (jspec.fact_capacity, jspec.build_capacity,
                            jspec.key_span, jspec.salt)
    f = pd.DataFrame({"k": fk, "v": fv})[fvld[:, 0]]
    o = f.merge(pd.DataFrame({"k": bk, "g": bg}), on="k").groupby("g")[
        "v"].sum().reindex(range(16), fill_value=0)
    np.testing.assert_array_equal(s.numpy(), o.to_numpy())
    if salt is None:
        assert rj.COUNTS["salt"] > 1 and fired >= 1


# --- the shuffle --------------------------------------------------------------


@pytest.mark.parametrize("n,parts,cap", [(10, 3, 4), (10, 2, 4), (300, 8, 30),
                                         (6, 3, 4)])
def test_bucketize_equals_jax(n, parts, cap):
    """Bucket rows, counts and ``dropped`` equal the JAX package's,
    out-of-range destinations included (dropped, never wrapped)."""
    rng = np.random.default_rng(n + parts)
    rows = rng.integers(0, 255, (n, 3)).astype(np.uint8)
    part = rng.integers(-1, parts + 1, n).astype(np.int32)
    want = jsh.bucketize_rows(_j(rows), _j(part), parts, cap)
    got = sh.bucketize_rows(_t(rows), _t(part), parts, cap)
    np.testing.assert_array_equal(got.rows.numpy(), np.asarray(want.rows))
    np.testing.assert_array_equal(got.counts.numpy(),
                                  np.asarray(want.counts))
    assert int(got.dropped) == int(want.dropped)


@pytest.mark.parametrize("salt", [1, 2, 4, 8])
def test_salted_and_replicated_ids_equal_jax(salt):
    rng = np.random.default_rng(salt)
    keys = rng.integers(-10**12, 10**12, 512).astype(np.int64)
    np.testing.assert_array_equal(
        sh.salted_partition_ids(_t(keys), 8, salt).numpy(),
        np.asarray(jsh.salted_partition_ids(_j(keys), 8, salt)))
    tiled = np.tile(keys[:64], salt)
    np.testing.assert_array_equal(
        sh.replicated_partition_ids(_t(tiled), 8, salt).numpy(),
        np.asarray(jsh.replicated_partition_ids(_j(tiled), 8, salt)))
    np.testing.assert_array_equal(
        murmur3_32(_t(keys)).numpy().astype(np.uint32),
        np.asarray(jmurmur(_j(keys))).astype(np.uint32))


def test_all_to_all_shuffle_delivers_every_row_once(mesh):
    per_dev, cap = 32, 24
    keys = np.arange(N_DEV * per_dev, dtype=np.int64)
    rows = np.repeat(keys[:, None], 4, axis=1).astype(np.uint8)
    sent = []
    for s in range(N_DEV):
        k = _t(keys[s * per_dev:(s + 1) * per_dev])
        part = hash_partition(murmur3_32(k), N_DEV)
        sent.append(sh.bucketize_rows(_t(rows[s * per_dev:(s + 1) * per_dev]),
                                      part, N_DEV, cap))
    recv = sh.all_to_all_shuffle(sent, mesh.devices)
    seen = []
    for d, b in enumerate(recv):
        flat = b.rows.reshape(-1, 4)[sh.received_mask(b).reshape(-1)]
        got = flat[:, 0].to(torch.int64)
        assert bool((hash_partition(murmur3_32(got), N_DEV) == d).all())
        seen += got.tolist()
        # shard d's row s is what shard s addressed to d
        for s in range(N_DEV):
            assert torch.equal(b.rows[s], sent[s].rows[d])
    assert sorted(seen) == keys.tolist()
    stats = sh.record_shuffle_stats(recv)
    assert stats["rows"] == N_DEV * per_dev and stats["dropped"] == 0
    assert stats["bytes_moved"] == N_DEV * per_dev * 4


# --- the distributed star aggregate -------------------------------------------


def _star_data(n=8 * 1000, m=64, groups=7, seed=0):
    rng = np.random.default_rng(seed)
    dim_keys = rng.choice(10_000, size=m, replace=False).astype(np.int64)
    dim_groups = [f"g{v}" for v in rng.integers(0, groups, m)]
    fact_key = np.where(rng.random(n) < 0.67,
                        rng.choice(dim_keys, size=n),
                        rng.integers(20_000, 30_000, n)).astype(np.int64)
    fact_val = rng.integers(-100, 100, n).astype(np.int64)
    return dim_keys, dim_groups, fact_key, fact_val


def test_star_agg_equals_jax_and_pandas(mesh):
    dim_keys, dim_groups, fact_key, fact_val = _star_data()
    dim = dq.prepare_dimension(
        Column.from_numpy(dim_keys, device=CPU),
        Column.strings_from_list(dim_groups, device=CPU))
    sums, cnts = dq.distributed_star_agg(mesh, dim, _t(fact_key),
                                         _t(fact_val))
    from spark_rapids_jni_tpu.column import Column as JColumn
    jdim = jdq.prepare_dimension(JColumn.from_numpy(dim_keys),
                                 JColumn.strings_from_list(dim_groups))
    js, jc = jdq.distributed_star_agg(jmake_mesh(N_DEV), jdim,
                                      _j(fact_key), _j(fact_val))
    np.testing.assert_array_equal(sums.numpy(), np.asarray(js))
    np.testing.assert_array_equal(cnts.numpy(), np.asarray(jc))
    assert dim.num_groups == jdim.num_groups
    np.testing.assert_array_equal(dim.keys.numpy(), np.asarray(jdim.keys))
    code_of = {g: i for i, g in enumerate(sorted(set(dim_groups)))}
    f = pd.DataFrame({"k": fact_key, "v": fact_val}).merge(
        pd.DataFrame({"k": dim_keys, "g": dim_groups}), on="k")
    for g, row in f.groupby("g")["v"].agg(["sum", "count"]).iterrows():
        assert sums[code_of[g]] == row["sum"]
        assert cnts[code_of[g]] == row["count"]


def test_star_agg_integer_groups_and_2d_mesh(mesh):
    rng = np.random.default_rng(7)
    dim = dq.prepare_dimension(
        Column.from_numpy(np.arange(20, dtype=np.int64), device=CPU),
        Column.from_numpy((np.arange(20) % 4).astype(np.int32), device=CPU))
    fact_key = rng.integers(0, 25, 8 * 64).astype(np.int64)
    fact_val = rng.integers(-10, 10, 8 * 64).astype(np.int64)
    m2 = make_2d_mesh(2, 4, device=CPU)
    assert m2.shape == {"dcn": 2, "ici": 4}
    for m, axis in ((mesh, "data"), (m2, ("dcn", "ici"))):
        sums, cnts = dq.distributed_star_agg(m, dim, _t(fact_key),
                                             _t(fact_val), axis_name=axis)
        hit = fact_key < 20
        assert int(cnts.sum()) == int(hit.sum())
        for g in range(dim.num_groups):
            sel = hit & ((fact_key % 4) == g)
            assert int(sums[g]) == int(fact_val[sel].sum())


def test_duplicate_dimension_keys_rejected():
    with pytest.raises(ValueError, match="unique"):
        dq.prepare_dimension(
            Column.from_numpy(np.asarray([1, 1, 2], np.int64), device=CPU),
            Column.from_numpy(np.asarray([0, 1, 0], np.int32), device=CPU))


def test_mesh_of_one_device_repeated():
    """A mesh may repeat a device (shards on one card): the exchange then
    copies on that device, and the join is the same."""
    case = _case(seed=2)
    one = make_mesh(1, device=CPU).devices[0]
    rep = pt.parallel.Mesh([one] * 4)
    many = make_mesh(4, device=CPU)
    a = _port_fixed(rep, case, 7, 256, 64)
    b = _port_fixed(many, case, 7, 256, 64)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert rep.size == 4 and rep.shape == {"data": 4}
