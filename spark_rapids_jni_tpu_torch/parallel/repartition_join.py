"""Repartition (shuffled) hash equi-join and aggregate over a device mesh.

The port's counterpart of the JAX package's
``parallel/repartition_join.py``: Spark's shuffled hash join for PK-FK
equi-joins (the TPC-DS store_sales ⋈ item shape) with BOTH sides
sharded.  Each side is hash-partitioned on its join key and exchanged,
so that all rows of a key land on one shard, where a local probe joins
them:

  per shard: JCUDF fixed-width rows (``rowconv``'s layout)
          →  murmur3 key hash → bucketize     (``shuffle.py``)
          →  all-to-all exchange              (both sides)
          →  rows decoded → local probe → per-group partials
  global:    the partials summed in shard order (the ``psum``)

As in the JAX package:

* every shape is fixed: a per-destination bucket capacity with drop
  accounting; :func:`repartition_join_agg_auto` sizes the capacities by
  a count pass (one host read), so that nothing drops;
* the local join is a segment-run probe over the received build side:
  equal-key build rows form a run, each fact row's value adds once to
  its run, and each live build row of the run takes the run's sums, so
  duplicate build keys join every matching fact row without the pairs;
* dense integer build keys (the auto path detects them from the build
  key range) skip the sort: fact values add into a ``[span]`` slot
  table addressed by ``key - key_min``;
* a tuple key packs into one int64 composite lane over per-key build
  windows, which the routing and the probe share;
* ``salt`` (the AQE skew split): a hot key's fact rows round-robin over
  ``S`` sub-partitions, each holding a replica of the key group's build
  rows, so the merge stays exact.

The JAX package runs this as one ``shard_map`` program; the port loops
over the shards of a :class:`~.mesh.Mesh` and exchanges by copies
(``shuffle.all_to_all_shuffle``).  The bucket counts, ``dropped``, the
capacities and the salted destinations are the JAX package's exactly.
:data:`COUNTS` holds the last exchange's accounting.
"""

from __future__ import annotations

import collections
from typing import NamedTuple, Sequence

import torch

from ..column import Column, Table
from ..ops.hashing import hash_partition, murmur3_32
from ..rowconv.convert import _fixed_extract, _fixed_region
from ..rowconv.layout import compute_row_layout
from ..utils import syncs
from .dist_query import psum, shard
from .mesh import Mesh
from .shuffle import (Buckets, all_to_all_shuffle, bucketize_rows,
                      received_mask, replicated_partition_ids,
                      salted_partition_ids)

#: the last join's exchange: ``rows_exchanged`` and ``bytes_exchanged``
#: (valid rows and their bytes), ``padded_bytes`` (the padded buckets
#: copied), ``dropped``, and the spec's ``salt``, capacities and
#: ``key_span``
COUNTS: collections.Counter = collections.Counter()


class JoinAggSpec(NamedTuple):
    """Static description of a repartition join + aggregate (the JAX
    package's fields).  Column indices address the respective schema; the
    probe (fact) side aggregates ``fact_value_idx`` grouped by the build
    side's ``build_group_idx`` (dense int32 codes in [0, num_groups))."""
    fact_schema: tuple
    build_schema: tuple
    fact_key_idx: "int | tuple"
    build_key_idx: "int | tuple"
    build_group_idx: int
    fact_value_idx: int
    num_groups: int
    fact_capacity: int     # per-destination bucket rows, fact side
    build_capacity: int    # per-destination bucket rows, build side
    # dense direct lookup: key_span > 0 addresses a [span] slot table by
    # key - key_min; 0 keeps the sort-merge probe
    key_min: int = 0
    key_span: int = 0
    # composite keys: per-key 0-based build windows [min, min + span)
    key_mins: tuple = ()
    key_spans: tuple = ()
    # the skew split: a power of two dividing the partition count
    salt: int = 1


def _composite_lane(datas, validm, idxs, mins, spans):
    """Mixed-radix int64 pack of a key tuple (the last key fastest) and
    the "every key valid and in its window" mask: ``ops/join_plan.py``'s
    composite lane."""
    comp = ok = None
    stride = 1
    for i, kmin, span in zip(idxs[::-1], mins[::-1], spans[::-1]):
        d = datas[i].to(torch.int64) - kmin
        okk = validm[:, i] & (d >= 0) & (d < span)
        ok = okk if ok is None else (ok & okk)
        t = d.clamp(0, span - 1) * stride
        comp = t if comp is None else comp + t
        stride *= span
    return comp, ok


def _key_lane(spec: JoinAggSpec, key_idx, datas, validm, mask=None):
    """(lane, live mask) of one side: the key column, or the composite
    pack of a key tuple."""
    if isinstance(key_idx, tuple):
        lane, ok = _composite_lane(datas, validm, key_idx, spec.key_mins,
                                   spec.key_spans)
        return lane, ok if mask is None else (mask & ok)
    v = validm[:, key_idx]
    return datas[key_idx], v if mask is None else (mask & v)


def _to_rows(layout, schema, datas, validm) -> torch.Tensor:
    """A shard's columns as JCUDF fixed-width rows, uint8 [n, row_size]."""
    n = validm.shape[0]
    cols = [Column(dt, d, validity=validm[:, i])
            for i, (dt, d) in enumerate(zip(schema, datas))]
    out = torch.empty((n, layout.fixed_row_size), dtype=torch.uint8,
                      device=validm.device)
    _fixed_region(layout, Table(cols), out)
    return out


def _shuffle_side(schema, datas, validm, parts, devices, capacity: int):
    """Every shard's columns → rows → buckets by ``parts`` → exchange →
    decode.  Returns per shard (datas, validity matrix, live-slot mask,
    dropped) of the rows it RECEIVED, and the received buckets."""
    P = len(devices)
    layout = compute_row_layout(list(schema))
    sent = [bucketize_rows(_to_rows(layout, schema, datas[s], validm[s]),
                           parts[s], P, capacity) for s in range(P)]
    recv = all_to_all_shuffle(sent, devices)
    out = []
    for b in recv:
        rows = b.rows.reshape(-1, layout.fixed_row_size)
        rdatas, rvalid, _ = _fixed_extract(layout, rows)
        out.append((rdatas, rvalid.t(), received_mask(b).reshape(-1),
                    b.dropped))
    return out, recv


def _zeros_add(size: int, index, values) -> torch.Tensor:
    """``zeros(size + 1).index_add_(index, values)[:size]``: index
    ``size`` is the sentinel that drops a value, as the JAX package's
    ``.at[].add(mode="drop")``."""
    out = torch.zeros(size + 1, dtype=values.dtype, device=values.device)
    out.index_add_(0, index.to(torch.int64), values)
    return out[:size]


def _groups(spec: JoinAggSpec, col, ok) -> torch.Tensor:
    g = col.to(torch.int64)
    G = spec.num_groups
    return torch.where(ok & (g >= 0) & (g < G), g, G)


def _local_join_agg(spec: JoinAggSpec, f, b):
    """One shard's join and per-group partials of its received rows
    (``f`` and ``b``: datas, validity matrix, live mask).  Returns (int64
    sums, int32 counts) over ``num_groups``."""
    fdatas, fvalidm, fmask = f
    bdatas, bvalidm, bmask = b
    fkey, flive = _key_lane(spec, spec.fact_key_idx, fdatas, fvalidm, fmask)
    bkey, blive = _key_lane(spec, spec.build_key_idx, bdatas, bvalidm, bmask)
    val = fdatas[spec.fact_value_idx].to(torch.int64)
    fval_ok = fvalidm[:, spec.fact_value_idx]
    G = spec.num_groups
    zero64 = torch.zeros((), dtype=torch.int64, device=val.device)
    zero32 = torch.zeros((), dtype=torch.int32, device=val.device)

    if spec.key_span > 0:
        # dense: the shuffle put every row of a key on this shard, so a
        # slot a live build row reads holds exactly its key's fact rows
        span = spec.key_span
        fd = fkey.to(torch.int64) - spec.key_min
        f_ok = flive & (fd >= 0) & (fd < span)
        fslot = torch.where(f_ok, fd, span)
        slot_sums = _zeros_add(span, fslot,
                               torch.where(f_ok & fval_ok, val, zero64))
        slot_cnts = _zeros_add(span, fslot, f_ok.to(torch.int32))
        bd = bkey.to(torch.int64) - spec.key_min
        b_ok = blive & (bd >= 0) & (bd < span)
        bslot = bd.clamp(0, span - 1)
        g = _groups(spec, bdatas[spec.build_group_idx], b_ok)
        sums = _zeros_add(G, g, torch.where(b_ok, slot_sums[bslot], zero64))
        cnts = _zeros_add(G, g, torch.where(b_ok, slot_cnts[bslot], zero32))
        return sums, cnts

    # build side: a dead or null-key slot gets the dtype's max AND sorts
    # after any live row of that value (a second, dead-flag key), so that
    # the leftmost match of a probe is live where one exists
    sent = torch.iinfo(bkey.dtype).max
    bkey = torch.where(blive, bkey, torch.full_like(bkey, sent))
    dead = (~blive).to(torch.int32)
    o1 = torch.sort(dead, stable=True).indices
    order = o1[torch.sort(bkey[o1], stable=True).indices]
    bkey_s = bkey[order]
    blive_s = blive[order]
    bgroup_s = bdatas[spec.build_group_idx][order]
    nb = bkey_s.shape[0]
    head = torch.ones(nb, dtype=torch.int64, device=bkey.device)
    head[1:] = (bkey_s[1:] != bkey_s[:-1]).to(torch.int64)
    run_id = torch.cumsum(head, 0) - 1
    common = torch.promote_types(bkey_s.dtype, fkey.dtype)
    sk, fk = bkey_s.to(common), fkey.to(common)
    pos = torch.searchsorted(sk, fk).clamp(0, max(nb - 1, 0))
    hit = flive & (sk[pos] == fk) & blive_s[pos]
    # each fact row adds once to its run; the sentinel run nb drops
    rf = torch.where(hit, run_id[pos], nb)
    run_sums = _zeros_add(nb, rf, torch.where(hit & fval_ok, val, zero64))
    run_cnts = _zeros_add(nb, rf, hit.to(torch.int32))
    # each live build row of a run takes the run's partials: one
    # contribution per (fact, build) pair
    g = _groups(spec, bgroup_s, blive_s)
    sums = _zeros_add(G, g, torch.where(blive_s, run_sums[run_id], zero64))
    cnts = _zeros_add(G, g, torch.where(blive_s, run_cnts[run_id], zero32))
    return sums, cnts


def _shard_side(mesh: Mesh, datas, valid, axis_name):
    """Per shard: the column tensors and the validity matrix."""
    cols = [shard(d, mesh, axis_name) for d in datas]
    vs = shard(valid, mesh, axis_name)
    return [[c[s] for c in cols] for s in range(len(vs))], vs


def repartition_join_agg(mesh: Mesh, spec: JoinAggSpec,
                         fact_datas: Sequence[torch.Tensor],
                         fact_valid: torch.Tensor,
                         build_datas: Sequence[torch.Tensor],
                         build_valid: torch.Tensor,
                         axis_name: str = "data"):
    """SELECT g, SUM(fact.value), COUNT(*) FROM fact JOIN build USING
    (key) GROUP BY build.group, both sides sharded and repartitioned over
    the mesh.  Duplicate build keys join every matching fact row.

    ``*_datas`` are global column tensors (row counts divisible by the
    shard count), ``*_valid`` the [n, ncols] validity matrices.  Returns
    (int64 sums [num_groups], int32 counts [num_groups], int32 dropped),
    on the first shard's device.  With fixed capacities ``dropped > 0``
    reports overflow; :func:`repartition_join_agg_auto` sizes them."""
    devices = mesh.devices
    P = mesh.axis_size(axis_name)
    fd, fv = _shard_side(mesh, fact_datas, fact_valid, axis_name)
    bd, bv = _shard_side(mesh, build_datas, build_valid, axis_name)
    # routing hashes the lane the probe uses
    fparts, bparts = [], []
    for s in range(P):
        fshuf, _ = _key_lane(spec, spec.fact_key_idx, fd[s], fv[s])
        if spec.salt > 1:
            # the skew split: the build shard replicated S times
            # (replica-major), one replica a sub-partition of its group
            bd[s] = [d.repeat(spec.salt) for d in bd[s]]
            bv[s] = bv[s].repeat(spec.salt, 1)
        bshuf, _ = _key_lane(spec, spec.build_key_idx, bd[s], bv[s])
        fparts.append(salted_partition_ids(fshuf, P, spec.salt))
        bparts.append(replicated_partition_ids(bshuf, P, spec.salt))
    f_recv, fb = _shuffle_side(spec.fact_schema, fd, fv, fparts, devices,
                               spec.fact_capacity)
    b_recv, bb = _shuffle_side(spec.build_schema, bd, bv, bparts, devices,
                               spec.build_capacity)
    _account(spec, fb, bb)
    parts = [_local_join_agg(spec, f[:3], b[:3])
             for f, b in zip(f_recv, b_recv)]
    dropped = psum([f[3] + b[3] for f, b in zip(f_recv, b_recv)])
    return (psum([p[0] for p in parts]), psum([p[1] for p in parts]),
            dropped)


def _account(spec: JoinAggSpec, fact: list[Buckets],
             build: list[Buckets]) -> None:
    """:data:`COUNTS` of an exchange, read from the received counts (one
    host read a side)."""
    COUNTS.clear()
    for side in (fact, build):
        counts = torch.stack([b.counts.to(side[0].counts.device)
                              for b in side])
        row_bytes = side[0].rows.shape[-1] * side[0].rows.element_size()
        rows = int(counts.sum())
        COUNTS["rows_exchanged"] += rows
        COUNTS["bytes_exchanged"] += rows * row_bytes
        COUNTS["padded_bytes"] += sum(b.rows.numel() * b.rows.element_size()
                                      for b in side)
    COUNTS["salt"] = spec.salt
    COUNTS["fact_capacity"] = spec.fact_capacity
    COUNTS["build_capacity"] = spec.build_capacity
    COUNTS["key_span"] = spec.key_span


def _bucket_capacity(need: int) -> int:
    """A measured bucket need rounded up to a shared size (at most ~12.5%
    growth), a multiple of 8: the JAX package's compile-key buckets."""
    need = max(int(need), 8)
    p = 8
    while p < need:
        p <<= 1
    step = max(8, p // 8)
    return -(-need // step) * step


def _needs(P: int, salts, fact_keys, build_keys) -> torch.Tensor:
    """The count pass: for each candidate salt, the largest
    per-destination bucket each side needs on any shard, int64 [2, k]
    (fact row, build row) on the first shard's device, not read."""
    nf, nbs = [], []
    for S in salts:
        groups = P // S if S > 1 else P
        fmax = bmax = None
        for fk, bk in zip(fact_keys, build_keys):
            fpart = salted_partition_ids(fk, P, S).to(torch.int64)
            fc = torch.bincount(fpart, minlength=P)[:P].max()
            bpart = hash_partition(murmur3_32(bk), groups).to(torch.int64)
            bc = torch.bincount(bpart, minlength=groups)[:groups].max()
            fc, bc = fc.to(fact_keys[0].device), bc.to(fact_keys[0].device)
            fmax = fc if fmax is None else torch.maximum(fmax, fc)
            bmax = bc if bmax is None else torch.maximum(bmax, bc)
        nf.append(fmax)
        nbs.append(bmax)
    return torch.stack([torch.stack(nf), torch.stack(nbs)])


def _read(t: torch.Tensor) -> list:
    """One host read (counted as a ``utils.syncs`` sync)."""
    syncs.note_sync()
    return t.cpu().tolist()


def repartition_join_agg_auto(mesh: Mesh, fact_schema, build_schema,
                              fact_key_idx, build_key_idx,
                              build_group_idx: int, fact_value_idx: int,
                              num_groups: int,
                              fact_datas: Sequence[torch.Tensor],
                              fact_valid: torch.Tensor,
                              build_datas: Sequence[torch.Tensor],
                              build_valid: torch.Tensor,
                              axis_name: str = "data",
                              salt: "int | None" = None):
    """:func:`repartition_join_agg` with the capacities sized by a count
    pass (the true per-destination bucket maxima, one host read),
    rounded by :func:`_bucket_capacity`, so that nothing drops.

    Tuple keys (equal-length index lists) pack over per-key build windows
    measured once (one read), into a composite lane below 2^63 (more
    raises).  A dense build key range (``ops/join_plan.py``'s rule) sets
    ``key_min`` / ``key_span`` so that each shard probes by direct
    lookup.

    ``salt`` forces a skew split (a power of two dividing the partition
    count).  None: with ``SRJT_AQE`` on, the count pass measures every
    candidate salt in the same read, and a hot-bucket need at least
    ``SRJT_AQE_SKEW_FACTOR`` times the uniform expectation picks a salt
    (``plan.aqe.skew_split.fired``): the same result, the hot side's
    capacity cut about salt times."""
    from ..ops import join_plan
    from ..utils import knobs, metrics
    from .shuffle import bucket_reservation

    fki = tuple(fact_key_idx) \
        if isinstance(fact_key_idx, (list, tuple)) else fact_key_idx
    bki = tuple(build_key_idx) \
        if isinstance(build_key_idx, (list, tuple)) else build_key_idx
    if isinstance(fki, tuple) != isinstance(bki, tuple) or (
            isinstance(fki, tuple) and len(fki) != len(bki)):
        raise ValueError("fact/build key index lists must match in length")
    if isinstance(fki, tuple) and len(fki) == 1:
        fki, bki = fki[0], bki[0]
    multi = isinstance(fki, tuple)
    key_min = key_span = 0
    key_mins = key_spans = ()
    P = mesh.axis_size(axis_name)
    S = 1 if salt is None else max(int(salt), 1)
    if S > 1 and ((S & (S - 1)) or P % S):
        raise ValueError("salt must be a power of two dividing the "
                         "partition count")
    if multi:
        exprs = []
        for i in bki:
            bk = build_datas[i]
            if (bk.dtype.is_floating_point or bk.dtype == torch.bool
                    or bk.dtype == torch.uint64):
                raise ValueError(
                    "composite repartition keys must be int-kind below 64 "
                    "unsigned bits; pre-encode strings/decimals to codes")
            bv = build_valid[:, i]
            info = torch.iinfo(bk.dtype)
            exprs += [torch.where(bv, bk, info.max).min().to(torch.int64),
                      torch.where(bv, bk, info.min).max().to(torch.int64)]
        allv = build_valid[:, list(bki)].all(dim=1)
        exprs.append(allv.sum().to(torch.int64))
        vals = _read(torch.stack(exprs))                 # one read
        nvalid = vals[-1]
        mins, spans, prod = [], [], 1
        for j in range(len(bki)):
            kmin, kmax = vals[2 * j], vals[2 * j + 1]
            if kmax < kmin:                  # this key column is all-null
                kmin, span = 0, 1
            else:
                kmin = (kmin // 64) * 64
                span = _bucket_capacity(kmax - kmin + 1)
            mins.append(kmin)
            spans.append(span)
            prod *= span
        if prod >= 1 << 63:
            raise ValueError(
                "composite key windows overflow 63 bits — the distributed "
                "shard path has no fingerprint fallback; narrow the key "
                "ranges or join through ops.join locally")
        key_mins, key_spans = tuple(mins), tuple(spans)
        if nvalid > 0 and prod <= min(
                max(join_plan.DENSE_SPAN_FACTOR * nvalid,
                    join_plan.DENSE_SPAN_FLOOR), join_plan.DENSE_SPAN_CAP):
            key_span = prod               # the composite lane is 0-based
        fact_key, _ = _composite_lane(fact_datas, fact_valid, fki,
                                      key_mins, key_spans)
        build_key, _ = _composite_lane(build_datas, build_valid, bki,
                                       key_mins, key_spans)
    else:
        fact_key, build_key = fact_datas[fki], build_datas[bki]
    fkeys = shard(fact_key, mesh, axis_name)
    bkeys = shard(build_key, mesh, axis_name)
    if salt is None and P > 1 and knobs.get("SRJT_AQE"):
        cand = [1]
        while cand[-1] * 2 <= P and P % (cand[-1] * 2) == 0:
            cand.append(cand[-1] * 2)
        needs_all = _read(_needs(P, cand, fkeys, bkeys))  # one read, [2, k]
        n_local = max(fact_datas[0].shape[0] // P, 1)
        uniform = max(n_local / P, 1.0)
        ratio = float(needs_all[0][0]) / uniform
        pick = 0
        if ratio >= float(knobs.get("SRJT_AQE_SKEW_FACTOR")):
            # the hot destination's need falls as hot_mass / S: salt up to
            # where the uniform tail would dominate (about 2·ratio)
            while pick + 1 < len(cand) and cand[pick + 1] <= 2 * ratio:
                pick += 1
        S = cand[pick]
        needs = [needs_all[0][pick], needs_all[1][pick]]
        if S > 1 and metrics.recording():
            metrics.count("plan.aqe.skew_split.fired")
            metrics.gauge_max("shuffle.salt", S)
            metrics.annotate(skew_salt=S, skew_ratio=round(ratio, 2))
    else:
        n2 = _read(_needs(P, [S], fkeys, bkeys))        # one read
        needs = [n2[0][0], n2[1][0]]
    if not multi:
        bk = build_datas[bki]
        if not (bk.dtype.is_floating_point or bk.dtype == torch.bool
                or bk.dtype == torch.uint64):
            bv = build_valid[:, bki]
            info = torch.iinfo(bk.dtype)
            nvalid, kmin, kmax = _read(torch.stack([    # one more read
                bv.sum().to(torch.int64),
                torch.where(bv, bk, info.max).min().to(torch.int64),
                torch.where(bv, bk, info.min).max().to(torch.int64)]))
            if nvalid > 0:
                limit = min(max(join_plan.DENSE_SPAN_FACTOR * nvalid,
                                join_plan.DENSE_SPAN_FLOOR),
                            join_plan.DENSE_SPAN_CAP)
                if kmax - kmin + 1 <= limit:
                    key_min = (kmin // 4096) * 4096
                    key_span = _bucket_capacity(kmax - key_min + 1)
    spec = JoinAggSpec(
        fact_schema=tuple(fact_schema), build_schema=tuple(build_schema),
        fact_key_idx=fki, build_key_idx=bki,
        build_group_idx=build_group_idx, fact_value_idx=fact_value_idx,
        num_groups=num_groups,
        fact_capacity=_bucket_capacity(needs[0]),
        build_capacity=_bucket_capacity(needs[1]),
        key_min=key_min, key_span=key_span,
        key_mins=key_mins, key_spans=key_spans, salt=S)
    if metrics.recording():
        # mesh-wide padded probe slots: the wasted-work proxy the AQE
        # comparison reads
        metrics.count("shuffle.padded_slots.fact", P * P * spec.fact_capacity)
        metrics.count("shuffle.padded_slots.build",
                      P * P * spec.build_capacity)
    # arena admission for both sides' padded buckets, sized from the
    # measured capacities before they are made
    row_bytes = [sum(a.element_size() for a in datas) + len(datas)
                 for datas in (fact_datas, build_datas)]
    with bucket_reservation(P, spec.fact_capacity, row_bytes[0],
                            tag="shuffle.fact"), \
         bucket_reservation(P, spec.build_capacity, row_bytes[1],
                            tag="shuffle.build"):
        return repartition_join_agg(mesh, spec, fact_datas, fact_valid,
                                    build_datas, build_valid, axis_name)

