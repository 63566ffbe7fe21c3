"""Join planning: build-side indexes, dense-key lookup, index caching and
join→aggregate fusion (the join engine).

The port's counterpart of the JAX package's ``ops/join_plan.py``.
:func:`build_index` looks at the build (right) side once and picks one of
two index layouts.  Both answer a probe with ``(lo, counts)``, positions
into a key-sorted ``row_ids``, so ``ops.join``'s expansion is shared and
the two engines give identical indices:

* **dense**: both keys fixed-width integers (dates, decimal32/64
  payloads, dictionary codes of string keys; not float keys, decimal128
  or uint64), and the build keys' span ``kmax - kmin + 1`` at most
  ``max(DENSE_SPAN_FACTOR * n_valid, DENSE_SPAN_FLOOR)`` and
  ``DENSE_SPAN_CAP``.  A ``[span]`` table (slot → start into ``row_ids``,
  run length) is built once with ``index_add_``; a probe is a subtract,
  a clamp and two gathers.  TPC-DS surrogate keys are contiguous, so the
  star joins take it.  With at most one build row a slot (``unique``)
  ``row_ids`` is one scatter, no sort, and ``ops.join`` skips the pair
  expansion.
* **sorted**: everything else: a stable key sort, then two
  ``torch.searchsorted`` a probe.

Each host read (the valid count, the window's bounds, the longest run)
is one ``utils.syncs.scalar``, as in the JAX package, so that the
engine choice is on a compiled query's tape and its staleness check
(``models/compiled.py``) sees a change of engine.

Indexes and multi-key plans are cached on the identity of their key
tensors: a weak reference and the tensor's ``_version``, so that an entry
dies with its tensor and an in-place write misses it.  Both caches are
bypassed under capture and replay, so that the two visit the same sites
(``utils.syncs``).  The index cache is an LRU over its indexes' device
bytes, capped at ``SRJT_INDEX_CACHE_CAP`` (where that is unset,
:data:`INDEX_CACHE_CAP`, the knob's default of 512 MiB); each eviction
counts in ``build_index.evictions`` and in :func:`index_cache_stats`.
With the arena on (``SRJT_HBM_ARENA``, ``memory/``) each cached index
registers as a ``memory.spill`` resident: budget pressure moves its
tensors to host memory, and the next hit faults them back bit-exactly
(``build_index.faultback``).  Each cache takes a lock of its own that
``analysis.sanitize`` tracks (``ops.join_plan.index_cache``,
``ops.join_plan.plan_memo``); where a spillable index may be touched,
the budget's lock comes first (the spiller runs under it).

``SRJT_JOIN_ENGINE`` (``dense`` or ``sorted``) pins the engine of every
join where no :func:`force_engine` is active.  Which engine, key plan
and fused path each call took is counted in :data:`COUNTS`
(``engine.dense``, ``pack.composite``, ``fused.unique_gather``, ...), as
a kernel wrapper counts its launches, and in ``utils.metrics`` under the
JAX package's ``join.*`` names, with its spans (``join.build_index``,
``join.pack``, ``join.aggregate``).
"""

from __future__ import annotations

import collections
import contextlib
import os
import threading
import weakref
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from .. import types as T
from ..analysis import sanitize
from ..column import Column, Table, as_dict_column, force_column
from ..memory import budget as mbudget
from ..memory import spill as mspill
from ..utils import knobs, metrics, syncs
from .filter import _gather_column, sized_nonzero

DENSE_SPAN_FACTOR = 2
DENSE_SPAN_FLOOR = 4096
DENSE_SPAN_CAP = 1 << 23
#: the build-index cache's cap on its indexes' device bytes where
#: ``SRJT_INDEX_CACHE_CAP`` is unset (that knob's default)
INDEX_CACHE_CAP = 512 << 20

#: calls by engine, key plan and fused path, since :func:`reset_counts`
COUNTS: collections.Counter = collections.Counter()


def reset_counts() -> None:
    COUNTS.clear()


def _count(key: str, n: int = 1) -> None:
    """Count ``n`` in :data:`COUNTS` and, as the JAX package's site does,
    in ``utils.metrics``."""
    COUNTS[key] += n
    metrics.count("join." + key, n)


# per thread, as the JAX package's: one caller's pin never leaks into
# joins running on other threads
_forced_tls = threading.local()


def forced_engine() -> Optional[str]:
    """The pinned engine: this thread's :func:`force_engine`, else
    ``SRJT_JOIN_ENGINE``, else None."""
    f = getattr(_forced_tls, "kind", None) or knobs.get("SRJT_JOIN_ENGINE")
    return f if f in ("dense", "sorted") else None


@contextlib.contextmanager
def force_engine(kind: Optional[str]):
    """Pin the join engine ("dense" or "sorted"; None restores the
    planner's choice) for the current thread.  Both give identical
    indices, so this trades memory for speed only."""
    old = getattr(_forced_tls, "kind", None)
    _forced_tls.kind = kind
    try:
        yield
    finally:
        _forced_tls.kind = old


class BuildIndex(NamedTuple):
    """An index over the build side's valid (non-null-key) rows."""
    kind: str                              # "dense" | "sorted"
    n_valid: int                           # valid build rows
    row_ids: torch.Tensor                  # [n_valid] key-sorted, stable
    sorted_keys: Optional[torch.Tensor]    # [n_valid] (sorted only)
    kmin: int                              # dense: the window's first key
    span: int                              # dense: the table's length
    lut_lo: Optional[torch.Tensor]         # [span] slot → start in row_ids
    lut_cnt: Optional[torch.Tensor]        # [span] slot → run length
    unique: bool                           # dense: each slot ≤ 1 row
    max_run: int = 0                       # dense: the hottest key's rows


class _IdentityCache:
    """LRU memo keyed on the identity of key tensors: a weak reference to
    each (the entry drops when one dies) and each one's ``_version`` (an
    in-place write makes it a different key).  Bounded by ``cap`` entries
    and by ``byte_cap()`` bytes (the ``nbytes`` each ``put`` declares):
    past either, the least recently used entries go, the newest always
    stays, and each one gone counts in ``evictions``.

    ``spillable`` entries (build indexes, with the arena on) register as
    ``memory.spill`` residents: the spiller moves their tensors to the
    host and takes their bytes off ``nbytes``; the next :meth:`get`
    faults them back and registers them again.

    Locks: the cache's own (``name``, tracked by ``analysis.sanitize``).
    The spiller runs inside ``spill.reclaim``, which ``budget.charge``
    calls with the budget's lock held, and takes this cache's lock; so
    wherever a spillable entry may be touched (the budget is on, or one
    is held), the budget's lock is taken FIRST, keeping the order budget
    → cache.  With the budget off and no spillable entry, only the
    cache's lock is taken."""

    def __init__(self, cap: Optional[int] = None, byte_cap=None,
                 name: str = "ops.join_plan.memo"):
        self._d: "collections.OrderedDict[tuple, dict]" = \
            collections.OrderedDict()
        self._cap = cap
        self._byte_cap = byte_cap
        # reentrant: a weak reference's callback can fire at a collection
        # point inside put, on the thread that holds the lock
        self._mu = sanitize.tracked_rlock(name)
        self._spillables = 0              # entries with a spill payload
        self.nbytes = 0
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._d)

    @contextlib.contextmanager
    def _locked(self, spill: bool = False):
        """The cache's lock, with the budget's before it where a
        spillable entry may be touched (``spill``, the budget on, or one
        held).  ``_spillables`` is read again under the lock: an entry
        that turned up meanwhile sends the caller round again with both."""
        while True:
            both = spill or mbudget.enabled() or self._spillables > 0
            with contextlib.ExitStack() as stack:
                if both:
                    stack.enter_context(mbudget._LOCK)
                stack.enter_context(self._mu)
                if not both and self._spillables > 0:
                    continue
                yield
                return

    def _drop(self, key) -> None:
        with self._locked():
            e = self._d.pop(key, None)
            if e is None:
                return
            payload = e.get("payload")
            if payload is None or not payload.spilled:
                self.nbytes -= e["nbytes"]
            if payload is not None:
                self._spillables -= 1
                if not payload.spilled:
                    mspill.unregister(("join_index",) + key)

    def get(self, key, tensors):
        with self._locked():
            e = self._d.get(key)
            if e is None:
                return None
            for r, v, t in zip(e["refs"], e["versions"], tensors):
                if r() is not t or t._version != v:
                    return None
            self._d.move_to_end(key)
            payload = e.get("payload")
            if payload is None:
                return e["value"]
            if not payload.spilled:
                mspill.touch(("join_index",) + key)
                return e["value"]
            lanes = payload.get()               # fault back, bit-exact
            e["value"] = e["value"]._replace(**lanes)
            self.nbytes += e["nbytes"]
            self._register(key, e)
            _count("build_index.faultback")
            self._trim(keep=key)
            return e["value"]

    def _over(self) -> bool:
        if self._cap is not None and len(self._d) > self._cap:
            return True
        byte_cap = None if self._byte_cap is None else self._byte_cap()
        return byte_cap is not None and self.nbytes > byte_cap

    def _trim(self, keep) -> None:
        # the caller holds the lock
        while len(self._d) > 1 and self._over():
            lru = next(k for k in self._d if k != keep)
            self._drop(lru)
            self.evictions += 1

    def _register(self, key, e) -> None:
        def spiller(e=e):
            with self._locked(spill=True):    # reentrant under reclaim
                freed = e["payload"].spill()
                if freed:
                    # the index keeps only host-independent fields
                    e["value"] = e["value"]._replace(
                        **{k: None for k in e["payload"].names})
                    self.nbytes -= e["nbytes"]
                return freed
        mspill.register(("join_index",) + key, e["nbytes"],
                        "join.build_index", spiller)

    def put(self, key, tensors, value, nbytes: int = 0,
            spillable: bool = False) -> None:
        refs = tuple(weakref.ref(t, lambda _, k=key: self._drop(k))
                     for t in tensors)
        e = {"refs": refs, "value": value, "nbytes": nbytes,
             "versions": tuple(t._version for t in tensors)}
        if spillable:
            e["payload"] = mspill.SpillableArrays(
                "join.build_index", {k: getattr(value, k) for k in
                                     ("row_ids", "sorted_keys", "lut_lo",
                                      "lut_cnt")})
        with self._locked(spill=spillable):
            # two threads can miss and build one key together: drop the
            # first one's entry, so that the byte ledger stays exact
            self._drop(key)
            self._d[key] = e
            self.nbytes += nbytes
            if spillable:
                self._spillables += 1
                self._register(key, e)
            self._trim(keep=key)

    def clear(self) -> None:
        with self._locked():
            for key in list(self._d):
                self._drop(key)
            self._d.clear()
            self.nbytes = 0
            self._spillables = 0


def _index_cache_cap() -> Optional[int]:
    """``SRJT_INDEX_CACHE_CAP`` where it is set, else
    :data:`INDEX_CACHE_CAP`."""
    if knobs.REGISTRY["SRJT_INDEX_CACHE_CAP"].name in os.environ:
        return knobs.parse_bytes(knobs.get("SRJT_INDEX_CACHE_CAP"))
    return INDEX_CACHE_CAP


_INDEX_CACHE = _IdentityCache(byte_cap=_index_cache_cap,
                              name="ops.join_plan.index_cache")


def _index_nbytes(ix: BuildIndex) -> int:
    """The device bytes of an index's tensors, as the JAX package counts
    them."""
    return sum(t.numel() * t.element_size() for t in
               (ix.row_ids, ix.sorted_keys, ix.lut_lo, ix.lut_cnt)
               if t is not None)


def index_cache_stats() -> dict:
    """The build-index cache's entries, device bytes and evictions."""
    return {"entries": len(_INDEX_CACHE), "bytes": _INDEX_CACHE.nbytes,
            "evictions": _INDEX_CACHE.evictions}


def _key(tag: str, tensors) -> tuple:
    return (tag,) + tuple(id(t) for t in tensors)


def dense_eligible(col: Column) -> bool:
    """Key types whose window arithmetic is exact."""
    dt = col.dtype
    if dt.is_variable_width or dt.is_nested:
        return False
    if dt.id in (T.TypeId.FLOAT32, T.TypeId.FLOAT64, T.TypeId.DECIMAL128):
        return False
    sd = np.dtype(dt.storage)
    if sd.kind not in "iu":
        return False
    return not (sd.kind == "u" and sd.itemsize == 8)


def build_index(data: torch.Tensor, valid, dense_ok: bool) -> BuildIndex:
    """Index the build side, memoized on the key tensors' identity."""
    forced = forced_engine()
    tensors = (data,) if valid is None else (data, valid)
    key = _key(f"build_index:{forced or 'auto'}", tensors)
    cached = syncs.mode() == "normal"
    hit = _INDEX_CACHE.get(key, tensors) if cached else None
    if hit is not None:
        _count("build_index.cache_hit")
        _count(f"engine.{hit.kind}")
        return hit
    with metrics.span("join.build_index"):
        ix = _build_index(data, valid, dense_ok and forced != "sorted",
                          forced == "dense")
        if metrics.recording():
            metrics.annotate(engine=ix.kind, n_valid=ix.n_valid,
                             key_span=ix.span)
    _count(f"engine.{ix.kind}")
    if not cached:
        _count("build_index.cache_bypass")
        return ix
    _count("build_index.cache_miss")
    evicted = _INDEX_CACHE.evictions
    _INDEX_CACHE.put(key, tensors, ix, _index_nbytes(ix),
                     spillable=mbudget.enabled())
    if _INDEX_CACHE.evictions > evicted:
        _count("build_index.evictions", _INDEX_CACHE.evictions - evicted)
    return ix


def _key_sorted_order(data, valid, n_valid: int):
    """Valid build rows in stable key order (ties in row order): the
    sorted engine's ``row_ids`` and keys."""
    order = torch.sort(data, stable=True).indices
    skeys = data[order]
    if valid is None:
        return order, skeys
    # the JAX package's lexsort((keys, rank)) over rows already in key
    # order is a stable sort by the rank: valid rows first
    rank = torch.where(valid, 0, 1).to(torch.int8)[order]
    rr = torch.sort(rank, stable=True).indices[:n_valid]
    return order[rr], skeys[rr]


def _build_index(data, valid, try_dense: bool, must_dense: bool):
    n = int(data.shape[0])
    dev = data.device
    n_valid = n if valid is None else syncs.size(valid.sum(), n)
    kmin = span = 0
    dense = False
    if try_dense and n_valid > 0:
        info = torch.iinfo(data.dtype)
        dmin = data if valid is None else torch.where(valid, data, info.max)
        dmax = data if valid is None else torch.where(valid, data, info.min)
        kmin = syncs.scalar(dmin.min())
        span = max(syncs.scalar(dmax.max()) - kmin + 1, 1)
        limit = DENSE_SPAN_CAP if must_dense else min(
            max(DENSE_SPAN_FACTOR * n_valid, DENSE_SPAN_FLOOR),
            DENSE_SPAN_CAP)
        dense = span <= limit
    if not dense:
        order, skeys = _key_sorted_order(data, valid, n_valid)
        return BuildIndex("sorted", n_valid, order, skeys, 0, 0, None, None,
                          False)
    ok = (torch.ones(n, dtype=torch.bool, device=dev) if valid is None
          else valid)
    slot = (data.to(torch.int64) - kmin).clamp(0, span - 1)
    lut_cnt = torch.zeros(span, dtype=torch.int32, device=dev).index_add_(
        0, slot, ok.to(torch.int32))
    lut_lo = torch.cumsum(lut_cnt, 0, dtype=torch.int32) - lut_cnt
    max_run = syncs.scalar(lut_cnt.max())
    unique = max_run <= 1
    if unique:
        # no sort: each valid row scatters to its slot's start; null rows
        # to a slot past the end, which is cut off (the JAX scatter's
        # mode="drop"), as is a start past it (only under a stale tape)
        tgt = torch.where(ok, lut_lo[slot].to(torch.int64),
                          n_valid).clamp_(max=n_valid)
        buf = torch.zeros(n_valid + 1, dtype=torch.int64, device=dev)
        buf.scatter_(0, tgt, torch.arange(n, dtype=torch.int64, device=dev))
        row_ids = buf[:n_valid]
    else:
        row_ids, _ = _key_sorted_order(data, valid, n_valid)
    return BuildIndex("dense", n_valid, row_ids, None, kmin, span, lut_lo,
                      lut_cnt, unique, max_run)


def extend_build_index(ix: BuildIndex, delta_data, delta_valid,
                       base_n: int) -> Optional[BuildIndex]:
    """Append build rows ``[base_n, base_n + len(delta_data))`` to a dense
    index inside its window: counts add into the same slots, the old
    ``row_ids`` move to their slots' new starts, and the new rows follow
    each slot's run, which is the stable key order a rebuild over the
    concatenated keys gives.  None where it does not apply (a sorted
    index, or a new key outside the window): the caller rebuilds."""
    if ix.kind != "dense":
        return None
    m = int(delta_data.shape[0])
    if m == 0:
        return ix
    dev = delta_data.device
    d = delta_data.to(torch.int64) - ix.kmin
    ok = (torch.ones(m, dtype=torch.bool, device=dev) if delta_valid is None
          else delta_valid)
    in_win = (d >= 0) & (d < ix.span)
    if syncs.scalar(((~in_win) & ok).sum()) > 0:
        _count("build_index.extend_window_miss")
        return None
    m_valid = m if delta_valid is None else syncs.size(ok.sum(), m)
    if m_valid == 0:
        return ix
    slot = d.clamp(0, ix.span - 1)
    new_cnt = ix.lut_cnt.clone().index_add_(0, slot, ok.to(torch.int32))
    new_lo = torch.cumsum(new_cnt, 0, dtype=torch.int32) - new_cnt
    # each old key-sorted position → its slot, by the old counts
    pos = torch.arange(ix.n_valid, dtype=torch.int64, device=dev)
    cum_old = torch.cumsum(ix.lut_cnt, 0)
    old_slot = torch.searchsorted(cum_old, pos, right=True)
    old_pos = new_lo[old_slot].to(torch.int64) + (
        pos - ix.lut_lo[old_slot].to(torch.int64))
    # new rows stable-sorted by slot (null rows last, cut off), ranked
    # within their run
    sort_key = torch.where(ok, slot, ix.span)
    dorder = torch.sort(sort_key, stable=True).indices[:m_valid]
    ds = sort_key[dorder]
    idxs = torch.arange(m_valid, dtype=torch.int64, device=dev)
    head = torch.ones(m_valid, dtype=torch.bool, device=dev)
    head[1:] = ds[1:] != ds[:-1]
    run_start = torch.cummax(torch.where(head, idxs, 0), 0).values
    delta_pos = (new_lo[ds].to(torch.int64) + ix.lut_cnt[ds].to(torch.int64)
                 + (idxs - run_start))
    n_total = ix.n_valid + m_valid
    row_ids = torch.zeros(n_total, dtype=torch.int64, device=dev)
    # positions past the end only under a stale tape: cut them there
    row_ids[old_pos.clamp_(0, n_total - 1)] = ix.row_ids
    row_ids[delta_pos.clamp_(0, n_total - 1)] = base_n + dorder
    max_run = syncs.scalar(new_cnt.max())
    _count("build_index.extended")
    return BuildIndex("dense", n_total, row_ids, None, ix.kmin, ix.span,
                      new_lo, new_cnt, max_run <= 1, max_run)


def _common(a: torch.Tensor, b: torch.Tensor):
    """``a`` and ``b`` in one dtype, as ``torch.searchsorted`` needs."""
    if a.dtype == b.dtype:
        return a, b
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt), b.to(dt)


def probe_counts(ix: BuildIndex, ldata, lvalid):
    """Per probe row: (first match position into ``ix.row_ids``, match
    count).  ``lo`` is unspecified where ``counts == 0``; callers clamp
    it before they gather."""
    if ix.kind == "dense":
        d = ldata.to(torch.int64) - ix.kmin
        in_r = (d >= 0) & (d < ix.span)
        if lvalid is not None:
            in_r = in_r & lvalid
        slot = d.clamp(0, max(ix.span - 1, 0))
        counts = torch.where(in_r, ix.lut_cnt[slot], 0)
        return ix.lut_lo[slot], counts
    skeys, probe = _common(ix.sorted_keys, ldata)
    lo = torch.searchsorted(skeys, probe, side="left")
    hi = torch.searchsorted(skeys, probe, side="right")
    counts = hi - lo
    if lvalid is not None:
        counts = torch.where(lvalid, counts, 0)
    return lo, counts


def skew_stats(ix: BuildIndex) -> Optional[dict]:
    """The hottest key's run over the mean run, from the dense table's
    histogram (values the build already read); None for a sorted or
    empty index."""
    if ix.kind != "dense" or ix.max_run <= 0 or ix.n_valid <= 0:
        return None
    mean_run = ix.n_valid / max(1, ix.span)
    return {"max_run": ix.max_run, "n_valid": ix.n_valid, "span": ix.span,
            "skew": ix.max_run / max(mean_run, 1.0)}


# -- multi-column keys ----------------------------------------------------

COMPOSITE_BITS = 63     # a packed tuple indexes as a non-negative int64


class KeyPlan(NamedTuple):
    """The probe lanes of one (maybe multi-column) equi-join key.
    ``verify`` holds (left lane, right lane) pairs a candidate pair must
    also match: empty where the probe lane alone is tuple equality."""
    mode: str            # "single" | "composite" | "fingerprint" | "fallback"
    ldata: torch.Tensor
    lvalid: Optional[torch.Tensor]
    rdata: torch.Tensor
    rvalid: Optional[torch.Tensor]
    verify: tuple
    dense_ok: bool


def _and_valid(a, b):
    if a is None:
        return b
    return a if b is None else (a & b)


def _key_lanes(col: Column):
    """Equality lanes of one (string-coded) key column: one integer lane,
    or the two int64 limbs of a decimal128."""
    from .join import _key_with_nulls_last
    c = force_column(col)
    if c.dtype.id == T.TypeId.DECIMAL128:
        return [c.data[:, 0], c.data[:, 1]], c.validity
    data, valid = _key_with_nulls_last(c)
    return [data], valid


_PLAN_CACHE = _IdentityCache(cap=8, name="ops.join_plan.plan_memo")


def plan_keys(left_cols: Sequence[Column],
              right_cols: Sequence[Column]) -> KeyPlan:
    """The probe lanes of a k-column equi-join key.

    A single key passes through.  String columns are first coded against
    one shared dictionary (``strings.encode_shared``).  A tuple packs:

    * **composite**: every column dense-eligible and the product of the
      build windows below 2^63: one non-negative int64, mixed radix over
      the windows; probe rows outside a window are invalid, and the
      single-key engines take it unchanged;
    * **fingerprint**: the windows overflow: a 64-bit murmur3 fingerprint
      (``ops.hashing.fingerprint64``), with every lane verified on the
      candidate pairs;
    * **fallback**: a column that never packs (float, decimal128,
      uint64): the same hashed probe and verification.
    """
    from . import strings
    k = len(left_cols)
    if k != len(right_cols):
        raise ValueError("join keys: left/right lists differ in length")
    if k == 0:
        raise ValueError("join keys: at least one key column required")
    enc_l, enc_r = [], []
    for lc, rc in zip(left_cols, right_cols):
        if lc.dtype.is_variable_width or rc.dtype.is_variable_width:
            if (as_dict_column(lc) is not None
                    or as_dict_column(rc) is not None):
                _count("dict_keys")
            lc, rc = strings.encode_shared([lc, rc])
        enc_l.append(lc)
        enc_r.append(rc)
    if k == 1 and not any(c.dtype.id == T.TypeId.DECIMAL128
                          for c in (enc_l[0], enc_r[0])):
        # a decimal128's two limbs have no single lane: it packs below as
        # a two-lane tuple
        from .join import _key_with_nulls_last
        lc, rc = force_column(enc_l[0]), force_column(enc_r[0])
        ldata, lvalid = _key_with_nulls_last(lc)
        rdata, rvalid = _key_with_nulls_last(rc)
        _count("pack.single")
        return KeyPlan("single", ldata, lvalid, rdata, rvalid, (),
                       dense_eligible(rc) and dense_eligible(lc))
    enc_l = [force_column(c) for c in enc_l]
    enc_r = [force_column(c) for c in enc_r]
    if syncs.mode() != "normal":
        with metrics.span("join.pack", n_keys=k):
            return _pack_keys(enc_l, enc_r)
    tensors = [a for c in enc_l + enc_r
               for a in (c.data, c.validity) if a is not None]
    key = _key("plan", tensors)
    hit = _PLAN_CACHE.get(key, tensors)
    if hit is not None:
        _count("pack.cache_hit")
        return hit
    with metrics.span("join.pack", n_keys=k):
        plan = _pack_keys(enc_l, enc_r)
    _PLAN_CACHE.put(key, tensors, plan)
    return plan


def _pack_keys(lcols, rcols) -> KeyPlan:
    from . import hashing

    llanes, rlanes = [], []
    lvalid = rvalid = None
    packable = True
    for lc, rc in zip(lcols, rcols):
        ll, lv = _key_lanes(lc)
        rl, rv = _key_lanes(rc)
        llanes += ll
        rlanes += rl
        lvalid = _and_valid(lvalid, lv)
        rvalid = _and_valid(rvalid, rv)
        packable = packable and dense_eligible(lc) and dense_eligible(rc)
    if packable:
        # each build lane's window (two reads each); an all-null build
        # lane is a window of one that no probe enters
        windows = []
        prod = 1
        for rl in rlanes:
            if rl.shape[0] == 0:
                windows.append((0, 1))
                continue
            info = torch.iinfo(rl.dtype)
            vmin = rl if rvalid is None else torch.where(rvalid, rl, info.max)
            vmax = rl if rvalid is None else torch.where(rvalid, rl, info.min)
            kmin = syncs.scalar(vmin.min())
            span = max(syncs.scalar(vmax.max()) - kmin + 1, 1)
            windows.append((kmin, span))
            prod *= span
        if prod < (1 << COMPOSITE_BITS):
            # mixed radix, the last key fastest; each lane clamped into
            # its window, so the int64 sum stays in [0, prod)
            dev = llanes[0].device
            comp_l = torch.zeros(llanes[0].shape[0], dtype=torch.int64,
                                 device=dev)
            comp_r = torch.zeros(rlanes[0].shape[0], dtype=torch.int64,
                                 device=dev)
            in_win = None
            stride = 1
            for (kmin, span), ll, rl in zip(windows[::-1], llanes[::-1],
                                            rlanes[::-1]):
                dl = ll.to(torch.int64) - kmin
                ok = (dl >= 0) & (dl < span)
                in_win = ok if in_win is None else (in_win & ok)
                comp_l = comp_l + dl.clamp(0, span - 1) * stride
                dr = (rl.to(torch.int64) - kmin).clamp(0, span - 1)
                comp_r = comp_r + dr * stride
                stride *= span
            # a probe tuple outside a window cannot match: fold it into
            # the key's validity
            lvalid = _and_valid(lvalid, in_win)
            _count("pack.composite")
            return KeyPlan("composite", comp_l, lvalid, comp_r, rvalid, (),
                           True)
        mode = "fingerprint"
    else:
        mode = "fallback"
    _count(f"pack.{mode}")
    return KeyPlan(mode, hashing.fingerprint64(llanes), lvalid,
                   hashing.fingerprint64(rlanes), rvalid,
                   tuple(zip(llanes, rlanes)), False)


# -- join→aggregate fusion ------------------------------------------------


def _null_where(col: Column, keep) -> Column:
    """A gathered build column with its validity also masked by ``keep``,
    the eager twin of ``ops.join.left_join``'s deferred mask."""
    g = force_column(col)
    v = keep if g.validity is None else (g.validity & keep)
    return Column(g.dtype, g.data, g.offsets, v)


def join_aggregate(left: Table, right: Table, left_on, right_on,
                   group_keys: Sequence[int],
                   aggs: Sequence[tuple[int, str]],
                   how: str = "inner") -> Table:
    """``groupby_aggregate(join(left, right, left_on, right_on),
    group_keys, aggs)`` without the join's pairs, ``how`` "inner" or
    "left".  ``left_on`` / ``right_on`` are one column index or lists;
    ``group_keys`` and the aggregates' columns index the joined
    (left ++ right) schema.  Paths:

    * **unique_gather**: a unique build side (a fact joined to a
      dimension on its key): the matched probe rows are the joined rows,
      so only the columns the groupby reads are gathered; a left join
      keeps every probe row and nulls the build columns where unmatched;
    * **weighted_groupby**: keys and values all of the probe side over a
      duplicated build side: each probe row's match count weighs its
      sums and counts (min and max ignore it); a left join weighs an
      unmatched row 1;
    * **fallback_join**: anything else, and every fingerprinted key
      (its counts are candidate counts): the join, then the groupby.
    """
    from .groupby import groupby_aggregate
    from .join import inner_join, left_join

    if how not in ("inner", "left"):
        raise ValueError(f"join_aggregate: unsupported how={how!r}")
    nl = left.num_columns
    lon = list(left_on) if isinstance(left_on, (list, tuple)) else [left_on]
    ron = list(right_on) if isinstance(right_on, (list, tuple)) \
        else [right_on]
    plan = plan_keys([left[i] for i in lon], [right[i] for i in ron])
    needed = list(group_keys) + [vi for vi, _ in aggs]

    def _unfused():
        _count("fused.fallback_join")
        with metrics.span("join.aggregate", path="fallback_join"):
            j = (inner_join if how == "inner" else left_join)(
                left, right, left_on, right_on)
            return groupby_aggregate(j, list(group_keys), list(aggs))

    if plan.verify:
        return _unfused()

    ix = build_index(plan.rdata, plan.rvalid, plan.dense_ok)
    if ix.unique:
        _count("fused.unique_gather")
        with metrics.span("join.aggregate", path="unique_gather"):
            return _unique_gather(left, right, plan, ix, how, nl, needed,
                                  group_keys, aggs)

    if (group_keys and all(ci < nl for ci in needed)
            and _weighted_ok([left[ci] for ci in group_keys],
                             [(left[vi], agg) for vi, agg in aggs])):
        _count("fused.weighted_groupby")
        with metrics.span("join.aggregate", path="weighted_groupby"):
            return _weighted_path(left, plan, ix, how, group_keys, aggs)

    return _unfused()


def _unique_gather(left, right, plan, ix, how, nl, needed, group_keys,
                   aggs) -> Table:
    """:func:`join_aggregate`'s unique_gather path."""
    from .groupby import groupby_aggregate
    lo, counts = probe_counts(ix, plan.ldata, plan.lvalid)
    pos = lo.clamp(0, max(ix.n_valid - 1, 0))
    if how == "inner":
        m = counts > 0
        li = sized_nonzero(m, syncs.size(m.sum(), m.shape[0]))
        ri = ix.row_ids[pos[li]]
        cols = [_gather_column(left[ci], li) if ci < nl
                else _gather_column(right[ci - nl], ri) for ci in needed]
    else:
        matched = counts > 0
        ri = torch.where(matched, ix.row_ids[pos], 0)
        cols = [force_column(left[ci]) if ci < nl
                else _null_where(_gather_column(right[ci - nl], ri), matched)
                for ci in needed]
    nk = len(group_keys)
    return groupby_aggregate(
        Table(cols), list(range(nk)),
        [(nk + i, agg) for i, (_, agg) in enumerate(aggs)])


def _weighted_path(left, plan, ix, how, group_keys, aggs) -> Table:
    """:func:`join_aggregate`'s weighted_groupby path."""
    lo, counts = probe_counts(ix, plan.ldata, plan.lvalid)
    if how == "inner":
        m = counts > 0
        li = sized_nonzero(m, syncs.size(m.sum(), m.shape[0]))
        w = counts.to(torch.int64)[li]
        return _weighted_groupby(
            [_gather_column(left[ci], li) for ci in group_keys],
            [(_gather_column(left[vi], li), agg) for vi, agg in aggs], w)
    w = counts.clamp(min=1).to(torch.int64)
    return _weighted_groupby(
        [force_column(left[ci]) for ci in group_keys],
        [(force_column(left[vi]), agg) for vi, agg in aggs], w)


def _weighted_ok(key_cols, val_aggs) -> bool:
    for c in key_cols:
        dt = c.dtype
        if (dt.is_variable_width or dt.is_nested
                or dt.id in (T.TypeId.FLOAT64, T.TypeId.DECIMAL128)):
            return False
    for c, agg in val_aggs:
        dt = c.dtype
        if dt.is_variable_width or dt.is_nested or dt.id == T.TypeId.DECIMAL128:
            return False
        if agg not in ("sum", "count", "mean", "min", "max"):
            return False
        if dt.id == T.TypeId.FLOAT64 and agg in ("min", "max"):
            return False          # a row's own value needs the full path
    return True


def _weighted_groupby(key_cols, val_aggs, w) -> Table:
    """The groupby of matched probe rows where row ``i`` stands for
    ``w[i]`` identical joined pairs, in ``ops.groupby``'s types, for the
    shapes :func:`_weighted_ok` admits.  The group heads are the segment
    starts."""
    from .groupby import (_agg_out_dtype, _agg_segment, _cast_res,
                          _empty_result, _segment_ids, _sorted_segment_sum,
                          _take_rows, resolve_segments)
    from .sort import order_by

    nk = len(key_cols)
    sub = Table(key_cols + [c for c, _ in val_aggs])
    if sub.num_rows == 0:
        return _empty_result(sub, list(range(nk)),
                             [(nk + i, a) for i, (_, a) in
                              enumerate(val_aggs)])
    order = order_by(Table(key_cols), list(range(nk)))
    skeys = [_take_rows(c, order) for c in key_cols]
    seg, ns = resolve_segments(
        _segment_ids([c.data for c in skeys], [c.validity for c in skeys]))
    n = order.shape[0]
    head = torch.ones(n, dtype=torch.bool, device=seg.device)
    head[1:] = seg[1:] != seg[:-1]
    head_pos = sized_nonzero(head, ns)
    out_cols = [_take_rows(c, head_pos) for c in skeys]
    ws = w[order]
    for col, agg in val_aggs:
        valid = None if col.validity is None else col.validity[order]
        if agg == "count":
            ones = ws if valid is None else torch.where(valid, ws, 0)
            res = _sorted_segment_sum(ones, seg, ns)
            dt = _agg_out_dtype(col.dtype, agg)
            out_cols.append(Column(dt, res.to(dt.torch_storage)))
            continue
        vals = col.data[order]
        kind = col.dtype.storage.kind
        if agg in ("sum", "mean"):
            acc = vals.to(torch.float64 if kind == "f" else torch.int64)
            if valid is not None:
                acc = torch.where(valid, acc, 0)
            s = _sorted_segment_sum(acc * ws.to(acc.dtype), seg, ns)
            dt = _agg_out_dtype(col.dtype, agg)
            if agg == "sum":
                out_cols.append(Column(dt, _cast_res(s, dt)))
                continue
            cnt = _sorted_segment_sum(
                ws if valid is None else torch.where(valid, ws, 0), seg, ns)
            res = s.to(torch.float64) / cnt.clamp(min=1).to(torch.float64)
            out_cols.append(Column(dt, _cast_res(res, dt)))
            continue
        # min and max: the pairs' multiplicity does not matter
        res = _agg_segment(vals, valid, seg, agg, ns, col.dtype.storage)
        v = None
        if valid is not None:
            v = _agg_segment(vals, valid, seg, "count", ns,
                             col.dtype.storage) > 0
        out_cols.append(Column(col.dtype, _cast_res(res, col.dtype),
                               validity=v))
    return Table(out_cols)
