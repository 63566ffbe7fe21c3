#!/usr/bin/env python3
"""Row counts of every node of a plan tree, computed with numpy.

    from torch_plan_oracle import node_rows
    rows = node_rows(tree, arrays)     # {ir.fingerprint(node): rows}

The per-node oracle for ``plan/profile.py``'s profiles: ``tree`` is a
(typically optimized) ``plan.ir`` tree of either package, ``arrays`` the
tables as ``{table: {column: numpy array}}`` (``tools/
torch_tpcds_parquet.py``'s ``tpcds_arrays``; strings as object arrays).
Each node is evaluated from its children the way the executor lowers it
— scans with their predicate and column list, filters, projections,
inner/left/semi/anti equi-joins, aggregates (and the fused join →
aggregate), sorts and limits — on integer codes for strings (a string
column's distinct values ranked once), with float sums in float64.
Only the row counts are the oracle's claim; a HAVING threshold compares
float64 sums, which differ from the card's in the last bits only.

Imports numpy and the plan IR's node classes by duck typing (the class
name), so it holds either package's trees and imports neither.
"""

from __future__ import annotations

import operator

import numpy as np

_CMP = {"==": operator.eq, "!=": operator.ne, "<": operator.lt,
        "<=": operator.le, ">": operator.gt, ">=": operator.ge}


def _kind(node) -> str:
    return type(node).__name__


def encode_arrays(arrays: dict) -> dict:
    """``arrays`` with every object (string) column replaced by int64
    ranks of its distinct values, and a map back to the values for
    literals: ``{table: {column: array}}`` plus ``"__vocab__"``."""
    out: dict = {"__vocab__": {}}
    for t, cols in arrays.items():
        out[t] = {}
        for c, a in cols.items():
            a = np.asarray(a)
            if a.dtype == object:
                uniq, inv = np.unique(a.astype(str), return_inverse=True)
                out[t][c] = inv.astype(np.int64)
                out["__vocab__"][c] = {v: i for i, v in enumerate(uniq)}
            else:
                out[t][c] = a
    return out


class _Eval:
    def __init__(self, enc: dict):
        self.enc = enc
        self.vocab = enc["__vocab__"]
        self.rows: dict = {}

    # -- expressions --------------------------------------------------------
    def lit(self, col: str, v):
        if isinstance(v, (str, bytes)):
            v = v.decode() if isinstance(v, bytes) else v
            return self.vocab.get(col, {}).get(v, -1)
        return v

    def expr(self, e, rel: dict):
        k = _kind(e)
        if k == "Col":
            return rel[e.name]
        if k == "Lit":
            return e.value
        if k == "Mul":
            return self.expr(e.left, rel) * self.expr(e.right, rel)
        if k == "ScalarAgg":
            v = np.asarray(self.expr(e.arg, rel), dtype=np.float64)
            return v.mean() if e.fn == "mean" else v.sum()
        raise NotImplementedError(k)

    def mask(self, p, rel: dict, n: int) -> np.ndarray:
        k = _kind(p)
        if k == "And":
            m = np.ones(n, bool)
            for q in p.parts:
                m &= self.mask(q, rel, n)
            return m
        if k == "Or":
            m = np.zeros(n, bool)
            for q in p.parts:
                m |= self.mask(q, rel, n)
            return m
        if k == "Cmp":
            a, b = p.left, p.right
            if _kind(a) == "Col" and _kind(b) == "Lit":
                return _CMP[p.op](rel[a.name], self.lit(a.name, b.value))
            return np.asarray(_CMP[p.op](self.expr(a, rel),
                                         self.expr(b, rel)))
        if k == "Between":
            v = self.expr(p.col, rel)
            m = np.ones(n, bool)
            if p.lo is not None:
                m &= v >= p.lo
            if p.hi is not None:
                m &= (v < p.hi) if p.hi_strict else (v <= p.hi)
            return m
        if k == "IsIn":
            name = p.col.name
            return np.isin(rel[name], [self.lit(name, v) for v in p.values])
        raise NotImplementedError(k)

    # -- nodes --------------------------------------------------------------
    def node(self, node) -> dict:
        rel = self._node(node)
        n = len(next(iter(rel.values()))) if rel else 0
        self.rows[_fingerprint(node)] = n
        return rel

    def _node(self, node) -> dict:
        k = _kind(node)
        if k == "Scan":
            t = self.enc[node.table]
            rel = dict(t)
            if node.predicate is not None:
                n = len(next(iter(rel.values())))
                m = self.mask(node.predicate, rel, n)
                rel = {c: a[m] for c, a in rel.items()}
            if node.columns is not None:
                rel = {c: rel[c] for c in node.columns}
            return rel
        if k == "Filter":
            rel = self.node(node.child)
            n = len(next(iter(rel.values())))
            m = self.mask(node.predicate, rel, n)
            return {c: a[m] for c, a in rel.items()}
        if k == "Project":
            rel = self.node(node.child)
            return {c: rel[c] for c in node.columns}
        if k == "Join":
            return self.join(self.node(node.left), self.node(node.right),
                             node.left_on, node.right_on, node.how)
        if k == "Aggregate":
            return self.aggregate(self.node(node.child), node.keys,
                                  node.aggs)
        if k == "FusedJoinAggregate":
            j = self.join(self.node(node.left), self.node(node.right),
                          node.left_on, node.right_on, node.how)
            return self.aggregate(j, node.keys, node.aggs)
        if k == "Sort":
            return self.node(node.child)
        if k == "Limit":
            rel = self.node(node.child)
            return {c: a[:node.n] for c, a in rel.items()}
        raise NotImplementedError(f"plan node {k}")

    @staticmethod
    def _key(rel: dict, names) -> np.ndarray:
        """One int64 key per row for the columns ``names`` (a dense rank
        of the tuples when there are several)."""
        cols = [np.asarray(rel[c]) for c in names]
        if len(cols) == 1:
            return cols[0].astype(np.int64)
        stacked = np.stack([c.astype(np.int64) for c in cols], axis=1)
        _, inv = np.unique(stacked, axis=0, return_inverse=True)
        return inv.reshape(-1).astype(np.int64)

    def join(self, left: dict, right: dict, lon, ron, how: str) -> dict:
        nl = len(next(iter(left.values())))
        nr = len(next(iter(right.values())))
        if len(lon) == 1:
            lk = np.asarray(left[lon[0]]).astype(np.int64)
            rk = np.asarray(right[ron[0]]).astype(np.int64)
        else:
            both = {c: np.concatenate([np.asarray(left[a]),
                                       np.asarray(right[b])])
                    for c, (a, b) in enumerate(zip(lon, ron))}
            k = self._key(both, list(both))
            lk, rk = k[:nl], k[nl:]
        order = np.argsort(rk, kind="stable")
        rs = rk[order]
        lo = np.searchsorted(rs, lk, side="left")
        hi = np.searchsorted(rs, lk, side="right")
        cnt = hi - lo
        if how in ("semi", "anti"):
            m = cnt > 0 if how == "semi" else cnt == 0
            return {c: np.asarray(a)[m] for c, a in left.items()}
        out_cnt = np.maximum(cnt, 1) if how == "left" else cnt
        li = np.repeat(np.arange(nl), out_cnt)
        starts = np.cumsum(out_cnt) - out_cnt
        within = np.arange(li.shape[0]) - np.repeat(starts, out_cnt)
        matched = within < np.repeat(cnt, out_cnt)
        ri = np.where(matched,
                      order[np.minimum(np.repeat(lo, out_cnt) + within,
                                       max(nr - 1, 0))] if nr else 0, -1)
        out = {c: np.asarray(a)[li] for c, a in left.items()}
        for c, a in right.items():
            a = np.asarray(a)
            v = a[np.maximum(ri, 0)] if nr else np.zeros(len(ri), a.dtype)
            out[c] = v
        return out

    def aggregate(self, rel: dict, keys, aggs) -> dict:
        n = len(next(iter(rel.values()))) if rel else 0
        if keys:
            k = self._key(rel, list(keys))
            uniq, first, inv = np.unique(k, return_index=True,
                                         return_inverse=True)
            g = len(uniq)
            out = {c: np.asarray(rel[c])[first] for c in keys}
        else:
            g, inv, out = 1, np.zeros(n, np.int64), {}
        cnt = np.bincount(inv, minlength=g)
        for src, fn, name in aggs:
            v = np.asarray(rel[src], dtype=np.float64)
            s = np.bincount(inv, weights=v, minlength=g)
            if fn == "sum":
                out[name] = s
            elif fn == "mean":
                out[name] = s / np.maximum(cnt, 1)
            elif fn == "count":
                out[name] = cnt.astype(np.float64)
            elif fn in ("min", "max"):
                r = np.full(g, np.inf if fn == "min" else -np.inf)
                (np.minimum if fn == "min" else np.maximum).at(r, inv, v)
                out[name] = r
            else:
                raise NotImplementedError(f"aggregate {fn}")
        return out


def _fingerprint(node) -> str:
    import importlib
    mod = importlib.import_module(type(node).__module__)
    return mod.fingerprint(node)


def node_rows(tree, arrays: dict, encoded: dict | None = None) -> dict:
    """``{fingerprint: output rows}`` of every node of ``tree``."""
    ev = _Eval(encoded if encoded is not None else encode_arrays(arrays))
    ev.node(tree)
    return ev.rows
