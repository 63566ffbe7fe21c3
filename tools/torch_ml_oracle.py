#!/usr/bin/env python3
"""numpy oracles of the ML handoff (``ml/``): the feature lanes and a
float64 replay of training.

* :func:`pack` — the lane rules of ``ml/features.py`` on host columns:
  ints, dates and timestamps ``astype(float32)``; BOOL8 ``!= 0``;
  DECIMAL32/64 ``unscaled.astype(float32) * float32(10**scale)``; FLOAT64
  ``astype(float32)``; strings ranked among their sorted distinct values
  (a null row as the empty string); then the imputation (``zero``,
  ``mean`` by a float64 mean of the valid lane values, ``("const", v)``)
  and the label transform (``gt`` / ``ge`` against a float32 threshold).
  The result is the float32 matrix the port must give bit for bit.
* :func:`replay` — the logistic or linear model trained by SGD (with
  momentum) or Adam over given batches, every number in float64: the
  reference a float32 training run is held to within a tolerance.

Imports numpy only, so it runs beside the port on the card's machine.
"""

from __future__ import annotations

import numpy as np

# the type ids of ``types.TypeId`` the lanes distinguish
BOOL8, FLOAT32, FLOAT64, DECIMAL32, DECIMAL64, STRING = (
    "BOOL8", "FLOAT32", "FLOAT64", "DECIMAL32", "DECIMAL64", "STRING")


def lane(kind: str, scale: int, values, validity=None, impute="error"):
    """One feature lane (float32 [n]) from a column's host values:
    ``kind`` the type id's name, ``values`` the payload (object array of
    str or None for strings), ``validity`` a bool array or None."""
    if kind == STRING:
        vals = ["" if v is None else v for v in values]
        uniq = sorted(set(vals))
        rank = {v: i for i, v in enumerate(uniq)}
        out = np.array([rank[v] for v in vals], dtype=np.float32)
        if validity is None:
            validity = np.array([v is not None for v in values])
            if validity.all():
                validity = None
    elif kind == BOOL8:
        out = (np.asarray(values) != 0).astype(np.float32)
    elif kind in (DECIMAL32, DECIMAL64):
        out = np.asarray(values).astype(np.float32) * np.float32(
            10.0 ** scale)
    else:
        out = np.asarray(values).astype(np.float32)
    if validity is None:
        return out
    valid = np.asarray(validity, dtype=bool)
    if impute == "zero":
        fill = np.float32(0.0)
    elif impute == "mean":
        fill = (np.float32(out[valid].astype(np.float64).mean())
                if valid.any() else np.float32(0.0))
    elif isinstance(impute, tuple) and impute[0] == "const":
        fill = np.float32(impute[1])
    else:
        raise ValueError("a nullable lane needs an imputation policy")
    return np.where(valid, out, fill).astype(np.float32)


def pack(columns: list, label=None, label_transform=None):
    """``(X float32 [n, k], y float32 [n] or None)``: ``columns`` a list of
    ``(kind, scale, values, validity, impute)``, ``label`` one more."""
    X = np.stack([lane(*c) for c in columns], axis=1)
    if label is None:
        return X, None
    y = lane(*label)
    if label_transform is not None:
        op, t = label_transform
        y = ((y > np.float32(t)) if op == "gt"
             else (y >= np.float32(t))).astype(np.float32)
    return X, y


def _softplus(z):
    return np.logaddexp(z, 0.0)


def _sigmoid(z):
    return np.exp(-np.logaddexp(0.0, -z))


def replay(epochs, model: str, opt: str, params, opt_kw: dict):
    """Train in float64 over ``epochs`` (a list, one per epoch, of
    ``(Xb [nb, b, k], yb [nb, b])``) from ``params`` ({"w", "b"}); returns
    (per-epoch mean losses, params).  ``model`` is ``logreg`` or
    ``linreg``, ``opt`` ``adam`` (lr, b1, b2, eps) or ``sgd`` (lr,
    momentum)."""
    w = np.asarray(params["w"], dtype=np.float64).copy()
    b = float(np.asarray(params["b"], dtype=np.float64))
    mw, vw, mb, vb, t = np.zeros_like(w), np.zeros_like(w), 0.0, 0.0, 0
    losses = []
    for Xb, yb in epochs:
        Xb = np.asarray(Xb, dtype=np.float64)
        yb = np.asarray(yb, dtype=np.float64)
        step_losses = []
        for xs, ys in zip(Xb, yb):
            z = xs @ w + b
            if model == "logreg":
                step_losses.append(np.mean(_softplus(z) - ys * z))
                gz = (_sigmoid(z) - ys) / len(ys)
            else:
                r = z - ys
                step_losses.append(np.mean(r * r))
                gz = 2.0 * r / len(ys)
            gw, gb = gz @ xs, gz.sum()
            if opt == "adam":
                lr = opt_kw.get("lr", 1e-3)
                b1, b2 = opt_kw.get("b1", 0.9), opt_kw.get("b2", 0.999)
                eps = opt_kw.get("eps", 1e-8)
                t += 1
                mw = b1 * mw + (1 - b1) * gw
                vw = b2 * vw + (1 - b2) * gw * gw
                mb = b1 * mb + (1 - b1) * gb
                vb = b2 * vb + (1 - b2) * gb * gb
                c1, c2 = 1 - b1 ** t, 1 - b2 ** t
                w = w - lr * (mw / c1) / (np.sqrt(vw / c2) + eps)
                b = b - lr * (mb / c1) / (np.sqrt(vb / c2) + eps)
            else:
                lr, mu = opt_kw.get("lr", 0.1), opt_kw.get("momentum", 0.0)
                mw = mu * mw + gw
                mb = mu * mb + gb
                w = w - lr * mw
                b = b - lr * mb
        losses.append(float(np.mean(step_losses)))
    return np.array(losses), {"w": w, "b": b}
