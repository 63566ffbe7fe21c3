"""FeatureSpec: plan/table columns → dense float32 matrix + label, on the card.

The port's counterpart of the JAX package's ``ml/features.py``.  The
JCUDF fixed-width row IS a dense feature matrix: once every feature
column is lowered to an all-valid FLOAT32 lane, the ``rowconv/``
fixed-width pack interleaves them into the row bytes and
:func:`rowconv.convert.fixed_rows_to_matrix` reinterprets those as
``float32 [n, k]`` — a view and a slice, no gather, no host round trip.

Lane lowering contract (the JAX package's, bit for bit; the numpy oracle
in ``tests/test_torch_ml.py`` mirrors it):

* ints / dates / timestamps → ``to(float32)``
* BOOL8                     → ``(v != 0) → {0.0, 1.0}``
* DECIMAL32/64 scale s      → ``unscaled.to(float32) * float32(10.0**s)``
* FLOAT64                   → ``to(float32)`` (native float64 here, the
  JAX package's exact bit-pair view there)
* STRING / DictColumn       → ``ops.strings.dictionary_encode`` rank codes
  (categorical ids; dict inputs re-encode through the dictionary only —
  row bytes are never materialized).  Ids rank the column's distinct byte
  strings: for plain strings nulls contribute the empty key, for dict
  columns the dictionary's distinct set is the id space.

Nulls resolve through declared imputation policies applied AFTER the lane
cast: ``"zero"``, ``"mean"`` (float64 accumulation on the card),
``("const", v)``, or ``"error"`` (reject columns that carry a validity
mask).  Every constant is made on the card (``torch.full``), so a pack
holds no host copy and can be captured in a CUDA graph.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Union

import numpy as np
import torch

from .. import types as T
from ..column import Column, Table, force_column
from ..utils import knobs, metrics

ImputePolicy = Union[str, tuple]

_CATEGORICAL_IDS = (T.TypeId.STRING,)


def _is_categorical(dt: T.DType) -> bool:
    return dt.id in _CATEGORICAL_IDS


@dataclasses.dataclass(frozen=True)
class Feature:
    """One feature column: a name plus its null-imputation policy.

    ``impute`` is ``"zero"`` | ``"mean"`` | ``("const", v)`` | ``"error"``
    (default; a nullable column without a declared policy is a spec
    error).
    """

    name: str
    impute: ImputePolicy = "error"

    def __post_init__(self):
        p = self.impute
        if isinstance(p, str):
            if p not in ("zero", "mean", "error"):
                raise ValueError(f"feature {self.name!r}: unknown imputation "
                                 f"policy {p!r}")
        elif not (isinstance(p, tuple) and len(p) == 2 and p[0] == "const"):
            raise ValueError(f"feature {self.name!r}: imputation must be "
                             "'zero' | 'mean' | ('const', v) | 'error'")


def _as_feature(f) -> Feature:
    return f if isinstance(f, Feature) else Feature(str(f))


@dataclasses.dataclass
class FeatureBatch:
    """Packed features on the card: ``X`` float32 [n, k], optional ``y``
    float32 [n]."""

    X: torch.Tensor
    y: Optional[torch.Tensor] = None
    feature_names: tuple = ()

    @property
    def num_rows(self) -> int:
        return int(self.X.shape[0])

    @property
    def num_features(self) -> int:
        return int(self.X.shape[1])


def _f32(value: float, device) -> torch.Tensor:
    """A float32 scalar on ``device``, made there (no host copy)."""
    return torch.full((), float(np.float32(value)), dtype=torch.float32,
                      device=device)


def _value_lane(col) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Column → (float32 value lane, validity) with no host
    materialization."""
    if _is_categorical(col.dtype):
        # rank codes == categorical ids; a DictColumn re-encodes through
        # its dictionary (no byte materialization), plain strings pay one
        # distinct-count read that rides the syncs tape under capture
        from ..ops import strings as S
        codes, _ = S.dictionary_encode(col)
        return codes.data.to(torch.float32), codes.validity
    col = force_column(col)
    dt, data = col.dtype, col.data
    if dt.id == T.TypeId.FLOAT32:
        lane = data
    elif dt.id == T.TypeId.BOOL8:
        lane = (data != 0).to(torch.float32)
    elif dt.id in (T.TypeId.DECIMAL32, T.TypeId.DECIMAL64):
        lane = data.to(torch.float32) * _f32(10.0 ** dt.scale, data.device)
    elif dt.is_fixed_width and dt.id != T.TypeId.DECIMAL128:
        lane = data.to(torch.float32)
    else:
        raise TypeError(f"dtype {dt!r} is not supported as an ML feature")
    return lane, col.validity


def _impute(name: str, lane: torch.Tensor, valid: Optional[torch.Tensor],
            policy: ImputePolicy) -> torch.Tensor:
    if valid is None:
        return lane
    if policy == "error":
        raise ValueError(
            f"feature {name!r} may contain nulls but declares no imputation "
            "policy — set impute='zero'|'mean'|('const', v)")
    if policy == "zero":
        return torch.where(valid, lane, _f32(0.0, lane.device))
    if policy == "mean":
        # float64 accumulation on the card: exact whenever the lane values
        # are integers small enough for float64 (the differential tests
        # pin this); for general float lanes the mean may differ from the
        # JAX package's in its last bits (another summation order)
        s = torch.where(valid, lane.to(torch.float64), 0.0).sum()
        cnt = valid.sum()
        mean = torch.where(cnt > 0, s / cnt.clamp(min=1), 0.0)
        return torch.where(valid, lane, mean.to(torch.float32))
    return torch.where(valid, lane, _f32(policy[1], lane.device))


def _pack_rowconv(lanes: Sequence[torch.Tensor]) -> torch.Tensor:
    """All-valid float32 lanes → float32 [n, k] through the JCUDF rows."""
    from ..rowconv import convert as RC
    from ..rowconv.layout import compute_row_layout
    tbl = Table([Column(T.float32, lane) for lane in lanes])
    if tbl.num_rows == 0:
        return torch.zeros((0, len(lanes)), dtype=torch.float32,
                           device=lanes[0].device)
    layout = compute_row_layout(tbl.schema)
    mats = [RC.fixed_rows_to_matrix(b, layout)
            for b in RC.convert_to_rows(tbl)]
    return mats[0] if len(mats) == 1 else torch.cat(mats, dim=0)


def _pack_stack(lanes: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.stack(lanes, dim=1)


@dataclasses.dataclass(frozen=True)
class FeatureSpec:
    """Declarative mapping from named columns to a packed FeatureBatch.

    ``label`` (optional) names the label column; ``label_transform``
    post-processes the label lane: ``None`` keeps the raw value,
    ``("gt", t)`` / ``("ge", t)`` binarize to {0.0, 1.0} float32.
    """

    features: tuple
    label: Optional[Feature] = None
    label_transform: Optional[tuple] = None

    @staticmethod
    def of(features: Sequence, label=None,
           label_transform: Optional[tuple] = None) -> "FeatureSpec":
        lab = None if label is None else _as_feature(label)
        return FeatureSpec(tuple(_as_feature(f) for f in features),
                           lab, label_transform)

    @property
    def feature_names(self) -> tuple:
        return tuple(f.name for f in self.features)

    def _column(self, table: Table, names: Sequence[str], want: str):
        try:
            return table.columns[list(names).index(want)]
        except ValueError:
            raise KeyError(f"column {want!r} not in plan output "
                           f"{list(names)}") from None

    def _label_lane(self, table: Table, names: Sequence[str]) -> torch.Tensor:
        lane, valid = _value_lane(self._column(table, names, self.label.name))
        lane = _impute(self.label.name, lane, valid, self.label.impute)
        if self.label_transform is not None:
            op, t = self.label_transform
            thr = _f32(t, lane.device)
            if op == "gt":
                lane = (lane > thr).to(torch.float32)
            elif op == "ge":
                lane = (lane >= thr).to(torch.float32)
            else:
                raise ValueError(f"unknown label transform {op!r}")
        return lane

    def pack(self, table: Table, names: Optional[Sequence[str]] = None, *,
             with_label: bool = True, engine: Optional[str] = None
             ) -> FeatureBatch:
        """Pack ``table`` into a :class:`FeatureBatch` on its device.

        ``names`` gives the table's column names in order (defaults to the
        feature order itself when the table was built column-per-feature).
        """
        if names is None:
            names = self.feature_names + (
                (self.label.name,) if self.label is not None else ())
        engine = engine or knobs.get("SRJT_ML_PACK")
        if engine not in ("rowconv", "stack"):
            raise ValueError(f"SRJT_ML_PACK={engine!r}: want rowconv|stack")
        with metrics.profile_stage("ml.pack", engine=engine) as rec:
            lanes = []
            for f in self.features:
                lane, valid = _value_lane(self._column(table, names, f.name))
                lanes.append(_impute(f.name, lane, valid, f.impute))
            X = (_pack_rowconv if engine == "rowconv" else _pack_stack)(lanes)
            y = (self._label_lane(table, names)
                 if with_label and self.label is not None else None)
            if rec is not None:
                rec.out_rows = int(X.shape[0])
                rec.engine = engine
        if metrics.recording():
            metrics.count("ml.pack.rows", X.shape[0])
            metrics.count("ml.pack.features", X.shape[1])
        return FeatureBatch(X, y, self.feature_names)


def compile_feature_plan(tree, schemas: dict, spec: FeatureSpec, *,
                         with_label: bool = True):
    """Lower a plan tree to ``tables → FeatureBatch`` (one query function).

    The result composes with ``models.compiled.compile_query`` — the pack
    path's only data-dependent read (a plain string column's distinct
    count) rides the ``syncs`` tape, so capture/replay works unchanged —
    and carries ``plan_tree`` / ``plan_fingerprint`` so EXPLAIN ANALYZE
    and the profile ledger attribute the ML stages to the plan.
    """
    from ..plan import lower
    pqfn = lower.compile_plan(tree, schemas)
    names = list(getattr(pqfn, "plan_output_names", None)
                 or lower.output_names(tree, schemas))

    def qfn(tables):
        return spec.pack(pqfn(tables), names, with_label=with_label)

    qfn.__name__ = "feature_" + getattr(pqfn, "__name__", "plan")
    qfn.plan_tree = getattr(pqfn, "plan_tree", tree)
    fp = getattr(pqfn, "plan_fingerprint", None)
    if fp is not None:
        qfn.plan_fingerprint = fp + ":ml.features"
    qfn.plan_output_names = names
    qfn.feature_spec = spec
    return qfn
