"""Served inference + the online feature store.

The port's counterpart of the JAX package's ``ml/serve.py``.  A trained
model registers as a :class:`ServableModel`: one query function
``tables → Table([prediction float32])`` that runs ``plan → features →
predict`` as a single compiled request (one CUDA graph on the card).
``exec/``'s scheduler serves it through the ordinary pipeline
(``QueryScheduler.submit_predict``) so admission control, request
coalescing, capture/replay and device failover all apply unchanged — the
predict qfn carries a ``plan_fingerprint`` derived from the plan's, and
the feature pack's only data-dependent read rides the ``syncs`` tape.

:class:`FeatureView` wires ``stream/`` view refresh in as an online
feature store: the view registry's refresh listener re-packs the feature
matrix after every delta refresh (incremental or full), so serving reads
features that are exactly the view's current contents.
"""

from __future__ import annotations

from typing import Optional

from .. import types as T
from ..analysis import sanitize
from ..column import Column, Table
from ..utils import flight, metrics
from .features import FeatureBatch, FeatureSpec


class ServableModel:
    """A trained model bound to the plan + FeatureSpec that feeds it."""

    def __init__(self, name: str, plan_qfn, names, spec: FeatureSpec,
                 model, params):
        self.name = name
        self.spec = spec
        self.model = model
        self.params = params
        self._predict = model.predict

        def qfn(tables):
            t = plan_qfn(tables)
            with metrics.profile_stage("ml.predict", model=name) as rec:
                fb = spec.pack(t, names, with_label=False)
                yhat = self._predict(params, fb.X)
                if rec is not None:
                    rec.out_rows = int(yhat.shape[0])
            return Table([Column(T.float32, yhat)])

        qfn.__name__ = f"predict_{name}"
        tree = getattr(plan_qfn, "plan_tree", None)
        if tree is not None:
            qfn.plan_tree = tree
        fp = getattr(plan_qfn, "plan_fingerprint", None)
        if fp is not None:
            qfn.plan_fingerprint = fp + ":ml.predict"
        self.qfn = qfn

    @classmethod
    def from_plan(cls, name: str, tree, schemas: dict, spec: FeatureSpec,
                  model, params) -> "ServableModel":
        from ..plan import lower
        pqfn = lower.compile_plan(tree, schemas)
        names = list(getattr(pqfn, "plan_output_names", None)
                     or lower.output_names(tree, schemas))
        return cls(name, pqfn, names, spec, model, params)

    def predict_table(self, tables) -> Table:
        """Direct (unscheduled) evaluation — the scheduler-parity oracle."""
        return self.qfn(tables)

    def predict_matrix(self, X):
        """Predict on an already-packed matrix (feature-store path)."""
        return self._predict(self.params, X)


# --- the registry -----------------------------------------------------------

_mu = sanitize.tracked_lock("ml.serve.registry")
_REGISTRY: dict[str, ServableModel] = {}
_probe_installed = False


def register_servable(sv: ServableModel) -> ServableModel:
    global _probe_installed
    with _mu:
        _REGISTRY[sv.name] = sv
        if not _probe_installed:
            flight.register_probe("ml.servables", servables)
            _probe_installed = True
    flight.record("ml.servable.registered", model=sv.name)
    if metrics.recording():
        metrics.count("ml.servable.registered")
    return sv


def get_servable(name: str) -> ServableModel:
    with _mu:
        try:
            return _REGISTRY[name]
        except KeyError:
            raise KeyError(f"no servable {name!r} registered "
                           f"(have {sorted(_REGISTRY)})") from None


def servables() -> list:
    with _mu:
        return sorted(_REGISTRY)


def resolve(model) -> ServableModel:
    return model if isinstance(model, ServableModel) else get_servable(model)


# --- online feature store ---------------------------------------------------


class FeatureView:
    """A stream/ view whose packed feature matrix tracks delta refreshes.

    Registers a refresh listener on the :class:`~stream.view.ViewRegistry`;
    every successful refresh (incremental or full) re-packs the view's
    output through the FeatureSpec, so :meth:`current` always serves
    features consistent with the view's latest refreshed contents.  The
    listener fires OUTSIDE the view's refresh lock (lock order: the view
    lock and the feature-view lock are never held together).
    """

    def __init__(self, registry, plan, spec: FeatureSpec, *,
                 name: Optional[str] = None,
                 with_label: Optional[bool] = None):
        from ..plan import lower
        self.registry = registry
        self.spec = spec
        self.view = registry.register_view(plan, name=name)
        self.names = list(lower.output_names(self.view.tree,
                                             registry.schemas))
        self.with_label = (spec.label is not None if with_label is None
                           else bool(with_label))
        self._mu = sanitize.tracked_lock("ml.serve.feature_view")
        self._batch: Optional[FeatureBatch] = None
        self.repacks = 0
        registry.add_refresh_listener(self._on_refresh)

    def _on_refresh(self, view, table) -> None:
        if view is not self.view:
            return
        fb = self.spec.pack(table, self.names, with_label=self.with_label)
        with self._mu:
            self._batch = fb
            self.repacks += 1
        if metrics.recording():
            metrics.count("ml.feature_view.repacks")
        flight.record("ml.feature_view.repack", view=view.name,
                      rows=fb.num_rows)

    def refresh(self) -> FeatureBatch:
        """Refresh the underlying view (delta-incremental when maintainable)
        and return the freshly re-packed batch."""
        self.registry.refresh(self.view)     # listener re-packs
        with self._mu:
            return self._batch

    def current(self) -> FeatureBatch:
        """The latest packed batch (refreshing once if never refreshed)."""
        with self._mu:
            fb = self._batch
        return fb if fb is not None else self.refresh()

    def close(self) -> None:
        self.registry.remove_refresh_listener(self._on_refresh)
