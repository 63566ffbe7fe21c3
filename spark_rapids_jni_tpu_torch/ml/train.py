"""Train-step harness: reference models + optimizers on the packed
feature matrix.

The port's counterpart of the JAX package's ``ml/train.py``.  The
reference models (linear / logistic regression, the JAX package's
losses) and optimizers (SGD with momentum, Adam) are hand-rolled float32
tensor math: a step is ``(params, opt_state, xb, yb) → loss`` with the
parameters and optimizer state updated in place.  The gradients are the
models' closed forms (the tests hold them against ``jax.grad``):

* linear: ``loss = mean(r²)``, ``r = Xw + b − y``, ``∂loss/∂z = 2r/B``;
* logistic: ``loss = mean(softplus(z) − y·z)``, ``∂loss/∂z =
  (sigmoid(z) − y)/B``;

and ``∂w = Xᵀ ∂z``, ``∂b = Σ ∂z``.

With ``SRJT_ML_EPOCH_FUSE`` (default on) a whole epoch on the card is
ONE CUDA-graph replay: the first fused epoch of a pipeline shape
captures the graph of its full step loop over static batch tensors,
with the parameters and optimizer state as static tensors updated in
place, and every later epoch copies its shuffled batches in and replays
the same graph.  Per-epoch losses stay on the card until
:meth:`Trainer.fit` reads them once at the end.  On the CPU the fused
epoch is the same loop, run eagerly.  The JAX package's
``SRJT_ML_DONATE`` has no counterpart: there is nothing to donate in
torch (the static tensors are the only buffers the graph writes).

:func:`params_from_numpy` carries weights across: a model the JAX
package trained (its params and optimizer state as numpy arrays) is
served or trained on by the port.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np
import torch

from ..utils import knobs, metrics, syncs
from .pipeline import BatchPipeline


# --- reference models -------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Model:
    """``init(k, device)`` → params; ``loss_z(z, y)`` → scalar loss of
    the logits ``z = Xw + b``; ``grad_z(z, y)`` → ``∂loss/∂z``;
    ``predict(params, X)`` → [n]."""

    name: str
    init: Callable
    loss_z: Callable
    grad_z: Callable
    predict: Callable

    def loss(self, params, X, y) -> torch.Tensor:
        return self.loss_z(_z(params, X), y)


def _linear_init(k: int, device=None):
    return {"w": torch.zeros(k, dtype=torch.float32, device=device),
            "b": torch.zeros((), dtype=torch.float32, device=device)}


def _z(params, X):
    # a row reduction, not a matrix product: its kernel and so its bits
    # are the same in an eager call and in a CUDA graph
    return (X * params["w"]).sum(dim=1) + params["b"]


def linear_regression() -> Model:
    """Least-squares linear model: loss = mean((Xw + b - y)^2)."""
    def loss_z(z, y):
        r = z - y
        return (r * r).mean()

    def grad_z(z, y):
        return (z - y) * (2.0 / z.shape[0])

    return Model("linreg", _linear_init, loss_z, grad_z, _z)


def logistic_regression() -> Model:
    """Binary logistic model, stable BCE-with-logits loss:
    mean(softplus(z) − y·z); predict = sigmoid(z)."""
    def loss_z(z, y):
        return (torch.nn.functional.softplus(z) - y * z).mean()

    def grad_z(z, y):
        return (torch.sigmoid(z) - y) / z.shape[0]

    def predict(params, X):
        return torch.sigmoid(_z(params, X))

    return Model("logreg", _linear_init, loss_z, grad_z, predict)


# --- reference optimizers ---------------------------------------------------


def _f32(x) -> float:
    """``x`` rounded to float32, as a Python float (the JAX package's
    ``np.float32`` constants)."""
    return float(np.float32(x))


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """``init(params)`` → state; ``update(grads, state, params)`` updates
    params and state in place."""

    name: str
    init: Callable
    update: Callable


def sgd(lr: float = 0.1, momentum: float = 0.0) -> Optimizer:
    lr32, mu32 = _f32(lr), _f32(momentum)

    def init(params):
        return {k: torch.zeros_like(v) for k, v in params.items()}

    def update(grads, vel, params):
        for k in params:
            vel[k].mul_(mu32).add_(grads[k])
            params[k].sub_(vel[k] * lr32)

    return Optimizer("sgd", init, update)


def adam(lr: float = 1e-3, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> Optimizer:
    lr32, b1_, b2_, eps_ = _f32(lr), _f32(b1), _f32(b2), _f32(eps)
    one_b1 = float(np.float32(1.0) - np.float32(b1))
    one_b2 = float(np.float32(1.0) - np.float32(b2))

    def init(params):
        dev = next(iter(params.values())).device
        return {"m": {k: torch.zeros_like(v) for k, v in params.items()},
                "v": {k: torch.zeros_like(v) for k, v in params.items()},
                "t": torch.zeros((), dtype=torch.float32, device=dev)}

    def update(grads, state, params):
        t = state["t"]
        t.add_(1.0)
        c1 = 1.0 - torch.pow(torch.full_like(t, b1_), t)
        c2 = 1.0 - torch.pow(torch.full_like(t, b2_), t)
        for k in params:
            g = grads[k]
            m, v = state["m"][k], state["v"][k]
            m.mul_(b1_).add_(g * one_b1)
            v.mul_(b2_).add_((g * g) * one_b2)
            params[k].sub_(lr32 * (m / c1) / (torch.sqrt(v / c2) + eps_))

    return Optimizer("adam", init, update)


# --- weights across packages --------------------------------------------------


def params_from_numpy(params: dict, opt_state=None, device=None):
    """Params (and optimizer state, if given) from numpy arrays — the JAX
    package's ``Trainer`` pytrees as ``np.asarray`` of each leaf — as
    float32 tensors on ``device`` (the GPU unless it says otherwise).
    Returns ``(params, opt_state)``."""
    from ..column import resolve_device
    dev = resolve_device(device)

    def conv(tree):
        if isinstance(tree, dict):
            return {k: conv(v) for k, v in tree.items()}
        return torch.tensor(np.asarray(tree, dtype=np.float32), device=dev)

    return conv(params), (None if opt_state is None else conv(opt_state))


def params_to_numpy(params: dict, opt_state=None):
    """The inverse of :func:`params_from_numpy` (float32 numpy arrays)."""
    def conv(tree):
        if isinstance(tree, dict):
            return {k: conv(v) for k, v in tree.items()}
        return tree.detach().cpu().numpy().astype(np.float32)

    return conv(params), (None if opt_state is None else conv(opt_state))


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.clone()


def _copy_into(dst, src) -> None:
    if isinstance(dst, dict):
        for k in dst:
            _copy_into(dst[k], src[k])
    else:
        dst.copy_(src)


# --- the harness ------------------------------------------------------------


@dataclasses.dataclass
class TrainResult:
    params: dict
    opt_state: dict
    losses: np.ndarray          # per-epoch mean loss, read once at the end
    model: Model

    @property
    def final_loss(self) -> float:
        return float(self.losses[-1])


class _EpochGraph:
    """One CUDA graph of a whole epoch's step loop over static tensors:
    the batches ``[nb, b, k]`` / ``[nb, b]``, the parameters and
    optimizer state (updated in place) and the epoch's mean loss."""

    def __init__(self, trainer: "Trainer", Xb: torch.Tensor,
                 yb: torch.Tensor, params, opt_state):
        from ..models import compiled as C
        self.shape = (tuple(Xb.shape), tuple(yb.shape))
        self.Xb = torch.empty_like(Xb)
        self.yb = torch.empty_like(yb)
        self.params = _clone(params)
        self.opt_state = _clone(opt_state)
        nb = Xb.shape[0]
        self.losses = torch.zeros(nb, dtype=torch.float32, device=Xb.device)
        with C.DEVICE.exclusive():
            C._bury()
            # a warm-up step on scratch copies (cuBLAS sets itself up
            # outside the capture); the statics stay untouched
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                trainer.train_step(_clone(params), _clone(opt_state), Xb[0],
                              yb[0])
            torch.cuda.current_stream().wait_stream(side)
            torch.cuda.synchronize()
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph):
                for i in range(nb):
                    loss = trainer.train_step(self.params, self.opt_state,
                                         self.Xb[i], self.yb[i])
                    self.losses[i].copy_(loss)
                self.loss = self.losses.mean()
            torch.cuda.synchronize()

    def run(self, Xb, yb, params, opt_state, fresh: bool) -> torch.Tensor:
        """One epoch: batches (and, at a fit's first epoch, the caller's
        params and state) copied in, one replay; the mean loss, cloned."""
        from ..models import compiled as C
        with C.device_work():
            if fresh:
                _copy_into(self.params, params)
                _copy_into(self.opt_state, opt_state)
            self.Xb.copy_(Xb)
            self.yb.copy_(yb)
            self.graph.replay()
            return self.loss.clone()


class Trainer:
    """Step/epoch harness for one (model, optimizer) pair."""

    def __init__(self, model: Model, opt: Optimizer, *,
                 fuse: Optional[bool] = None):
        self.model, self.opt = model, opt
        self.fuse = (knobs.get("SRJT_ML_EPOCH_FUSE") if fuse is None
                     else bool(fuse))
        self._graph: Optional[_EpochGraph] = None
        #: epoch graphs captured (the first fused epoch of a shape)
        self.graph_captures = 0

    def init(self, k: int, device=None):
        params = self.model.init(k, device)
        return params, self.opt.init(params)

    def train_step(self, params, ostate, xb, yb) -> torch.Tensor:
        """One step, updating ``params`` and ``ostate`` in place; the loss
        of the batch before the update."""
        z = _z(params, xb)
        loss = self.model.loss_z(z, yb)
        gz = self.model.grad_z(z, yb)
        grads = {"w": gz @ xb, "b": gz.sum()}
        self.opt.update(grads, ostate, params)
        return loss

    def run_epoch(self, params, ostate, Xb, yb) -> torch.Tensor:
        """One epoch's steps, eagerly (in place); the mean loss."""
        losses = torch.stack([self.train_step(params, ostate, Xb[i], yb[i])
                              for i in range(Xb.shape[0])])
        return losses.mean()

    def fit(self, pipe: BatchPipeline, epochs: int, *,
            params=None, opt_state=None,
            on_epoch: Optional[Callable[[int], None]] = None
            ) -> TrainResult:
        """Run ``epochs`` over the pipeline; ONE host read at the very end.

        The per-epoch loop launches only: shuffled batches come off the
        pipeline, the fused epoch is one graph replay on the card, and
        per-epoch losses accumulate as device scalars.  ``on_epoch(e)``,
        when given, is called once epoch ``e``'s work is launched.  The
        caller's ``params`` / ``opt_state`` are not modified; the result
        holds the trained copies."""
        dev = pipe.X.device
        if params is None:
            params, opt_state = self.init(pipe.k, dev)
        elif opt_state is None:
            opt_state = self.opt.init(params)
        graphed = self.fuse and dev.type == "cuda"
        if not graphed:
            params, opt_state = _clone(params), _clone(opt_state)
        t0 = time.perf_counter()
        losses = []
        with metrics.profile_stage("ml.train", model=self.model.name,
                                   opt=self.opt.name) as rec:
            for e in range(epochs):
                Xb, yb = pipe.epoch_arrays(e)
                if graphed:
                    g = self._graph
                    if g is None or g.shape != (tuple(Xb.shape),
                                                tuple(yb.shape)):
                        g = self._graph = _EpochGraph(self, Xb, yb, params,
                                                      opt_state)
                        self.graph_captures += 1
                    loss = g.run(Xb, yb, params, opt_state, fresh=e == 0)
                elif self.fuse:
                    loss = self.run_epoch(params, opt_state, Xb, yb)
                else:
                    loss = None
                    for i in range(pipe.num_batches):
                        loss = self.train_step(params, opt_state, Xb[i],
                                               yb[i])
                losses.append(loss)
                if on_epoch is not None:
                    on_epoch(e)
            # the ONLY steady-loop read: the stacked loss history
            syncs.note_sync()
            hist = torch.stack(losses).cpu().numpy().astype(np.float32)
            rows = pipe.rows_per_epoch * epochs
            if rec is not None:
                rec.out_rows = rows
        if graphed:
            params = _clone(self._graph.params)
            opt_state = _clone(self._graph.opt_state)
        dt_ms = (time.perf_counter() - t0) * 1e3
        if metrics.recording():
            metrics.count("ml.train.epochs", epochs)
            metrics.count("ml.train.rows", rows)
            metrics.observe("ml.train.epoch_ms", dt_ms / max(epochs, 1))
            metrics.ledger_add(f"ml.train:{self.model.name}",
                               train_ms=dt_ms, epochs=epochs, rows=rows)
        return TrainResult(params, opt_state, hist, self.model)
