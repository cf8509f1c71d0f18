"""Optimizers as functions on parameter dicts (counterpart of
``optwboundeigenval_tpu/optim/api.py``).

    state          = opt.init(params)
    params, state  = opt.step(direction, state, params, *, grad_fn=None,
                              rng=None, stats_fn=None, err_fn=None)

``direction`` is the regularized gradient ``p = grad f + mu * grad g``.
The keywords are the JAX package's protocol for the comparator
optimizers (optim/api.py:1-23): ``grad_fn(params) -> (loss, grads)``
re-evaluates the plain loss on the current batch (SAM's second pass,
Entropy-SGD's Langevin steps), ``rng`` is the trainer's
``torch.Generator``, ``stats_fn(params, rng)`` captures the K-FAC
statistics, ``err_fn(params) -> (loss, err %)`` is Entropy-SGD's closure;
``sgd`` and ``adam`` ignore them.  ``step`` is functional — it returns
new tensors and leaves its inputs alone — so the trainer can withhold a
non-finite step.  The learning rate sits in ``state["lr"]`` where
host-side schedulers set it between epochs (torch scheduler semantics,
opt.py:760-763); optimizers whose JAX state holds it in float32
(K-FAC, Entropy-SGD) round it so (``lr_float32``).

The arithmetic of ``sgd`` and ``adam`` is optax's
(``add_decayed_weights`` then ``sgd`` or ``adam``), which is
torch.optim's with COUPLED weight decay.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import numpy as np
import torch

Tree = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """``wants_err``: ``step`` takes ``err_fn`` and its state carries the
    closure's ``mf``/``merr``; ``needs_stats``: ``step`` takes
    ``stats_fn``, with sampled targets when ``kfac_rand``;
    ``build_extra_state(state, task, params, model_state)`` fills the
    model-shaped state once at ``init_state`` (the K-FAC factors);
    ``slices``: ``step`` may run on a rank's slices of sharded leaves
    (``parallel/sharding.py``), else the trainer hands it the gathered
    tree and keeps the slices of its result (K-FAC's per-layer inverse,
    Entropy-SGD's noise drawn in the full shapes)."""

    name: str
    init: Callable[[Tree], dict]
    step: Callable[..., tuple]
    lr_float32: bool = False
    wants_err: bool = False
    needs_stats: bool = False
    kfac_rand: bool = True
    build_extra_state: Optional[Callable] = None
    slices: bool = True

    def set_learning_rate(self, state: dict, lr: float) -> dict:
        return {**state, "lr": float(np.float32(lr) if self.lr_float32 else lr)}

    def get_learning_rate(self, state: dict) -> float:
        return state["lr"]


def _decayed(direction: Tree, params: Tree, weight_decay: float) -> Tree:
    if not weight_decay:
        return direction
    return {k: d + weight_decay * params[k] for k, d in direction.items()}


def sgd(learning_rate: float = 0.1, momentum: Optional[float] = None,
        nesterov: bool = False, weight_decay: float = 0.0) -> Optimizer:
    """torch.optim.SGD (dampening 0): ``t = d + momentum * t``,
    ``p <- p - lr * t`` (``d + momentum * t`` again for Nesterov)."""

    def init(params):
        state = {"lr": float(learning_rate)}
        if momentum:
            state["trace"] = {k: torch.zeros_like(p) for k, p in params.items()}
        return state

    def step(direction, state, params, **_):
        d = _decayed(direction, params, weight_decay)
        new_state = dict(state)
        if momentum:
            trace = {k: g + momentum * state["trace"][k] for k, g in d.items()}
            new_state["trace"] = trace
            d = ({k: g + momentum * trace[k] for k, g in d.items()}
                 if nesterov else trace)
        lr = state["lr"]
        return {k: p + (-lr) * d[k] for k, p in params.items()}, new_state

    return Optimizer(name="SGD", init=init, step=step)


def adam(learning_rate: float = 1e-3, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8, weight_decay: float = 0.0) -> Optimizer:
    """torch.optim.Adam with COUPLED weight decay (``wd * p`` is added to
    the gradient before the moments; params/chestxray_best_reg.py:110)."""

    def init(params):
        zeros = lambda: {k: torch.zeros_like(p) for k, p in params.items()}
        return {"lr": float(learning_rate), "count": 0, "mu": zeros(),
                "nu": zeros()}

    def step(direction, state, params, **_):
        d = _decayed(direction, params, weight_decay)
        count = state["count"] + 1
        mu = {k: (1 - b1) * g + b1 * state["mu"][k] for k, g in d.items()}
        nu = {k: (1 - b2) * g * g + b2 * state["nu"][k] for k, g in d.items()}
        c1, c2 = 1 - b1 ** count, 1 - b2 ** count
        lr = state["lr"]
        new_params = {
            k: p + (-lr) * ((mu[k] / c1) / (torch.sqrt(nu[k] / c2) + eps))
            for k, p in params.items()
        }
        return new_params, {**state, "count": count, "mu": mu, "nu": nu}

    return Optimizer(name="Adam", init=init, step=step)
