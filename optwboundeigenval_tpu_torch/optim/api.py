"""Optimizers as functions on parameter dicts (counterpart of
``optwboundeigenval_tpu/optim/api.py``).

    state          = opt.init(params)
    params, state  = opt.step(direction, state, params)

``direction`` is the regularized gradient ``p = grad f + mu * grad g``.
``step`` is functional — it returns new tensors and leaves its inputs
alone — so the trainer can withhold a non-finite step.  The learning
rate sits in ``state["lr"]`` where host-side schedulers set it between
epochs (torch scheduler semantics, opt.py:760-763).

The arithmetic is optax's (``add_decayed_weights`` then ``sgd`` or
``adam``), which is torch.optim's with COUPLED weight decay.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch

Tree = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class Optimizer:
    name: str
    init: Callable[[Tree], dict]
    step: Callable[[Tree, dict, Tree], tuple]

    def set_learning_rate(self, state: dict, lr: float) -> dict:
        return {**state, "lr": float(lr)}

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

    def step(direction, state, params):
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

    def step(direction, state, params):
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
