"""Host-side learning-rate schedulers with torch-scheduler semantics
(counterpart of ``optwboundeigenval_tpu/optim/schedules.py``:
``LambdaLR``, ``ExponentialLR``, ``CosineAnnealingLR`` and
``ReduceLROnPlateau``).  Each epoch the trainer calls
``step(metric)`` with the epoch's train loss ``f`` (opt.py:760-763) and
writes the returned lr into the optimizer state."""

from __future__ import annotations

import math
from typing import Callable, Optional


class LambdaLR:
    """``lr = base_lr * fn(epoch)`` (torch.optim.lr_scheduler.LambdaLR)."""

    def __init__(self, base_lr: float, lr_lambda: Callable[[int], float]):
        self.base_lr = float(base_lr)
        self.fn = lr_lambda
        self.epoch = 0
        self.lr = self.base_lr * float(lr_lambda(0))

    def step(self, metric: Optional[float] = None) -> float:
        self.epoch += 1
        self.lr = self.base_lr * float(self.fn(self.epoch))
        return self.lr


class ExponentialLR:
    """``lr = base_lr * gamma ** epoch`` (JAX schedules.py:44-50)."""

    def __init__(self, base_lr: float, gamma: float):
        self.base_lr = self.lr = float(base_lr)
        self.gamma = gamma
        self.epoch = 0

    def step(self, metric: Optional[float] = None) -> float:
        self.epoch += 1
        self.lr = self.base_lr * self.gamma ** self.epoch
        return self.lr


class CosineAnnealingLR:
    """``lr = eta_min + (base_lr - eta_min) (1 + cos(pi epoch / T_max)) / 2``
    (JAX schedules.py:53-70), with no clamp at ``T_max``: past it the lr
    rises again, as torch's closed form does."""

    def __init__(self, base_lr: float, T_max: int, eta_min: float = 0.0):
        self.base_lr = self.lr = float(base_lr)
        self.T_max = T_max
        self.eta_min = eta_min
        self.epoch = 0

    def step(self, metric: Optional[float] = None) -> float:
        self.epoch += 1
        self.lr = (self.eta_min + (self.base_lr - self.eta_min)
                   * (1 + math.cos(math.pi * self.epoch / self.T_max)) / 2)
        return self.lr


class ReduceLROnPlateau:
    """Multiply the lr by ``factor`` (not below ``min_lr``) once the metric
    has gone more than ``patience`` epochs without improving by a relative
    ``threshold``; ``mode`` ``"min"`` or ``"max"`` (JAX schedules.py:73-112)."""

    def __init__(self, base_lr: float, factor: float = 0.1, patience: int = 10,
                 threshold: float = 1e-4, min_lr: float = 0.0, mode: str = "min"):
        self.base_lr = float(base_lr)
        self.lr = self.base_lr
        self.epoch = 0
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.min_lr = min_lr
        self.mode = mode
        self.best: Optional[float] = None
        self.bad_epochs = 0

    def step(self, metric: Optional[float] = None) -> float:
        self.epoch += 1
        if metric is None:
            return self.lr
        better = (self.best is None
                  or (self.mode == "min" and metric < self.best * (1 - self.threshold))
                  or (self.mode == "max" and metric > self.best * (1 + self.threshold)))
        if better:
            self.best, self.bad_epochs = metric, 0
        else:
            self.bad_epochs += 1
            if self.bad_epochs > self.patience:
                self.bad_epochs = 0
                self.lr = max(self.lr * self.factor, self.min_lr)
        return self.lr
