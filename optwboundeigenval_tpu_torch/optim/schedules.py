"""Host-side learning-rate schedulers with torch-scheduler semantics
(counterpart of ``optwboundeigenval_tpu/optim/schedules.py``; only
``LambdaLR`` so far).  Each epoch the trainer calls ``step(metric)`` and
writes the returned lr into the optimizer state."""

from __future__ import annotations

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
