"""Task: binds an ``nn.Module`` and a loss into the pure functions the
trainer and the curvature ops consume (counterpart of
``optwboundeigenval_tpu/train/task.py``).

The module serves as a skeleton: parameters and buffers live in plain
dicts ``{name: tensor}`` and go in through
``torch.func.functional_call``, so the same functions can be
differentiated two and three times.

* ``loss_fn(model_state)(params, batch)`` — train-mode loss with the
  BatchNorm running statistics FROZEN: the function whose Hessian is
  regularized (the reference computes HVPs in train mode, opt.py:421).
* ``train_loss(params, model_state, batch)`` — ``(loss, new_state)``:
  the running statistics update here, functionally, and only here.
* ``predict(params, model_state, batch)`` — eval-mode outputs.

Batches are dicts ``{"x", "y", "w"}``; ``w`` weights each example and
carries ``w = 0`` on padded rows, so every loss is a weighted mean.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

Tree = Dict[str, torch.Tensor]


def _weighted_mean(per_example: torch.Tensor,
                   w: Optional[torch.Tensor]) -> torch.Tensor:
    if w is None:
        return per_example.mean()
    w = w.to(per_example.dtype)
    return (per_example * w).sum() / torch.clamp_min(w.sum(), 1e-12)


def _pick(values: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return values.gather(-1, y.long()[:, None])[:, 0]


def cross_entropy(outputs, y, w=None):
    """Softmax cross entropy from logits against integer labels."""
    return _weighted_mean(-_pick(F.log_softmax(outputs, dim=-1), y), w)


def cross_entropy_double_softmax(outputs, y, w=None):
    """The reference's exact composition: softmax in the model, then
    ``nn.CrossEntropyLoss`` applies log-softmax again."""
    logp = F.log_softmax(F.softmax(outputs, dim=-1), dim=-1)
    return _weighted_mean(-_pick(logp, y), w)


def _mean_rest(t: torch.Tensor) -> torch.Tensor:
    return t.mean(dim=tuple(range(1, t.dim()))) if t.dim() > 1 else t


def mse(outputs, y, w=None):
    return _weighted_mean(_mean_rest((outputs - y) ** 2), w)


def bce_with_logits(outputs, y, w=None):
    per = (torch.clamp_min(outputs, 0) - outputs * y
           + torch.log1p(torch.exp(-outputs.abs())))
    return _weighted_mean(_mean_rest(per), w)


def kl_onehot(outputs, y, w=None):
    """KLDivLoss against one-hot targets, mean-reduced over all elements
    (opt.py:182-187)."""
    return _weighted_mean(-_pick(outputs, y), w) / outputs.shape[-1]


def weighted_bce_with_logits(outputs, y, w=None):
    """W_BCEWithLogitsLoss (dcnn.py:375-400): global positive/negative
    re-weighting over the valid (non-NaN, ``w > 0``) labels, per-class
    means, then the mean over classes that had any valid label."""
    valid = ~torch.isnan(y)
    if w is not None:
        valid = valid & (w[:, None] > 0)
    y0 = torch.where(valid, y, torch.zeros_like(y))
    p = y0.sum()
    s = valid.sum().to(outputs.dtype)
    degenerate = (p == 0) | (p == s)
    one = torch.ones_like(p)
    w_pos = torch.where(degenerate, 2.0 * one, s / torch.where(p == 0, one, p))
    w_neg = torch.where(degenerate, one, s / torch.where(s - p == 0, one, s - p))
    weight = torch.where(y0 > 0, w_pos, w_neg)
    elt = -weight * (y0 * F.logsigmoid(outputs)
                     + (1.0 - y0) * F.logsigmoid(-outputs))
    elt = torch.where(valid, elt, torch.zeros_like(elt))
    cnt = valid.sum(dim=0)
    per_class = elt.sum(dim=0) / torch.clamp_min(cnt, 1)
    has_any = cnt > 0
    return (torch.where(has_any, per_class, torch.zeros_like(per_class)).sum()
            / torch.clamp_min(has_any.sum(), 1))


losses: Dict[str, Callable] = {
    "cross_entropy": cross_entropy,
    "cross_entropy_double_softmax": cross_entropy_double_softmax,
    "mse": mse,
    "bce_with_logits": bce_with_logits,
    "kl_onehot": kl_onehot,
    "weighted_bce_with_logits": weighted_bce_with_logits,
}


@dataclasses.dataclass(frozen=True, eq=False)
class Task:
    """Model + loss binding.  ``model.forward(x, train, stats_out)``
    returns logits; ``stats_out`` collects updated BN statistics."""

    model: nn.Module
    loss: Callable = cross_entropy
    has_batch_stats: bool = False
    has_dropout: bool = False

    def __post_init__(self):
        if self.has_dropout:
            raise NotImplementedError("dropout models are not ported")

    def init(self, generator: Optional[torch.Generator],
             device) -> tuple[Tree, Tree]:
        """Fresh ``(params, model_state)`` on ``device``, drawn from
        ``generator``."""
        self.model.reset_parameters(generator)
        params = {k: p.detach().to(device, copy=True)
                  for k, p in self.model.named_parameters()}
        state = {k: b.detach().to(device, copy=True)
                 for k, b in self.model.named_buffers()}
        return params, state

    def _apply(self, params, model_state, x, train, stats_out=None):
        return functional_call(self.model, (params, model_state), (x,),
                               {"train": train, "stats_out": stats_out})

    def loss_fn(self, model_state: Tree) -> Callable:
        """``f(params, batch) -> scalar`` in train mode with frozen
        running statistics — the function the curvature ops
        differentiate."""

        def f(params, batch):
            out = self._apply(params, model_state, batch["x"], True)
            return self.loss(out, batch["y"], batch.get("w"))

        return f

    @torch.no_grad()
    def train_loss(self, params, model_state, batch):
        """``(loss, new_model_state)``; BN running statistics update
        here and only here."""
        stats: dict = {}
        out = self._apply(params, model_state, batch["x"], True,
                          stats if self.has_batch_stats else None)
        new_state = dict(model_state)
        for name, module in self.model.named_modules():
            if module in stats:
                new_state[f"{name}.running_mean"], \
                    new_state[f"{name}.running_var"] = stats[module]
        return self.loss(out, batch["y"], batch.get("w")), new_state

    @torch.no_grad()
    def predict(self, params, model_state, batch):
        """Eval-mode outputs (running statistics)."""
        return self._apply(params, model_state, batch["x"], False)
