"""The two training losses, as weighted means over the batch's rows
(``w`` weights each row).

* ``cross_entropy``: softmax cross entropy of logits against class ids.
* ``weighted_bce``: the chest x-ray recipe's weighted binary cross
  entropy with logits: labels that are NaN or on rows of weight 0 do not
  count; positives weigh ``s / p`` and negatives ``s / (s - p)`` over the
  batch's ``s`` valid labels of which ``p`` are positive (2 and 1 where
  the batch has no positive or no negative); each class's sum over its
  valid labels is divided by their count, and the classes that have any
  are averaged.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def cross_entropy(logits: torch.Tensor, y: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    per_row = -F.log_softmax(logits, dim=-1).gather(-1, y.long()[:, None])[:, 0]
    w = w.to(per_row.dtype)
    return (per_row * w).sum() / torch.clamp_min(w.sum(), 1e-12)


def weighted_bce(logits: torch.Tensor, y: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    valid = ~torch.isnan(y) & (w[:, None] > 0)
    y = torch.where(valid, y, torch.zeros_like(y))
    p = y.sum()
    s = valid.sum().to(logits.dtype)
    if p == 0 or p == s:
        w_pos, w_neg = 2.0, 1.0
    else:
        w_pos, w_neg = s / p, s / (s - p)
    weight = torch.where(y > 0, w_pos, w_neg)
    per = -weight * (y * F.logsigmoid(logits) + (1.0 - y) * F.logsigmoid(-logits))
    per = torch.where(valid, per, torch.zeros_like(per))
    count = valid.sum(dim=0)
    has = count > 0
    per_class = per.sum(dim=0) / torch.clamp_min(count, 1)
    return torch.where(has, per_class, torch.zeros_like(per_class)).sum() / torch.clamp_min(
        has.sum(), 1)


LOSSES = {"cross_entropy": cross_entropy, "weighted_bce_with_logits": weighted_bce}
