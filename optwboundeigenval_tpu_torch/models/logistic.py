"""Logistic regression (counterpart of ``optwboundeigenval_tpu/models/logistic.py``):
the reference's ``LogisticRegression`` (dcnn.py:332-341), the saliency
meta-classifier's model.  The input is flattened as it comes (an NHWC
batch in the JAX package's order), so ``linear`` is flax's ``Dense_0``
transposed; logits out.  ``dtype`` is the JAX model's compute dtype
(``None``: the parameters')."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from optwboundeigenval_tpu_torch.models.layers import Linear
from optwboundeigenval_tpu_torch.models.mlp_forest import reset_torch_default


class LogisticRegression(nn.Module):
    def __init__(self, in_features: int, num_outputs: int = 1,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.linear = Linear(in_features, num_outputs, compute_dtype=dtype)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        reset_torch_default(self, generator)

    def forward(self, x: torch.Tensor, train: bool = False,
                stats_out: Optional[dict] = None) -> torch.Tensor:
        x = x.reshape(x.shape[0], -1).to(self.dtype or self.linear.weight.dtype)
        return self.linear(x)
