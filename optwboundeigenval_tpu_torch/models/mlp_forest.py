"""Forest CoverType MLP (counterpart of ``optwboundeigenval_tpu/models/mlp_forest.py``).

Reference ``Net`` (forest_data.py:75-89): 54 -> 20 -> 20 -> 7 with ``fc2``
applied twice.  The second call is the same ``nn.Linear``, so its
gradient sums over both uses, as the reference's weight tying does.  The
model outputs logits; the loss applies the softmax.  ``dtype`` is the
JAX model's compute dtype (``models/layers.py``); ``None``, the default,
computes in the parameters' dtype.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from optwboundeigenval_tpu_torch.models.activations import relu
from optwboundeigenval_tpu_torch.models.layers import Linear


@torch.no_grad()
def reset_torch_default(module: nn.Module,
                        generator: Optional[torch.Generator] = None) -> None:
    """torch's default init of ``nn.Linear`` and ``nn.Conv2d``
    (``kaiming_uniform_(a=sqrt(5))``: weight and bias uniform in
    ``+-1/sqrt(fan_in)``), drawn from ``generator``: the reference models'
    init."""
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d)):
            bound = 1.0 / math.sqrt(m.weight[0].numel())
            m.weight.uniform_(-bound, bound, generator=generator)
            m.bias.uniform_(-bound, bound, generator=generator)


class ForestNet(nn.Module):
    def __init__(self, hidden: int = 20, num_classes: int = 7,
                 in_features: int = 54, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.fc1 = Linear(in_features, hidden, compute_dtype=dtype)
        self.fc2 = Linear(hidden, hidden, compute_dtype=dtype)
        self.fc3 = Linear(hidden, num_classes, compute_dtype=dtype)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        reset_torch_default(self, generator)

    def forward(self, x: torch.Tensor, train: bool = False,
                stats_out: Optional[dict] = None) -> torch.Tensor:
        x = x.to(self.dtype or self.fc1.weight.dtype)
        x = relu(self.fc1(x))
        x = relu(self.fc2(x))
        x = relu(self.fc2(x))  # fc2 applied twice: the reference's tying
        return self.fc3(x)
