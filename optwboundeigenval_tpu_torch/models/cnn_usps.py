"""USPS digit CNN (counterpart of ``optwboundeigenval_tpu/models/cnn_usps.py``).

Reference ``CNN`` (usps_data.py:298-336): 3x(conv3x3 SAME + ReLU +
maxpool2) -> fc64 -> fc10 on 16x16x1 inputs, logits out.  Parameter
names are the reference's (``conv1..3``, ``fc1``, ``fc2``).  The input
is NHWC ``(B, 16, 16, 1)`` or flat ``(B, 256)``; it is computed in NCHW
and flattened in torch's CHW order, so ``fc1``'s columns are the
reference's and ``utils/interop.py`` permutes them to and from the JAX
model's HWC flatten.  Only ``conv_impl='lax'`` (the library convolution)
is ported.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from optwboundeigenval_tpu_torch.models.activations import relu
from optwboundeigenval_tpu_torch.models.mlp_forest import reset_torch_default


class CNNUSPS(nn.Module):
    def __init__(self, num_classes: int = 10, conv_impl: str = "lax"):
        super().__init__()
        if conv_impl != "lax":
            raise NotImplementedError(f"CNNUSPS(conv_impl={conv_impl!r}) is not ported")
        self.conv1 = nn.Conv2d(1, 8, 3, padding=1)
        self.conv2 = nn.Conv2d(8, 16, 3, padding=1)
        self.conv3 = nn.Conv2d(16, 32, 3, padding=1)
        self.fc1 = nn.Linear(2 * 2 * 32, 64)
        self.fc2 = nn.Linear(64, num_classes)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        reset_torch_default(self, generator)

    def forward(self, x: torch.Tensor, train: bool = False,
                stats_out: Optional[dict] = None) -> torch.Tensor:
        x = x.reshape(-1, 16, 16, 1).permute(0, 3, 1, 2)
        x = x.to(self.conv1.weight.dtype).contiguous()
        for conv in (self.conv1, self.conv2, self.conv3):
            x = F.max_pool2d(relu(conv(x)), 2)
        x = relu(self.fc1(x.flatten(1)))  # (B, 32*2*2) in CHW order
        return self.fc2(x)
