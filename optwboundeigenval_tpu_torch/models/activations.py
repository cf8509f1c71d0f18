"""Activations (counterpart of ``optwboundeigenval_tpu/models/activations.py``).

Only ``relu`` so far; the ReLU with a swapped backward that saliency
maps use belongs to the analysis port.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def relu(x: torch.Tensor) -> torch.Tensor:
    return F.relu(x)
