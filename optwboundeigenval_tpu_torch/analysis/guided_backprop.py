"""Guided backpropagation (counterpart of
``optwboundeigenval_tpu/analysis/guided_backprop.py``; reference
``GuidedBackprop``, guided_backprop.py:8-75): the gradient of the target
class's score with respect to the input, every ReLU's backward passing
the upstream gradient only where both it and the ReLU's input are
positive (``models/activations.guided``)."""

from __future__ import annotations

import torch

from optwboundeigenval_tpu_torch.analysis.saliency import input_gradient
from optwboundeigenval_tpu_torch.models import activations


def generate_gradients(task, params, model_state, x, target_class=None) -> torch.Tensor:
    """Guided gradients of a batch, shaped as ``x``; ``target_class`` an int
    or one per example, by default the arg max."""
    with activations.guided():
        return input_gradient(task, params, model_state, x, target_class)
