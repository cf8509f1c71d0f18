"""Activations (counterpart of ``optwboundeigenval_tpu/models/activations.py``).

The reference's GuidedBackprop swaps every ReLU's backward through module
hooks (guided_backprop.py:8-75).  Here every model of the port calls
:func:`relu`, which reads a context variable at call time: inside
:func:`guided` it is :class:`GuidedReLU`, whose backward passes the
upstream gradient only where both the input and that gradient are
positive; everywhere else, the training step included, it is ``F.relu``.
"""

from __future__ import annotations

import contextlib
import contextvars

import torch
import torch.nn.functional as F

_GUIDED = contextvars.ContextVar("guided_relu", default=False)


class GuidedReLU(torch.autograd.Function):
    """``max(x, 0)`` whose backward is ``g * ((x > 0) & (g > 0))``."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return F.relu(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return torch.where((x > 0) & (g > 0), g, torch.zeros_like(g))


def relu(x: torch.Tensor) -> torch.Tensor:
    """ReLU; the guided one inside :func:`guided`."""
    if _GUIDED.get():
        return GuidedReLU.apply(x)
    return F.relu(x)


@contextlib.contextmanager
def guided():
    """Run a forward (and its backward) with guided-ReLU gradients."""
    token = _GUIDED.set(True)
    try:
        yield
    finally:
        _GUIDED.reset(token)
