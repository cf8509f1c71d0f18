"""BatchNorm written as explicit tensor ops, with torch's running-stat
semantics (counterpart of ``optwboundeigenval_tpu/models/norm.py``).

Why not ``F.batch_norm``:

* its hand-written double backward is exact only to second order; the
  vGHv pass differentiates it a third time and loses the dependence on
  the saved statistics (PARITY.md, tests/test_parity_reference.py::
  test_bn_triple_backward_exactness).  Composed from ``mean``/``rsqrt``
  the autograd graph is exact at every order;
* it updates the running buffers in place, which a ``torch.func``
  transform cannot carry.  Here a train-mode forward never touches the
  buffers; it reports the updated statistics into ``stats_out`` when the
  caller asks (``Task.train_loss``), and only then.

Statistics: batch mean, biased variance ``E[(x - E[x])^2]``, eps 1e-5.
The JAX model takes flax's one-pass ``E[x^2] - E[x]^2``; the two agree
to rounding in float64, but in float32 the one-pass form loses digits
to cancellation when a channel's mean is large against its spread, and
that loss reaches the gradient of the first layers, so the port keeps
the two-pass form of torch's own BatchNorm.  The running
variance stores the UNBIASED ``var * n / (n - 1)``; momentum 0.1 in
torch's convention is flax's 0.9.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn


class BatchNorm2d(nn.Module):
    """BatchNorm over NCHW feature maps (per-channel statistics)."""

    def __init__(self, num_features: int, eps: float = 1e-5,
                 momentum: float = 0.1):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def reset_parameters(self) -> None:
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()
            self.running_mean.zero_()
            self.running_var.fill_(1.0)

    def forward(self, x: torch.Tensor, train: bool = False,
                stats_out: Optional[Dict[nn.Module, tuple]] = None
                ) -> torch.Tensor:
        if train:
            dims = (0, 2, 3)
            mean = x.mean(dims)
            y = x - mean[None, :, None, None]
            var = (y * y).mean(dims)
            if stats_out is not None:
                n = x.numel() // x.shape[1]
                unbiased = var.detach() * (n / max(n - 1.0, 1.0))
                m = self.momentum
                stats_out[self] = (
                    (1 - m) * self.running_mean + m * mean.detach(),
                    (1 - m) * self.running_var + m * unbiased,
                )
        else:
            var = self.running_var
            y = x - self.running_mean[None, :, None, None]
        mul = torch.rsqrt(var + self.eps) * self.weight
        return y * mul[None, :, None, None] + self.bias[None, :, None, None]
