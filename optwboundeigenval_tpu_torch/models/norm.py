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
  buffers; it reports the batch's statistics into ``stats_out`` when the
  caller asks, and only then: ``Task.train_loss`` folds them into the
  running statistics with the module's momentum, and the Asymmetric
  Valley's ``bn_update`` averages them over a loader.

Statistics: batch mean, biased variance ``E[(x - E[x])^2]``, eps 1e-5.
The JAX model takes flax's one-pass ``E[x^2] - E[x]^2``; the two agree
to rounding in float64, but in float32 the one-pass form loses digits
to cancellation when a channel's mean is large against its spread, and
that loss reaches the gradient of the first layers, so the port keeps
the two-pass form of torch's own BatchNorm.  The running
variance stores the UNBIASED ``var * n / (n - 1)``; momentum 0.1 in
torch's convention is flax's 0.9.

Under a data-parallel mesh (``parallel/mesh.py``, ``active``) the
statistics are the global batch's, as the JAX package's mean over a
sharded batch axis is: the per-channel sums and the count go through an
all-reduce over the ``data`` group (each row once) that autograd
differentiates to every order, the mean first
and then the squared deviations from it (two passes still).

A compute ``dtype`` (flax's ``dtype`` under the JAX package's
``force_float32_reductions``): the input is taken up to at least float32,
the statistics are reduced and the input normalised there against the
float32 scale and bias, and the output is cast to ``dtype``, in train and
eval mode alike (flax ``normalization._compute_stats`` and
``_normalize``); ``stats_out`` and the running buffers stay float32.
``dtype=None`` computes in the input's dtype, which the port's models make
the parameters'.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from optwboundeigenval_tpu_torch.parallel import mesh as meshlib
from optwboundeigenval_tpu_torch.utils import timing


class BatchNorm2d(nn.Module):
    """BatchNorm over NCHW feature maps (per-channel statistics)."""

    def __init__(self, num_features: int, eps: float = 1e-5,
                 momentum: float = 0.1, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.dtype = dtype
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
        if self.dtype is not None:
            x = x.to(torch.promote_types(self.dtype, torch.float32))
        if train:
            dims = (0, 2, 3)
            n = x.numel() // x.shape[1]
            if meshlib.current() is None:
                mean = x.mean(dims)
                y = x - mean[None, :, None, None]
                var = (y * y).mean(dims)
            else:
                n = int(timing.read("norm.count", meshlib.all_sum(
                    timing.to_device("norm.count", n, x.device))))
                mean = meshlib.all_sum_diff(x.sum(dims)) / n
                y = x - mean[None, :, None, None]
                var = meshlib.all_sum_diff((y * y).sum(dims)) / n
            if stats_out is not None:
                stats_out[self] = (mean.detach(), var.detach() * (n / max(n - 1.0, 1.0)))
        else:
            var = self.running_var
            y = x - self.running_mean[None, :, None, None]
        mul = torch.rsqrt(var + self.eps) * self.weight
        out = y * mul[None, :, None, None] + self.bias[None, :, None, None]
        return out if self.dtype is None else out.to(self.dtype)
