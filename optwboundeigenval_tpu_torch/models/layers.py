"""Layers with a compute dtype (flax's ``dtype`` field of ``nn.Conv``,
``nn.Dense``, ``nn.Embed`` and ``nn.ConvTranspose``).

flax's rule (``flax.linen.dtypes.promote_dtype`` with ``dtype`` given):
the input, the kernel and the bias are cast to the compute dtype, and the
layer computes and returns in it; the parameters keep their own dtype
(``param_dtype``, float32 by default), so the gradient with respect to a
parameter comes back in the parameter's dtype through the cast's
backward.  There is no float32 output of the accumulation.

Each layer here is the ``torch.nn`` one with a ``compute_dtype`` (the
``dtype`` keyword of ``torch.nn`` already names the parameters' dtype):
``None`` casts nothing and runs the ``torch.nn`` forward as it is, which
is the port's default, "compute in the parameters' dtype".  The casts are
explicit ops, not ``torch.autocast``, whose op lists disagree with flax
(autocast runs ``log_softmax``, ``softmax`` and the reductions in
float32) and whose cast cache outlives a pass of the curvature products.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


def cast(dtype: Optional[torch.dtype], *tensors):
    """Each tensor in ``dtype`` (``None`` entries pass); ``dtype=None``
    returns them as they are."""
    if dtype is None:
        return tensors
    return tuple(None if t is None else t.to(dtype) for t in tensors)


class Conv2d(nn.Conv2d):
    def __init__(self, *args, compute_dtype: Optional[torch.dtype] = None, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.compute_dtype is None:
            return super().forward(x)
        return self._conv_forward(*cast(self.compute_dtype, x, self.weight, self.bias))


class ConvTranspose2d(nn.ConvTranspose2d):
    def __init__(self, *args, compute_dtype: Optional[torch.dtype] = None, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.compute_dtype is None:
            return super().forward(x)
        x, w, b = cast(self.compute_dtype, x, self.weight, self.bias)
        return F.conv_transpose2d(x, w, b, self.stride, self.padding, self.output_padding,
                                  self.groups, self.dilation)


class Linear(nn.Linear):
    def __init__(self, *args, compute_dtype: Optional[torch.dtype] = None, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(*cast(self.compute_dtype, x, self.weight, self.bias))


class Embedding(nn.Embedding):
    """flax ``nn.Embed``: the table is cast, the looked-up rows come out in
    the compute dtype."""

    def __init__(self, *args, compute_dtype: Optional[torch.dtype] = None, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, idx: torch.Tensor) -> torch.Tensor:
        if self.compute_dtype is None:
            return super().forward(idx)
        (w,) = cast(self.compute_dtype, self.weight)
        return F.embedding(idx, w, self.padding_idx, self.max_norm, self.norm_type,
                           self.scale_grad_by_freq, self.sparse)
