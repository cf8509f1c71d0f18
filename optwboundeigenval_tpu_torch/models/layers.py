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

Under the ``model`` mesh axis (``parallel/sharding.py``) a layer's weight
may arrive as this rank's slice of its output features (dim 0 of a
``Conv2d`` or ``Linear`` weight, dim 1 of a ``ConvTranspose2d`` or
``Embedding`` one).  The layer then computes its own output columns
without the bias, and ``sharding.assemble_columns`` makes the whole
output over the ``model`` group and adds the bias.  A full-shaped weight
computes the whole layer as ``torch.nn`` does.  A slice in a layer that
cannot split (a grouped convolution, an embedding with ``max_norm``)
raises.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from optwboundeigenval_tpu_torch.parallel.sharding import assemble_columns


def cast(dtype: Optional[torch.dtype], *tensors):
    """Each tensor in ``dtype`` (``None`` entries pass); ``dtype=None``
    returns them as they are."""
    if dtype is None:
        return tensors
    return tuple(None if t is None else t.to(dtype) for t in tensors)


def _unsplit(layer: nn.Module, cannot: bool) -> None:
    """Raise where ``layer``, holding a slice of its weight, cannot split."""
    if cannot:
        raise ValueError(f"{layer}: its weight is a slice, and the layer cannot compute "
                         "its own output columns")


class Conv2d(nn.Conv2d):
    def __init__(self, *args, compute_dtype: Optional[torch.dtype] = None, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.weight.shape[0] == self.out_channels:
            if self.compute_dtype is None:
                return super().forward(x)
            return self._conv_forward(*cast(self.compute_dtype, x, self.weight, self.bias))
        _unsplit(self, self.groups != 1)
        x, w, b = cast(self.compute_dtype, x, self.weight, self.bias)
        return assemble_columns(self._conv_forward(x, w, None), self.out_channels, 1, b)


class ConvTranspose2d(nn.ConvTranspose2d):
    def __init__(self, *args, compute_dtype: Optional[torch.dtype] = None, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        whole = self.weight.shape[1] * self.groups == self.out_channels
        if whole and self.compute_dtype is None:
            return super().forward(x)
        x, w, b = cast(self.compute_dtype, x, self.weight, self.bias)
        if whole:
            return F.conv_transpose2d(x, w, b, self.stride, self.padding, self.output_padding,
                                      self.groups, self.dilation)
        _unsplit(self, self.groups != 1)
        y = F.conv_transpose2d(x, w, None, self.stride, self.padding, self.output_padding,
                               self.groups, self.dilation)
        return assemble_columns(y, self.out_channels, 1, b)


class Linear(nn.Linear):
    def __init__(self, *args, compute_dtype: Optional[torch.dtype] = None, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, w, b = cast(self.compute_dtype, x, self.weight, self.bias)
        if w.shape[0] == self.out_features:
            return F.linear(x, w, b)
        return assemble_columns(F.linear(x, w), self.out_features, -1, b)


class Embedding(nn.Embedding):
    """flax ``nn.Embed``: the table is cast, the looked-up rows come out in
    the compute dtype."""

    def __init__(self, *args, compute_dtype: Optional[torch.dtype] = None, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, idx: torch.Tensor) -> torch.Tensor:
        whole = self.weight.shape[1] == self.embedding_dim
        if whole and self.compute_dtype is None:
            return super().forward(idx)
        (w,) = cast(self.compute_dtype, self.weight)
        if not whole:
            _unsplit(self, self.max_norm is not None)
        y = F.embedding(idx, w, self.padding_idx, self.max_norm, self.norm_type,
                        self.scale_grad_by_freq, self.sparse)
        return y if whole else assemble_columns(y, self.embedding_dim, -1)
