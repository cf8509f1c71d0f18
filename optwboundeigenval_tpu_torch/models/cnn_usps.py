"""USPS digit CNN (counterpart of ``optwboundeigenval_tpu/models/cnn_usps.py``).

Reference ``CNN`` (usps_data.py:298-336): 3x(conv3x3 SAME + ReLU +
maxpool2) -> fc64 -> fc10 on 16x16x1 inputs, logits out.  Parameter
names are the reference's (``conv1..3``, ``fc1``, ``fc2``).  The input
is NHWC ``(B, 16, 16, 1)`` or flat ``(B, 256)``; it is computed in NCHW
and flattened in torch's CHW order, so ``fc1``'s columns are the
reference's and ``utils/interop.py`` permutes them to and from the JAX
model's HWC flatten.

``conv_impl='gemm'`` (JAX cnn_usps.py:32-72) computes each 3x3 SAME conv
as im2col patches in the JAX package's ``(kh, kw, in_c)`` order and one
matmul, and each 2x2 pool as a reshape and ``torch.amax`` over the two
window axes.  The parameters keep the names and layouts of ``conv1..3``,
so weights, K-FAC factors and checkpoints cross unchanged.  The forward
equals ``'lax'``'s, the derivatives do not: at a window of tied maxima
``amax`` (as the JAX package's reshape-max) shares the gradient evenly,
where ``F.max_pool2d`` (as ``nn.max_pool``) gives it all to one element.

``dtype`` is the JAX model's compute dtype (``None``, the default,
computes in the parameters' dtype).  As in the JAX package, whose
``GemmConv3x3`` makes its ``kernel`` and ``bias`` in the compute dtype
(JAX cnn_usps.py:66-71), under ``'gemm'`` the three convs HOLD their
parameters in ``dtype`` while the dense layers keep float32: at bfloat16
the model's tree mixes bfloat16 and float32 leaves.  Under ``'lax'``
every parameter keeps its dtype and the layers cast
(``models/layers.py``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from optwboundeigenval_tpu_torch.models.activations import relu
from optwboundeigenval_tpu_torch.models.layers import Conv2d, Linear, cast
from optwboundeigenval_tpu_torch.models.mlp_forest import reset_torch_default
from optwboundeigenval_tpu_torch.parallel.sharding import assemble_columns


def gemm_conv3x3_same(x: torch.Tensor, weight: torch.Tensor,
                      bias: torch.Tensor, out_channels: Optional[int] = None) -> torch.Tensor:
    """3x3 SAME conv of an NCHW batch as im2col and one matmul; the patch
    columns in ``(kh, kw, in_c)`` order, ``weight`` in torch's OIHW.  A
    ``weight`` of fewer rows than ``out_channels`` is this rank's slice
    under the ``model`` mesh axis: the matmul makes its own output
    columns, assembled over the ``model`` group with the bias
    (``sharding.assemble_columns``)."""
    b, c, h, w = x.shape
    xp = F.pad(x, (1, 1, 1, 1))
    cols = torch.stack([xp[:, :, dy:dy + h, dx:dx + w]
                        for dy in range(3) for dx in range(3)], dim=1)
    patches = cols.permute(0, 3, 4, 1, 2).reshape(b * h * w, 9 * c)
    out = patches @ weight.permute(2, 3, 1, 0).reshape(9 * c, -1)
    if out_channels is not None and weight.shape[0] != out_channels:
        out = assemble_columns(out, out_channels, -1, bias)
    else:
        out = out + bias
    return out.reshape(b, h, w, -1).permute(0, 3, 1, 2)


def reshape_max_pool2(x: torch.Tensor) -> torch.Tensor:
    """2x2 stride-2 max pool of an NCHW batch as a reshape and ``amax``."""
    b, c, h, w = x.shape
    return x.reshape(b, c, h // 2, 2, w // 2, 2).amax(dim=(3, 5))


class CNNUSPS(nn.Module):
    def __init__(self, num_classes: int = 10, conv_impl: str = "lax",
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        if conv_impl not in ("lax", "gemm"):
            raise ValueError(f"conv_impl must be 'lax' or 'gemm', got {conv_impl!r}")
        self.conv_impl = conv_impl
        self.dtype = dtype
        # the gemm convs' parameters in the compute dtype (JAX GemmConv3x3)
        held = dtype if conv_impl == "gemm" else None
        self.conv1 = Conv2d(1, 8, 3, padding=1, compute_dtype=dtype, dtype=held)
        self.conv2 = Conv2d(8, 16, 3, padding=1, compute_dtype=dtype, dtype=held)
        self.conv3 = Conv2d(16, 32, 3, padding=1, compute_dtype=dtype, dtype=held)
        self.fc1 = Linear(2 * 2 * 32, 64, compute_dtype=dtype)
        self.fc2 = Linear(64, num_classes, compute_dtype=dtype)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        reset_torch_default(self, generator)

    def forward(self, x: torch.Tensor, train: bool = False,
                stats_out: Optional[dict] = None) -> torch.Tensor:
        x = x.reshape(-1, 16, 16, 1).permute(0, 3, 1, 2)
        x = x.to(self.dtype or self.fc1.weight.dtype).contiguous()
        for conv in (self.conv1, self.conv2, self.conv3):
            if self.conv_impl == "gemm":
                x = reshape_max_pool2(relu(gemm_conv3x3_same(
                    *cast(self.dtype, x, conv.weight, conv.bias), conv.out_channels)))
            else:
                x = F.max_pool2d(relu(conv(x)), 2)
        x = relu(self.fc1(x.flatten(1)))  # (B, 32*2*2) in CHW order
        return self.fc2(x)
