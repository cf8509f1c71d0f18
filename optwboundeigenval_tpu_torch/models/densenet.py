"""DenseNet for CIFAR (counterpart of ``optwboundeigenval_tpu/models/densenet.py``).

Reference ``DenseNet3`` (densenet.py:70-121): dense blocks of bottleneck
layers (BN-ReLU-1x1 conv-BN-ReLU-3x3 conv, 4x intermediate width) or,
with ``bottleneck=False``, of basic layers (BN-ReLU-3x3 conv), transition
blocks with ``reduction`` compression and 2x2 average pooling, three
dense blocks, global 8x8 average pool, linear classifier.  With
``drop_rate > 0`` a dropout layer (``models/dropout.py``) follows every
conv of a dense layer and the transition's conv, before its pool, at the
JAX package's sites.  Parameter and buffer names are the reference's
(``block{b}.layer.{i}.bn1``, ``trans{t}``, ``bn1``, ``fc``), so
``utils/interop.py`` and the JAX package's
``torch_interop.convert_densenet3_state_dict`` map them.

The public input is NHWC ``(B, 32, 32, 3)``, as in the JAX batch; it is
permuted to NCHW once.  ``forward(x, train, stats_out)`` takes the mode
explicitly (``Task`` calls it through ``torch.func.functional_call``);
BatchNorm is ``models/norm.BatchNorm2d``.

``dtype`` is the JAX model's compute dtype: the input is cast to it, the
convs and the classifier compute in it (``models/layers.py``) and
BatchNorm reduces in float32 and returns in it, over parameters that keep
their own dtype (``DenseNet3(dtype=torch.bfloat16)`` computes in bfloat16
over float32 parameters and statistics).  ``None``, the default, computes
in the parameters' dtype (flax's default is float32).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from optwboundeigenval_tpu_torch.models.activations import relu
from optwboundeigenval_tpu_torch.models.dropout import Dropout, name_sites
from optwboundeigenval_tpu_torch.models.layers import Conv2d, Linear
from optwboundeigenval_tpu_torch.models.norm import BatchNorm2d


class BottleneckBlock(nn.Module):
    def __init__(self, in_planes: int, out_planes: int, drop_rate: float = 0.0,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        inter = out_planes * 4
        self.bn1 = BatchNorm2d(in_planes, dtype=dtype)
        self.conv1 = Conv2d(in_planes, inter, 1, bias=False, compute_dtype=dtype)
        self.drop1 = Dropout(drop_rate)
        self.bn2 = BatchNorm2d(inter, dtype=dtype)
        self.conv2 = Conv2d(inter, out_planes, 3, padding=1, bias=False, compute_dtype=dtype)
        self.drop2 = Dropout(drop_rate)

    def forward(self, x, train=False, stats_out=None):
        out = self.drop1(self.conv1(relu(self.bn1(x, train, stats_out))), train)
        out = self.drop2(self.conv2(relu(self.bn2(out, train, stats_out))), train)
        return torch.cat([x, out], dim=1)


class BasicBlock(nn.Module):
    """BN, ReLU, 3x3 conv (JAX densenet.py:62-77)."""

    def __init__(self, in_planes: int, out_planes: int, drop_rate: float = 0.0,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.bn1 = BatchNorm2d(in_planes, dtype=dtype)
        self.conv1 = Conv2d(in_planes, out_planes, 3, padding=1, bias=False,
                            compute_dtype=dtype)
        self.drop = Dropout(drop_rate)

    def forward(self, x, train=False, stats_out=None):
        out = self.drop(self.conv1(relu(self.bn1(x, train, stats_out))), train)
        return torch.cat([x, out], dim=1)


class TransitionBlock(nn.Module):
    def __init__(self, in_planes: int, out_planes: int, drop_rate: float = 0.0,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.bn1 = BatchNorm2d(in_planes, dtype=dtype)
        self.conv1 = Conv2d(in_planes, out_planes, 1, bias=False, compute_dtype=dtype)
        self.drop = Dropout(drop_rate)

    def forward(self, x, train=False, stats_out=None):
        out = self.drop(self.conv1(relu(self.bn1(x, train, stats_out))), train)
        return F.avg_pool2d(out, 2)


class DenseBlock(nn.Module):
    def __init__(self, nb_layers: int, in_planes: int, growth_rate: int,
                 block=BottleneckBlock, drop_rate: float = 0.0,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.layer = nn.ModuleList(
            block(in_planes + i * growth_rate, growth_rate, drop_rate, dtype)
            for i in range(nb_layers)
        )

    def forward(self, x, train=False, stats_out=None):
        for layer in self.layer:
            x = layer(x, train, stats_out)
        return x


class DenseNet3(nn.Module):
    """DenseNet-BC by default; depth 40, growth 12 is the reference's CIFAR
    model (params/cifar10_DenseNet_*.py).  ``bottleneck=False,
    reduction=1.0, drop_rate=0.2`` is the original DenseNet of Huang et al.
    (2017, Table 2, C10 without augmentation)."""

    def __init__(self, depth: int = 40, num_classes: int = 10,
                 growth_rate: int = 12, reduction: float = 0.5,
                 bottleneck: bool = True, drop_rate: float = 0.0,
                 generator: Optional[torch.Generator] = None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.bottleneck = bottleneck
        self.dtype = dtype
        in_planes = 2 * growth_rate
        n = (depth - 4) / 3
        if bottleneck:
            n = n / 2
        n = int(n)
        block = BottleneckBlock if bottleneck else BasicBlock
        self.conv1 = Conv2d(3, in_planes, 3, padding=1, bias=False, compute_dtype=dtype)
        for b in range(1, 4):
            setattr(self, f"block{b}", DenseBlock(n, in_planes, growth_rate, block, drop_rate,
                                                  dtype))
            in_planes = int(in_planes + n * growth_rate)
            if b < 3:
                out_planes = int(math.floor(in_planes * reduction))
                setattr(self, f"trans{b}", TransitionBlock(in_planes, out_planes, drop_rate,
                                                           dtype))
                in_planes = out_planes
        self.bn1 = BatchNorm2d(in_planes, dtype=dtype)
        self.fc = Linear(in_planes, num_classes, compute_dtype=dtype)
        name_sites(self)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """Reference init (densenet.py:104-113): He-normal convs with
        fan-out ``k*k*out``, BN weight 1 / bias 0, zero classifier bias
        (the classifier weight keeps ``nn.Linear``'s uniform bound)."""
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                k = m.kernel_size[0] * m.kernel_size[1] * m.out_channels
                m.weight.normal_(0.0, math.sqrt(2.0 / k), generator=generator)
            elif isinstance(m, BatchNorm2d):
                m.reset_parameters()
            elif isinstance(m, nn.Linear):
                bound = 1.0 / math.sqrt(m.in_features)
                m.weight.uniform_(-bound, bound, generator=generator)
                m.bias.zero_()

    def forward(self, x: torch.Tensor, train: bool = False,
                stats_out: Optional[dict] = None) -> torch.Tensor:
        # NHWC -> NCHW once, in the compute dtype (else the parameters'), as
        # the JAX model casts its input to its compute dtype
        x = x.permute(0, 3, 1, 2).to(self.dtype or self.conv1.weight.dtype).contiguous()
        out = self.conv1(x)
        out = self.trans1(self.block1(out, train, stats_out), train, stats_out)
        out = self.trans2(self.block2(out, train, stats_out), train, stats_out)
        out = self.block3(out, train, stats_out)
        out = relu(self.bn1(out, train, stats_out))
        out = F.avg_pool2d(out, 8).flatten(1)
        return self.fc(out)
