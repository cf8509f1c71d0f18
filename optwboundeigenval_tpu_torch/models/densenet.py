"""DenseNet-BC for CIFAR (counterpart of ``optwboundeigenval_tpu/models/densenet.py``).

Reference ``DenseNet3`` (densenet.py:70-121): bottleneck dense blocks
(BN-ReLU-1x1 conv-BN-ReLU-3x3 conv, 4x intermediate width), transition
blocks with 0.5 compression and 2x2 average pooling, three dense blocks,
global 8x8 average pool, linear classifier.  Parameter and buffer names
are the reference's (``block{b}.layer.{i}.bn1``, ``trans{t}``, ``bn1``,
``fc``), so ``utils/interop.py`` and the JAX package's
``torch_interop.convert_densenet3_state_dict`` map them.

The public input is NHWC ``(B, 32, 32, 3)``, as in the JAX batch; it is
permuted to NCHW once.  ``forward(x, train, stats_out)`` takes the mode
explicitly (``Task`` calls it through ``torch.func.functional_call``);
BatchNorm is ``models/norm.BatchNorm2d``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from optwboundeigenval_tpu_torch.models.activations import relu
from optwboundeigenval_tpu_torch.models.norm import BatchNorm2d


class BottleneckBlock(nn.Module):
    def __init__(self, in_planes: int, out_planes: int):
        super().__init__()
        inter = out_planes * 4
        self.bn1 = BatchNorm2d(in_planes)
        self.conv1 = nn.Conv2d(in_planes, inter, 1, bias=False)
        self.bn2 = BatchNorm2d(inter)
        self.conv2 = nn.Conv2d(inter, out_planes, 3, padding=1, bias=False)

    def forward(self, x, train=False, stats_out=None):
        out = self.conv1(relu(self.bn1(x, train, stats_out)))
        out = self.conv2(relu(self.bn2(out, train, stats_out)))
        return torch.cat([x, out], dim=1)


class TransitionBlock(nn.Module):
    def __init__(self, in_planes: int, out_planes: int):
        super().__init__()
        self.bn1 = BatchNorm2d(in_planes)
        self.conv1 = nn.Conv2d(in_planes, out_planes, 1, bias=False)

    def forward(self, x, train=False, stats_out=None):
        out = self.conv1(relu(self.bn1(x, train, stats_out)))
        return F.avg_pool2d(out, 2)


class DenseBlock(nn.Module):
    def __init__(self, nb_layers: int, in_planes: int, growth_rate: int):
        super().__init__()
        self.layer = nn.ModuleList(
            BottleneckBlock(in_planes + i * growth_rate, growth_rate)
            for i in range(nb_layers)
        )

    def forward(self, x, train=False, stats_out=None):
        for layer in self.layer:
            x = layer(x, train, stats_out)
        return x


class DenseNet3(nn.Module):
    """DenseNet-BC; depth 40, growth 12 is the reference's CIFAR model
    (params/cifar10_DenseNet_*.py)."""

    def __init__(self, depth: int = 40, num_classes: int = 10,
                 growth_rate: int = 12, reduction: float = 0.5,
                 bottleneck: bool = True, drop_rate: float = 0.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if not bottleneck:
            raise NotImplementedError("DenseNet3(bottleneck=False) is not ported")
        if drop_rate > 0:
            raise NotImplementedError("DenseNet3(drop_rate > 0) is not ported")
        in_planes = 2 * growth_rate
        n = int((depth - 4) / 3 / 2)
        self.conv1 = nn.Conv2d(3, in_planes, 3, padding=1, bias=False)
        for b in range(1, 4):
            setattr(self, f"block{b}", DenseBlock(n, in_planes, growth_rate))
            in_planes = int(in_planes + n * growth_rate)
            if b < 3:
                out_planes = int(math.floor(in_planes * reduction))
                setattr(self, f"trans{b}", TransitionBlock(in_planes, out_planes))
                in_planes = out_planes
        self.bn1 = BatchNorm2d(in_planes)
        self.fc = nn.Linear(in_planes, num_classes)
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
        # NHWC -> NCHW once; compute in the parameters' dtype, as the JAX
        # model casts its input to its compute dtype
        x = x.permute(0, 3, 1, 2).to(self.conv1.weight.dtype).contiguous()
        out = self.conv1(x)
        out = self.trans1(self.block1(out, train, stats_out), train, stats_out)
        out = self.trans2(self.block2(out, train, stats_out), train, stats_out)
        out = self.block3(out, train, stats_out)
        out = relu(self.bn1(out, train, stats_out))
        out = F.avg_pool2d(out, 8).flatten(1)
        return self.fc(out)
