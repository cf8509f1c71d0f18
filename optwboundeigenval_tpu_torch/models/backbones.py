"""ImageNet-style feature trunks of the chest x-ray models (counterpart of
``optwboundeigenval_tpu/models/backbones.py``): torchvision's AlexNet,
VGG16-BN, ResNet50 and DenseNet-121/161/169/201 ``features``.

Each trunk maps an NCHW batch to an NCHW feature map, takes
``forward(x, train, stats_out)`` as every model of the port does, and
names its submodules as torchvision does (``conv0``, ``norm0``,
``denseblock1.denselayer1.norm1``, ``transition1.conv``, ``layer1.0.bn3``,
``downsample.0``, the ``features`` indices of AlexNet and VGG), so a
torchvision state dict's keys under ``features.`` are this module's.
BatchNorm is ``models/norm.BatchNorm2d`` (explicit ops, exact at every
order of autodiff).

Padding as the JAX package's flax modules have it: a 3x3 stride-1
``"SAME"`` conv is pad 1 and a 1x1 ``"SAME"`` conv (the stride-2 ResNet
projection too) pad 0; a max pool with padding pads with -inf (as
``F.max_pool2d`` does); AlexNet's and VGG's pools and DenseNet's
transition average pools are VALID; the stride-2 3x3 conv of a ResNet
bottleneck pads 1 on every side (JAX backbones.py:81-85); the last
BatchNorm of a bottleneck starts at scale 0 (backbones.py:89-90).

Initialisation (``reset_parameters(generator)``): convs and dense layers
normal with variance ``1 / fan_in`` (flax's LeCun normal, untruncated),
biases 0, BatchNorm scale 1 and bias 0.  Weights are drawn from the
generator, so two trunks built from one seed are equal; tests carry the
JAX package's weights over through ``utils/interop.py``.

``dtype`` (every trunk and block) is the JAX modules' compute dtype: the
convs compute in it (``models/layers.py``), BatchNorm reduces in float32
and returns in it; ``None`` computes in the parameters' dtype.  The trunk
takes its input as it comes: the first conv casts it, as ``nn.Conv``
does.

``load_pretrained_npz`` overlays converted ImageNet weights from a local
``.npz`` in the layout ``scripts/convert_torch_weights.py`` writes.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from optwboundeigenval_tpu_torch.models.activations import relu
from optwboundeigenval_tpu_torch.models.layers import Conv2d
from optwboundeigenval_tpu_torch.models.norm import BatchNorm2d


@torch.no_grad()
def lecun_init(model: nn.Module, generator: Optional[torch.Generator] = None) -> None:
    """Convs and dense layers ``N(0, 1 / fan_in)`` with zero bias, BatchNorm
    at scale 1 and bias 0 with fresh running statistics, then every
    bottleneck's last BatchNorm at scale 0."""
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            fan_in = m.weight[0].numel()
            m.weight.normal_(0.0, 1.0 / math.sqrt(fan_in), generator=generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, BatchNorm2d):
            m.reset_parameters()
    for m in model.modules():
        if isinstance(m, Bottleneck):
            m.bn3.weight.zero_()


def _conv(cin, cout, k, stride=1, padding=0, bias=True, dtype=None):
    return Conv2d(cin, cout, k, stride=stride, padding=padding, bias=bias,
                  compute_dtype=dtype)


class AlexNetFeatures(nn.Module):
    """torchvision ``alexnet.features``: 5 convs (ReLU after each) and 3
    VALID 3x3 stride-2 max pools, 256 channels out; convs at the indices
    0, 3, 6, 8, 10 of torchvision's Sequential."""

    out_channels = 256
    _LAYERS = ((0, 3, 64, 11, 4, 2), (3, 64, 192, 5, 1, 2), (6, 192, 384, 3, 1, 1),
               (8, 384, 256, 3, 1, 1), (10, 256, 256, 3, 1, 1))
    _POOL_AFTER = (0, 3, 10)

    def __init__(self, dtype: Optional[torch.dtype] = None):
        super().__init__()
        for idx, cin, cout, k, s, p in self._LAYERS:
            self.add_module(str(idx), _conv(cin, cout, k, s, p, dtype=dtype))
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        lecun_init(self, generator)

    def forward(self, x, train=False, stats_out=None):
        for idx, *_ in self._LAYERS:
            x = relu(getattr(self, str(idx))(x))
            if idx in self._POOL_AFTER:
                x = F.max_pool2d(x, 3, 2)
        return x


VGG16_CFG = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
             512, 512, 512, "M", 512, 512, 512, "M")


class VGG16BNFeatures(nn.Module):
    """torchvision ``vgg16_bn.features`` for ``cfg`` (channels, ``"M"`` a
    VALID 2x2 stride-2 max pool): conv 3x3 pad 1 with bias, BatchNorm,
    ReLU; the conv of each triple at torchvision's Sequential index, its
    BatchNorm at the next."""

    def __init__(self, cfg: Sequence = VGG16_CFG, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.cfg = tuple(cfg)
        self._plan = []  # (conv index, or None for a pool)
        idx, cin = 0, 3
        for v in self.cfg:
            if v == "M":
                self._plan.append(None)
                idx += 1
            else:
                self.add_module(str(idx), _conv(cin, v, 3, padding=1, dtype=dtype))
                self.add_module(str(idx + 1), BatchNorm2d(v, dtype=dtype))
                self._plan.append(idx)
                idx, cin = idx + 3, v
        self.out_channels = cin
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        lecun_init(self, generator)

    def forward(self, x, train=False, stats_out=None):
        for idx in self._plan:
            if idx is None:
                x = F.max_pool2d(x, 2, 2)
            else:
                x = getattr(self, str(idx))(x)
                x = relu(getattr(self, str(idx + 1))(x, train, stats_out))
        return x


class Bottleneck(nn.Module):
    """torchvision's ResNet bottleneck: 1x1, 3x3 (stride here, pad 1), 1x1
    to ``4 * width``, a 1x1 projection where the shape changes."""

    def __init__(self, cin: int, width: int, stride: int = 1,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.conv1 = _conv(cin, width, 1, bias=False, dtype=dtype)
        self.bn1 = BatchNorm2d(width, dtype=dtype)
        self.conv2 = _conv(width, width, 3, stride, 1, bias=False, dtype=dtype)
        self.bn2 = BatchNorm2d(width, dtype=dtype)
        self.conv3 = _conv(width, 4 * width, 1, bias=False, dtype=dtype)
        self.bn3 = BatchNorm2d(4 * width, dtype=dtype)
        if cin != 4 * width or stride != 1:
            self.downsample = nn.ModuleList([
                _conv(cin, 4 * width, 1, stride, bias=False, dtype=dtype),
                BatchNorm2d(4 * width, dtype=dtype)])
        else:
            self.downsample = None

    def forward(self, x, train=False, stats_out=None):
        y = relu(self.bn1(self.conv1(x), train, stats_out))
        y = relu(self.bn2(self.conv2(y), train, stats_out))
        y = self.bn3(self.conv3(y), train, stats_out)
        if self.downsample is not None:
            conv, bn = self.downsample
            x = bn(conv(x), train, stats_out)
        return relu(x + y)


class ResNet50Features(nn.Module):
    """torchvision ``resnet50`` without its pool and classifier: stem conv
    7x7 stride 2 pad 3, BatchNorm, ReLU, max pool 3 stride 2 pad 1, then
    ``stage_sizes`` bottlenecks per stage (``layer1`` ... ``layer4``),
    ``2048`` channels out for 4 stages."""

    def __init__(self, stage_sizes: Sequence[int] = (3, 4, 6, 3),
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.stage_sizes = tuple(stage_sizes)
        self.conv1 = _conv(3, 64, 7, 2, 3, bias=False, dtype=dtype)
        self.bn1 = BatchNorm2d(64, dtype=dtype)
        cin = 64
        for i, n in enumerate(self.stage_sizes):
            blocks = []
            for b in range(n):
                blocks.append(Bottleneck(cin, 64 * 2 ** i, 2 if (i > 0 and b == 0) else 1,
                                         dtype))
                cin = 4 * 64 * 2 ** i
            self.add_module(f"layer{i + 1}", nn.ModuleList(blocks))
        self.out_channels = cin
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        lecun_init(self, generator)

    def forward(self, x, train=False, stats_out=None):
        x = relu(self.bn1(self.conv1(x), train, stats_out))
        x = F.max_pool2d(x, 3, 2, 1)
        for i in range(len(self.stage_sizes)):
            for block in getattr(self, f"layer{i + 1}"):
                x = block(x, train, stats_out)
        return x


class DenseLayer(nn.Module):
    def __init__(self, cin: int, growth_rate: int, bn_size: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.norm1 = BatchNorm2d(cin, dtype=dtype)
        self.conv1 = _conv(cin, bn_size * growth_rate, 1, bias=False, dtype=dtype)
        self.norm2 = BatchNorm2d(bn_size * growth_rate, dtype=dtype)
        self.conv2 = _conv(bn_size * growth_rate, growth_rate, 3, padding=1, bias=False,
                           dtype=dtype)

    def forward(self, x, train=False, stats_out=None):
        y = self.conv1(relu(self.norm1(x, train, stats_out)))
        y = self.conv2(relu(self.norm2(y, train, stats_out)))
        return torch.cat([x, y], dim=1)


class Transition(nn.Module):
    def __init__(self, cin: int, cout: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.norm = BatchNorm2d(cin, dtype=dtype)
        self.conv = _conv(cin, cout, 1, bias=False, dtype=dtype)

    def forward(self, x, train=False, stats_out=None):
        return F.avg_pool2d(self.conv(relu(self.norm(x, train, stats_out))), 2)


class DenseNetFeatures(nn.Module):
    """torchvision's DenseNet ``features`` (densenet121 by default: blocks
    (6, 12, 24, 16), growth 32, 64 initial features, 1,024 out), ending in
    ``norm5`` and a ReLU."""

    def __init__(self, block_config: Sequence[int] = (6, 12, 24, 16),
                 growth_rate: int = 32, num_init_features: int = 64, bn_size: int = 4,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.block_config = tuple(block_config)
        self.conv0 = _conv(3, num_init_features, 7, 2, 3, bias=False, dtype=dtype)
        self.norm0 = BatchNorm2d(num_init_features, dtype=dtype)
        c = num_init_features
        for i, n in enumerate(self.block_config):
            block = nn.Module()
            for j in range(n):
                block.add_module(f"denselayer{j + 1}", DenseLayer(c + j * growth_rate,
                                                                  growth_rate, bn_size, dtype))
            self.add_module(f"denseblock{i + 1}", block)
            c += n * growth_rate
            if i < len(self.block_config) - 1:
                self.add_module(f"transition{i + 1}", Transition(c, c // 2, dtype))
                c //= 2
        self.norm5 = BatchNorm2d(c, dtype=dtype)
        self.out_channels = c
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        lecun_init(self, generator)

    def forward(self, x, train=False, stats_out=None):
        x = relu(self.norm0(self.conv0(x), train, stats_out))
        x = F.max_pool2d(x, 3, 2, 1)
        for i in range(len(self.block_config)):
            for layer in getattr(self, f"denseblock{i + 1}").children():
                x = layer(x, train, stats_out)
            if i < len(self.block_config) - 1:
                x = getattr(self, f"transition{i + 1}")(x, train, stats_out)
        return relu(self.norm5(x, train, stats_out))


def densenet121_features(dtype: Optional[torch.dtype] = None):
    return DenseNetFeatures((6, 12, 24, 16), 32, 64, dtype=dtype)  # 1,024 out


def densenet161_features(dtype: Optional[torch.dtype] = None):
    return DenseNetFeatures((6, 12, 36, 24), 48, 96, dtype=dtype)  # 2,208 out


def densenet169_features(dtype: Optional[torch.dtype] = None):
    return DenseNetFeatures((6, 12, 32, 32), 32, 64, dtype=dtype)  # 1,664 out


def densenet201_features(dtype: Optional[torch.dtype] = None):
    return DenseNetFeatures((6, 12, 48, 32), 32, 64, dtype=dtype)  # 1,920 out


def load_pretrained_npz(model: nn.Module, params, model_state, path: str,
                        prefix: Optional[str] = None):
    """Overlay converted pretrained weights from the local ``.npz`` at
    ``path`` on ``(params, model_state)`` of ``model``; returns the new
    pair (JAX backbones.py:185-220).

    The npz holds '/'-joined flax paths, bare (``Conv_0/kernel``) or
    namespaced (``params/Conv_0/kernel``, ``batch_stats/BatchNorm_0/mean``),
    as ``scripts/convert_torch_weights.py`` writes them.  The port's state
    goes to the JAX package's flax tree through ``utils/interop.py``, each
    leaf takes the first of the JAX package's candidate keys that is in
    the npz with the leaf's shape (``prefix`` names the submodule the
    trunk lives under, e.g. ``"features"`` in ``CXRModel``, and the
    candidates include the key without it), and the tree comes back.  A
    leaf with no such key keeps its value; a loaded one takes the leaf's
    dtype."""
    from optwboundeigenval_tpu_torch.utils import interop

    loaded = dict(np.load(path))
    fparams, fstats = interop.to_jax(model, params, model_state)
    flat = {}
    for coll, tree in (("params", fparams), ("batch_stats", fstats)):
        flat.update({f"{coll}/{k}": v for k, v in interop.flatten(tree).items()})
    for k in list(flat):
        candidates = [k, k.removeprefix("params/"), "params/" + k]
        if prefix:
            for cand in list(candidates):
                parts = cand.split("/")
                if prefix in parts:
                    parts.remove(prefix)
                    candidates.append("/".join(parts))
        for key in candidates:
            if key in loaded and loaded[key].shape == flat[k].shape:
                flat[k] = loaded[key].astype(flat[k].dtype)
                break
    trees = {"params": {}, "batch_stats": {}}
    for k, v in flat.items():
        coll, rest = k.split("/", 1)
        trees[coll][rest] = v
    new_p, new_s = interop.from_jax(model, interop.unflatten(trees["params"]),
                                    interop.unflatten(trees["batch_stats"]))
    return ({k: new_p[k].to(t.device, t.dtype) for k, t in params.items()},
            {k: new_s[k].to(t.device, t.dtype) if k in new_s else t
             for k, t in model_state.items()})
