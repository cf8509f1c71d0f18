"""Chest x-ray classifiers (counterpart of ``optwboundeigenval_tpu/models/cxr.py``).

* :class:`CXRModel`: a trunk of ``models/backbones.py`` (``features``)
  and :class:`TransitHead` (``head``): a 3x3 conv with bias to 1,024
  channels, BatchNorm, ReLU, a 2x2 stride-2 max pool padded by 1 (with
  -inf), the global max over the map, and ``Linear(1024, outnum)``
  (the reference's ``MyDensNet121`` and its kin, dcnn.py:203-329);
* :class:`DenseNet121Sigmoid`: the DenseNet-121 trunk, the global mean,
  ``Linear(1024, class_count)`` and a sigmoid inside the model
  (dcnn.py:255-265).

The global max is ``torch.amax``, which shares the gradient evenly
between tied maxima as ``jnp.max`` does (``max(dim)`` would route it to
one index).  Inputs are NHWC, as the JAX batch is (224 x 224 x 3 for
the published recipe), permuted to NCHW once and cast to the compute
``dtype`` (the JAX models' ``dtype``: every conv, dense layer and
BatchNorm of trunk and head computes in it, ``models/layers.py``), or to
the parameters' dtype under ``dtype=None``, the default.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from optwboundeigenval_tpu_torch.models import backbones
from optwboundeigenval_tpu_torch.models.activations import relu
from optwboundeigenval_tpu_torch.models.layers import Conv2d, Linear
from optwboundeigenval_tpu_torch.models.norm import BatchNorm2d

BACKBONES = {
    "alexnet": backbones.AlexNetFeatures,
    "vgg16_bn": backbones.VGG16BNFeatures,
    "resnet50": backbones.ResNet50Features,
    "densenet121": backbones.densenet121_features,
    "densenet161": backbones.densenet161_features,
    "densenet201": backbones.densenet201_features,
}


def _nchw(x: torch.Tensor, classifier: Linear) -> torch.Tensor:
    """NHWC to NCHW in the classifier's compute dtype, else its weight's."""
    return x.permute(0, 3, 1, 2).to(classifier.compute_dtype or classifier.weight.dtype
                                    ).contiguous()


class TransitHead(nn.Module):
    """transit conv + BN + ReLU + max pool (2, stride 2, pad 1), global max,
    then the ``1024 -> outnum`` classifier (dcnn.py:206-217)."""

    def __init__(self, in_channels: int, outnum: int = 14,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.transit_conv = Conv2d(in_channels, 1024, 3, padding=1, compute_dtype=dtype)
        self.transit_bn = BatchNorm2d(1024, dtype=dtype)
        self.classifier = Linear(1024, outnum, compute_dtype=dtype)

    def forward(self, x, train=False, stats_out=None):
        x = relu(self.transit_bn(self.transit_conv(x), train, stats_out))
        x = F.max_pool2d(x, 2, 2, 1)
        return self.classifier(torch.amax(x, dim=(2, 3)))


class CXRModel(nn.Module):
    """``backbone`` features -> :class:`TransitHead`; logits out."""

    def __init__(self, backbone: str = "densenet121", outnum: int = 14,
                 generator: Optional[torch.Generator] = None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.backbone = backbone
        self.features = BACKBONES[backbone](dtype=dtype)
        self.head = TransitHead(self.features.out_channels, outnum, dtype)
        self.reset_parameters(generator)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        backbones.lecun_init(self, generator)

    def forward(self, x, train=False, stats_out=None):
        x = _nchw(x, self.head.classifier)
        return self.head(self.features(x, train, stats_out), train, stats_out)


class DenseNet121Sigmoid(nn.Module):
    """The reference's ``DenseNet121``: probabilities out, so its configs
    evaluate without ``'sigmoid'`` in ``test_func``."""

    def __init__(self, class_count: int = 14,
                 generator: Optional[torch.Generator] = None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.features = backbones.densenet121_features(dtype)
        self.classifier = Linear(self.features.out_channels, class_count,
                                 compute_dtype=dtype)
        self.reset_parameters(generator)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        backbones.lecun_init(self, generator)

    def forward(self, x, train=False, stats_out=None):
        x = self.features(_nchw(x, self.classifier), train, stats_out)
        return torch.sigmoid(self.classifier(x.mean(dim=(2, 3))))
