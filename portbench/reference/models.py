"""The two architectures of the benchmark, in plain PyTorch, over a dict
of parameters named as the program names them.

* ``densenet_bc``: DenseNet-BC of Huang et al. (2017) for 32 px inputs:
  a 3x3 stem conv to ``2 * growth`` channels, three dense blocks of
  bottleneck layers (BN, ReLU, 1x1 conv to ``4 * growth``, BN, ReLU, 3x3
  conv to ``growth``, concatenated), transitions (BN, ReLU, 1x1 conv to
  ``reduction`` of the channels, 2x2 average pool), a last BN and ReLU,
  the global mean and a linear classifier.
* ``cxr_densenet``: torchvision's DenseNet-121 trunk (7x7 stride-2 stem,
  3x3 stride-2 max pool, blocks (6, 12, 24, 16) of growth 32, halving
  transitions, ``norm5`` and ReLU) under the chest x-ray head of
  Rajpurkar et al.'s recipe as the program has it: a 3x3 conv with bias
  to ``head_width`` channels, BN, ReLU, a 2x2 stride-2 max pool padded
  by 1, the global max and a linear classifier.

Inputs are NHWC batches, permuted to NCHW once.  BatchNorm is written
out: in train mode the batch mean and the biased variance of the
deviations (two passes), ``eps`` 1e-5; ``stats_out`` collects each
BatchNorm's mean and unbiased variance under its running buffers' names.
In eval mode the running statistics normalise.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

Tree = Dict[str, torch.Tensor]
BN_EPS = 1e-5

# a leaf: (name, shape, init) with init ("normal", std), ("uniform", bound),
# ("ones",) or ("zeros",)
Leaf = Tuple[str, Tuple[int, ...], tuple]


def _bn_leaves(name: str, c: int) -> List[Leaf]:
    return [(f"{name}.weight", (c,), ("ones",)), (f"{name}.bias", (c,), ("zeros",))]


def _conv_leaf(name: str, cout: int, cin: int, k: int, init: str) -> Leaf:
    if init == "lecun":
        std = 1.0 / math.sqrt(cin * k * k)
    else:  # He normal over the fan-out
        std = math.sqrt(2.0 / (k * k * cout))
    return (f"{name}.weight", (cout, cin, k, k), ("normal", std))


class Model:
    """``leaves()``: the parameters; ``buffers()``: the running
    statistics; ``forward(params, state, x, train, stats_out)``."""

    def __init__(self, arch: dict):
        self.arch = dict(arch)
        self._leaves: List[Leaf] = []
        self._bns: List[Tuple[str, int]] = []
        kind = arch["kind"]
        if kind == "densenet_bc":
            self._plan = self._plan_densenet_bc()
        elif kind == "cxr_densenet":
            self._plan = self._plan_cxr()
        else:
            raise ValueError(f"unknown architecture {kind!r}")

    # -- structure ----------------------------------------------------
    def _conv(self, name, cout, cin, k, init):
        self._leaves.append(_conv_leaf(name, cout, cin, k, init))

    def _bn(self, name, c):
        self._leaves.extend(_bn_leaves(name, c))
        self._bns.append((name, c))

    def _plan_densenet_bc(self):
        a = self.arch
        growth, depth = a["growth_rate"], a["depth"]
        n = (depth - 4) // 6
        c = 2 * growth
        self._conv("conv1", c, 3, 3, "he")
        blocks = []
        for b in range(1, 4):
            layers = []
            for i in range(n):
                p = f"block{b}.layer.{i}"
                self._bn(f"{p}.bn1", c)
                self._conv(f"{p}.conv1", 4 * growth, c, 1, "he")
                self._bn(f"{p}.bn2", 4 * growth)
                self._conv(f"{p}.conv2", growth, 4 * growth, 3, "he")
                layers.append(p)
                c += growth
            trans = None
            if b < 3:
                trans = f"trans{b}"
                out = int(math.floor(c * a["reduction"]))
                self._bn(f"{trans}.bn1", c)
                self._conv(f"{trans}.conv1", out, c, 1, "he")
                c = out
            blocks.append((layers, trans))
        self._bn("bn1", c)
        bound = 1.0 / math.sqrt(c)
        self._leaves += [("fc.weight", (a["num_classes"], c), ("uniform", bound)),
                         ("fc.bias", (a["num_classes"],), ("zeros",))]
        return blocks

    def _plan_cxr(self):
        a = self.arch
        growth, bn_size = a["growth_rate"], a["bn_size"]
        c = a["num_init_features"]
        self._conv("features.conv0", c, 3, 7, "lecun")
        self._bn("features.norm0", c)
        blocks = []
        for i, n in enumerate(a["block_config"]):
            layers = []
            for j in range(n):
                p = f"features.denseblock{i + 1}.denselayer{j + 1}"
                self._bn(f"{p}.norm1", c)
                self._conv(f"{p}.conv1", bn_size * growth, c, 1, "lecun")
                self._bn(f"{p}.norm2", bn_size * growth)
                self._conv(f"{p}.conv2", growth, bn_size * growth, 3, "lecun")
                layers.append(p)
                c += growth
            trans = None
            if i < len(a["block_config"]) - 1:
                trans = f"features.transition{i + 1}"
                self._bn(f"{trans}.norm", c)
                self._conv(f"{trans}.conv", c // 2, c, 1, "lecun")
                c //= 2
            blocks.append((layers, trans))
        self._bn("features.norm5", c)
        w = a["head_width"]
        self._conv("head.transit_conv", w, c, 3, "lecun")
        self._leaves.append(("head.transit_conv.bias", (w,), ("zeros",)))
        self._bn("head.transit_bn", w)
        self._leaves += [("head.classifier.weight", (a["outnum"], w),
                          ("normal", 1.0 / math.sqrt(w))),
                         ("head.classifier.bias", (a["outnum"],), ("zeros",))]
        return blocks

    def leaves(self) -> List[Leaf]:
        return list(self._leaves)

    def buffers(self) -> List[Tuple[str, Tuple[int, ...], tuple]]:
        out = []
        for name, c in self._bns:
            out += [(f"{name}.running_mean", (c,), ("zeros",)),
                    (f"{name}.running_var", (c,), ("ones",))]
        return out

    # -- forward ------------------------------------------------------
    def forward(self, params: Tree, state: Tree, x: torch.Tensor, train: bool,
                stats_out: Optional[Tree] = None) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2).contiguous()

        def bn(name, t):
            if train:
                mean = t.mean((0, 2, 3))
                y = t - mean[None, :, None, None]
                var = (y * y).mean((0, 2, 3))
                if stats_out is not None:
                    n = t.numel() // t.shape[1]
                    stats_out[f"{name}.running_mean"] = mean.detach()
                    stats_out[f"{name}.running_var"] = var.detach() * (n / max(n - 1.0, 1.0))
            else:
                var = state[f"{name}.running_var"]
                y = t - state[f"{name}.running_mean"][None, :, None, None]
            scale = torch.rsqrt(var + BN_EPS) * params[f"{name}.weight"]
            return y * scale[None, :, None, None] + params[f"{name}.bias"][None, :, None, None]

        def conv(name, t, padding=0, stride=1, bias=False):
            b = params[f"{name}.bias"] if bias else None
            return F.conv2d(t, params[f"{name}.weight"], b, stride, padding)

        if self.arch["kind"] == "densenet_bc":
            out = conv("conv1", x, 1)
            for layers, trans in self._plan:
                for p in layers:
                    y = conv(f"{p}.conv1", F.relu(bn(f"{p}.bn1", out)))
                    y = conv(f"{p}.conv2", F.relu(bn(f"{p}.bn2", y)), 1)
                    out = torch.cat([out, y], dim=1)
                if trans:
                    out = F.avg_pool2d(conv(f"{trans}.conv1",
                                            F.relu(bn(f"{trans}.bn1", out))), 2)
            out = F.relu(bn("bn1", out)).mean((2, 3))
            return F.linear(out, params["fc.weight"], params["fc.bias"])

        out = F.relu(bn("features.norm0", conv("features.conv0", x, 3, 2)))
        out = F.max_pool2d(out, 3, 2, 1)
        for layers, trans in self._plan:
            for p in layers:
                y = conv(f"{p}.conv1", F.relu(bn(f"{p}.norm1", out)))
                y = conv(f"{p}.conv2", F.relu(bn(f"{p}.norm2", y)), 1)
                out = torch.cat([out, y], dim=1)
            if trans:
                out = F.avg_pool2d(conv(f"{trans}.conv", F.relu(bn(f"{trans}.norm", out))), 2)
        out = F.relu(bn("features.norm5", out))
        out = F.relu(bn("head.transit_bn", conv("head.transit_conv", out, 1, bias=True)))
        out = torch.amax(F.max_pool2d(out, 2, 2, 1), dim=(2, 3))
        return F.linear(out, params["head.classifier.weight"], params["head.classifier.bias"])
