"""Reference PyTorch checkpoints to and from the port's state dicts
(counterpart of ``optwboundeigenval_tpu/utils/torch_interop.py`` and of
the backbone walkers of ``scripts/convert_torch_weights.py``).

The port's models carry the reference's torch names and layouts
(``ForestNet`` ``fc1..3``, ``CNNUSPS`` ``conv1..3``/``fc1``/``fc2``,
``DenseNet3`` ``block{b}.layer.{i}.bn1``, ...), and its trunks carry
torchvision's names under ``features.`` (``conv0``,
``denseblock1.denselayer1.norm1``, VGG's and AlexNet's Sequential
indices, ResNet's ``layer1.0.bn3``, ``downsample.0``).  So a reference
state dict maps onto a port model by names alone: no transpose, no
column permutation.  What the map does:

* :func:`normalize_state_dict_keys`: the reference's tolerant cleanup
  (opt.py:1041-1059, dnet.py:328-343): unwrap ``{"state_dict": ...}``,
  strip DataParallel's ``module.``, read ``encoder.`` as ``features.``,
  and legacy dotted names such as ``norm.1`` as ``norm1``;
* drop torch BatchNorm's ``num_batches_tracked`` (the port's BatchNorm
  has no counter);
* for a trunk arch, keep the keys under ``features.`` without the prefix
  (ResNet50: everything but the classifier ``fc``), the names of the
  trunk module itself (``models/backbones.py``; a ``CXRModel`` holds it
  as ``features``).
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import torch

Tree = Dict[str, torch.Tensor]

REFERENCE_ARCHS = ("forest", "usps_cnn", "densenet3")
TRUNK_ARCHS = ("densenet121", "densenet161", "densenet169", "densenet201",
               "vgg16_bn", "alexnet", "resnet50")
_REQUIRED = {
    "forest": [f"fc{i}.{k}" for i in (1, 2, 3) for k in ("weight", "bias")],
    "usps_cnn": [f"{m}.{k}" for m in ("conv1", "conv2", "conv3", "fc1", "fc2")
                 for k in ("weight", "bias")],
}
_LEGACY = re.compile(r"(norm|conv|relu|pool)\.(\d+)")


def normalize_state_dict_keys(sd: Mapping) -> dict:
    """The reference's key cleanup (JAX torch_interop.py:72-90); values as
    given."""
    if "state_dict" in sd and isinstance(sd["state_dict"], Mapping):
        sd = sd["state_dict"]
    out = {}
    for k, v in sd.items():
        k = k.removeprefix("module.")
        if k.startswith("encoder."):
            k = "features." + k.removeprefix("encoder.")
        out[_LEGACY.sub(lambda m: m.group(1) + m.group(2), k)] = v
    return out


def from_reference(sd: Mapping, arch: str) -> Tree:
    """A reference or torchvision state dict -> the port's state dict for
    ``arch``: a model of ``REFERENCE_ARCHS`` or a trunk of
    ``TRUNK_ARCHS``.  Load it with ``model.load_state_dict``."""
    if arch not in REFERENCE_ARCHS + TRUNK_ARCHS:
        raise ValueError(f"unknown arch {arch!r}; have {sorted(REFERENCE_ARCHS + TRUNK_ARCHS)}")
    sd = {k: torch.as_tensor(v) for k, v in normalize_state_dict_keys(sd).items()
          if not k.endswith("num_batches_tracked")}
    if arch == "resnet50":
        sd = {k: v for k, v in sd.items() if not k.startswith("fc.")}
    elif arch in TRUNK_ARCHS:
        sd = {k.removeprefix("features."): v for k, v in sd.items()
              if k.startswith("features.")}
    missing = [k for k in _REQUIRED.get(arch, ()) if k not in sd]
    if missing:
        raise KeyError(f"{arch} state dict lacks {missing}")
    if arch in _REQUIRED:
        sd = {k: sd[k] for k in _REQUIRED[arch]}
    return sd


def to_reference(state, arch: str) -> Tree:
    """A port model (or its ``{**params, **model_state}``) -> the state dict
    the reference's model of ``arch`` loads (``forest`` and ``usps_cnn``:
    the parameters; ``densenet3``: parameters and running statistics), as
    contiguous CPU tensors."""
    if arch not in REFERENCE_ARCHS:
        raise ValueError(f"unknown arch {arch!r}; have {sorted(REFERENCE_ARCHS)}")
    if isinstance(state, torch.nn.Module):
        state = state.state_dict()
    keys = _REQUIRED.get(arch, list(state))
    return {k: state[k].detach().cpu().contiguous() for k in keys}
