"""Weights between the JAX package's flax trees and this port's state
dicts, as numpy (no JAX import here).

The port's DenseNet3 uses the reference torch names, so the map is the
one of ``optwboundeigenval_tpu/utils/torch_interop.py``
``convert_densenet3_state_dict``: ``block{b+1}.layer.{i}`` is
``BottleneckBlock_{b*n+i}``, ``trans{t}`` is ``TransitionBlock_{t-1}``,
the final ``bn1`` is ``BatchNorm_0`` and ``fc`` is ``fc``.  Convs are
OIHW here and HWIO there; the classifier is ``(out, in)`` here and
``(in, out)`` there.  The final pool leaves a 1x1 map, so the flatten
before ``fc`` needs no column permutation.

``ForestNet`` and ``CNNUSPS`` keep the reference torch names too: flax
``fc1``/``fc2``/``fc3`` and ``Conv_0..2``/``Dense_0..1`` map to
``fc1..3`` and ``conv1..3``/``fc1``/``fc2``, the maps of
``torch_interop.convert_forestnet_state_dict`` and
``convert_cnnusps_state_dict``.  CNNUSPS's ``fc1`` reads a (32, 2, 2) map
flattened CHW here and HWC there, so its columns are permuted as
``torch_interop.dense_after_flatten_from_torch`` does.
"""

from __future__ import annotations

from typing import Dict, Iterator, Tuple

import numpy as np
import torch

Tree = Dict[str, torch.Tensor]


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, order="C"))


def _a(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _densenet3_pairs(n_blocks: int) -> Iterator[Tuple[str, Tuple[str, ...], str]]:
    """``(port prefix, flax path, kind)`` for every layer of a DenseNet3
    whose dense blocks hold ``n_blocks`` bottleneck layers each."""
    yield "conv1", ("conv1",), "conv"
    for b in range(3):
        for i in range(n_blocks):
            t = f"block{b + 1}.layer.{i}"
            f = f"BottleneckBlock_{b * n_blocks + i}"
            yield f"{t}.bn1", (f, "BatchNorm_0"), "bn"
            yield f"{t}.conv1", (f, "Conv_0"), "conv"
            yield f"{t}.bn2", (f, "BatchNorm_1"), "bn"
            yield f"{t}.conv2", (f, "Conv_1"), "conv"
        if b < 2:
            f = f"TransitionBlock_{b}"
            yield f"trans{b + 1}.bn1", (f, "BatchNorm_0"), "bn"
            yield f"trans{b + 1}.conv1", (f, "Conv_0"), "conv"
    yield "bn1", ("BatchNorm_0",), "bn"
    yield "fc", ("fc",), "dense"


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _set(tree, path, value):
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def densenet3_from_jax(params, batch_stats) -> Tuple[Tree, Tree]:
    """flax ``(params, batch_stats)`` of ``models.DenseNet3`` (numpy or
    array leaves) -> the port's ``(params, model_state)`` as CPU tensors
    of the same dtype."""
    n_blocks = sum(k.startswith("BottleneckBlock_") for k in params) // 3
    p, s = {}, {}
    for name, path, kind in _densenet3_pairs(n_blocks):
        src = _get(params, path)
        if kind == "conv":
            p[f"{name}.weight"] = _t(np.asarray(src["kernel"]).transpose(3, 2, 0, 1))
        elif kind == "dense":
            p[f"{name}.weight"] = _t(np.asarray(src["kernel"]).T)
            p[f"{name}.bias"] = _t(src["bias"])
        else:
            stats = _get(batch_stats, path)
            p[f"{name}.weight"] = _t(src["scale"])
            p[f"{name}.bias"] = _t(src["bias"])
            s[f"{name}.running_mean"] = _t(stats["mean"])
            s[f"{name}.running_var"] = _t(stats["var"])
    return p, s


def densenet3_to_jax(params: Tree, model_state: Tree):
    """The port's ``(params, model_state)`` -> flax ``(params,
    batch_stats)`` as nested dicts of numpy arrays."""
    n_blocks = sum(k.endswith(".conv2.weight") for k in params) // 3
    fp, fs = {}, {}
    for name, path, kind in _densenet3_pairs(n_blocks):
        if kind == "conv":
            _set(fp, path, {"kernel": np.ascontiguousarray(
                _a(params[f"{name}.weight"]).transpose(2, 3, 1, 0))})
        elif kind == "dense":
            _set(fp, path, {"kernel": np.ascontiguousarray(
                _a(params[f"{name}.weight"]).T),
                "bias": _a(params[f"{name}.bias"])})
        else:
            _set(fp, path, {"scale": _a(params[f"{name}.weight"]),
                            "bias": _a(params[f"{name}.bias"])})
            _set(fs, path, {"mean": _a(model_state[f"{name}.running_mean"]),
                            "var": _a(model_state[f"{name}.running_var"])})
    return fp, fs


def forestnet_from_jax(params) -> Tree:
    """flax params of ``models.ForestNet`` -> the port's params."""
    p = {}
    for name in ("fc1", "fc2", "fc3"):
        p[f"{name}.weight"] = _t(np.asarray(params[name]["kernel"]).T)
        p[f"{name}.bias"] = _t(params[name]["bias"])
    return p


def forestnet_to_jax(params: Tree):
    """The port's ForestNet params -> flax params as numpy."""
    return {name: {"kernel": np.ascontiguousarray(_a(params[f"{name}.weight"]).T),
                   "bias": _a(params[f"{name}.bias"])}
            for name in ("fc1", "fc2", "fc3")}


_CNNUSPS_CONVS = (("Conv_0", "conv1"), ("Conv_1", "conv2"), ("Conv_2", "conv3"))
_CNNUSPS_FC1_CHW = (32, 2, 2)


def cnnusps_from_jax(params) -> Tree:
    """flax params of ``models.CNNUSPS`` -> the port's params; ``Dense_0``'s
    rows go from HWC to CHW order."""
    p = {}
    for src, dst in _CNNUSPS_CONVS:
        p[f"{dst}.weight"] = _t(np.asarray(params[src]["kernel"]).transpose(3, 2, 0, 1))
        p[f"{dst}.bias"] = _t(params[src]["bias"])
    c, h, w = _CNNUSPS_FC1_CHW
    k = np.asarray(params["Dense_0"]["kernel"])  # (H*W*C, out), rows HWC
    out = k.shape[1]
    p["fc1.weight"] = _t(k.T.reshape(out, h, w, c).transpose(0, 3, 1, 2)
                         .reshape(out, c * h * w))
    p["fc1.bias"] = _t(params["Dense_0"]["bias"])
    p["fc2.weight"] = _t(np.asarray(params["Dense_1"]["kernel"]).T)
    p["fc2.bias"] = _t(params["Dense_1"]["bias"])
    return p


def cnnusps_to_jax(params: Tree):
    """The port's CNNUSPS params -> flax params as numpy (inverse of
    :func:`cnnusps_from_jax`)."""
    fp = {}
    for dst, src in _CNNUSPS_CONVS:
        fp[dst] = {"kernel": np.ascontiguousarray(
            _a(params[f"{src}.weight"]).transpose(2, 3, 1, 0)),
            "bias": _a(params[f"{src}.bias"])}
    c, h, w = _CNNUSPS_FC1_CHW
    wt = _a(params["fc1.weight"])  # (out, C*H*W), columns CHW
    out = wt.shape[0]
    fp["Dense_0"] = {"kernel": np.ascontiguousarray(
        wt.reshape(out, c, h, w).transpose(0, 2, 3, 1).reshape(out, h * w * c).T),
        "bias": _a(params["fc1.bias"])}
    fp["Dense_1"] = {"kernel": np.ascontiguousarray(_a(params["fc2.weight"]).T),
                     "bias": _a(params["fc2.bias"])}
    return fp
