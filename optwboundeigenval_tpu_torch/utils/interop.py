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
"""

from __future__ import annotations

from typing import Dict, Iterator, Tuple

import numpy as np
import torch

Tree = Dict[str, torch.Tensor]


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
    t = lambda a: torch.from_numpy(np.array(a, order="C"))
    p, s = {}, {}
    for name, path, kind in _densenet3_pairs(n_blocks):
        src = _get(params, path)
        if kind == "conv":
            p[f"{name}.weight"] = t(np.asarray(src["kernel"]).transpose(3, 2, 0, 1))
        elif kind == "dense":
            p[f"{name}.weight"] = t(np.asarray(src["kernel"]).T)
            p[f"{name}.bias"] = t(src["bias"])
        else:
            stats = _get(batch_stats, path)
            p[f"{name}.weight"] = t(src["scale"])
            p[f"{name}.bias"] = t(src["bias"])
            s[f"{name}.running_mean"] = t(stats["mean"])
            s[f"{name}.running_var"] = t(stats["var"])
    return p, s


def densenet3_to_jax(params: Tree, model_state: Tree):
    """The port's ``(params, model_state)`` -> flax ``(params,
    batch_stats)`` as nested dicts of numpy arrays."""
    n_blocks = sum(k.endswith(".conv2.weight") for k in params) // 3
    a = lambda x: x.detach().cpu().numpy()
    fp, fs = {}, {}
    for name, path, kind in _densenet3_pairs(n_blocks):
        if kind == "conv":
            _set(fp, path, {"kernel": np.ascontiguousarray(
                a(params[f"{name}.weight"]).transpose(2, 3, 1, 0))})
        elif kind == "dense":
            _set(fp, path, {"kernel": np.ascontiguousarray(
                a(params[f"{name}.weight"]).T),
                "bias": a(params[f"{name}.bias"])})
        else:
            _set(fp, path, {"scale": a(params[f"{name}.weight"]),
                            "bias": a(params[f"{name}.bias"])})
            _set(fs, path, {"mean": a(model_state[f"{name}.running_mean"]),
                            "var": a(model_state[f"{name}.running_var"])})
    return fp, fs
