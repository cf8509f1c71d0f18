"""Weights between the JAX package's flax trees and this port's state
dicts, as numpy (no JAX import here).

The port's DenseNet3 uses the reference torch names, so the map is the
one of ``optwboundeigenval_tpu/utils/torch_interop.py``
``convert_densenet3_state_dict``: ``block{b+1}.layer.{i}`` is
``BottleneckBlock_{b*n+i}`` (``BasicBlock_{b*n+i}`` without bottleneck,
its ``bn1``/``conv1`` only), ``trans{t}`` is ``TransitionBlock_{t-1}``,
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

K-FAC factor state (``ops/kfac.py``): the JAX package keys a layer by its
flax path (``"fc1"``, ``"Conv_0"``, ``"BottleneckBlock_0/Conv_1"``), the
port by its module name (the maps above).  A conv's ``A`` factor is in
``(kh, kw, in_c)`` patch order there and in ``(in_c, kh, kw)`` here, and
CNNUSPS's ``fc1`` takes the HWC -> CHW column permutation of its weight;
the bias row and column stay last, and ``G`` is the same on both sides.
A permutation ``P`` acts as ``m_aa[P][:, P]`` and ``Q_a[P]``, so the
round trip is exact.

The chest x-ray models (``models/backbones.py``, ``models/cxr.py``) keep
torchvision's names; :func:`model_pairs` walks a model in the order its
flax counterpart creates its layers and assigns flax's auto-names
(``Conv_0``, ``BatchNorm_3``, ``_Bottleneck_5``, ``DenseNetFeatures_0``)
with one counter per class and scope, as ``scripts/convert_torch_weights.py``
does.  :func:`from_jax`/:func:`to_jax` carry any of the port's models
across through that map, and the K-FAC factor functions take it for the
chest x-ray models' layer names (``features/Conv_0`` is
``features.conv0``, ``head/transit_conv`` is ``head.transit_conv``).
:func:`module_names` extends the map to every flax scope above those
layers (``features``, ``BottleneckBlock_3``, ``_Bottleneck_5``), the
port's module whose submodules hold the scope's layers, so that a JAX
Grad-CAM ``cam_layer`` such as CNNUSPS's ``Conv_2`` names the port's
``conv3``.

The GANs (``models/gan.py``) keep flax's creation order too: ``Embed_0``
is ``label_emb`` (the table as it is), ``Dense_i``, ``Conv_i`` and
``BatchNorm_i`` as above, and ``ConvTranspose_i`` a transposed
convolution whose kernel is ``(k, k, in, out)`` there and ``(in, out, k,
k)`` here, flipped in both spatial axes (flax's ``ConvTranspose`` does not
flip, torch's does).
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Tuple

import numpy as np
import torch
from torch import nn

Tree = Dict[str, torch.Tensor]


def _t(a) -> torch.Tensor:
    a = np.array(a, order="C")
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16, which torch cannot read
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(a)


def _a(t: torch.Tensor) -> np.ndarray:
    """``t`` as numpy; a bfloat16 tensor as ``ml_dtypes.bfloat16`` (the
    type of the JAX package's bfloat16 arrays), through float32."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes

        return t.float().numpy().astype(ml_dtypes.bfloat16)
    return t.numpy()


def _densenet3_pairs(n_blocks: int, bottleneck: bool = True
                     ) -> Iterator[Tuple[str, Tuple[str, ...], str]]:
    """``(port prefix, flax path, kind)`` for every layer of a DenseNet3
    whose dense blocks hold ``n_blocks`` bottleneck (or basic) layers each."""
    cls = "BottleneckBlock" if bottleneck else "BasicBlock"
    yield "conv1", ("conv1",), "conv"
    for b in range(3):
        for i in range(n_blocks):
            t = f"block{b + 1}.layer.{i}"
            f = f"{cls}_{b * n_blocks + i}"
            yield f"{t}.bn1", (f, "BatchNorm_0"), "bn"
            yield f"{t}.conv1", (f, "Conv_0"), "conv"
            if bottleneck:
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


def _pairs_from_jax(pairs, params, batch_stats) -> Tuple[Tree, Tree]:
    """flax ``(params, batch_stats)`` -> the port's ``(params,
    model_state)`` over ``(port prefix, flax path, kind)`` pairs."""
    p, s = {}, {}
    for name, path, kind in pairs:
        src = _get(params, path)
        if kind == "bn":
            stats = _get(batch_stats, path)
            p[f"{name}.weight"] = _t(src["scale"])
            s[f"{name}.running_mean"] = _t(stats["mean"])
            s[f"{name}.running_var"] = _t(stats["var"])
        elif kind == "conv":
            p[f"{name}.weight"] = _t(np.asarray(src["kernel"]).transpose(3, 2, 0, 1))
        elif kind == "deconv":
            p[f"{name}.weight"] = _t(np.asarray(src["kernel"])[::-1, ::-1].transpose(2, 3, 0, 1))
        elif kind == "embed":
            p[f"{name}.weight"] = _t(src["embedding"])
        else:
            p[f"{name}.weight"] = _t(np.asarray(src["kernel"]).T)
        if "bias" in src:
            p[f"{name}.bias"] = _t(src["bias"])
    return p, s


def _pairs_to_jax(pairs, params: Tree, model_state: Tree):
    """The port's ``(params, model_state)`` -> flax ``(params,
    batch_stats)`` as nested dicts of numpy arrays."""
    fp, fs = {}, {}
    for name, path, kind in pairs:
        w = _a(params[f"{name}.weight"])
        if kind == "bn":
            leaf = {"scale": w}
            _set(fs, path, {"mean": _a(model_state[f"{name}.running_mean"]),
                            "var": _a(model_state[f"{name}.running_var"])})
        elif kind == "conv":
            leaf = {"kernel": np.ascontiguousarray(w.transpose(2, 3, 1, 0))}
        elif kind == "deconv":
            leaf = {"kernel": np.ascontiguousarray(w.transpose(2, 3, 0, 1)[::-1, ::-1])}
        elif kind == "embed":
            leaf = {"embedding": w}
        else:
            leaf = {"kernel": np.ascontiguousarray(w.T)}
        if f"{name}.bias" in params:
            leaf["bias"] = _a(params[f"{name}.bias"])
        _set(fp, path, leaf)
    return fp, fs


def densenet3_from_jax(params, batch_stats) -> Tuple[Tree, Tree]:
    """flax ``(params, batch_stats)`` of ``models.DenseNet3`` (numpy or
    array leaves; bottleneck or basic layers) -> the port's ``(params,
    model_state)`` as CPU tensors of the same dtype."""
    basic = sum(k.startswith("BasicBlock_") for k in params)
    n_blocks = (basic or sum(k.startswith("BottleneckBlock_") for k in params)) // 3
    return _pairs_from_jax(_densenet3_pairs(n_blocks, not basic), params, batch_stats)


def densenet3_to_jax(params: Tree, model_state: Tree):
    """The port's ``(params, model_state)`` -> flax ``(params,
    batch_stats)`` as nested dicts of numpy arrays."""
    n_blocks = sum(k.startswith("block") and k.endswith(".bn1.weight") for k in params) // 3
    bottleneck = any(k.endswith(".conv2.weight") for k in params)
    return _pairs_to_jax(_densenet3_pairs(n_blocks, bottleneck), params, model_state)


class _Names:
    """flax auto-names in creation order: one counter per class."""

    def __init__(self, scope: Tuple[str, ...] = ()):
        self.scope, self.counts = scope, {}

    def __call__(self, cls: str) -> Tuple[str, ...]:
        i = self.counts.get(cls, 0)
        self.counts[cls] = i + 1
        return self.scope + (f"{cls}_{i}",)


def _trunk_pairs(trunk: nn.Module, prefix: str, scope: Tuple[str, ...]) -> List:
    """``(port prefix, flax path, kind)`` of a ``models/backbones.py``
    trunk, in the creation order of its flax module (JAX
    backbones.py:24-182)."""
    from optwboundeigenval_tpu_torch.models import backbones as bb

    n, out = _Names(scope), []
    conv = lambda name: out.append((f"{prefix}{name}", n("Conv"), "conv"))
    bn = lambda name: out.append((f"{prefix}{name}", n("BatchNorm"), "bn"))
    if isinstance(trunk, bb.AlexNetFeatures):
        for idx, *_ in trunk._LAYERS:
            conv(str(idx))
    elif isinstance(trunk, bb.VGG16BNFeatures):
        for idx in trunk._plan:
            if idx is not None:
                conv(str(idx))
                bn(str(idx + 1))
    elif isinstance(trunk, bb.ResNet50Features):
        conv("conv1")
        bn("bn1")
        for i in range(len(trunk.stage_sizes)):
            for b, block in enumerate(getattr(trunk, f"layer{i + 1}")):
                sub = _Names(n("_Bottleneck"))
                p = f"{prefix}layer{i + 1}.{b}."
                for j in (1, 2, 3):
                    out.append((f"{p}conv{j}", sub("Conv"), "conv"))
                    out.append((f"{p}bn{j}", sub("BatchNorm"), "bn"))
                if block.downsample is not None:
                    out.append((f"{p}downsample.0", sub("Conv"), "conv"))
                    out.append((f"{p}downsample.1", sub("BatchNorm"), "bn"))
    elif isinstance(trunk, bb.DenseNetFeatures):
        conv("conv0")
        bn("norm0")
        for i, layers in enumerate(trunk.block_config):
            for j in range(layers):
                p = f"denseblock{i + 1}.denselayer{j + 1}."
                bn(p + "norm1")
                conv(p + "conv1")
                bn(p + "norm2")
                conv(p + "conv2")
            if i < len(trunk.block_config) - 1:
                bn(f"transition{i + 1}.norm")
                conv(f"transition{i + 1}.conv")
        bn("norm5")
    else:
        raise TypeError(f"no flax layout for {type(trunk).__name__}")
    return out


def _gan_pairs(model: nn.Module) -> List:
    """``(port prefix, flax path, kind)`` of a ``models/gan.py`` module, in
    the creation order of its flax counterpart (JAX gan.py:26-127)."""
    from optwboundeigenval_tpu_torch.models import gan

    n = _Names()
    out = [("label_emb", n("Embed"), "embed")]
    layer = lambda name, cls, kind: out.append((name, n(cls), kind))
    if isinstance(model, gan.MLPGenerator):
        for i in range(len(model.fc)):
            layer(f"fc.{i}", "Dense", "dense")
            if i > 0:
                layer(f"bn.{i - 1}", "BatchNorm", "bn")
        layer("out", "Dense", "dense")
    elif isinstance(model, gan.MLPDiscriminator):
        for name in ("fc1", "fc2", "fc3", "fc4"):
            layer(name, "Dense", "dense")
    elif isinstance(model, gan.DCGenerator):
        for i in range(len(model.deconv)):
            layer(f"deconv.{i}", "ConvTranspose", "deconv")
            layer(f"bn.{i}", "BatchNorm", "bn")
        layer("out", "ConvTranspose", "deconv")
    else:
        for i in range(len(model.conv)):
            layer(f"conv.{i}", "Conv", "conv")
        layer("fc", "Dense", "dense")
    return out


def model_pairs(model: nn.Module) -> List:
    """``(port prefix, flax path, kind)`` of every layer of ``model``: a
    ``CXRModel`` (or any module with a trunk ``features`` and a
    ``TransitHead`` ``head``), a ``DenseNet121Sigmoid``, a bare trunk, a
    ``DenseNet3``, one of the GANs, a ``VAE`` (its trunk or ``ForestNet``
    under the flax scope ``encoder``) or a ``LogisticRegression``."""
    from optwboundeigenval_tpu_torch.models import gan
    from optwboundeigenval_tpu_torch.models.cxr import DenseNet121Sigmoid, TransitHead
    from optwboundeigenval_tpu_torch.models.densenet import DenseNet3
    from optwboundeigenval_tpu_torch.models.logistic import LogisticRegression
    from optwboundeigenval_tpu_torch.models.vae import VAE

    if isinstance(model, (gan.MLPGenerator, gan.MLPDiscriminator, gan.DCGenerator,
                          gan.DCDiscriminator)):
        return _gan_pairs(model)
    if isinstance(model, VAE):
        from optwboundeigenval_tpu_torch.models.mlp_forest import ForestNet

        enc = ([(f"encoder.{n}", ("encoder", n), "dense") for n in ("fc1", "fc2", "fc3")]
               if isinstance(model.encoder, ForestNet)
               else _trunk_pairs(model.encoder, "encoder.", ("encoder",)))
        return enc + [(name, (name,), "dense") for name in ("mu_fc", "logv_fc", "de1", "de2")]
    if isinstance(model, LogisticRegression):
        return [("linear", ("Dense_0",), "dense")]
    if isinstance(model, DenseNet3):
        return list(_densenet3_pairs(len(model.block1.layer), model.bottleneck))
    if isinstance(model, DenseNet121Sigmoid):
        return (_trunk_pairs(model.features, "features.", ("DenseNetFeatures_0",))
                + [("classifier", ("classifier",), "dense")])
    if isinstance(getattr(model, "head", None), TransitHead):
        return (_trunk_pairs(model.features, "features.", ("features",))
                + [(f"head.{name}", ("head", name), kind) for name, kind in
                   (("transit_conv", "conv"), ("transit_bn", "bn"),
                    ("classifier", "dense"))])
    return _trunk_pairs(model, "", ())


def from_jax(model: nn.Module, params, batch_stats) -> Tuple[Tree, Tree]:
    """The JAX package's flax ``(params, batch_stats)`` of ``model``'s
    counterpart -> the port's ``(params, model_state)``, CPU tensors of
    the same dtype."""
    return _pairs_from_jax(model_pairs(model), params, batch_stats)


def to_jax(model: nn.Module, params: Tree, model_state: Tree):
    """The port's ``(params, model_state)`` of ``model`` -> flax ``(params,
    batch_stats)`` as nested dicts of numpy arrays."""
    return _pairs_to_jax(model_pairs(model), params, model_state)


def module_names(model: nn.Module) -> Dict[str, str]:
    """flax module path -> the port's module name, for every layer with
    weights of ``model`` (``ForestNet``, ``CNNUSPS`` or a model of
    :func:`model_pairs`) and every flax scope above them; a scope is the
    longest dotted prefix shared by the modules that hold its layers
    (``features`` -> ``features``, ``BottleneckBlock_3`` ->
    ``block1.layer.3``)."""
    from optwboundeigenval_tpu_torch.models.cnn_usps import CNNUSPS
    from optwboundeigenval_tpu_torch.models.mlp_forest import ForestNet

    if isinstance(model, CNNUSPS):
        leaves = [(dst, (src,)) for src, dst in _CNNUSPS_CONVS]
        leaves += [("fc1", ("Dense_0",)), ("fc2", ("Dense_1",))]
    elif isinstance(model, ForestNet):
        leaves = [(name, (name,)) for name in ("fc1", "fc2", "fc3")]
    else:
        leaves = [(name, path) for name, path, _ in model_pairs(model)]
    out = {"/".join(path): name for name, path in leaves}
    holders: Dict[Tuple[str, ...], List[List[str]]] = {}
    for name, path in leaves:
        for i in range(1, len(path)):
            holders.setdefault(path[:i], []).append(name.split(".")[:-1])
    for scope, parents in holders.items():
        common = parents[0]
        for p in parents[1:]:
            k = 0
            while k < min(len(common), len(p)) and common[k] == p[k]:
                k += 1
            common = common[:k]
        out["/".join(scope)] = ".".join(common)
    return out


def flatten(tree, sep: str = "/") -> Dict[str, np.ndarray]:
    """A nested dict -> ``{"a/b/c": leaf}`` (flax's ``flatten_dict``)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update({f"{k}{sep}{kk}": vv for kk, vv in flatten(v, sep).items()})
        else:
            out[k] = v
    return out


def unflatten(flat: Dict[str, np.ndarray], sep: str = "/"):
    """The inverse of :func:`flatten`."""
    tree: dict = {}
    for k, v in flat.items():
        _set(tree, tuple(k.split(sep)), v)
    return tree


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


_FACTOR_FIELDS = ("m_aa", "m_gg", "Q_a", "d_a", "Q_g", "d_g")


def _layer_names(flax_paths, model=None) -> Dict[str, str]:
    """flax path -> port module name of every factored layer; ``model``
    gives the map of the chest x-ray models."""
    if model is not None:
        return {"/".join(path): name for name, path, kind in model_pairs(model)
                if kind != "bn"}
    paths = set(flax_paths)
    if "Conv_0" in paths:  # CNNUSPS
        names = dict(_CNNUSPS_CONVS)
        names.update({"Dense_0": "fc1", "Dense_1": "fc2"})
        return names
    for cls, per_layer in (("BottleneckBlock_", 2), ("BasicBlock_", 1)):
        if any(p.startswith(cls) for p in paths):
            n_blocks = sum(p.startswith(cls) for p in paths) // (3 * per_layer)
            return {"/".join(path): name for name, path, kind
                    in _densenet3_pairs(n_blocks, per_layer == 2) if kind != "bn"}
    return {p: p for p in paths}  # ForestNet


def _a_perm(name: str, params: Tree, cnn_fc1: bool) -> np.ndarray:
    """``P`` with ``port A = jax A[P][:, P]`` for layer ``name``."""
    w = params[f"{name}.weight"]
    if w.dim() == 4:
        _, ic, kh, kw = w.shape
        perm = np.arange(kh * kw * ic).reshape(kh, kw, ic).transpose(2, 0, 1).ravel()
    elif cnn_fc1:
        c, h, ww = _CNNUSPS_FC1_CHW
        perm = np.arange(h * ww * c).reshape(h, ww, c).transpose(2, 0, 1).ravel()
    else:
        perm = np.arange(w.shape[1])
    if f"{name}.bias" in params:
        perm = np.append(perm, len(perm))
    return perm


def _permuted(f, perm) -> Dict[str, np.ndarray]:
    out = {k: np.asarray(f[k]) for k in _FACTOR_FIELDS}
    out["m_aa"] = out["m_aa"][perm][:, perm]
    out["Q_a"] = out["Q_a"][perm]
    return out


def kfac_factors_from_jax(factors, params: Tree, model=None) -> Dict[str, Tree]:
    """The JAX package's ``{flax path: LayerFactors}`` -> the port's
    ``{module name: {field: tensor}}``; ``params`` is the port's parameter
    dict (it gives the kernel shapes and the bias), ``model`` the port's
    model where the flax paths alone do not name the layers (the chest
    x-ray models)."""
    names = _layer_names(factors, model)
    cnn = "Conv_0" in names
    out = {}
    for path, f in factors.items():
        name = names[path]
        f = {k: getattr(f, k) if hasattr(f, k) else f[k] for k in _FACTOR_FIELDS}
        perm = _a_perm(name, params, cnn and path == "Dense_0")
        out[name] = {k: _t(v) for k, v in _permuted(f, perm).items()}
    return out


def kfac_factors_to_jax(factors: Dict[str, Tree], params: Tree, flax_paths, model=None):
    """The port's factors -> ``{flax path: {field: numpy array}}`` (build
    the JAX package's ``LayerFactors(**fields)`` from each);
    ``flax_paths`` are the JAX model's factored layer paths."""
    names = _layer_names(flax_paths, model)
    cnn = "Conv_0" in names
    out = {}
    for path in flax_paths:
        name = names[path]
        inv = np.argsort(_a_perm(name, params, cnn and path == "Dense_0"))
        out[path] = _permuted({k: _a(v) for k, v in factors[name].items()}, inv)
    return out
