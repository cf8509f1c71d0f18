"""Reference ``.pt`` import and export of the port
(``train/checkpoints.load_torch_checkpoint``/``save_torch_checkpoint``,
``utils/torch_interop.py``) against the JAX package's converters, on
state dicts the tests synthesize in the reference's save formats (nested
under ``state_dict``, ``module.`` prefixes, legacy ``norm.1`` keys, torch
BatchNorm's ``num_batches_tracked``).  Every comparison is equality: the
maps move values without arithmetic."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optwboundeigenval_tpu.models import CNNUSPS as JaxCNNUSPS
from optwboundeigenval_tpu.models import ForestNet as JaxForestNet
from optwboundeigenval_tpu.models.densenet import DenseNet3 as JaxDenseNet3
from optwboundeigenval_tpu.train import checkpoints as jck
from optwboundeigenval_tpu.utils import torch_interop as jti
from optwboundeigenval_tpu_torch.models import backbones
from optwboundeigenval_tpu_torch.models.cnn_usps import CNNUSPS
from optwboundeigenval_tpu_torch.models.densenet import DenseNet3
from optwboundeigenval_tpu_torch.models.mlp_forest import ForestNet
from optwboundeigenval_tpu_torch.train import checkpoints
from optwboundeigenval_tpu_torch.utils import interop, torch_interop
from scripts.convert_torch_weights import CONVERTERS

torch.set_num_threads(1)


def _equal_trees(got, want):
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _reference_file(path, sd, nested=True, prefix="module."):
    """``sd`` saved as the reference saves a checkpoint."""
    sd = {prefix + k: torch.as_tensor(np.asarray(v)) for k, v in sd.items()}
    torch.save({"state_dict": sd, "epoch": 3} if nested else sd, path)
    return path


def _jax_params(model, x):
    p = model.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    return jax.tree.map(lambda a: np.asarray(a, np.float64), p)


CASES = {
    "forest": (lambda: JaxForestNet(hidden=20, num_classes=7, dtype=jnp.float64),
               ForestNet, np.zeros((2, 54)), jti.forestnet_to_state_dict,
               interop.forestnet_to_jax),
    "usps_cnn": (lambda: JaxCNNUSPS(dtype=jnp.float64), CNNUSPS, np.zeros((2, 16, 16, 1)),
                 jti.cnnusps_to_state_dict, interop.cnnusps_to_jax),
}


@pytest.mark.parametrize("arch", sorted(CASES))
@pytest.mark.parametrize("nested", [True, False])
def test_load_matches_the_jax_converter(tmp_path, arch, nested):
    jmodel, tmodel, x, to_sd, to_jax = CASES[arch]
    p = _jax_params(jmodel(), x)
    path = _reference_file(str(tmp_path / "ref.pt"), to_sd(p), nested)
    want = jck.load_torch_checkpoint(path, arch)
    got = checkpoints.load_torch_checkpoint(path, arch)
    _equal_trees(to_jax(got), want)
    m = tmodel().double()
    m.load_state_dict(got)  # strict: the port's names are the reference's


@pytest.mark.parametrize("arch", sorted(CASES))
def test_save_matches_the_jax_exporter(tmp_path, arch):
    jmodel, tmodel, x, to_sd, _ = CASES[arch]
    p = _jax_params(jmodel(), x)
    jck.save_torch_checkpoint(p, str(tmp_path / "jax.pt"), arch)
    m = tmodel().double()
    m.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in to_sd(p).items()})
    checkpoints.save_torch_checkpoint(m, str(tmp_path / "port.pt"), arch)
    want = torch.load(str(tmp_path / "jax.pt"), weights_only=True)
    got = torch.load(str(tmp_path / "port.pt"), weights_only=True)
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    # and back: the file loads into the model it came from
    assert all(torch.equal(t, m.state_dict()[k]) for k, t in
               checkpoints.load_torch_checkpoint(str(tmp_path / "port.pt"), arch).items())


@pytest.mark.parametrize("bottleneck", [True, False])
def test_densenet3_both_ways(tmp_path, bottleneck):
    kw = dict(depth=10, growth_rate=4, bottleneck=bottleneck, reduction=0.5 if bottleneck else 1.0)
    jm = JaxDenseNet3(dtype=jnp.float64, **kw)
    v = jm.init(jax.random.PRNGKey(0), jnp.zeros((2, 32, 32, 3)))
    rng = np.random.default_rng(0)
    p = jax.tree.map(lambda a: np.asarray(a, np.float64), v["params"])
    s = jax.tree.map(lambda a: np.asarray(a, np.float64) + rng.uniform(0, 1, a.shape),
                     v["batch_stats"])
    tp, ts = interop.densenet3_from_jax(p, s)
    sd = {**tp, **ts}
    ref = {k: t.numpy() for k, t in sd.items()}
    # the reference's torch BatchNorms count their batches
    ref.update({k.replace("running_mean", "num_batches_tracked"): np.asarray(5)
                for k in sd if k.endswith("running_mean")})
    path = _reference_file(str(tmp_path / "ref.pt"), ref)
    got = checkpoints.load_torch_checkpoint(path, "densenet3")
    _equal_trees(interop.densenet3_to_jax(
        {k: got[k] for k in tp}, {k: got[k] for k in ts}),
        jti.convert_densenet3_state_dict(ref, depth=10, bottleneck=bottleneck))
    m = DenseNet3(**kw).double()
    m.load_state_dict(got)
    out = checkpoints.save_torch_checkpoint(m, str(tmp_path / "port.pt"), "densenet3")
    back = checkpoints.load_torch_checkpoint(out, "densenet3")
    assert sorted(back) == sorted(sd) and all(torch.equal(back[k], sd[k]) for k in sd)


def _legacy(key):
    """torchvision's old dotted names: ``norm1`` -> ``norm.1``."""
    return key.replace("norm1", "norm.1").replace("conv2", "conv.2")


TRUNKS = {"densenet121": backbones.densenet121_features,
          "densenet161": backbones.densenet161_features,
          "densenet169": backbones.densenet169_features,
          "densenet201": backbones.densenet201_features,
          "vgg16_bn": backbones.VGG16BNFeatures, "alexnet": backbones.AlexNetFeatures,
          "resnet50": backbones.ResNet50Features}


@pytest.mark.parametrize("arch", sorted(TRUNKS))
def test_torchvision_trunks_map_as_the_jax_converter(tmp_path, arch):
    """A torchvision state dict of ``arch`` (small tensors of the right
    rank, each its own values: the maps read names and ranks only) through
    the port's loader and ``interop.to_jax``, against the flax paths that
    ``scripts/convert_torch_weights.py`` writes for it."""
    with torch.device("meta"):
        trunk = TRUNKS[arch]()
    names = trunk.state_dict()
    rng = np.random.default_rng(1)
    small = {k: rng.normal(size=(2,) * t.dim()) for k, t in names.items()}
    prefix = "" if arch == "resnet50" else "features."
    ref = {prefix + k: v for k, v in small.items()}
    ref.update({prefix + k.replace("running_mean", "num_batches_tracked"): np.asarray(7)
                for k in names if k.endswith("running_mean")})
    ref.update({"fc.weight": np.ones((3, 2)), "fc.bias": np.ones(3)} if arch == "resnet50"
               else {"classifier.weight": np.ones((3, 2))})
    if arch.startswith("densenet"):
        ref = {_legacy(k): v for k, v in ref.items()}
    path = _reference_file(str(tmp_path / "tv.pt"), ref, nested=False)
    got = checkpoints.load_torch_checkpoint(path, arch)
    assert sorted(got) == sorted(names)
    params = {k: got[k] for k, _ in trunk.named_parameters()}
    state = {k: got[k] for k, _ in trunk.named_buffers()}
    fp, fs = interop.to_jax(trunk, params, state)
    flat = {f"params/{k}": v for k, v in interop.flatten(fp).items()}
    flat.update({f"batch_stats/{k}": v for k, v in interop.flatten(fs).items()})
    want = CONVERTERS[arch]({k.removeprefix("module."): v for k, v in
                             torch.load(path, weights_only=True).items()})
    assert sorted(flat) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(flat[k], np.asarray(want[k]), err_msg=k)


def test_key_cleanup_matches_jax():
    sd = {"module.encoder.denseblock1.denselayer1.norm.1.weight": 1,
          "module.features.conv0.weight": 2, "fc.bias": 3, "layer1.0.downsample.0.weight": 4,
          "features.transition1.pool.0.x": 5}
    for wrapped in (sd, {"state_dict": sd}):
        got = torch_interop.normalize_state_dict_keys(wrapped)
        want = jti.normalize_state_dict_keys(wrapped)
        assert list(got) == list(want)
        assert [int(v) for v in got.values()] == [int(v) for v in want.values()]


def test_unknown_arch_and_missing_keys_raise(tmp_path):
    path = _reference_file(str(tmp_path / "x.pt"), {"fc1.weight": np.ones((2, 2))})
    with pytest.raises(ValueError, match="unknown arch"):
        checkpoints.load_torch_checkpoint(path, "lenet")
    with pytest.raises(KeyError, match="lacks"):
        checkpoints.load_torch_checkpoint(path, "forest")
    with pytest.raises(ValueError, match="unknown arch"):
        checkpoints.save_torch_checkpoint(ForestNet(), str(tmp_path / "y.pt"), "resnet50")
