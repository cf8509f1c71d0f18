"""The port's chest x-ray models against the JAX package at float64 on the
CPU: the four trunks (forward in train and eval mode, the updated
BatchNorm statistics), ``TransitHead`` on a small DenseNet trunk (loss,
gradient, HVP, vGHv), ``DenseNet121Sigmoid``'s forward, the weight and
K-FAC factor interop, the ``pretrained_npz`` overlay of weights converted
by ``scripts/convert_torch_weights.py``, and a trainer from every config
module.

Tensors agree to rtol 1e-10 (same float64 math, other summation order);
weight maps are transposes, so round trips and overlays are exact.
"""

import importlib
import os

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optwboundeigenval_tpu.models import backbones as jbb
from optwboundeigenval_tpu.models.cxr import DenseNet121Sigmoid as JaxDN121Sigmoid
from optwboundeigenval_tpu.models.cxr import TransitHead as JaxTransitHead
from optwboundeigenval_tpu.ops import curvature as jcurv
from optwboundeigenval_tpu.ops import kfac as jkfac
from optwboundeigenval_tpu.train.task import Task as JaxTask
from optwboundeigenval_tpu.train.task import losses as jax_losses
from optwboundeigenval_tpu_torch.models import backbones as tbb
from optwboundeigenval_tpu_torch.models.cxr import CXRModel, DenseNet121Sigmoid, TransitHead
from optwboundeigenval_tpu_torch.ops import curvature as tcurv
from optwboundeigenval_tpu_torch.ops import kfac as tkfac
from optwboundeigenval_tpu_torch.train import driver
from optwboundeigenval_tpu_torch.train.task import Task
from optwboundeigenval_tpu_torch.utils import interop

torch.set_num_threads(1)
RTOL = 1e-10
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _close(got, want, rtol=RTOL, msg=""):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * max(np.abs(want).max(), 1e-30),
                               err_msg=msg)


def _close_trees(got, want, rtol=RTOL):
    """Leaf by leaf to ``rtol``, with an absolute floor of ``rtol`` times
    the tree's largest value (a conv bias ahead of a BatchNorm has a zero
    gradient, which float64 leaves at rounding level)."""
    assert sorted(got) == sorted(want)
    scale = max(float(np.abs(np.asarray(w)).max()) for w in want.values())
    for k in want:
        w = np.asarray(want[k])
        g = got[k].detach().numpy() if isinstance(got[k], torch.Tensor) else np.asarray(got[k])
        np.testing.assert_allclose(g, w, rtol=rtol, atol=rtol * scale, err_msg=k)


def _jax_vars(module, x, seed=0):
    """float64 flax variables of ``module`` at ``x`` drawn from ``seed``
    (only their shapes come from flax, so nothing is compiled): kernels
    ``N(0, 1 / fan_in)``, biases ``N(0, 0.01)``, BatchNorm scales ``1 +
    N(0, 0.01)`` (a zero scale would hide a branch), running means in
    ``[0.1, 0.5)`` and variances in ``[1.1, 1.5)``."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda x: module.init(jax.random.PRNGKey(0), x, train=False),
                            jax.ShapeDtypeStruct(x.shape, jnp.float64))

    def draw(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "kernel":
            return rng.normal(size=shape) / np.sqrt(np.prod(shape[:-1]))
        if name in ("bias", "scale"):
            return (name == "scale") + 0.1 * rng.normal(size=shape)
        return (name == "var") + rng.uniform(0.1, 0.5, size=shape)

    p = jax.tree_util.tree_map_with_path(draw, shapes["params"])
    s = jax.tree_util.tree_map_with_path(draw, shapes.get("batch_stats", {}))
    return p, s


# ---- the trunks -------------------------------------------------------------

TRUNKS = {
    "densenet": (lambda: jbb.DenseNetFeatures(block_config=(2, 2), growth_rate=8,
                                              num_init_features=16, dtype=jnp.float64),
                 lambda: tbb.DenseNetFeatures(block_config=(2, 2), growth_rate=8,
                                              num_init_features=16), 32),
    "resnet50": (lambda: jbb.ResNet50Features(stage_sizes=(1, 1), dtype=jnp.float64),
                 lambda: tbb.ResNet50Features(stage_sizes=(1, 1)), 32),
    "vgg": (lambda: jbb.VGG16BNFeatures(cfg=(8, "M", 16, 16, "M"), dtype=jnp.float64),
            lambda: tbb.VGG16BNFeatures(cfg=(8, "M", 16, 16, "M")), 16),
    "alexnet": (lambda: jbb.AlexNetFeatures(dtype=jnp.float64),
                lambda: tbb.AlexNetFeatures(), 67),
}


@pytest.fixture(scope="module", params=sorted(TRUNKS))
def trunk(request):
    jmake, tmake, size = TRUNKS[request.param]
    x = np.random.default_rng(1).normal(size=(3, size, size, 3))
    jm, tm = jmake(), tmake().double()
    p, s = _jax_vars(jm, x)
    tp, ts = interop.from_jax(tm, p, s)
    return jm, p, s, x, tm, tp, ts


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()


def test_trunk_state_names_are_the_module_s(trunk):
    *_, tm, tp, ts = trunk
    assert sorted(tp) == sorted(k for k, _ in tm.named_parameters())
    assert sorted(ts) == sorted(k for k, _ in tm.named_buffers())


@pytest.mark.parametrize("train", [True, False])
def test_trunk_forward_matches_flax(trunk, train):
    jm, p, s, x, tm, tp, ts = trunk
    variables = {"params": p, "batch_stats": s} if s else {"params": p}
    if train:
        want, _ = jm.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
    else:
        want = jm.apply(variables, jnp.asarray(x), train=False)
    got = Task(model=tm)._apply(tp, ts, _nchw(x), train)
    _close(got.permute(0, 2, 3, 1), want)


def test_trunk_batch_stats_update_matches_flax(trunk):
    jm, p, s, x, tm, tp, ts = trunk
    if not s:  # AlexNet: no BatchNorm on either side
        assert not ts and not list(tm.buffers())
        return
    _, new = jm.apply({"params": p, "batch_stats": s}, jnp.asarray(x), train=True,
                      mutable=["batch_stats"])
    task = Task(model=tm, loss=lambda out, y, w: out.mean(), has_batch_stats=True)
    _, got = task.train_loss(tp, ts, {"x": _nchw(x), "y": None})
    _close_trees(got, interop.from_jax(tm, p, jax.tree.map(np.asarray, new["batch_stats"]))[1])


def test_trunk_interop_round_trip(trunk):
    _, p, s, _, tm, tp, ts = trunk
    fp, fs = interop.to_jax(tm, tp, ts)
    assert jax.tree.structure(fp) == jax.tree.structure(p)
    assert jax.tree.structure(fs) == jax.tree.structure(s)
    for a, b in zip(jax.tree.leaves(fp) + jax.tree.leaves(fs),
                    jax.tree.leaves(p) + jax.tree.leaves(s)):
        np.testing.assert_array_equal(a, b)


# ---- TransitHead on a small trunk, composed the same way on both sides ------


class JaxSmallCXR(fnn.Module):
    outnum: int = 5

    def setup(self):
        self.features = jbb.DenseNetFeatures(block_config=(2, 2), growth_rate=8,
                                             num_init_features=16, dtype=jnp.float64)
        self.head = JaxTransitHead(self.outnum, jnp.float64)

    def __call__(self, x, train=False):
        return self.head(self.features(x, train), train)


class SmallCXR(torch.nn.Module):
    forward = CXRModel.forward

    def __init__(self, outnum=5):
        super().__init__()
        self.features = tbb.DenseNetFeatures(block_config=(2, 2), growth_rate=8,
                                             num_init_features=16)
        self.head = TransitHead(self.features.out_channels, outnum)

    def reset_parameters(self, generator=None):
        tbb.lecun_init(self, generator)


@pytest.fixture(scope="module")
def head():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(6, 32, 32, 3))
    y = (rng.random((6, 5)) < 0.4).astype(np.float64)
    y[1, 2] = y[4, 0] = np.nan
    w = np.array([1, 1, 1, 1, 1, 0], np.float32)
    jtask = JaxTask(model=JaxSmallCXR(), loss=jax_losses["weighted_bce_with_logits"],
                    has_batch_stats=True)
    p, s = _jax_vars(jtask.model, x, seed=3)
    ttask = Task(model=SmallCXR().double(), loss=driver.losses["weighted_bce_with_logits"],
                 has_batch_stats=True)
    tp, ts = interop.from_jax(ttask.model, p, s)
    v = jax.tree.map(lambda a: rng.normal(size=a.shape), p)
    tv = interop.from_jax(ttask.model, v, s)[0]
    jb = {"x": jnp.asarray(x), "y": jnp.asarray(y), "w": jnp.asarray(w)}
    tb = {"x": torch.from_numpy(x), "y": torch.from_numpy(y), "w": torch.from_numpy(w)}
    return jtask, p, s, jb, v, ttask, tp, ts, tb, tv


@pytest.mark.parametrize("form", ["loss", "grad", "hvp", "vghv", "train_stats", "predict"])
def test_transit_head_matches_jax(head, form):
    jtask, p, s, jb, v, ttask, tp, ts, tb, tv = head
    jloss, tloss = jtask.loss_fn({"batch_stats": s}), ttask.loss_fn(ts)
    to_port = lambda tree: interop.from_jax(ttask.model, jax.tree.map(np.asarray, tree), s)[0]
    if form == "loss":
        _close(tloss(tp, tb), jloss(p, jb))
    elif form == "grad":
        _close_trees(tcurv.grad(tloss, tp, tb), to_port(jax.jit(jcurv.grad, static_argnums=0)(
            jloss, p, jb)))
    elif form in ("hvp", "vghv"):
        fn = jax.jit(getattr(jcurv, form), static_argnums=0)
        _close_trees(getattr(tcurv, form)(tloss, tp, tb, tv), to_port(fn(jloss, p, jb, v)))
    elif form == "train_stats":
        jl, js = jtask.train_loss(p, {"batch_stats": s}, jb)
        tl, tstate = ttask.train_loss(tp, ts, tb)
        _close(tl, jl)
        _close_trees(tstate, interop.from_jax(ttask.model, p, jax.tree.map(
            np.asarray, js["batch_stats"]))[1])
    else:
        _close(ttask.predict(tp, ts, tb), jtask.predict(p, {"batch_stats": s}, jb))


def test_kfac_factors_of_the_cxr_head_map_to_jax(head):
    """K-FAC's covariances of the small CXR model against the JAX
    package's, keyed ``features/Conv_0`` ... ``head/transit_conv``,
    ``head/classifier`` there, through the interop: the transit conv's
    ``A`` is ``(kh, kw, in_c)`` there and ``(in_c, kh, kw)`` here, the bias
    last.  (The JAX package's patch extraction takes a conv padding as
    ``"SAME"``, ``"VALID"`` or pairs, not the ``(1, 1)`` its CXR modules
    give, so the captures' padding goes to pairs before its ``cov_a``.)"""
    jtask, p, s, jb, v, ttask, tp, ts, tb, tv = head
    _, jcaps = jkfac.capture(jtask, p, {"batch_stats": s}, jb)
    jf = {}
    for path, c in jcaps.items():
        if c.kind == "conv" and not isinstance(c.conv_cfg[2], str):
            k, st, pad = c.conv_cfg
            c = c._replace(conv_cfg=(k, st, tuple((q, q) for q in pad)))
        node = p
        for part in path.split("/"):
            node = node[part]
        aa = np.asarray(jkfac.cov_a(c, "bias" in node))
        gg = np.asarray(jkfac.cov_g(c, True))
        jf[path] = {"m_aa": aa, "m_gg": gg, "Q_a": np.eye(len(aa)), "d_a": np.ones(len(aa)),
                    "Q_g": np.eye(len(gg)), "d_g": np.ones(len(gg))}
    assert "head/transit_conv" in jf and "features/Conv_0" in jf
    want = interop.kfac_factors_from_jax(jf, tp, model=ttask.model)
    _, caps = tkfac.capture(ttask, tp, ts, tb)
    assert sorted(want) == sorted(caps)
    assert want["head.transit_conv"]["m_aa"].shape[0] == 32 * 9 + 1
    for name, cap in caps.items():
        _close(tkfac.cov_a(cap, f"{name}.bias" in tp), want[name]["m_aa"].numpy(), RTOL, name)
        _close(tkfac.cov_g(cap), want[name]["m_gg"].numpy(), RTOL, name)
    back = interop.kfac_factors_to_jax(want, tp, sorted(jf), model=ttask.model)
    for path in jf:
        np.testing.assert_array_equal(back[path]["m_aa"], jf[path]["m_aa"])


def test_densenet121_sigmoid_forward_matches_flax():
    x = np.random.default_rng(4).normal(size=(2, 64, 64, 3))
    jm = JaxDN121Sigmoid(class_count=3, dtype=jnp.float64)
    p, s = _jax_vars(jm, x, seed=5)
    tm = DenseNet121Sigmoid(class_count=3).double()
    tp, ts = interop.from_jax(tm, p, s)
    task = Task(model=tm)
    want = jax.jit(lambda p, s, x: (
        jm.apply({"params": p, "batch_stats": s}, x, train=False),
        jm.apply({"params": p, "batch_stats": s}, x, train=True, mutable=["batch_stats"])[0]))(
            p, s, jnp.asarray(x))
    for train in (False, True):
        _close(task._apply(tp, ts, torch.from_numpy(x), train), want[train])


def test_cxr_densenet121_width():
    """The published model: 16,408,462 parameters, 9,438,208 of them in the
    transit conv (1,024 x 1,024 x 3 x 3 + 1,024)."""
    m = CXRModel("densenet121", 14)
    assert sum(t.numel() for t in m.parameters()) == 16_408_462
    assert m.head.transit_conv.weight.numel() + m.head.transit_conv.bias.numel() == 9_438_208
    assert m(torch.zeros(1, 64, 64, 3), train=True).shape == (1, 14)


# ---- pretrained_npz ---------------------------------------------------------


def _torchvision_sd(trunk, seed):
    """A state dict of ``trunk`` in torchvision's key layout (the trunk's own
    names under ``features.``, plus the ``num_batches_tracked`` counters
    torchvision keeps), random values."""
    rng = np.random.default_rng(seed)
    sd = {f"features.{k}": rng.normal(size=tuple(t.shape)).astype(np.float32)
          for k, t in {**dict(trunk.named_parameters()), **dict(trunk.named_buffers())}.items()}
    sd.update({k.replace("running_mean", "num_batches_tracked"): np.asarray(3)
               for k in list(sd) if k.endswith("running_mean")})
    return sd


@pytest.mark.parametrize("arch", ["densenet121", "alexnet"])
def test_pretrained_npz_overlay(arch, tmp_path, monkeypatch):
    """A torchvision-layout state dict, converted by the unedited
    ``scripts/convert_torch_weights.py``, overlays ``CXRModel``'s trunk
    through ``driver.run`` before training; a key left out of the npz and
    a key of another shape keep their init, and so does the head."""
    from optwboundeigenval_tpu_torch.configs import chestxray_mu0_01_K0
    from optwboundeigenval_tpu_torch.train.trainer import SpectralTrainer
    from scripts.convert_torch_weights import CONVERTERS

    opts = chestxray_mu0_01_K0.options(device="cpu", enc=arch, comp_test=False,
                                       log_dir=str(tmp_path / "logs"),
                                       model_dir=str(tmp_path / "models"))
    sd = _torchvision_sd(opts["model"].features, 6)
    flat = CONVERTERS[arch](sd)
    del flat[sorted(k for k in flat if k.startswith("params/"))[0]]
    reshaped = sorted(flat)[-1]
    flat[reshaped] = np.zeros(flat[reshaped].shape + (2,), np.float32)
    np.savez(tmp_path / "w.npz", **flat)

    init = driver.build_trainer(opts)
    init.init_state()
    init = {**init.params, **init.model_state}
    seen = {}
    monkeypatch.setattr(SpectralTrainer, "train", lambda self, **kw: seen.update(
        {**self.params, **self.model_state}))
    monkeypatch.setattr(SpectralTrainer, "parse", lambda self: {})
    driver.run({**opts, "pretrained_npz": str(tmp_path / "w.npz")})
    assert sorted(seen) == sorted(init)
    kept = 0
    for name, got in seen.items():
        src = sd.get(name)
        if src is None:
            assert name.startswith("head.") and torch.equal(got, init[name]), name
        elif torch.equal(got, init[name]):
            kept += 1  # the key left out and the one reshaped
        else:
            assert torch.equal(got, torch.from_numpy(src)), name
    assert kept == 2


# ---- the configs -------------------------------------------------------------

CONFIGS = sorted(f[:-3] for f in os.listdir(os.path.join(ROOT, "optwboundeigenval_tpu", "configs"))
                 if f.endswith(".py") and not f.startswith("_"))


def test_every_config_module_is_ported():
    port = sorted(f[:-3] for f in os.listdir(os.path.join(
        ROOT, "optwboundeigenval_tpu_torch", "configs"))
        if f.endswith(".py") and not f.startswith("_"))
    assert len(CONFIGS) == 44 and port == CONFIGS


@pytest.mark.parametrize("name", CONFIGS)
def test_config_builds_a_trainer(name):
    mod = importlib.import_module(f"optwboundeigenval_tpu_torch.configs.{name}")
    opts = mod.options(device="cpu")
    trainer = driver.build_trainer(opts)
    assert trainer.device == torch.device("cpu")
    if name.startswith("chestxray"):
        assert opts["remat"] and opts["comp_test"] and not opts["test"]
        assert trainer.test_func == "accauc sigmoid"
        assert trainer.eigensolver == ("lanczos_adaptive" if "best" in name and "lobpcg"
                                       not in name else "power")
