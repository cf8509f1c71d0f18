"""The models' compute dtype: the port at bfloat16 compute over float32
parameters against the JAX package at ``dtype=jnp.bfloat16``, on the CPU.

Models: a small ``DenseNet3`` (depth 10, growth 4), a ``DenseNetFeatures``
trunk with a short ``block_config`` at 32 px under a mean-pool and dense
head, ``CNNUSPS`` with ``conv_impl='lax'`` and ``'gemm'`` and ``ForestNet``.
Weights and inputs come from a numpy seed and cross through
``utils/interop.py``.

Dtypes are checked exactly: bfloat16 logits; float32 parameters,
gradients, HVPs and vGHvs (bfloat16 for the gemm convs' leaves, which
both packages hold in the compute dtype); float32 BatchNorm statistics.

Values are held to the JAX package's own bfloat16 error: with ``jb`` the
JAX value at bfloat16, ``jf`` at float32 (same weights, same inputs; the
port's float32 value, which the other test files hold to the JAX package
at float64, stands for it),
``|port - jb| <= 3 |jb - jf| + 1e-2 max|jf|`` elementwise for the logits
and the loss, and by the 2-norm for each leaf of the gradient, the HVP,
the vGHv and a train step's update, ``||port - jb|| <= 3 ||jb - jf|| +
1e-2 ||jf||``.  A step's ``rho`` agrees within 5% relative.  XLA's CPU
backend may keep bfloat16 intermediates in float32 inside a fusion where
torch rounds at every op, which the ``3 |jb - jf|`` term absorbs.

At ``dtype=torch.float32`` every model of the port is bit-equal to
``dtype=None`` on float32 parameters.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import flax.linen as fnn

from optwboundeigenval_tpu.models import backbones as jbb
from optwboundeigenval_tpu.models.cnn_usps import CNNUSPS as JaxCNNUSPS
from optwboundeigenval_tpu.models.densenet import DenseNet3 as JaxDenseNet3
from optwboundeigenval_tpu.models.mlp_forest import ForestNet as JaxForestNet
from optwboundeigenval_tpu.ops import curvature as jcurv
from optwboundeigenval_tpu.optim import sgd as jax_sgd
from optwboundeigenval_tpu.train import SpectralTrainer as JaxTrainer
from optwboundeigenval_tpu.train.task import Task as JaxTask
from optwboundeigenval_tpu_torch.models import backbones as tbb
from optwboundeigenval_tpu_torch.models import gan
from optwboundeigenval_tpu_torch.models.cnn_usps import CNNUSPS
from optwboundeigenval_tpu_torch.models.cxr import CXRModel, DenseNet121Sigmoid
from optwboundeigenval_tpu_torch.models.densenet import DenseNet3
from optwboundeigenval_tpu_torch.models.layers import Linear
from optwboundeigenval_tpu_torch.models.logistic import LogisticRegression
from optwboundeigenval_tpu_torch.models.mlp_forest import ForestNet
from optwboundeigenval_tpu_torch.models.norm import BatchNorm2d
from optwboundeigenval_tpu_torch.models.vae import VAE
from optwboundeigenval_tpu_torch.ops import curvature as tcurv
from optwboundeigenval_tpu_torch.optim import api as topt
from optwboundeigenval_tpu_torch.train.task import Task
from optwboundeigenval_tpu_torch.train.trainer import SpectralTrainer
from optwboundeigenval_tpu_torch.utils import interop

torch.set_num_threads(1)
BF16 = torch.bfloat16
SOLVER = dict(mu=0.01, K=0.0, pow_iter_eps=0.01, max_pow_iter=50)


class JaxTrunkNet(fnn.Module):
    """A short DenseNet trunk, the spatial mean and a dense head."""
    dtype: object = jnp.float32

    @fnn.compact
    def __call__(self, x, train: bool = False):
        x = jbb.DenseNetFeatures(block_config=(1, 1), growth_rate=4, num_init_features=8,
                                 dtype=self.dtype, name="features")(x, train)
        return fnn.Dense(10, dtype=self.dtype, name="classifier")(jnp.mean(x, axis=(1, 2)))


class TrunkNet(torch.nn.Module):
    def __init__(self, dtype=None):
        super().__init__()
        self.dtype = dtype
        self.features = tbb.DenseNetFeatures((1, 1), 4, 8, dtype=dtype)
        self.classifier = Linear(self.features.out_channels, 10, compute_dtype=dtype)

    def forward(self, x, train=False, stats_out=None):
        x = x.permute(0, 3, 1, 2).to(self.dtype or self.classifier.weight.dtype)
        return self.classifier(self.features(x, train, stats_out).mean(dim=(2, 3)))


def _trunk_pairs(model):
    return (interop._trunk_pairs(model.features, "features.", ("features",))
            + [("classifier", ("classifier",), "dense")])


# name -> (JAX model at a dtype, port model at a dtype, flax tree -> port
# tree, input shape, classes, BatchNorm)
CASES = {
    "densenet3": (lambda dt: JaxDenseNet3(depth=10, growth_rate=4, dtype=dt),
                  lambda dt: DenseNet3(depth=10, growth_rate=4, dtype=dt),
                  lambda m, p, s: interop.densenet3_from_jax(p, s), (8, 32, 32, 3), 10, True),
    "densenet_trunk": (lambda dt: JaxTrunkNet(dtype=dt), lambda dt: TrunkNet(dtype=dt),
                       lambda m, p, s: interop._pairs_from_jax(_trunk_pairs(m), p, s),
                       (8, 32, 32, 3), 10, True),
    "cnnusps_lax": (lambda dt: JaxCNNUSPS(dtype=dt), lambda dt: CNNUSPS(dtype=dt),
                    lambda m, p, s: (interop.cnnusps_from_jax(p), {}), (8, 16, 16, 1), 10, False),
    "cnnusps_gemm": (lambda dt: JaxCNNUSPS(dtype=dt, conv_impl="gemm"),
                     lambda dt: CNNUSPS(conv_impl="gemm", dtype=dt),
                     lambda m, p, s: (interop.cnnusps_from_jax(p), {}), (8, 16, 16, 1), 10,
                     False),
    "forestnet": (lambda dt: JaxForestNet(dtype=dt), lambda dt: ForestNet(dtype=dt),
                  lambda m, p, s: (interop.forestnet_from_jax(p), {}), (16, 54), 7, False),
}


def _draw(name):
    """Weights (float32, the bfloat16 model's leaves in its parameter
    dtype), statistics, a batch and a tangent, all from one numpy seed."""
    jmake, _, _, shape, classes, bn = CASES[name]
    rng = np.random.default_rng(11)
    x = rng.normal(size=shape).astype(np.float32)
    shapes = jax.eval_shape(lambda x: jmake(jnp.bfloat16).init(jax.random.PRNGKey(0), x),
                            jax.ShapeDtypeStruct(shape, jnp.float32))

    def draw(path, leaf):
        key = path[-1].key
        if key == "kernel":
            v = rng.normal(size=leaf.shape) / np.sqrt(np.prod(leaf.shape[:-1]))
        elif key in ("bias", "scale"):
            v = (key == "scale") + 0.1 * rng.normal(size=leaf.shape)
        elif key == "embedding":
            v = rng.normal(size=leaf.shape)
        else:  # running statistics
            v = (key == "var") + rng.uniform(0.1, 0.5, size=leaf.shape)
        return jnp.asarray(v, jnp.float32).astype(leaf.dtype)

    p = jax.tree_util.tree_map_with_path(draw, shapes["params"])
    s = jax.tree_util.tree_map_with_path(draw, shapes.get("batch_stats", {}))
    v = jax.tree.map(lambda a: jnp.asarray(rng.normal(size=a.shape), jnp.float32)
                     .astype(a.dtype), p)
    batch = {"x": x, "y": rng.integers(0, classes, size=shape[0]).astype(np.int32),
             "w": np.ones(shape[0], np.float32)}
    return p, s, v, batch


def _jax_products(name, dtype, p, s, v, batch):
    """Train-mode logits, eval-mode logits, loss, gradient, HVP and vGHv of
    the JAX model at ``dtype``."""
    jmake, *_, bn = CASES[name]
    task = JaxTask(model=jmake(dtype), has_batch_stats=bn)
    ms = {"batch_stats": s} if bn else {}
    jb = {k: jnp.asarray(a) for k, a in batch.items()}

    @jax.jit
    def run(p, v):
        f = task.loss_fn(ms)
        out = task._apply(p, ms, jb["x"], True)
        loss, g = jax.value_and_grad(f)(p, jb)
        return (out, task.predict(p, ms, jb), loss, g, jcurv.hvp(f, p, jb, v),
                jcurv.vghv(f, p, jb, v))

    return jax.tree.map(np.asarray, run(p, v))


_CACHE = {}


def _port_products(name, dtype, p, s, v, batch):
    """The port's products at compute ``dtype`` (``None``: float32 weights,
    the float32 model)."""
    _, tmake, to_port, *_, bn = CASES[name]
    model = tmake(dtype)
    tp, ts = to_port(model, p, s)
    tv = to_port(model, v, s)[0]
    if dtype is None:
        tp, tv = ({k: t.float() for k, t in tree.items()} for tree in (tp, tv))
    task = Task(model=model, has_batch_stats=bn)
    tb = {k: torch.from_numpy(a) for k, a in batch.items()}
    f = task.loss_fn(ts)
    loss, g = tcurv.value_and_grad(f, tp, tb)
    out = dict(out=task._apply(tp, ts, tb["x"], True), pred=task.predict(tp, ts, tb),
               loss=loss, grad=g, hvp=tcurv.hvp(f, tp, tb, tv), vghv=tcurv.vghv(f, tp, tb, tv))
    if dtype is not None:
        _, lin = tcurv.linearize_hvp(f, tp, tb)
        _, rec = tcurv.recompute_hvp(f, tp, tb)
        out.update(lin=lin(tv), rec=rec(tv), micro=tcurv.hvp_microbatched(f, tp, tb, tv, 2),
                   vghv_micro=tcurv.vghv_microbatched(f, tp, tb, tv, 2),
                   stats=task.batch_stats(tp, ts, tb))
    return tp, ts, out


_CACHE = {}


def _setup(name):
    """The port's products at bfloat16 and float32 and the JAX package's at
    bfloat16, from the same weights.  The float32 value of the rule is the
    port's float32 model, which the other test files hold to the JAX
    package at float64 (1e-8 to 1e-12): at float32 the two differ by
    float32 rounding, far below the bfloat16 errors held here."""
    if name not in _CACHE:
        _, tmake, to_port, *_ = CASES[name]
        p, s, v, batch = _draw(name)
        j = _jax_products(name, jnp.bfloat16, p, s, v, batch)
        model = tmake(BF16)
        conv = lambda t: to_port(model, t, s)[0]
        jb = dict(out=j[0], pred=j[1], loss=j[2], grad=conv(j[3]), hvp=conv(j[4]),
                  vghv=conv(j[5]))
        tp, ts, port = _port_products(name, BF16, p, s, v, batch)
        f32 = _port_products(name, None, p, s, v, batch)[2]
        _CACHE[name] = (tp, ts, port, {"bf16": jb, "f32": f32})
    return _CACHE[name]


def _f32(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(t, np.float32)


def _within(got, jb, jf, what):
    """Elementwise: ``|got - jb| <= 3 |jb - jf| + 1e-2 max|jf|``."""
    got, jb, jf = _f32(got), _f32(jb), _f32(jf)
    bound = 3 * np.abs(jb - jf) + 1e-2 * np.abs(jf).max()
    err = np.abs(got - jb)
    assert (err <= bound).all(), f"{what}: worst excess {(err - bound).max():.3e}"


def _within_norm(got, jb, jf, what, whole_tree=False):
    """Each leaf by the 2-norm: ``||got - jb|| <= 3 ||jb - jf|| + 1e-2 ||jf||``;
    under ``whole_tree`` the norms are the whole tree's (see TREE_NORM)."""
    assert sorted(got) == sorted(jb), what
    if whole_tree:
        flat = lambda t: {"tree": np.concatenate([_f32(t[k]).ravel() for k in sorted(jb)])}
        got, jb, jf = flat(got), flat(jb), flat(jf)
    for k in jb:
        g, b, f = _f32(got[k]), _f32(jb[k]), _f32(jf[k])
        bound = 3 * np.linalg.norm(b - f) + 1e-2 * np.linalg.norm(f)
        err = np.linalg.norm(g - b)
        assert err <= bound, f"{what} {k}: {err:.3e} > {bound:.3e}"


# Where the bound is loosened, from each leaf's norm to the whole tree's:
# the curvature products of the models with lax convolutions, and the
# lax CNNUSPS's gradient.  The port takes its HVP reverse over reverse, the
# JAX package forward over reverse, and at bfloat16 the two round at other
# intermediates: torch rounds every op of a conv's double backward, and of
# the pooling and loss-head derivatives, to bfloat16, where XLA's CPU
# fusions keep float32 inside.  Measured on these weights: single leaves
# (a conv bias, a bias behind a BatchNorm, the classifier's bias) carry
# 4-14x JAX's own distance to float32, while over the whole tree the
# port's distance to JAX's bfloat16 value stays at 0.3-0.96 of the bound.
# The gemm CNNUSPS and ForestNet (no lax convs) hold the bound leaf by
# leaf at 0.03-0.3 of it.
TREE_NORM = {("cnnusps_lax", what) for what in ("grad", "hvp", "vghv")} | {
    (name, what) for name in ("densenet3", "densenet_trunk") for what in ("hvp", "vghv")}


@pytest.mark.parametrize("name", sorted(CASES))
def test_dtypes_follow_flax(name):
    tp, ts, port, _ = _setup(name)
    gemm = name == "cnnusps_gemm"
    want = {k: (BF16 if gemm and k.startswith("conv") else torch.float32) for k in tp}
    assert {k: t.dtype for k, t in tp.items()} == want
    assert port["out"].dtype == BF16 and port["pred"].dtype == BF16
    assert port["loss"].dtype == BF16  # cross entropy keeps the logits' dtype
    for what in ("grad", "hvp", "vghv", "lin", "rec", "micro", "vghv_micro"):
        assert {k: t.dtype for k, t in port[what].items()} == want, what
    assert all(t.dtype == torch.float32 for t in ts.values())
    assert all(t.dtype == torch.float32 for t in port["stats"].values())
    assert bool(port["stats"]) == CASES[name][-1]


@pytest.mark.parametrize("name", sorted(CASES))
def test_forward_and_loss_match_jax_bf16(name):
    _, _, port, j = _setup(name)
    for what in ("out", "pred", "loss"):
        _within(port[what], j["bf16"][what], j["f32"][what], f"{name} {what}")


@pytest.mark.parametrize("name", sorted(CASES))
def test_gradient_hvp_vghv_match_jax_bf16(name):
    _, _, port, j = _setup(name)
    for what, jwhat in (("grad", "grad"), ("hvp", "hvp"), ("lin", "hvp"), ("rec", "hvp"),
                        ("micro", "hvp"), ("vghv", "vghv"), ("vghv_micro", "vghv")):
        if name in ("densenet3", "densenet_trunk") and what in ("micro", "vghv_micro"):
            continue  # BatchNorm statistics per micro-batch: another function
        _within_norm(port[what], j["bf16"][jwhat], j["f32"][jwhat], f"{name} {what}",
                     (name, jwhat) in TREE_NORM)


def _port_trainer(name, dtype, hvp_micro, p, s):
    _, tmake, to_port, *_, bn = CASES[name]
    model = tmake(dtype)
    tr = SpectralTrainer(Task(model=model, has_batch_stats=bn), topt.sgd(0.1),
                         hvp_micro=hvp_micro, device="cpu", **SOLVER)
    tr.params, tr.model_state = to_port(model, p, s)
    if dtype is None:  # the float32 model: every leaf float32
        tr.params = {k: t.float() for k, t in tr.params.items()}
    tr.opt_state = tr.optimizer.init(tr.params)
    tr.v = {k: torch.full_like(t, 1 / np.sqrt(tr.ndim)) for k, t in tr.params.items()}
    return tr


@pytest.mark.parametrize("name", ["densenet3", "cnnusps_gemm", "forestnet"])
def test_train_step_hvp_micro2_matches_jax_bf16(name):
    """One ``train_step`` with ``hvp_micro=2`` (K1's plain version on the
    CPU: float32 leaves, and bfloat16 ones for the gemm convs) against the
    JAX trainer's bfloat16 step from the same weights and ``v``: ``rho``
    within 5%, each leaf's update within the rule.  The float32 value of
    the rule is the port's own float32 step (dtype None), which
    tests/test_torch_trainer.py holds to the JAX trainer at float64; at
    float32 the two differ by float32 rounding, far below the bfloat16
    errors held here.

    The JAX trainer refuses the gemm CNNUSPS at bfloat16 (its eigensolver's
    loop carry would turn the bfloat16 leaves float32), so there the JAX
    bfloat16 step is that of the ``'lax'`` form, the same function with
    float32 convs; the reference update is rounded as a bfloat16 leaf holds
    ``p + u``, and the bound has one unit in the last place of each value
    such a leaf holds: the port's SGD rounds ``lr * d`` and then ``p - lr *
    d`` in the leaf's dtype, where optax adds a float32 update and rounds
    once."""
    jmake, _, to_port, *_, bn = CASES[name]
    p, s, _, batch = _draw(name)
    gemm = name == "cnnusps_gemm"
    jtr = JaxTrainer(JaxTask(model=JaxCNNUSPS(dtype=jnp.bfloat16) if gemm else
                             jmake(jnp.bfloat16), has_batch_stats=bn),
                     jax_sgd(0.1), hvp_micro=2, **SOLVER)
    jtr.init_state(batch)
    jtr.params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), p) if gemm else p
    jtr.model_state = {"batch_stats": s} if bn else {}
    jtr.opt_state = jtr.optimizer.init(jtr.params)
    jtr.v = jax.tree.map(lambda a: jnp.full_like(a, 1 / np.sqrt(sum(
        x.size for x in jax.tree.leaves(p)))), jtr.params)
    ttr, tf32 = (_port_trainer(name, dt, 2, p, s) for dt in (BF16, None))
    p0 = {k: t.clone() for k, t in ttr.params.items()}
    tm, fm, jm = ttr.train_step(batch), tf32.train_step(batch), jtr.train_step(batch)
    assert tm["step_ok"] and fm["step_ok"] and jm["step_ok"]
    rho, jrho = tm["rho"], float(jm["rho"])
    assert jrho > 0 and abs(rho - jrho) <= 0.05 * abs(jrho), (rho, jrho)
    assert {k: t.dtype for k, t in ttr.params.items()} == {k: t.dtype for k, t in p0.items()}
    upd = {k: ttr.params[k].float() - p0[k].float() for k in p0}
    f_upd = {k: tf32.params[k] - p0[k].float() for k in p0}
    j0 = to_port(ttr.task.model, p, s)[0]
    j_upd = {k: t.float() - j0[k].float() for k, t in
             to_port(ttr.task.model, jax.tree.map(np.asarray, jtr.params), s)[0].items()}
    if not gemm:
        _within_norm(upd, j_upd, f_upd, f"{name} update")
    else:
        for k in p0:
            want = (p0[k].float() + f_upd[k]).to(p0[k].dtype).float() - p0[k].float()
            x = _f32(p0[k])
            ulp = torch.finfo(p0[k].dtype).eps * 2.0 ** np.floor(np.log2(np.abs(x) + 1e-30))
            err = np.linalg.norm(_f32(upd[k]) - _f32(want))
            bound = (3 * np.linalg.norm(_f32(j_upd[k] - f_upd[k]))
                     + 1e-2 * np.linalg.norm(_f32(want))
                     + (np.linalg.norm(ulp) if p0[k].dtype == BF16 else 0.0))
            assert err <= bound, f"{name} update {k}: {err:.3e} > {bound:.3e}"
    if bn:
        want = to_port(ttr.task.model, p, jtr.model_state["batch_stats"])[1]
        for k, t in ttr.model_state.items():
            assert t.dtype == torch.float32, k
            np.testing.assert_allclose(t.numpy(), np.asarray(want[k], np.float32),
                                       rtol=2e-2, atol=2e-2, err_msg=k)


# ---- dtype=torch.float32 is dtype=None, bit for bit ---------------------------

def _cxr(dtype):
    return CXRModel("densenet121", outnum=3, dtype=dtype)


ALL_MODELS = {
    "densenet3": (lambda dt: DenseNet3(depth=10, growth_rate=4, dtype=dt), (2, 32, 32, 3)),
    "densenet3_basic_dropout": (lambda dt: DenseNet3(depth=7, growth_rate=4, bottleneck=False,
                                                     dtype=dt), (2, 32, 32, 3)),
    "cxr_densenet121": (_cxr, (2, 32, 32, 3)),
    "cxr_vgg16_bn": (lambda dt: CXRModel("vgg16_bn", outnum=3, dtype=dt), (2, 32, 32, 3)),
    "cxr_resnet50": (lambda dt: CXRModel("resnet50", outnum=3, dtype=dt), (2, 32, 32, 3)),
    "cxr_alexnet": (lambda dt: CXRModel("alexnet", outnum=3, dtype=dt), (2, 67, 67, 3)),
    "densenet121_sigmoid": (lambda dt: DenseNet121Sigmoid(3, dtype=dt), (2, 32, 32, 3)),
    "cnnusps_lax": (lambda dt: CNNUSPS(dtype=dt), (2, 16, 16, 1)),
    "cnnusps_gemm": (lambda dt: CNNUSPS(conv_impl="gemm", dtype=dt), (2, 16, 16, 1)),
    "forestnet": (lambda dt: ForestNet(dtype=dt), (2, 54)),
    "logistic": (lambda dt: LogisticRegression(12, dtype=dt), (2, 2, 2, 3)),
    "vae": (lambda dt: VAE(ForestNet(dtype=dt), znum=4, hnum=8, outnum=3, in_features=7,
                           dtype=dt), (2, 54)),
}


def _same(a, b, what):
    assert a.dtype == b.dtype and torch.equal(a, b), what


@pytest.mark.parametrize("name", sorted(ALL_MODELS))
def test_float32_compute_is_bit_equal_to_none(name):
    make, shape = ALL_MODELS[name]
    torch.manual_seed(0)
    m0, m1 = make(None), make(torch.float32)
    m1.load_state_dict(m0.state_dict())
    x = torch.from_numpy(np.random.default_rng(2).normal(size=shape).astype(np.float32))
    for train in (True, False):
        kw = {"noise": torch.zeros(2, 4)} if name == "vae" and train else {}
        outs = [m(x, train, **kw) for m in (m0, m1)]
        outs = [o if isinstance(o, tuple) else (o,) for o in outs]
        for a, b in zip(*outs):
            _same(a, b, f"{name} train={train}")
    loss = [(m(x, True, **({"noise": torch.zeros(2, 4)} if name == "vae" else {})))
            for m in (m0, m1)]
    loss = [(o[0] if isinstance(o, tuple) else o).square().sum() for o in loss]
    grads = [torch.autograd.grad(lo, list(m.parameters())) for lo, m in zip(loss, (m0, m1))]
    for a, b in zip(*grads):
        _same(a, b, f"{name} gradient")


GANS = {
    "mlp_generator": (lambda dt: gan.MLPGenerator(n=8, dtype=dt), "gen"),
    "mlp_discriminator": (lambda dt: gan.MLPDiscriminator(n=8, dtype=dt), "disc"),
    "dc_generator": (lambda dt: gan.DCGenerator(feat=4, dtype=dt), "gen"),
    "dc_discriminator": (lambda dt: gan.DCDiscriminator(feat=4, dtype=dt), "disc"),
}


def _gan_args(kind, model, train):
    rng = np.random.default_rng(5)
    labels = torch.arange(4) % 10
    if kind == "gen":
        return (torch.from_numpy(rng.normal(size=(4, 100)).astype(np.float32)), labels, train)
    size = 32 if isinstance(model, gan.DCDiscriminator) else 16
    img = torch.from_numpy(rng.normal(size=(4, size, size, 1)).astype(np.float32))
    keep = [torch.from_numpy(rng.random((4,) + s) < 0.6) for s in model.dropout_shapes]
    return (img, labels, train) + ((keep,) if keep and train else ())


@pytest.mark.parametrize("name", sorted(GANS))
def test_gan_float32_bit_equal_and_bf16_dtypes(name):
    make, kind = GANS[name]
    torch.manual_seed(0)
    m0, m1, mb = make(None), make(torch.float32), make(BF16)
    m1.load_state_dict(m0.state_dict())
    mb.load_state_dict(m0.state_dict())
    for train in (True, False):
        a, b = (m(*_gan_args(kind, m, train)) for m in (m0, m1))
        _same(a, b, f"{name} train={train}")
        out = mb(*_gan_args(kind, mb, train))
        assert out.dtype == BF16 and torch.isfinite(out.float()).all()
        # a sanity bound, not a reference: bfloat16 keeps ~3 digits, a lost
        # cast or a statistic in bfloat16 shows as O(1)
        err = (out.float() - a).abs().max().item()
        assert err <= 5e-2 * a.abs().max().item(), f"{name} train={train}: {err:.3e}"
    assert all(t.dtype == torch.float32 for t in mb.state_dict().values())


def test_batchnorm_bf16_reduces_in_float32_and_returns_bf16():
    torch.manual_seed(0)
    bn0, bnb = BatchNorm2d(3), BatchNorm2d(3, dtype=BF16)
    x = (torch.randn(4, 3, 5, 5) * 3 + 40).to(BF16)  # a mean large against the spread
    stats0, statsb = {}, {}
    y0 = bn0(x.float(), True, stats0)
    yb = bnb(x, True, statsb)
    assert yb.dtype == BF16
    assert torch.equal(yb, y0.to(BF16))  # float32 throughout, one rounding at the end
    for a, b in zip(stats0[bn0], statsb[bnb]):
        assert b.dtype == torch.float32 and torch.equal(a, b)
    assert torch.equal(bnb(x, False), bn0(x.float(), False).to(BF16))
