"""The port's analysis path against the JAX package on the CPU: the guided
ReLU, the three map generators (input gradients, guided backprop,
Grad-CAM) on CNNUSPS, a small DenseNet3 and a small-trunk CXR model,
the jet overlay, the PR-curve cutoffs, the Jaccard audits, covariate-
shift testing, the distance tools, the MNIST and generated-set loaders,
the driver's analysis routes and the scripts' ``main``.

Maps agree to rtol 1e-10 at float64 (same math, other summation order);
masks, Jaccards, CSVs, shift indices and constructed sets are equal;
the float32 meta-classifier agrees to rtol 1e-4 and the float32
distances to rtol 1e-5.
"""

import os
import sys
import types

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from sklearn.metrics import f1_score, precision_recall_curve as sk_prc

from optwboundeigenval_tpu.analysis import cov_shift as jcs
from optwboundeigenval_tpu.analysis import distance as jdist
from optwboundeigenval_tpu.analysis import jaccard as jjac
from optwboundeigenval_tpu.analysis.grad_cam import grad_cam as jgrad_cam
from optwboundeigenval_tpu.analysis.grad_cam import show_cam_on_image as jshow_cam
from optwboundeigenval_tpu.analysis.guided_backprop import generate_gradients as jguided
from optwboundeigenval_tpu.analysis.saliency import batch_saliency as jsaliency
from optwboundeigenval_tpu.data import usps as jusps
from optwboundeigenval_tpu.data.loaders import ArrayLoader as JaxLoader
from optwboundeigenval_tpu.models import activations as jact
from optwboundeigenval_tpu.models import backbones as jbb
from optwboundeigenval_tpu.models.cnn_usps import CNNUSPS as JaxCNNUSPS
from optwboundeigenval_tpu.models.cxr import TransitHead as JaxTransitHead
from optwboundeigenval_tpu.models.densenet import DenseNet3 as JaxDenseNet3
from optwboundeigenval_tpu.models.mlp_forest import ForestNet as JaxForestNet
from optwboundeigenval_tpu.optim import sgd as jax_sgd
from optwboundeigenval_tpu.train import SpectralTrainer as JaxTrainer
from optwboundeigenval_tpu.train import driver as jdriver
from optwboundeigenval_tpu.train.task import Task as JaxTask
from optwboundeigenval_tpu_torch.analysis import cov_shift, distance, jaccard
from optwboundeigenval_tpu_torch.analysis.grad_cam import grad_cam, jet, show_cam_on_image
from optwboundeigenval_tpu_torch.analysis.guided_backprop import generate_gradients
from optwboundeigenval_tpu_torch.analysis.saliency import batch_saliency
from optwboundeigenval_tpu_torch.data import usps
from optwboundeigenval_tpu_torch.data.loaders import ArrayLoader
from optwboundeigenval_tpu_torch.data.synthetic import make_classification, make_images
from optwboundeigenval_tpu_torch.models import activations
from optwboundeigenval_tpu_torch.models import backbones as tbb
from optwboundeigenval_tpu_torch.models.cnn_usps import CNNUSPS
from optwboundeigenval_tpu_torch.models.cxr import CXRModel, TransitHead
from optwboundeigenval_tpu_torch.models.densenet import DenseNet3
from optwboundeigenval_tpu_torch.models.mlp_forest import ForestNet
from optwboundeigenval_tpu_torch.optim.api import sgd
from optwboundeigenval_tpu_torch.train import driver
from optwboundeigenval_tpu_torch.train.task import Task
from optwboundeigenval_tpu_torch.train.trainer import CKPT_BEST, SpectralTrainer
from optwboundeigenval_tpu_torch.utils import interop

torch.set_num_threads(1)
RTOL = 1e-10


def _close(got, want, rtol=RTOL):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * max(np.abs(want).max(), 1e-30))


def _jax_vars(module, x, seed=0):
    """float64 flax variables of ``module`` at ``x`` from ``seed`` (shapes
    from flax, nothing compiled): kernels ``N(0, 1 / fan_in)``, biases
    ``N(0, 0.01)``, BatchNorm scales ``1 + N(0, 0.01)``, running means
    ``N(0, 0.01)`` (centred: a DenseNet3 whose last BatchNorm subtracts more
    than its input holds is dead after the ReLU, every map 0) and
    variances in ``[1.1, 1.5)``."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda x: module.init(jax.random.PRNGKey(0), x, train=False),
                            jax.ShapeDtypeStruct(x.shape, jnp.float64))

    def draw(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "kernel":
            return rng.normal(size=shape) / np.sqrt(np.prod(shape[:-1]))
        if name in ("bias", "scale", "mean"):
            return (name == "scale") + 0.1 * rng.normal(size=shape)
        return 1.0 + rng.uniform(0.1, 0.5, size=shape)

    p = jax.tree_util.tree_map_with_path(draw, shapes["params"])
    s = jax.tree_util.tree_map_with_path(draw, shapes.get("batch_stats", {}))
    return p, s


# ---- the guided ReLU ----------------------------------------------------------


def test_guided_relu_backward_is_exact():
    """Ties at x = 0 (either sign of zero) and negative upstream gradients:
    bit-equal to the JAX package's custom VJP."""
    x = np.array([-1.0, 0.0, -0.0, 0.0, 2.0, 3.0, 1e-300, 5.0, -2.0, 7.0])
    g = np.array([1.0, 1.0, 2.0, -1.0, -2.0, 4.0, 2.0, 0.0, -3.0, 1e-300])
    _, vjp = jax.vjp(jact.guided_relu, jnp.asarray(x))
    want = np.asarray(vjp(jnp.asarray(g))[0])
    xt = torch.tensor(x, requires_grad=True)
    with activations.guided():
        out = activations.relu(xt)
    out.backward(torch.tensor(g))
    np.testing.assert_array_equal(out.detach().numpy(), np.maximum(x, 0))
    np.testing.assert_array_equal(xt.grad.numpy(), want)


def test_plain_relu_outside_guided():
    """Outside the context (the training step) ``relu`` is ``F.relu``: the
    negative upstream gradient passes where x > 0."""
    x = torch.tensor([1.0, -1.0, 2.0], requires_grad=True)
    with activations.guided():
        pass
    activations.relu(x).backward(torch.tensor([-3.0, 5.0, 2.0]))
    assert x.grad.tolist() == [-3.0, 0.0, 2.0]
    assert activations._GUIDED.get() is False


# ---- the three maps -------------------------------------------------------------


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


# name: (JAX model, port model, input shape, JAX Grad-CAM layer, weights to the port)
MODELS = {
    "cnnusps": (lambda: JaxCNNUSPS(dtype=jnp.float64), lambda: CNNUSPS().double(),
                (4, 16, 16, 1), "Conv_2", lambda m, p, s: (interop.cnnusps_from_jax(p), {})),
    "densenet3": (lambda: JaxDenseNet3(depth=10, growth_rate=4, dtype=jnp.float64),
                  lambda: DenseNet3(depth=10, growth_rate=4).double(), (3, 32, 32, 3),
                  "TransitionBlock_1", lambda m, p, s: interop.densenet3_from_jax(p, s)),
    "cxr": (JaxSmallCXR, lambda: SmallCXR().double(), (2, 48, 48, 3), "features",
            lambda m, p, s: interop.from_jax(m, p, s)),
}


@pytest.fixture(scope="module", params=sorted(MODELS))
def model_case(request):
    jmake, tmake, shape, jlayer, to_port = MODELS[request.param]
    x = np.random.default_rng(5).normal(size=shape)
    jm, tm = jmake(), tmake()
    p, s = _jax_vars(jm, x, seed=7)
    tp, ts = to_port(tm, p, s)
    jtask = JaxTask(model=jm, has_batch_stats=bool(s))
    jstate = {"batch_stats": s} if s else {}
    return jtask, p, jstate, Task(model=tm), tp, ts, x, jlayer


@pytest.mark.parametrize("method", ["saliency", "guided", "gradcam"])
def test_maps_match_jax(model_case, method):
    jtask, p, js, ttask, tp, ts, x, jlayer = model_case
    xj = jnp.asarray(x)
    if method == "saliency":
        want, got = jsaliency(jtask, p, js, xj), batch_saliency(ttask, tp, ts, x)
    elif method == "guided":
        want, got = jguided(jtask, p, js, xj), generate_gradients(ttask, tp, ts, x)
        plain = batch_saliency(ttask, tp, ts, x)
        assert plain.max() > 0  # a live network
        assert not np.allclose(np.abs(got.numpy()), plain.numpy())  # the swap acts
    else:
        layer = interop.module_names(ttask.model)[jlayer]
        want, got = jgrad_cam(jtask, p, js, xj, jlayer), grad_cam(ttask, tp, ts, x, layer)
        assert got.shape == x.shape[:3] and np.all(got >= 0)
    _close(got, want)


def test_maps_take_a_target_class(model_case):
    jtask, p, js, ttask, tp, ts, x, jlayer = model_case
    _close(batch_saliency(ttask, tp, ts, x, target_class=1),
           jsaliency(jtask, p, js, jnp.asarray(x), target_class=1))
    _close(generate_gradients(ttask, tp, ts, x, target_class=[1, 0] + [2] * (len(x) - 2)),
           jguided(jtask, p, js, jnp.asarray(x), jnp.asarray([1, 0] + [2] * (len(x) - 2))))


def test_grad_cam_unknown_layer_raises():
    task = Task(model=CNNUSPS())
    params = {k: t.detach() for k, t in task.model.named_parameters()}
    x = np.zeros((2, 16, 16, 1), np.float32)
    for name in ("NoSuchLayer", "Conv_2", "conv3.weight"):
        with pytest.raises(KeyError):
            grad_cam(task, params, {}, x, name)


def test_module_names_reach_every_flax_scope():
    names = interop.module_names(CNNUSPS())
    assert names["Conv_2"] == "conv3" and names["Dense_1"] == "fc2"
    names = interop.module_names(DenseNet3(depth=16, growth_rate=4))
    assert names["BottleneckBlock_3"] == "block2.layer.1"
    assert names["TransitionBlock_1"] == "trans2"
    assert names["BottleneckBlock_3/Conv_1"] == "block2.layer.1.conv2"
    names = interop.module_names(CXRModel("resnet50", 3))
    assert names["features"] == "features" and names["head"] == "head"
    assert names["features/_Bottleneck_5"] == "features.layer2.2"
    model = CXRModel("resnet50", 3)
    for flax_path, name in names.items():
        model.get_submodule(name)


def test_jet_and_overlay_match_matplotlib_and_jax():
    import matplotlib.cm as cm

    mask = np.concatenate([np.linspace(0, 1, 1001), [-0.5, 1.5, 0.3, 0.99999]]).reshape(5, -1)
    np.testing.assert_array_equal(jet(mask), cm.jet(mask))
    rng = np.random.default_rng(0)
    img, m = rng.random((16, 16)), rng.random((16, 16))
    np.testing.assert_array_equal(show_cam_on_image(img, m), jshow_cam(img, m))
    img3 = rng.random((16, 16, 1))
    np.testing.assert_array_equal(show_cam_on_image(img3, m, alpha=0.3),
                                  jshow_cam(img3, m, alpha=0.3))


# ---- cutoffs and the audits -------------------------------------------------------


def test_precision_recall_curve_matches_sklearn():
    rng = np.random.default_rng(3)
    for n in (1, 7, 50):
        y = (rng.random(n) < 0.4).astype(np.float64)
        s = np.round(rng.random(n), 1)  # ties
        for got, want in zip(jaccard.precision_recall_curve(y, s), sk_prc(y, s)):
            np.testing.assert_array_equal(got, want)


def test_f1_max_cutoffs_match_jax():
    rng = np.random.default_rng(4)
    labels = (rng.random((120, 5)) < 0.4).astype(np.float64)
    labels[rng.random((120, 5)) < 0.15] = np.nan
    labels[:, 3] = np.where(np.isnan(labels[:, 3]), np.nan, 1.0)  # one value
    scores = np.round(labels * 0.3 + rng.random((120, 5)) * 0.7, 2)  # ties
    scores[:, 4] = 0.5  # all tied
    got = jaccard.f1_max_cutoffs(labels, scores)
    np.testing.assert_array_equal(got, jjac.f1_max_cutoffs(labels, scores))
    assert got[3] == 0.5


def _usps_pair(tmp_path, n_classes, seed):
    """A port trainer and its JAX stand-in (what ``jaccard`` reads: task,
    params, state, header2) with the same float64 CNNUSPS weights."""
    jm = JaxCNNUSPS(num_classes=n_classes, dtype=jnp.float64)
    p, _ = _jax_vars(jm, np.zeros((1, 16, 16, 1)), seed=seed)
    tr = SpectralTrainer(Task(model=CNNUSPS(num_classes=n_classes).double()), sgd(0.1),
                         header=f"M{seed}", batch_size=8, device="cpu",
                         log_dir=str(tmp_path / "logs"), model_dir=str(tmp_path / "models"))
    tr.init_state()
    tr.params = interop.cnnusps_from_jax(p)
    jtr = types.SimpleNamespace(task=JaxTask(model=jm), params=p, model_state={},
                                header2=tr.header2)
    return tr, jtr


@pytest.mark.parametrize("kind,method", [("multiclass", "saliency"),
                                         ("multiclass", "gradcam"),
                                         ("multilabel", "guided")])
def test_jaccard_audit_and_comp_match_jax(tmp_path, kind, method):
    n_classes = 10 if kind == "multiclass" else 14
    rng = np.random.default_rng(8)
    x = rng.normal(size=(20, 16, 16, 1))
    if kind == "multiclass":
        y = rng.integers(0, 10, 20)
    else:
        y = (rng.random((20, 14)) < 0.3).astype(np.float64)
        y[rng.random((20, 14)) < 0.1] = np.nan
    (tr, jtr), (base, jbase), (third, jthird) = (_usps_pair(tmp_path, n_classes, s)
                                                 for s in (1, 2, 3))
    layer = {"gradcam": ("conv3", "Conv_2")}.get(method, (None, None))
    dirs = lambda side: dict(log_dir=str(tmp_path / side / "logs"),
                             plot_dir=str(tmp_path / side / "plots"))
    got = jaccard.jaccard_audit(tr, base, ArrayLoader(x, y, 8), method=method,
                                layer_path=layer[0], max_img=2, train_meta=True,
                                **dirs("port"))
    want = jjac.jaccard_audit(jtr, jbase, JaxLoader(x, y, 8), method=method,
                              layer_path=layer[1], max_img=2, train_meta=True,
                              **dirs("jax"))
    for k in ("jaccard", "conditioned", "counts"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k in ("cutoffs_model", "cutoffs_baseline"):  # the models' outputs, to rounding
        if kind == "multiclass":
            assert got[k] is None and want[k] is None
        else:
            _close(got[k], want[k])
    for k in ("w", "b"):
        np.testing.assert_allclose(got["meta"][k], want["meta"][k], rtol=1e-4,
                                   atol=1e-4 * np.abs(want["meta"][k]).max())
    for tail in ("cond", "counts", "values"):
        name = f"{tr.header2}_jaccard_{tail}.csv"
        with open(tmp_path / "port" / "logs" / name) as a, \
                open(tmp_path / "jax" / "logs" / name) as b:
            assert a.read() == b.read(), name
    got = jaccard.jaccard_comp([tr, base, third], ArrayLoader(x, y, 8), method=method,
                               layer_path=layer[0], log_dir=str(tmp_path / "port" / "logs"))
    want = jjac.jaccard_comp([jtr, jbase, jthird], JaxLoader(x, y, 8), method=method,
                             layer_path=layer[1], log_dir=str(tmp_path / "jax" / "logs"))
    np.testing.assert_array_equal(got, want)
    with open(tmp_path / "port" / "logs" / "jaccard_comp.csv") as a, \
            open(tmp_path / "jax" / "logs" / "jaccard_comp.csv") as b:
        assert a.read() == b.read()


def test_audit_writes_csvs_without_matplotlib(tmp_path, monkeypatch, capsys):
    """Only the figures need matplotlib: without it one line says so and
    the CSVs are written all the same."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    (tr, _), (base, _) = (_usps_pair(tmp_path, 10, s) for s in (1, 2))
    x = np.random.default_rng(9).normal(size=(8, 16, 16, 1))
    jaccard.jaccard_audit(tr, base, ArrayLoader(x, np.arange(8) % 10, 8),
                          log_dir=str(tmp_path / "logs"), plot_dir=str(tmp_path / "plots"))
    assert "figures skipped, matplotlib is not installed" in capsys.readouterr().out
    assert os.path.exists(tmp_path / "logs" / f"{tr.header2}_jaccard_values.csv")
    assert not os.path.exists(tmp_path / "plots")
    assert cov_shift.cov_shift_plots(np.zeros((1, 3)), np.ones((2, 3)), ["m"]) is None


# ---- covariate shift ------------------------------------------------------------


def test_get_prob_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(30, 5)) * 3
    for m, sd, skew in (([0.5], [1.2], [0]), ([0.0], [1.0], [1.5]),
                        (rng.normal(size=5), 1 + rng.random(5), rng.normal(size=5))):
        np.testing.assert_array_equal(cov_shift.get_prob(x, m, sd, skew),
                                      jcs.get_prob(x, m, sd, skew))


def test_f1_micro_weighted_matches_sklearn():
    rng = np.random.default_rng(1)
    y, p, w = rng.integers(0, 4, 50), rng.integers(0, 4, 50), rng.random(50)
    _close(cov_shift.f1_micro_weighted(y, p, w),
           f1_score(y, p, average="micro", sample_weight=w))


def _forest_pair(tmp_path, seed):
    """A port and a JAX Forest trainer with the same float64 best checkpoint."""
    x, y = make_classification(64, 8, 3, seed=0)
    jm = JaxForestNet(hidden=8, num_classes=3, dtype=jnp.float64)
    p, _ = _jax_vars(jm, x, seed=seed)
    kw = dict(header=f"CS{seed}", batch_size=32, log_dir=str(tmp_path / "logs"),
              model_dir=str(tmp_path / "models"))
    jtr = JaxTrainer(JaxTask(model=jm), jax_sgd(0.1), **kw)
    jtr.init_state({"x": x[:32], "y": y[:32], "w": np.ones(32, np.float32)})
    jtr.params = jax.tree.map(jnp.asarray, p)
    jtr.save("_trained_model_best.msgpack")
    tr = SpectralTrainer(Task(model=ForestNet(hidden=8, num_classes=3, in_features=8).double()),
                         sgd(0.1), device="cpu", **kw)
    tr.init_state()
    tr.params = interop.forestnet_from_jax(p)
    tr.save(CKPT_BEST)
    tr.params = None  # model_load must bring them back
    tr.init_state()
    return tr, jtr


def test_cov_shift_matches_jax(tmp_path):
    rng = np.random.default_rng(2)
    x, y = make_classification(96, 8, 3, seed=5)
    (tr1, jtr1), (tr2, jtr2) = _forest_pair(tmp_path, 1), _forest_pair(tmp_path, 2)
    shift = dict(test_mean=rng.normal(size=8) * 0.2, test_sd=[1.1], test_skew=[0.5])
    got = cov_shift.test_model_best_cov(tr1, x, y, **shift)
    want = jcs.test_model_best_cov(jtr1, x, y, **shift)
    _close(got, want)
    assert got[3] <= 1.0 <= got[4]

    kw = dict(iters=5, bad_modes=[6, 7], header="T", mult=0.3, mean_diff=1.0,
              sd_diff=0.2, skew_diff=1.0, seed=11)
    got = cov_shift.cov_shift_tester([tr1, tr2], x, y, log_dir=str(tmp_path / "port"), **kw)
    want = jcs.cov_shift_tester([jtr1, jtr2], x, y, log_dir=str(tmp_path / "jax"), **kw)
    np.testing.assert_array_equal(got[2], want[2])  # the indices
    _close(got[0], want[0])
    _close(got[1], want[1])
    for tail in ("acc", "f1"):
        _close(np.loadtxt(tmp_path / "port" / f"T_cov_shift_{tail}.csv", delimiter=","),
               np.loadtxt(tmp_path / "jax" / f"T_cov_shift_{tail}.csv", delimiter=","))
    assert (open(tmp_path / "port" / "T_cov_shift_indices.csv").read()
            == open(tmp_path / "jax" / "T_cov_shift_indices.csv").read())
    # the indices read back, appended
    idx_csv = str(tmp_path / "port" / "T_cov_shift_indices.csv")
    again = cov_shift.cov_shift_tester([tr1], x, y, iters=5, indices=idx_csv, header="T",
                                       mean_diff=1.0, sd_diff=0.2, skew_diff=1.0,
                                       append=True, log_dir=str(tmp_path / "port"))
    np.testing.assert_array_equal(again[0], got[0][:1])
    rows, comps = cov_shift.slope_comparison(got[0], got[2], ["a", "b"])
    jrows, jcomps = jcs.slope_comparison(want[0], want[2], ["a", "b"])
    for r, jr in zip(rows + comps, jrows + jcomps):
        assert r.keys() == jr.keys()
        for k in r:
            if isinstance(r[k], str):
                assert r[k] == jr[k]
            else:
                _close(r[k], jr[k])
    out = cov_shift.cov_shift_plots(got[0], got[2], ["a", "b"],
                                    out_path=str(tmp_path / "plots" / "cs.png"))
    assert os.path.exists(out)


# ---- distances -------------------------------------------------------------------


def test_nearest_distances_match_jax():
    rng = np.random.default_rng(0)
    a = rng.normal(size=(20, 7)).astype(np.float32)
    b = rng.normal(size=(15, 7)).astype(np.float32)
    for dist in ("euclid", "cosine"):
        got = distance.nearest_distances(a, b, dist, device="cpu")
        np.testing.assert_allclose(got, jdist.nearest_distances(a, b, dist), rtol=1e-5)
    with pytest.raises(ValueError):
        distance.nearest_distances(a, b, "manhattan", device="cpu")


def _far_from_edges(ref, pool, dist):
    """The pool's rows whose distance to ``ref`` (float64) is at least 1e-3
    from every bin edge."""
    a, b = ref.reshape(len(ref), -1).astype(np.float64), pool.reshape(len(pool), -1)
    if dist == "euclid":
        d = np.sqrt(((b[:, None, :] - a[None]) ** 2).sum(-1)).min(axis=1)
        off = np.abs(d - np.round(d))
    else:
        an = a / np.linalg.norm(a, axis=1, keepdims=True)
        bn = b / np.linalg.norm(b, axis=1, keepdims=True)
        d = (bn @ an.T).max(axis=1)
        off = np.abs((d - 0.5) / 0.025 - np.round((d - 0.5) / 0.025)) * 0.025
    return off > 1e-3, off


@pytest.mark.parametrize("dist,minmax", [("euclid", False), ("cosine", False),
                                         ("cosine", True)])
def test_create_dist_dataset_matches_jax(tmp_path, dist, minmax):
    rng = np.random.default_rng(3)
    ref = rng.random((30, 16, 16, 1)).astype(np.float32)
    pools = []
    for k in (1, 2):
        # near copies of the reference rows at spread distances
        p = (ref[rng.integers(0, 30, 90)] + rng.normal(size=(90, 16, 16, 1))
             * rng.uniform(0.02, 0.6, (90, 1, 1, 1))).astype(np.float32)
        keep, _ = _far_from_edges(ref, p, dist)
        pools.append((p[keep], rng.integers(0, 10, int(keep.sum()))))
        assert np.all(_far_from_edges(ref, pools[-1][0], dist)[1] > 1e-4)
    kw = dict(dist=dist, zeroes=2, minmax=minmax, name=f"constructed_{dist}", seed=4)
    got = distance.create_dist_dataset(ref, *pools, data_dir=str(tmp_path / "port"),
                                       plot_dir=str(tmp_path / "plots"), device="cpu", **kw)
    want = jdist.create_dist_dataset(ref, *pools, data_dir=str(tmp_path / "jax"),
                                     plot_dir=str(tmp_path / "plots"), **kw)
    with np.load(got) as g, np.load(want) as w:
        assert g["x"].dtype == w["x"].dtype == np.float32 and g["x"].ndim == 4
        np.testing.assert_array_equal(g["x"], w["x"])
        np.testing.assert_array_equal(g["y"], w["y"])
    # each package's get_gan_loader reads the other's file
    for root, loader in ((tmp_path / "jax", usps.get_gan_loader),
                         (tmp_path / "port", jusps.get_gan_loader)):
        b = next(iter(loader(batch_size=4096, file=f"constructed_{dist}.npz", root=str(root))))
        with np.load(want) as w:
            np.testing.assert_array_equal(b["x"][b["w"] > 0], w["x"])


# ---- loaders ---------------------------------------------------------------------


def test_mnist_loader_reads_idx_files_as_jax(tmp_path):
    rng = np.random.default_rng(6)
    imgs, lbls = rng.integers(0, 256, (12, 28, 28), dtype=np.uint8), rng.integers(0, 10, 12)
    with open(tmp_path / "t10k-images-idx3-ubyte", "wb") as fh:
        fh.write(np.array([2051, 12, 28, 28], ">i4").tobytes() + imgs.tobytes())
    with open(tmp_path / "t10k-labels-idx1-ubyte", "wb") as fh:
        fh.write(np.array([2049, 12], ">i4").tobytes() + lbls.astype(np.uint8).tobytes())
    for root in (str(tmp_path), str(tmp_path / "absent")):  # the files, then the stand-in
        got, want = usps.get_mnist_loader(5, root), jusps.get_mnist_loader(5, root)
        assert got.x.shape[1:] == (16, 16, 1) and got.x.dtype == np.float32
        np.testing.assert_array_equal(got.x, want.x)
        np.testing.assert_array_equal(got.y, want.y)
    np.testing.assert_array_equal(usps.get_gan_loader(root=str(tmp_path)).x,
                                  jusps.get_gan_loader(root=str(tmp_path)).x)


# ---- the driver's routes ------------------------------------------------------------


def test_driver_routes_write_the_csvs_of_the_jax_driver(tmp_path, monkeypatch):
    """``saliency``, ``jaccard`` (baseline from ``comp_fname``) and
    ``jaccard_comp`` after a ``train=False`` load of a float64 CNNUSPS:
    the port's CSVs equal the JAX driver's (which writes to ./logs)."""
    monkeypatch.chdir(tmp_path)
    x, y = make_images(24, shape=(16, 16, 1), n_classes=10, seed=3)
    x = x.astype(np.float64)
    jm = JaxCNNUSPS(dtype=jnp.float64)
    ckpts = {}
    for tag, seed in (("AUD", 1), ("base", 2)):
        p, _ = _jax_vars(jm, x[:1], seed=seed)
        jtr = JaxTrainer(JaxTask(model=jm), jax_sgd(0.1), header=tag, model_dir="jm")
        jtr.init_state({"x": x[:8], "y": y[:8], "w": np.ones(8, np.float32)})
        jtr.params = jax.tree.map(jnp.asarray, p)
        jtr.save()
        tr = SpectralTrainer(Task(model=CNNUSPS().double()), sgd(0.1), header=tag,
                             model_dir="tm", device="cpu")
        tr.init_state()
        tr.params = interop.cnnusps_from_jax(p)
        tr.save()
        ckpts[tag] = (jtr, tr)
    common = dict(mu=0.0, K=0.0, pow_iter=False, batch_size=8, header="AUD", train=False,
                  saliency=True, jaccard=True, jaccard_comp=True, max_img=3)
    jopts = dict(common, model=jm, optimizer=jax_sgd(0.1), train_loader=JaxLoader(x, y, 8),
                 test_loader=[JaxLoader(x, y, 8)],
                 fname=f"jm/{ckpts['AUD'][0].header2}_trained_model.msgpack", model_dir="jm",
                 comp_fname=f"jm/{ckpts['base'][0].header2}_trained_model.msgpack",
                 comp_trainers=[ckpts["base"][0]])
    topts = dict(common, model=CNNUSPS().double(), optimizer=sgd(0.1),
                 train_loader=ArrayLoader(x, y, 8), test_loader=[ArrayLoader(x, y, 8)],
                 fname=f"tm/{ckpts['AUD'][1].header2}_trained_model.pt",
                 comp_fname=f"tm/{ckpts['base'][1].header2}_trained_model.pt",
                 comp_trainers=[ckpts["base"][1]], device="cpu", log_dir="tlogs",
                 model_dir="tm", plot_dir="tplots")
    os.makedirs("logs"), os.makedirs("tlogs")  # a run that does not train makes none
    jtr, tr = jdriver.run(jopts), driver.run(topts)
    assert tr.header2 == jtr.header2
    for name in [f"{tr.header2}_jaccard_{t}.csv" for t in ("cond", "counts", "values")] + [
            "jaccard_comp.csv"]:
        assert open(f"tlogs/{name}").read() == open(f"logs/{name}").read(), name
    sal = np.load(f"tplots/{tr.header2}_saliency.npz")
    assert sal["saliency"].shape == (3, 16, 16, 1)
    _close(sal["saliency"], jsaliency(jtr.task, jtr.params, jtr.model_state,
                                      jnp.asarray(x[:3])))
    assert sorted(f for f in os.listdir("tplots") if f.endswith(".png")) == sorted(
        f for f in os.listdir("plots") if f.startswith(tr.header2))


# ---- the scripts ------------------------------------------------------------------


def test_cov_shift_script_main(tmp_path, capsys):
    from optwboundeigenval_tpu_torch.data import forest
    from optwboundeigenval_tpu_torch.scripts import cov_shift_test

    x = forest.get_data(str(tmp_path / "data"))["inputs_test"]
    for kw in (dict(mu=0.01, K=1.0), dict(mu=0.0, K=0.0)):
        tr = SpectralTrainer(Task(model=ForestNet()), sgd(0.5), header="Forest",
                             batch_size=128, device="cpu", model_dir=str(tmp_path / "m"), **kw)
        tr.init_state()
        tr.save(CKPT_BEST)
    out = cov_shift_test.main(["3", "0.1", "--device", "cpu", "--models_dir",
                               str(tmp_path / "m"), "--log_dir", str(tmp_path / "logs"),
                               "--plot_dir", str(tmp_path / "plots"), "--seed", "0",
                               "--data_root", str(tmp_path / "data")])
    acc, f1, idx = out
    assert acc.shape == (2, 3) and np.isfinite(acc).all() and idx.shape == (x.shape[1], 3)
    assert np.all(idx[10:] == 0)
    assert "mu=0.01 K=1.0 vs mu=0.0 K=0.0" in capsys.readouterr().out
    assert os.path.exists(tmp_path / "logs" / "Forest_cov_shift_f1.csv")
    assert os.path.exists(tmp_path / "plots" / "cov_shift_acc.png")


def test_distance_scripts_main(tmp_path, capsys):
    from optwboundeigenval_tpu_torch.scripts import create_dist, distance as dscript

    out = create_dist.main(["--dist", "cosine", "--name", "constructed_cli", "--zeroes", "2",
                            "--seed", "0", "--device", "cpu", "--data_dir", str(tmp_path),
                            "--plot_dir", str(tmp_path / "plots")])
    with np.load(out) as z:
        assert z["x"].shape[1:] == (16, 16, 1) and len(z["x"]) == len(z["y"])
    dmm = dscript.main(["cosine", "constructed_cli", "--device", "cpu", "--data_dir",
                        str(tmp_path), "--plot_dir", str(tmp_path / "plots")])
    assert np.all((dmm > 0.5) & (dmm <= 1 + 1e-6))
    assert "constructed_cli/cosine: mean nearest similarity" in capsys.readouterr().out
    dmm = dscript.main(["euclid", "Aug1", "--device", "cpu", "--data_dir", str(tmp_path),
                        "--plot_dir", str(tmp_path / "plots")])
    assert dmm.shape == (2007,) and np.all(dmm >= 0)
