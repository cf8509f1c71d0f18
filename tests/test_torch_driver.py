"""The training run: the port's ``driver.run`` against the JAX driver at
float64 on the CPU, the epoch loop's rules, the evaluation metrics and
the driver's handling of options.

``driver.run`` for ``forest_best`` (512 train rows) and
``usps_cnn_mu0_01_K0`` (256), 2 epochs with ``rho_test``, from the same
float64 weights (flax init, converted) on both sides: the TSV rows, the
test lines and the ``rho_test`` CSV agree to rtol 1e-8 (float64 math in
other orders, accumulated over two epochs; measured ~1e-14), leaving out
wall times.  The power iteration counts are equal.  The same for Forest
with ``eigensolver='auto'`` (early-exit Lanczos), USPS with
``rand_init`` and the augmented test loaders, the ``rho_test_fused`` and
``spectrum_test`` audits, and the published CIFAR recipe (augmentation
and remat) on a small DenseNet3.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from sklearn.metrics import confusion_matrix as sk_confusion
from sklearn.metrics import f1_score

from optwboundeigenval_tpu.configs import forest_best as jforest_best
from optwboundeigenval_tpu.configs import usps_cnn_mu0_01_K0 as jusps_cfg
from optwboundeigenval_tpu.data.loaders import ArrayLoader as JaxLoader
from optwboundeigenval_tpu.models import CNNUSPS as JaxCNNUSPS
from optwboundeigenval_tpu.models import ForestNet as JaxForestNet
from optwboundeigenval_tpu.optim import sgd as jax_sgd
from optwboundeigenval_tpu.train import SpectralTrainer as JaxTrainer
from optwboundeigenval_tpu.train import driver as jdriver
from optwboundeigenval_tpu.train.task import Task as JaxTask
from optwboundeigenval_tpu_torch import main as tmain
from optwboundeigenval_tpu_torch.configs import cifar10_densenet_mu0_01_K0
from optwboundeigenval_tpu_torch.configs import forest_best, usps_cnn_mu0_01_K0
from optwboundeigenval_tpu_torch.data.loaders import ArrayLoader
from optwboundeigenval_tpu_torch.data.usps import load_usps
from optwboundeigenval_tpu_torch.data.synthetic import make_classification
from optwboundeigenval_tpu_torch.models.cnn_usps import CNNUSPS
from optwboundeigenval_tpu_torch.models.mlp_forest import ForestNet
from optwboundeigenval_tpu_torch.optim.api import sgd
from optwboundeigenval_tpu_torch.train import driver
from optwboundeigenval_tpu_torch.train.task import Task
from optwboundeigenval_tpu_torch.train.trainer import (
    SpectralTrainer,
    confusion_matrix,
    f1_micro,
)
from optwboundeigenval_tpu_torch.utils import interop

torch.set_num_threads(1)
RTOL = 1e-8


def _float(s):
    try:
        return float(s)
    except ValueError:
        return s


def _log(path):
    """The log's lines as lists of numbers, without the wall-time line."""
    with open(path) as fh:
        return [[_float(t) for t in ln.replace(":", " ").split()]
                for ln in fh if not ln.startswith("Time elapsed")]


def _same(a, b):
    assert len(a) == len(b)
    for ra, rb in zip(a, b):
        assert len(ra) == len(rb)
        for x, y in zip(ra, rb):
            if isinstance(x, float):
                np.testing.assert_allclose(x, y, rtol=RTOL, atol=1e-12)
            else:
                assert x == y


def _cut_usps(opts, loader):
    """256 train, 128 valid and test rows, as loaders of ``loader``'s class
    (the augmented test loaders keep their hooks and seeds)."""
    cut = lambda ld, n, **kw: loader(ld.x[:n], ld.y[:n], 128, **kw)
    opts["train_loader"] = cut(opts["train_loader"], 256, shuffle=True, seed=1226)
    opts["valid_loader"] = cut(opts["valid_loader"], 128)
    opts["train_loader_na"] = cut(opts["train_loader_na"], 256)
    opts["test_loader"] = [cut(opts["test_loader"][0], 128)]
    opts["test_loader_aug"] = [cut(ld, 128, seed=1226 + i, augment=ld.augment)
                               for i, ld in enumerate(opts["test_loader_aug"])]


def _cut_forest(opts, _):
    for k, n in (("inputs", 512), ("target", 512), ("inputs_valid", 128),
                 ("target_valid", 128), ("inputs_test", 128), ("target_test", 128)):
        opts[k] = opts[k][:n]


_FOREST = (jforest_best, forest_best, JaxForestNet, interop.forestnet_from_jax,
           (1, 54), _cut_forest)
_USPS = (jusps_cfg, usps_cnn_mu0_01_K0, JaxCNNUSPS, interop.cnnusps_from_jax,
         (1, 16, 16, 1), _cut_usps)
CASES = {  # name: (config and model pairs, extra options)
    "forest_best": (_FOREST, {}),
    "usps_cnn_mu0_01_K0": (_USPS, {}),
    "forest_best-auto": (_FOREST, dict(eigensolver="auto")),
    "usps_cnn_mu0_01_K0-rand_init-aug_test": (_USPS, dict(rand_init=True, aug_test=True)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_driver_run_matches_jax(name, tmp_path, monkeypatch):
    (jcfg, tcfg, jmodel, to_port, xshape, cut), extra = CASES[name]
    jm = jmodel(dtype=jnp.float64)
    p0 = jax.tree.map(lambda a: np.asarray(a, np.float64),
                      jm.init(jax.random.PRNGKey(0), jnp.zeros(xshape))["params"])
    # both tasks start from the same float64 weights
    monkeypatch.setattr(JaxTask, "init",
                        lambda self, rng, x: (jax.tree.map(jnp.asarray, p0), {}))
    monkeypatch.setattr(Task, "init", lambda self, g, dev: (to_port(p0), {}))
    runs = {}
    for side, opts, loader, run in (
            ("jax", jcfg.options(), JaxLoader, jdriver.run),
            ("port", tcfg.options(device="cpu"), ArrayLoader, driver.run)):
        cut(opts, loader)
        opts.update(max_iter=2, rho_test=True, log_dir=str(tmp_path / side / "logs"),
                    model_dir=str(tmp_path / side / "models"), **extra)
        if side == "jax":
            opts["model"] = jm
        runs[side] = run(opts)
    jtr, ttr = runs["jax"], runs["port"]
    assert ttr.header2 == jtr.header2
    assert ttr.eigensolver == jtr.eigensolver
    logs = {s: str(tmp_path / s / "logs" / jtr.header2) for s in runs}
    _same(_log(logs["port"] + ".log"), _log(logs["jax"] + ".log"))
    rows = [ln for ln in _log(logs["port"] + ".log") if isinstance(ln[0], float)]
    assert len(rows) == 2
    summary = {s: [ln.rstrip("\n").split("\t")[1:]  # without Time_elapsed
                   for ln in open(logs[s] + "_summary.tsv")] for s in logs}
    assert summary["port"][0] == summary["jax"][0]
    _same([list(map(float, summary["port"][1]))], [list(map(float, summary["jax"][1]))])
    jrho, trho = (np.loadtxt(logs[s] + "_rho_test.csv", delimiter=",") for s in ("jax", "port"))
    np.testing.assert_allclose(trho[:, :5], jrho[:, :5], rtol=RTOL, atol=1e-12)
    for f in ("_trained_model.pt", "_trained_model_best.pt"):
        assert os.path.exists(tmp_path / "port" / "models" / (jtr.header2 + f))
    if extra.get("aug_test"):
        assert sum(ln[:2] == ["Aug", "Test"] for ln in _log(logs["port"] + ".log")) == 6


# ---- the audits: rho_test_fused and spectrum_test --------------------------


def _usps_pair(tmp_path, **kw):
    """A JAX and a port USPS trainer at the same float64 weights, and four
    batches of 32 rows."""
    jm = JaxCNNUSPS(dtype=jnp.float64)
    p0 = jax.tree.map(lambda a: np.asarray(a, np.float64),
                      jm.init(jax.random.PRNGKey(3), jnp.zeros((1, 16, 16, 1)))["params"])
    common = dict(batch_size=32, header="A", **kw)
    jtr = JaxTrainer(JaxTask(model=jm), jax_sgd(0.1), log_dir=str(tmp_path / "jax"),
                     **common)
    jtr.params, jtr.model_state = jax.tree.map(jnp.asarray, p0), {}
    jtr.v = jax.tree.map(jnp.ones_like, jtr.params)
    ttr = SpectralTrainer(Task(model=CNNUSPS()), sgd(0.1), log_dir=str(tmp_path / "port"),
                          device="cpu", **common)
    ttr.params, ttr.model_state = interop.cnnusps_from_jax(p0), {}
    ttr.v = {k: torch.ones_like(t) for k, t in ttr.params.items()}
    x, y = load_usps(str(tmp_path))
    return jtr, ttr, ArrayLoader(x[:128], y[:128], 32)


@pytest.mark.parametrize("eigensolver", ["power", "auto"])
def test_rho_test_fused_matches_jax(tmp_path, eigensolver):
    jtr, ttr, loader = _usps_pair(tmp_path, eigensolver=eigensolver)
    v_before = {k: t.clone() for k, t in ttr.v.items()}
    jmeans = jtr.rho_test_fused(loader=loader)
    tmeans = ttr.rho_test_fused(loader=loader)
    jrows, trows = (np.loadtxt(tmp_path / s / (tr.header2 + "_rho_test.csv"), delimiter=",")
                    for s, tr in (("jax", jtr), ("port", ttr)))
    assert trows.shape == jrows.shape == (4, 6)
    np.testing.assert_array_equal(trows[:, 3], jrows[:, 3])  # iterations
    np.testing.assert_allclose(trows[:, :5], jrows[:, :5], rtol=RTOL, atol=1e-12)
    np.testing.assert_allclose(tmeans[:4], jmeans[:4], rtol=RTOL, atol=1e-12)
    for k, t in v_before.items():  # the carried eigenvector is left alone
        assert torch.equal(ttr.v[k], t)


@pytest.mark.parametrize("method", ["subspace", "lanczos"])
def test_spectrum_test_matches_jax(tmp_path, method):
    """The JAX trainer's random starts (its fixed key-0 block, or its
    per-batch perturbations from ``self.rng``) go into the port through
    ``starts``, converted to the port's layout."""
    from jax.flatten_util import ravel_pytree

    from optwboundeigenval_tpu.utils.tree import tree_random_like
    from optwboundeigenval_tpu_torch.utils.tree import tree_ravel

    jtr, ttr, loader = _usps_pair(tmp_path)
    flat, unravel = ravel_pytree(jtr.params)
    if method == "subspace":
        block = jax.random.normal(jax.random.PRNGKey(0), (4, flat.size), flat.dtype)
        rows = [tree_ravel(interop.cnnusps_from_jax(unravel(r)))[0] for r in block]
        starts = [torch.stack(rows)] * len(loader)
    else:
        rng, starts = jtr.rng, []
        for _ in range(len(loader)):
            rng, r = jax.random.split(rng)
            starts.append(interop.cnnusps_from_jax(tree_random_like(r, jtr.params)))
    kw = dict(loader=loader, k=4, method=method, max_iter=25)
    want = jtr.spectrum_test(**kw)
    got = ttr.spectrum_test(starts=starts, **kw)
    assert got.shape == want.shape == (4, 9)
    np.testing.assert_array_equal(got[:, 8], want[:, 8])
    np.testing.assert_allclose(got[:, :4], want[:, :4], rtol=1e-10)
    np.testing.assert_allclose(got[:, 4:8], want[:, 4:8], rtol=RTOL, atol=1e-12)
    assert np.isfinite(got).all()


# ---- the slice: the published CIFAR recipe ---------------------------------


def test_published_cifar_recipe_matches_jax(tmp_path, monkeypatch):
    """``cifar10_densenet_mu0_01_K0`` with no override but the model (a
    DenseNet3 of depth 10, growth 4) and a 64-row cut of every split that
    keeps the train loader's augmentation: one epoch with
    ``augment=True, remat=True, defer_metrics=True`` equals the JAX
    driver's log."""
    from optwboundeigenval_tpu.configs import cifar10_densenet_mu0_01_K0 as jcifar_cfg
    from optwboundeigenval_tpu.models.densenet import DenseNet3 as JaxDenseNet3
    from optwboundeigenval_tpu_torch.models.densenet import DenseNet3

    jm = JaxDenseNet3(depth=10, growth_rate=4, dtype=jnp.float64)
    v0 = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)), train=False)
    p0 = jax.tree.map(lambda a: np.asarray(a, np.float64), v0["params"])
    s0 = jax.tree.map(lambda a: np.asarray(a, np.float64), v0["batch_stats"])
    monkeypatch.setattr(JaxTask, "init", lambda self, rng, x: (
        jax.tree.map(jnp.asarray, p0), {"batch_stats": jax.tree.map(jnp.asarray, s0)}))
    monkeypatch.setattr(Task, "init", lambda self, g, dev: interop.densenet3_from_jax(p0, s0))
    runs = {}
    for side, opts, loader, run in (
            ("jax", jcifar_cfg.options(), JaxLoader, jdriver.run),
            ("port", cifar10_densenet_mu0_01_K0.options(device="cpu"), ArrayLoader,
             driver.run)):
        assert opts["remat"] and opts["defer_metrics"]
        assert opts["train_loader"].augment is not None
        cut = lambda ld, **kw: loader(ld.x[:64], ld.y[:64], 32, **kw)
        opts["train_loader"] = cut(opts["train_loader"], shuffle=True, seed=1226,
                                   augment=opts["train_loader"].augment)
        opts["valid_loader"] = cut(opts["valid_loader"])
        opts["train_loader_na"] = cut(opts["train_loader_na"])
        opts["test_loader"] = [cut(opts["test_loader"][0])]
        opts.update(max_iter=1, log_dir=str(tmp_path / side / "logs"),
                    model_dir=str(tmp_path / side / "models"))
        opts["model"] = jm if side == "jax" else DenseNet3(depth=10, growth_rate=4)
        runs[side] = run(opts)
    jtr, ttr = runs["jax"], runs["port"]
    assert ttr.remat and jtr.remat
    logs = {s: str(tmp_path / s / "logs" / jtr.header2) for s in runs}
    jlog, tlog = _log(logs["jax"] + ".log"), _log(logs["port"] + ".log")
    _same(tlog, jlog)
    assert len([ln for ln in tlog if isinstance(ln[0], float)]) == 1


# ---- the epoch loop on a small ForestNet -----------------------------------


def _trainer(tmp_path, header="T", **kw):
    opts = dict(mu=0.01, K=1.0, batch_size=32, max_iter=2, min_iter=1,
                max_pow_iter=15, pow_iter_eps=1e-2, header=header, device="cpu",
                log_dir=str(tmp_path / "logs"), model_dir=str(tmp_path / "models"))
    opts.update(kw)
    return SpectralTrainer(Task(model=ForestNet(hidden=8, num_classes=3, in_features=8)),
                           sgd(0.1), **opts)


def _data(n=128, seed=0, shuffle=True):
    x, y = make_classification(n, 8, 3, seed=seed)
    return ArrayLoader(x, y, 32, shuffle=shuffle, seed=1)


def _rows(tr):
    return [ln for ln in _log(tr.log_file) if isinstance(ln[0], float)]


def test_defer_metrics_gives_the_same_run(tmp_path):
    runs = []
    for defer in (False, True):
        tr = _trainer(tmp_path, header=f"D{defer}", defer_metrics=defer, max_iter=3)
        tr.train(train_loader=_data(), valid_loader=_data(64, seed=1, shuffle=False))
        runs.append((_rows(tr), tr.params, tr.mean_pow_iters))
    assert runs[0][0] == runs[1][0]
    assert runs[0][2] == runs[1][2]
    for k, t in runs[0][1].items():
        assert torch.equal(t, runs[1][1][k])


@pytest.mark.parametrize("defer", [False, True])
def test_non_finite_steps_roll_back(tmp_path, defer):
    """A poisoned batch leaves finite parameters: the step is withheld
    (and the last checkpoint reloaded), or with ``defer_metrics`` the
    epoch-start state is restored."""
    x, y = make_classification(96, 8, 3, seed=0)
    x[32:64] = np.nan
    tr = _trainer(tmp_path, defer_metrics=defer, max_iter=2)
    tr.init_state()
    start = {k: t.clone() for k, t in tr.params.items()}
    tr.train(train_loader=ArrayLoader(x, y, 32))
    assert all(bool(torch.isfinite(t).all()) for t in tr.params.values())
    if defer:  # every epoch held a bad step: the start state comes back
        for k, t in start.items():
            assert torch.equal(tr.params[k], t)


def test_cov_stop(tmp_path):
    tr = _trainer(tmp_path, eps=1e9, min_iter=3, max_iter=10)
    tr.train(train_loader=_data())
    assert tr.i == 2 and len(_rows(tr)) == 3
    tr = _trainer(tmp_path, header="N", eps=-1.0, min_iter=1, max_iter=3)
    tr.train(train_loader=_data())
    assert len(_rows(tr)) == 3


def test_best_h_keeps_the_largest_h(tmp_path):
    """``best_h`` compares with ``>`` although ``h`` is minimised (the
    reference's rule): the best model is the epoch of the largest h."""
    tr = _trainer(tmp_path, best_h=True, max_iter=4, mu=1.0)
    tr.train(train_loader=_data(), valid_loader=_data(64, seed=1, shuffle=False))
    hs = [r[3] for r in _rows(tr)]
    assert tr.best_iter == int(np.argmax(hs))
    lines = open(tr.log_file).read()
    assert f"Best H: {tr.best_h}" in lines and "Best Validation" not in lines


class _PinnedRng:
    """The epoch's random batch as a function of a counter, so a resumed
    trainer draws what the straight run drew."""

    def __init__(self, start=0):
        self.i = start

    def integers(self, low, high):
        self.i += 1
        return low + (self.i - 1) % max(high - low, 1)


def test_save_full_and_resume_give_the_straight_run(tmp_path):
    straight = _trainer(tmp_path, header="S", max_iter=4)
    straight._np_rng = _PinnedRng()
    straight.train(train_loader=_data(shuffle=False),
                   valid_loader=_data(64, seed=1, shuffle=False))
    first = _trainer(tmp_path, header="R", max_iter=2, full_ckpt=True)
    first._np_rng = _PinnedRng()
    first.train(train_loader=_data(shuffle=False),
                valid_loader=_data(64, seed=1, shuffle=False))
    second = _trainer(tmp_path, header="R", max_iter=4)
    second.resume()
    assert second.i == 1 and second._h_hist == first._h_hist
    second._np_rng = _PinnedRng(2)
    second.train(train_loader=_data(shuffle=False),
                 valid_loader=_data(64, seed=1, shuffle=False))
    assert _rows(second) == _rows(straight)
    for k, t in straight.params.items():
        assert torch.equal(second.params[k], t)


def test_conf_test_func_writes_the_confusion_matrix(tmp_path):
    tr = _trainer(tmp_path, test_func="maxconf", max_iter=1)
    tr.train(train_loader=_data(), valid_loader=_data(64, seed=1, shuffle=False))
    loss, acc, f1 = tr.test_model(loader=_data(64, seed=1, shuffle=False))
    assert acc is None and f1 is None and np.isfinite(loss)
    cm = np.loadtxt(os.path.join(tr.log_dir, tr.header2 + "_conf_matrix.csv"),
                    delimiter=",")
    assert cm.sum() == 64
    assert np.isnan(_rows(tr)[0][5])


def test_metrics_match_sklearn():
    rng = np.random.default_rng(4)
    for n in (1, 7, 100):
        t, p = rng.integers(0, 5, size=n), rng.integers(1, 7, size=n)
        assert f1_micro(t, p) == f1_score(t, p, average="micro")
        np.testing.assert_array_equal(confusion_matrix(t, p), sk_confusion(t, p))
        t2 = (rng.random((n, 4)) < 0.3).astype(np.float32)
        p2 = (rng.random((n, 4)) < 0.5).astype(np.float32)
        assert f1_micro(t2, p2) == f1_score(t2, p2, average="micro")
    zero = np.zeros((3, 2), np.float32)
    assert f1_micro(zero, zero) == f1_score(zero, zero, average="micro",
                                            zero_division=0.0)


# ---- options --------------------------------------------------------------


def test_trainer_takes_every_jax_keyword():
    import inspect

    jax_args = set(inspect.signature(JaxTrainer.__init__).parameters)
    assert jax_args <= set(inspect.signature(SpectralTrainer.__init__).parameters)


@pytest.mark.parametrize("bad", [
    dict(scan_steps=4), dict(donate=True),
    dict(mem_track=True), dict(profile_epoch=1), dict(profile_dir="trace"),
    dict(mesh="data")])
def test_unported_trainer_options_raise(bad):
    """The trainer's execution knobs and the mesh are ported: each builds;
    a ``model`` axis needs as many ranks."""
    from optwboundeigenval_tpu_torch.parallel import make_mesh

    if "mesh" in bad:
        with pytest.raises(ValueError, match="world of 1"):
            make_mesh(model=2, device="cpu")
        bad = {"mesh": make_mesh(device="cpu")}
    tr = SpectralTrainer(Task(model=ForestNet()), sgd(0.1), device="cpu", **bad)
    for k, v in bad.items():
        assert getattr(tr, k) is v or getattr(tr, k) == v


def test_config_options_reach_the_trainer():
    opts = cifar10_densenet_mu0_01_K0.options(remat=False, augment=False, device="cpu")
    tr = driver.build_trainer(opts)
    assert tr.eps == 0.001 and tr.defer_metrics is True  # tol -> eps
    assert (tr.batch_size, tr.max_iter, tr.header) == (32, 100, "CIFAR10_DenseNet")
    tr = driver.build_trainer(usps_cnn_mu0_01_K0.options(
        device="cpu", eigensolver="lanczos", lanczos_m=6, rand_init=True, remat=True,
        aug_test=True))
    assert (tr.eigensolver, tr.lanczos_m, tr.rand_init, tr.remat) == ("lanczos", 6, True, True)


@pytest.mark.parametrize("key,value,match", [
    ("no_such_option", 1, "not known"), ("jaccard", True, "jaccard"),
    ("device_data", True, "device_data"), ("saliency", True, "saliency"),
    ("jaccard_comp", True, "jaccard_comp")])
def test_unknown_or_unported_config_keys_raise(key, value, match):
    """An unknown key raises ``NotImplementedError``.  The analysis routes
    and ``device_data`` are ported: ``saliency`` and ``device_data`` build,
    and an audit without what it compares (a baseline, other trainers)
    raises ``ValueError``."""
    opts = forest_best.options(device="cpu", **{key: value})
    if key in ("saliency", "device_data"):
        assert driver.build_trainer(opts).header2 == "Forest_SGD_mu0.0028_K1.0"
    elif key in ("jaccard", "jaccard_comp"):
        with pytest.raises(ValueError, match=match):
            driver.build_trainer(opts)
    else:
        with pytest.raises(NotImplementedError, match=match):
            driver.build_trainer(opts)


def test_unported_config_choices_raise():
    """An unknown optimizer raises; ``has_dropout`` is ported: the driver
    builds a dropout ``Task`` whose steps draw one key each from the
    trainer's seed, and a model without dropout layers trains as without
    the option (as in the JAX package, whose flax model then draws
    nothing)."""
    with pytest.raises(ValueError, match="unknown optimizer"):
        forest_best.options(device="cpu", optimizer="lbfgs")
    runs = []
    for has_dropout in (True, False):
        opts = forest_best.options(device="cpu", has_dropout=has_dropout)
        tr = driver.build_trainer(opts)
        assert tr.task.has_dropout == has_dropout
        batch = {"x": opts["inputs"][:128], "y": opts["target"][:128],
                 "w": np.ones(128, np.float32)}
        runs.append(tr.train_step(batch))
        assert tr._dropout_draws == int(has_dropout)
    assert runs[0]["rho"] == runs[1]["rho"] and runs[0]["pow_iters"] == runs[1]["pow_iters"]


def test_main_needs_the_card_unless_told():
    if torch.cuda.is_available():
        pytest.skip("CUDA is available: main runs on the card there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmain.main(["main", "forest_best", "max_iter=1"])
    with pytest.raises(NotImplementedError, match="not known"):
        tmain.main(["main", "forest_best", "device='cpu'", "maxiter=1"])
