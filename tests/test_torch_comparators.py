"""The LOBPCG trainer mode and the comparator optimizers (SAM, Entropy-SGD,
K-FAC) against the JAX package at float64 on the CPU, from the same
weights (flax init, converted) and the same batches.

* LOBPCG epochs of the Forest and USPS recipes (``exp(-4 i - 2)``
  damping, ``kfac_rand=False``) with ``kfac_batch`` 2 over 3 batches (the
  last one padded), so refits fall inside epochs and on the epoch-end
  ``rho``, with ``kfac_ema`` both ways: the epoch values, parameters,
  eigenvector and factors agree to rtol 1e-8 (float64 math in other
  orders, carried over steps; measured ~1e-13); ``save_full``/``resume``
  mid-cadence gives the straight run bit for bit.
* SAM, Entropy-SGD (noise passed in, ``recompute_grads`` both ways;
  through the trainer with no noise) and K-FAC (``TCov=2, TInv=3``, and
  the weight-decay branch) steps: parameters and optimizer state to rtol
  1e-8, Entropy-SGD's float32 closure error % exactly.
* 2-epoch ``driver.run`` logs of ``forest_lobpcg`` and
  ``usps_cnn_lobpcg`` on cut data equal the JAX driver's to rtol 1e-8.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optwboundeigenval_tpu.data.loaders import ArrayLoader as JaxLoader
from optwboundeigenval_tpu.models import CNNUSPS as JaxCNNUSPS
from optwboundeigenval_tpu.models import ForestNet as JaxForestNet
from optwboundeigenval_tpu.ops import kfac as jkfac
from optwboundeigenval_tpu.optim import KFAC as JKFAC
from optwboundeigenval_tpu.optim import sgd as jsgd
from optwboundeigenval_tpu.optim.entropy_sgd import EntropySGD as JEntropySGD
from optwboundeigenval_tpu.optim.sam import SAM as JSAM
from optwboundeigenval_tpu.train import SpectralTrainer as JaxTrainer
from optwboundeigenval_tpu.train.task import Task as JaxTask
from optwboundeigenval_tpu_torch.configs._families import lobpcg_alpha
from optwboundeigenval_tpu_torch.data.loaders import ArrayLoader
from optwboundeigenval_tpu_torch.models.cnn_usps import CNNUSPS
from optwboundeigenval_tpu_torch.models.mlp_forest import ForestNet
from optwboundeigenval_tpu_torch.optim.api import sgd
from optwboundeigenval_tpu_torch.optim.entropy_sgd import EntropySGD, accuracy
from optwboundeigenval_tpu_torch.optim.kfac_optimizer import KFAC
from optwboundeigenval_tpu_torch.optim.sam import SAM
from optwboundeigenval_tpu_torch.train.task import Task
from optwboundeigenval_tpu_torch.train.trainer import SpectralTrainer
from optwboundeigenval_tpu_torch.utils import interop

torch.set_num_threads(1)
RTOL = 1e-8
JAX_ALPHA = lambda i: jnp.exp(-4.0 * i.astype(jnp.float32) - 2.0)
MODELS = {  # name: (JAX model, port model, weight map, input shape, classes)
    "forest": (JaxForestNet, ForestNet, interop.forestnet_from_jax, (54,), 7),
    "usps": (JaxCNNUSPS, CNNUSPS, interop.cnnusps_from_jax, (16, 16, 1), 10),
}


def _float(s):
    try:
        return float(s)
    except ValueError:
        return s


def _close(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * max(np.abs(want).max(), 1e-30),
                               err_msg=what)


def _close_tree(got, jtree, to_port, what):
    want = to_port(jax.tree.map(np.asarray, jtree))
    assert sorted(got) == sorted(want)
    for k in want:
        _close(got[k].numpy(), want[k].numpy(), f"{what}: {k}")


def _data(name, n=80, seed=3):
    _, _, _, xshape, classes = MODELS[name]
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n,) + xshape).astype(np.float32),
            rng.integers(0, classes, size=n).astype(np.int32))


@pytest.fixture
def same_weights(monkeypatch):
    """``init(name)`` makes both packages' tasks start from one set of
    float64 weights; returns ``(jax model, port model, weight map)``."""

    def init(name):
        jcls, tcls, to_port, xshape, _ = MODELS[name]
        jm = jcls(dtype=jnp.float64)
        p0 = jax.tree.map(lambda a: np.asarray(a, np.float64),
                          jm.init(jax.random.PRNGKey(0), jnp.zeros((1,) + xshape))["params"])
        monkeypatch.setattr(JaxTask, "init",
                            lambda self, rng, x: (jax.tree.map(jnp.asarray, p0), {}))
        monkeypatch.setattr(Task, "init", lambda self, g, dev: (to_port(p0), {}))
        return jm, tcls(), to_port

    return init


def _pair(jm, tm, jopt, topt, **kw):
    jtr = JaxTrainer(JaxTask(model=jm), jopt, **kw)
    ttr = SpectralTrainer(Task(model=tm), topt, device="cpu", **kw)
    return jtr, ttr


def _check_factors(tfac, jfac, params, what):
    want = interop.kfac_factors_from_jax(jfac, params)
    assert sorted(tfac) == sorted(want)
    for layer, f in tfac.items():
        for k in ("m_aa", "m_gg"):
            _close(f[k].numpy(), want[layer][k].numpy(), f"{what} {layer} {k}")


# ---- LOBPCG ------------------------------------------------------------------


LOBPCG = dict(mu=0.0028, K=1.0, lobpcg=True, kfac_batch=2, kfac_rand=False,
              batch_size=32, verbose=False)


@pytest.mark.parametrize("name,ema", [("forest", False), ("forest", True),
                                      ("usps", False), ("usps", True)])
def test_lobpcg_epochs_match_jax(same_weights, name, ema):
    jm, tm, to_port = same_weights(name)
    x, y = _data(name)
    jtr, ttr = _pair(jm, tm, jsgd(0.5), sgd(0.5), kfac_ema=ema, **LOBPCG)
    jtr.pow_iter_alpha, ttr.pow_iter_alpha = JAX_ALPHA, lobpcg_alpha
    jtr.init_state({"x": x[:32], "y": y[:32], "w": np.ones(32, np.float32)})
    ttr.init_state()
    for epoch in range(2):
        jtr.i = ttr.i = epoch
        jtr.iter_epoch(JaxLoader(x, y, 32))
        ttr.iter_epoch(ArrayLoader(x, y, 32))
        for k in ("f", "rho", "norm", "h"):
            _close(getattr(ttr, k), getattr(jtr, k), f"epoch {epoch} {k}")
        assert ttr._kfac_iter == jtr._kfac_iter
        _close_tree(ttr.params, jtr.params, to_port, f"epoch {epoch} params")
        _close_tree(ttr.v, jtr.v, to_port, f"epoch {epoch} v")
        _check_factors(ttr._precond_state, jtr._precond_state, ttr.params, f"epoch {epoch}")
    assert np.isfinite(ttr.rho) and ttr.rho > 0


class _PinnedRng:
    """The epoch's random batch as a function of a counter, so a resumed
    trainer draws what the straight run drew."""

    def __init__(self, start=0):
        self.i = start

    def integers(self, low, high):
        self.i += 1
        return low + (self.i - 1) % max(high - low, 1)


def test_lobpcg_resume_mid_cadence_gives_the_straight_run(tmp_path):
    """``kfac_batch`` 3 over 2 batches an epoch: the checkpoint after
    epoch 1 falls between two refits, and carries the factors and the
    counter."""
    x, y = _data("forest", n=64)
    loader = lambda: ArrayLoader(x, y, 32)

    def trainer(header, max_iter, **kw):
        tr = SpectralTrainer(Task(model=ForestNet()), sgd(0.5), device="cpu", header=header,
                             max_iter=max_iter, log_dir=str(tmp_path / "logs"),
                             model_dir=str(tmp_path / "models"),
                             **{**LOBPCG, "kfac_batch": 3, "pow_iter_alpha": lobpcg_alpha},
                             **kw)
        return tr

    straight = trainer("S", 4)
    straight._np_rng = _PinnedRng()
    straight.train(train_loader=loader())
    first = trainer("R", 2, full_ckpt=True)
    first._np_rng = _PinnedRng()
    first.train(train_loader=loader())
    assert first._kfac_iter == 3 and first._precond_state is not None
    second = trainer("R", 4)
    second.resume()
    assert second._kfac_iter == 3
    second._np_rng = _PinnedRng(2)
    second.train(train_loader=loader())
    rows = lambda tr: [ln for ln in open(tr.log_file).read().splitlines()[1:]
                       if ln[:1].isdigit()]
    assert rows(second) == rows(straight) and len(rows(straight)) == 4
    for k, t in straight.params.items():
        assert torch.equal(second.params[k], t)
    for layer, f in straight._precond_state.items():
        for k, t in f.items():
            assert torch.equal(second._precond_state[layer][k], t)


def test_rho_test_fused_is_sequential_under_lobpcg(tmp_path):
    x, y = _data("forest", n=64)
    tr = SpectralTrainer(Task(model=ForestNet()), sgd(0.5), device="cpu",
                         log_dir=str(tmp_path), **LOBPCG)
    tr.init_state()
    tr._refresh_precond(tr.put_batch(next(iter(ArrayLoader(x, y, 32)))))
    v0 = {k: t.clone() for k, t in tr.v.items()}
    fused = tr.rho_test_fused(loader=ArrayLoader(x, y, 32))
    tr.v = v0
    seq = tr.rho_test(loader=ArrayLoader(x, y, 32))
    np.testing.assert_array_equal(fused[:4], seq[:4])


# ---- the comparator optimizers -----------------------------------------------


def _steps(jtr, ttr, batches, to_port, what, check=None):
    for i, (bx, by) in enumerate(batches):
        batch = {"x": bx, "y": by, "w": np.ones(len(by), np.float32)}
        if i == len(batches) - 1:
            batch["w"][-3:] = 0.0  # a padded batch
        jm_ = jtr.train_step(batch)
        tm_ = ttr.train_step(batch)
        assert tm_["step_ok"] and jm_["step_ok"]
        assert tm_["pow_iters"] == int(jm_["pow_iters"])
        for k in ("rho", "g", "gradf_norm", "gradg_norm"):
            _close(tm_[k], float(jm_[k]), f"{what} step {i} {k}")
        _close_tree(ttr.params, jtr.params, to_port, f"{what} step {i} params")
        if check:
            check(i, jm_, tm_)


def _batches(name, n, size=16, seed=4):
    x, y = _data(name, n * size, seed)
    return [(x[i * size:(i + 1) * size], y[i * size:(i + 1) * size]) for i in range(n)]


SPECTRAL = dict(mu=0.0028, K=1.0, pow_iter_eps=1e-3, batch_size=16)


@pytest.mark.parametrize("name", ["forest", "usps"])
def test_sam_steps_match_jax(same_weights, name):
    """SAM perturbs along the REGULARIZED direction (here with the
    spectral penalty on) and steps from the original weights."""
    jm, tm, to_port = same_weights(name)
    jtr, ttr = _pair(jm, tm, JSAM(jsgd(0.1), rho=0.05), SAM(sgd(0.1), rho=0.05), **SPECTRAL)
    _steps(jtr, ttr, _batches(name, 3), to_port, "SAM")
    ttr.opt_state = ttr.optimizer.set_learning_rate(ttr.opt_state, 0.25)
    assert ttr.optimizer.get_learning_rate(ttr.opt_state) == 0.25


def _jax_noise(rng, params, L):
    """The standard normals JAX's Entropy-SGD draws from ``rng``, one tree
    per inner step (entropy_sgd.py:103-123)."""
    out = []
    for key in jax.random.split(rng, L):
        leaves, treedef = jax.tree_util.tree_flatten(params)
        keys = jax.random.split(key, len(leaves))
        out.append(jax.tree_util.tree_unflatten(
            treedef, [jax.random.normal(k, p.shape, p.dtype) for k, p in zip(keys, leaves)]))
    return out


@pytest.mark.parametrize("recompute", [True, False])
def test_entropy_sgd_steps_match_jax_with_its_noise(recompute):
    """Two optimizer steps (the first warm-starts the outer buffer) with
    JAX's Langevin noise passed in, weight decay and the closure."""
    rng = np.random.default_rng(5)
    jm = JaxForestNet(dtype=jnp.float64)
    p0 = jax.tree.map(lambda a: np.asarray(a, np.float64),
                      jm.init(jax.random.PRNGKey(1), jnp.zeros((1, 54)))["params"])
    x = jnp.asarray(rng.normal(size=(16, 54)))
    y = jnp.asarray(rng.integers(0, 7, size=16).astype(np.int32))
    jloss = lambda p: jnp.mean(-jax.nn.log_softmax(jm.apply({"params": p}, x))[jnp.arange(16), y])
    tm = ForestNet()
    tx, ty = torch.from_numpy(np.array(x)), torch.from_numpy(np.array(y))
    task = Task(model=tm)
    tloss = lambda p: task.loss_fn({})(p, {"x": tx, "y": ty})
    cfg = dict(lr=0.1, L=3, weight_decay=1e-3, recompute_grads=recompute, eps=1e-2)
    jopt, topt = JEntropySGD(**cfg), EntropySGD(**cfg)
    jp, jstate = jax.tree.map(jnp.asarray, p0), None
    tp = interop.forestnet_from_jax(p0)
    jstate, tstate = jopt.init(jp), topt.init(tp)
    from optwboundeigenval_tpu_torch.ops import curvature
    for step in range(2):
        key = jax.random.PRNGKey(10 + step)
        jd, td = jax.grad(jloss)(jp), curvature.grad(lambda p, b: tloss(p), tp, None)
        jerr = lambda p: (jloss(p), jnp.float32(3.5))
        jp, jstate = jopt.step(jd, jstate, jp, grad_fn=jax.value_and_grad(jloss), rng=key,
                               err_fn=jerr)
        noise = [interop.forestnet_from_jax(jax.tree.map(np.asarray, z))
                 for z in _jax_noise(key, p0, 3)]
        tp, tstate = topt.step(
            td, tstate, tp, grad_fn=lambda p: curvature.value_and_grad(
                lambda q, b: tloss(q), p, None), noise=noise,
            err_fn=lambda p: (tloss(p), torch.tensor(3.5, dtype=torch.float32)))
        _close_tree(tp, jp, interop.forestnet_from_jax, f"step {step} params")
        _close_tree(tstate["mdw"], jstate.mdw, interop.forestnet_from_jax, f"step {step} mdw")
        assert tstate["t"] == int(jstate.t) == step + 1
        _close(float(tstate["mf"]), float(jstate.mf), "mf")
    assert tstate["lr"] == float(jstate.lr)
    tstate = topt.set_learning_rate(tstate, 0.3)
    assert tstate["lr"] == float(jopt.set_learning_rate(jstate, 0.3).lr) != 0.3


def test_entropy_sgd_through_the_trainer_matches_jax(same_weights):
    """The trainer's protocol (``grad_fn``, ``err_fn``, the reported
    ``opt_mf``/``opt_merr``) with the noise off (``eps=0``)."""
    jm, tm, to_port = same_weights("forest")
    cfg = dict(lr=0.5, L=2, eps=0.0)
    jtr, ttr = _pair(jm, tm, JEntropySGD(**cfg), EntropySGD(**cfg), mu=0.0, K=0.0,
                     pow_iter=False, batch_size=16)

    def check(i, jm_, tm_):
        _close(tm_["opt_mf"], float(jm_["opt_mf"]), "opt_mf")
        assert np.float32(tm_["opt_merr"]) == np.float32(jm_["opt_merr"])

    _steps(jtr, ttr, _batches("forest", 3), to_port, "EntropySGD", check)


def test_entropy_sgd_accuracy_helper_matches_jax():
    from optwboundeigenval_tpu.optim.entropy_sgd import accuracy as jaccuracy

    rng = np.random.default_rng(0)
    out, tgt = rng.normal(size=(20, 5)), rng.integers(0, 5, size=20)
    got = accuracy(torch.from_numpy(out), torch.from_numpy(tgt), topk=(1, 3))
    want = jaccuracy(jnp.asarray(out), jnp.asarray(tgt), topk=(1, 3))
    assert [float(g) for g in got] == [float(w) for w in want]


@pytest.mark.parametrize("name", ["forest", "usps"])
def test_kfac_steps_match_jax(same_weights, name):
    """K-FAC through the trainer as its configs run it (no spectral term):
    statistics every 2 steps, inverses every 3 (steps 0, 2 and 0, 3),
    over 4 steps; the factors and momentum after each step."""
    jm, tm, to_port = same_weights(name)
    cfg = dict(lr=0.05, TCov=2, TInv=3, kfac_rand=False)
    jtr, ttr = _pair(jm, tm, JKFAC(**cfg), KFAC(**cfg), mu=0.0, K=0.0, pow_iter=False,
                     batch_size=16)

    def check(i, jm_, tm_):
        assert ttr.opt_state["steps"] == int(jtr.opt_state.steps) == i + 1
        _check_factors(ttr.opt_state["factors"], jtr.opt_state.factors, ttr.params,
                       f"step {i}")
        _close_tree(ttr.opt_state["momentum"], jtr.opt_state.momentum, to_port,
                    f"step {i} momentum")

    _steps(jtr, ttr, _batches(name, 4), to_port, "KFAC", check)


def test_kfac_weight_decay_branch_matches_jax():
    """From ``20 * TCov`` steps on the decay joins the direction; the KL
    clip sums over factored layers only."""
    jm, tm = JaxForestNet(dtype=jnp.float64), ForestNet()
    x = np.random.default_rng(2).normal(size=(16, 54))
    y = np.random.default_rng(3).integers(0, 7, size=16).astype(np.int32)
    p0 = jax.tree.map(lambda a: np.asarray(a, np.float64),
                      jm.init(jax.random.PRNGKey(1), jnp.zeros((1, 54)))["params"])
    jtask, ttask = JaxTask(model=jm), Task(model=tm)
    jb = {"x": jnp.asarray(x), "y": jnp.asarray(y), "w": jnp.ones(16)}
    tb = {"x": torch.from_numpy(x), "y": torch.from_numpy(y), "w": torch.ones(16)}
    jp, tp = jax.tree.map(jnp.asarray, p0), interop.forestnet_from_jax(p0)
    cfg = dict(lr=0.05, TCov=1, TInv=1, weight_decay=1e-2, kfac_rand=False, kl_clip=1e-6)
    jopt, topt = JKFAC(**cfg), KFAC(**cfg)
    jstate = jopt.build_extra_state(jopt.init(jp), jtask, jp, {}, jb, jax.random.PRNGKey(0))
    jstate = jstate._replace(steps=jnp.asarray(20, jnp.int32))
    tstate = {**topt.build_extra_state(topt.init(tp), ttask, tp, {}), "steps": 20}
    jd = jax.grad(jtask.loss_fn({}))(jp, jb)
    from optwboundeigenval_tpu_torch.ops import curvature, kfac

    td = curvature.grad(ttask.loss_fn({}), tp, tb)
    jstats = lambda p, r: jkfac.capture(jtask, p, {}, jb)[1]
    tstats = lambda p, r: kfac.capture(ttask, p, {}, tb)[1]
    jp2, jstate2 = jopt.step(jd, jstate, jp, stats_fn=jstats, rng=jax.random.PRNGKey(1))
    tp2, tstate2 = topt.step(td, tstate, tp, stats_fn=tstats)
    _close_tree(tp2, jp2, interop.forestnet_from_jax, "params")
    # the decay-free step differs: the branch was taken
    tp3, _ = KFAC(**{**cfg, "weight_decay": 0.0}).step(td, tstate, tp, stats_fn=tstats)
    assert not torch.allclose(tp3["fc1.weight"], tp2["fc1.weight"])


# ---- the LOBPCG configs through driver.run ----------------------------------


@pytest.mark.parametrize("name", ["forest_lobpcg", "usps_cnn_lobpcg"])
def test_lobpcg_driver_run_matches_jax(tmp_path, monkeypatch, name):
    """2 epochs of each LOBPCG config on cut data (Forest 512 train rows,
    USPS 256; 128 valid and test rows), the logs of both drivers."""
    import importlib
    import os

    from optwboundeigenval_tpu.train import driver as jdriver
    from optwboundeigenval_tpu_torch.train import driver

    jcfg = importlib.import_module(f"optwboundeigenval_tpu.configs.{name}")
    tcfg = importlib.import_module(f"optwboundeigenval_tpu_torch.configs.{name}")
    model = "forest" if name.startswith("forest") else "usps"
    jcls, _, to_port, xshape, _ = MODELS[model]
    jm = jcls(dtype=jnp.float64)
    p0 = jax.tree.map(lambda a: np.asarray(a, np.float64),
                      jm.init(jax.random.PRNGKey(0), jnp.zeros((1,) + xshape))["params"])
    monkeypatch.setattr(JaxTask, "init", lambda self, rng, x: (jax.tree.map(jnp.asarray, p0), {}))
    monkeypatch.setattr(Task, "init", lambda self, g, dev: (to_port(p0), {}))
    runs = {}
    for side, opts, loader, run in (("jax", jcfg.options(), JaxLoader, jdriver.run),
                                    ("port", tcfg.options(device="cpu"), ArrayLoader,
                                     driver.run)):
        if model == "forest":
            for k, n in (("inputs", 512), ("target", 512), ("inputs_valid", 128),
                         ("target_valid", 128), ("inputs_test", 128), ("target_test", 128)):
                opts[k] = opts[k][:n]
        else:
            cut = lambda ld, n, **kw: loader(ld.x[:n], ld.y[:n], 128, **kw)
            opts["train_loader"] = cut(opts["train_loader"], 256, shuffle=True, seed=1226)
            opts["valid_loader"] = cut(opts["valid_loader"], 128)
            opts["train_loader_na"] = cut(opts["train_loader_na"], 256)
            opts["test_loader"] = [cut(opts["test_loader"][0], 128)]
        opts.update(max_iter=2, log_dir=str(tmp_path / side / "logs"),
                    model_dir=str(tmp_path / side / "models"))
        if side == "jax":
            opts["model"] = jm
        runs[side] = run(opts)
    jtr, ttr = runs["jax"], runs["port"]
    assert ttr.header2 == jtr.header2 and ttr.lobpcg and ttr.kfac_batch == 8
    logs = {s: str(tmp_path / s / "logs" / jtr.header2) for s in runs}
    read = lambda p: [[_float(t) for t in ln.replace(":", " ").split()] for ln in open(p)
                      if not ln.startswith(("Time elapsed", "G Time", "Test Time",
                                            "Iteration Time"))]
    got, want = read(logs["port"] + ".log"), read(logs["jax"] + ".log")
    assert len(got) == len(want) and sum(isinstance(r[0], float) for r in got) == 2
    for rg, rw in zip(got, want):
        assert len(rg) == len(rw)
        for a, b in zip(rg, rw):
            if isinstance(b, float):
                np.testing.assert_allclose(a, b, rtol=RTOL, atol=1e-12)
            else:
                assert a == b
    if ttr.verbose:  # forest_lobpcg: the per-batch lines too
        vg, vw = (read(logs[s] + "_verbose.log") for s in ("port", "jax"))
        assert len(vg) == len(vw)
        for rg, rw in zip(vg, vw):
            for a, b in zip(rg, rw):
                if isinstance(b, float):
                    np.testing.assert_allclose(a, b, rtol=RTOL, atol=1e-6)
    assert os.path.exists(tmp_path / "port" / "models" / (jtr.header2 + "_trained_model.pt"))
