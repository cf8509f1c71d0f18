"""The slice end to end: the port's ``SpectralTrainer.train_step`` against
the JAX trainer at float64 on the CPU, from shared weights and batches,
on a small DenseNet3 with the CIFAR recipe's solver settings (mu 0.01,
K 0, pow_iter_eps 0.05, SGD momentum 0.9, weight decay 1e-4).

Per step, ``pow_iters`` and the convergence flag must be equal, and
``rho``, ``g``, both gradient norms, the parameters, the BN statistics
and the eigenvector agree to rtol 1e-8 (float64 math in another
summation order, accumulated over the steps; measured ~1e-13).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from optwboundeigenval_tpu.models.densenet import DenseNet3 as JaxDenseNet3
from optwboundeigenval_tpu.optim import sgd as jax_sgd
from optwboundeigenval_tpu.train import SpectralTrainer as JaxTrainer
from optwboundeigenval_tpu.train import Task as JaxTask
from optwboundeigenval_tpu.utils.tree import tree_uniform_like as jax_uniform
from optwboundeigenval_tpu_torch.configs import cifar10_densenet_mu0_01_K0
from optwboundeigenval_tpu_torch.models.densenet import DenseNet3
from optwboundeigenval_tpu_torch.optim import api as topt
from optwboundeigenval_tpu_torch.optim.schedules import LambdaLR
from optwboundeigenval_tpu_torch.train.driver import build_trainer
from optwboundeigenval_tpu_torch.train.task import Task
from optwboundeigenval_tpu_torch.train.trainer import SpectralTrainer
from optwboundeigenval_tpu_torch.utils.interop import densenet3_from_jax
from optwboundeigenval_tpu_torch.utils.tree import tree_uniform_like

torch.set_num_threads(1)
RTOL = 1e-8
SOLVER = dict(mu=0.01, K=0.0, pow_iter_eps=0.05, max_pow_iter=100)


def _batches(n, seed=7):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        w = np.ones(8, np.float32)
        if i == 1:
            w[-2:] = 0.0  # a padded batch
        out.append({"x": rng.normal(size=(8, 32, 32, 3)).astype(np.float32),
                    "y": rng.integers(0, 10, size=8).astype(np.int32), "w": w})
    return out


def _pair(hvp_micro):
    """A JAX and a port trainer holding the same float64 state."""
    batches = _batches(1)
    jtr = JaxTrainer(JaxTask(model=JaxDenseNet3(depth=10, growth_rate=4,
                                                dtype=jnp.float64),
                             has_batch_stats=True),
                     jax_sgd(0.1, momentum=0.9, weight_decay=1e-4),
                     hvp_micro=hvp_micro, **SOLVER)
    jtr.init_state(batches[0])
    p = jax.tree.map(lambda a: np.asarray(a, np.float64), jtr.params)
    rng = np.random.default_rng(0)
    stats = jax.tree.map(lambda a: np.asarray(a, np.float64)
                         + rng.uniform(0.0, 0.2, size=a.shape),
                         jtr.model_state["batch_stats"])
    jtr.params = jax.tree.map(jnp.asarray, p)
    jtr.model_state = {"batch_stats": jax.tree.map(jnp.asarray, stats)}
    jtr.opt_state = jtr.optimizer.init(jtr.params)
    jtr.v = jax_uniform(jtr.params)

    ttr = SpectralTrainer(Task(model=DenseNet3(depth=10, growth_rate=4),
                               has_batch_stats=True),
                          topt.sgd(0.1, momentum=0.9, weight_decay=1e-4),
                          hvp_micro=hvp_micro, device="cpu", **SOLVER)
    ttr.params, ttr.model_state = densenet3_from_jax(p, stats)
    ttr.opt_state = ttr.optimizer.init(ttr.params)
    ttr.v = tree_uniform_like(ttr.params)
    return jtr, ttr


def _close_tree(got, want_params, want_stats, what):
    """``got`` = (port params-like dict, port stats dict or None)."""
    want = densenet3_from_jax(jax.tree.map(np.asarray, want_params),
                              jax.tree.map(np.asarray, want_stats))
    for g, w in zip(got, want):
        if g is None:
            continue
        assert sorted(g) == sorted(w)
        for k in w:
            np.testing.assert_allclose(g[k].numpy(), w[k].numpy(), rtol=RTOL,
                                       atol=RTOL * float(w[k].abs().max()),
                                       err_msg=f"{what}: {k}")


@pytest.mark.parametrize("hvp_micro,steps", [(2, 3), (0, 1)])
def test_train_steps_match_jax(hvp_micro, steps):
    jtr, ttr = _pair(hvp_micro)
    for i, batch in enumerate(_batches(steps)):
        jm = jtr.train_step(batch)
        tm = ttr.train_step(batch)
        assert tm["step_ok"] and jm["step_ok"]
        assert tm["pow_iters"] == int(jm["pow_iters"]), i
        assert tm["converged"] == bool(jm["converged"]), i
        for k in ("rho", "g", "gradf_norm", "gradg_norm", "norm"):
            np.testing.assert_allclose(tm[k], float(jm[k]), rtol=RTOL,
                                       err_msg=f"step {i}: {k}")
        assert tm["g"] > 0  # K = 0: the vGHv pass runs every step
        _close_tree((ttr.params, ttr.model_state), jtr.params,
                    jtr.model_state["batch_stats"], f"step {i}")
        _close_tree((ttr.v, None), jtr.v, jtr.model_state["batch_stats"],
                    f"step {i} v")


def test_non_finite_step_is_not_committed():
    ttr = SpectralTrainer(Task(model=DenseNet3(depth=10, growth_rate=4),
                               has_batch_stats=True),
                          topt.sgd(0.1), hvp_micro=2, device="cpu",
                          **{**SOLVER, "max_pow_iter": 3})
    ttr.init_state()
    before = {k: t.clone() for k, t in ttr.params.items()}
    batch = _batches(1)[0]
    batch["x"][:] = np.nan
    m = ttr.train_step(batch)
    assert not m["step_ok"]
    for k, t in before.items():
        assert torch.equal(ttr.params[k], t)


def test_entry_points_need_the_card_unless_told():
    task = Task(model=DenseNet3(depth=10, growth_rate=4), has_batch_stats=True)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            SpectralTrainer(task, topt.sgd(0.1))
    # the execution knobs and the mesh build; a model axis needs its ranks
    from optwboundeigenval_tpu_torch.parallel import make_mesh

    for knob in (dict(scan_steps=4), dict(donate=True), dict(mem_track=True),
                 dict(profile_dir="p"), dict(mesh=make_mesh(device="cpu"))):
        tr = SpectralTrainer(task, topt.sgd(0.1), device="cpu", **knob)
        assert all(getattr(tr, k) is v or getattr(tr, k) == v for k, v in knob.items())
    with pytest.raises(ValueError, match="world of 1"):
        make_mesh(model=2, device="cpu")
    # lobpcg is ported: it builds, and refuses what it does not compose with
    assert SpectralTrainer(task, topt.sgd(0.1), device="cpu", lobpcg=True).lobpcg
    for bad in (dict(eigensolver="arnoldi"),
                dict(eigensolver="lanczos", pow_iter_momentum=0.9),
                dict(eigensolver="lanczos", lobpcg=True),
                dict(pow_iter_momentum=0.9, lobpcg=True)):
        with pytest.raises(ValueError):
            SpectralTrainer(task, topt.sgd(0.1), device="cpu", **bad)


def test_config_builds_the_trainer_with_overrides():
    tr = build_trainer(cifar10_densenet_mu0_01_K0.options(device="cpu"))
    assert tr.remat and tr.defer_metrics and tr.eigensolver == "power"
    assert cifar10_densenet_mu0_01_K0.options()["train_loader"].augment is not None
    opts = cifar10_densenet_mu0_01_K0.options(remat=False, hvp_micro=2,
                                              augment=False, device="cpu")
    tr = build_trainer(opts)
    assert (tr.hvp_micro, tr.K, tr.mu, tr.pow_iter_eps, tr.max_pow_iter) == \
        (2, 0.0, 0.01, 0.05, 100)
    assert tr.device == torch.device("cpu") and tr.task.has_batch_stats
    batch = next(iter(opts["train_loader"]))
    assert batch["x"].shape == (32, 32, 32, 3) and batch["w"].sum() == 32
    tr.init_state()
    assert tr.ndim == 176122
    assert opts["scheduler"].lr == 0.1


def _optax_steps(tx, params, grads_seq):
    state = tx.init(params)
    for g in grads_seq:
        upd, state = tx.update(g, state, params)
        params = optax.apply_updates(params, upd)
    return params


@pytest.mark.parametrize("name,kw", [
    ("sgd", dict(learning_rate=0.1)),
    ("sgd", dict(learning_rate=0.1, momentum=0.9, weight_decay=1e-4)),
    ("sgd", dict(learning_rate=0.05, momentum=0.9, nesterov=True)),
    ("adam", dict(learning_rate=1e-3)),
    ("adam", dict(learning_rate=1e-2, weight_decay=1e-3)),
])
def test_optimizers_match_optax(name, kw):
    from optwboundeigenval_tpu.optim import adam as jadam, sgd as jsgd

    rng = np.random.default_rng(2)
    params = {"a": rng.normal(size=(3, 4)), "b": rng.normal(size=5)}
    grads = [{k: rng.normal(size=v.shape) for k, v in params.items()}
             for _ in range(3)]
    jopt = (jsgd if name == "sgd" else jadam)(**kw)
    want = _optax_steps(jopt.tx, {k: jnp.asarray(v) for k, v in params.items()},
                        [{k: jnp.asarray(v) for k, v in g.items()} for g in grads])
    topt_ = getattr(topt, name)(**kw)
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    state = topt_.init(tp)
    for g in grads:
        tp, state = topt_.step({k: torch.from_numpy(v) for k, v in g.items()},
                               state, tp)
    for k in params:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(want[k]), rtol=1e-12)
    assert topt_.get_learning_rate(topt_.set_learning_rate(state, 0.5)) == 0.5


def test_lambda_lr_schedule():
    s = LambdaLR(0.1, lambda i: 1.0 if i < 2 else 0.2)
    assert s.lr == 0.1
    assert [s.step() for _ in range(3)] == [0.1, 0.1 * 0.2, 0.1 * 0.2]


@pytest.mark.parametrize("eigensolver", ["power", "lanczos", "auto"])
def test_eigensolver_resolution_matches_jax(eigensolver):
    """The resolved solver and the Lanczos depth equal the JAX trainer's
    over ``rand_init`` x ``pow_iter_eps`` x ``lanczos_m`` x momentum."""
    from optwboundeigenval_tpu.models import ForestNet as JaxForestNet
    from optwboundeigenval_tpu_torch.models.mlp_forest import ForestNet

    for rand_init in (False, True):
        for eps in (1e-12, 1e-6, 1e-3, 5e-3, 6e-3, 0.05, 0.5, 3.0):
            for lanczos_m in (None, 5):
                for momentum in ((None, 0.9) if eigensolver != "lanczos" else (None,)):
                    kw = dict(eigensolver=eigensolver, rand_init=rand_init,
                              pow_iter_eps=eps, lanczos_m=lanczos_m,
                              pow_iter_momentum=momentum)
                    j = JaxTrainer(JaxTask(model=JaxForestNet()), jax_sgd(0.1), **kw)
                    t = SpectralTrainer(Task(model=ForestNet()), topt.sgd(0.1),
                                        device="cpu", **kw)
                    assert (t.eigensolver, t.lanczos_m, t.rand_init) == \
                        (j.eigensolver, j.lanczos_m, j.rand_init), kw
                    assert t.eigensolver_requested == eigensolver
