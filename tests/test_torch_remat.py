"""``remat``: the loss under ``torch.utils.checkpoint``.

``torch.func`` transforms refuse the checkpoint's saved-tensor hooks, so
every curvature product is plain autograd.  At float64 on the CPU, on a
small DenseNet3 (BatchNorm) and on CNNUSPS, each product with remat on
(``curvature.checkpointed``) must equal

* the same product with remat off to rtol 1e-12 (the recomputed forward
  is the same arithmetic; measured bit-equal);
* the JAX package's product of its ``jax.checkpoint``-ed loss to rtol
  1e-10.

And no ``torch.func`` transform is reached under remat, the checkpoint
really recomputes the forward, and the trainer's remat steps equal the
JAX trainer's (rtol 1e-10) and its own without remat (rtol 1e-12).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optwboundeigenval_tpu.models import CNNUSPS as JaxCNNUSPS
from optwboundeigenval_tpu.models.densenet import DenseNet3 as JaxDenseNet3
from optwboundeigenval_tpu.ops import curvature as jcurv
from optwboundeigenval_tpu.optim import sgd as jax_sgd
from optwboundeigenval_tpu.train import SpectralTrainer as JaxTrainer
from optwboundeigenval_tpu.train.task import Task as JaxTask
from optwboundeigenval_tpu.utils.tree import tree_uniform_like as jax_uniform
from optwboundeigenval_tpu_torch.models.cnn_usps import CNNUSPS
from optwboundeigenval_tpu_torch.models.densenet import DenseNet3
from optwboundeigenval_tpu_torch.ops import curvature as tcurv
from optwboundeigenval_tpu_torch.optim import api as topt
from optwboundeigenval_tpu_torch.train.task import Task
from optwboundeigenval_tpu_torch.train.trainer import SpectralTrainer
from optwboundeigenval_tpu_torch.utils.interop import cnnusps_from_jax, densenet3_from_jax
from optwboundeigenval_tpu_torch.utils.tree import tree_uniform_like

torch.set_num_threads(1)


def _densenet():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(8, 32, 32, 3))
    jtask = JaxTask(model=JaxDenseNet3(depth=10, growth_rate=4, dtype=jnp.float64),
                    has_batch_stats=True)
    p, s = jtask.init(jax.random.PRNGKey(0), jnp.asarray(x))
    p = jax.tree.map(lambda a: np.asarray(a, np.float64), p)
    stats = jax.tree.map(lambda a: np.asarray(a, np.float64) + 0.25, s["batch_stats"])
    v = jax.tree.map(lambda a: rng.normal(size=a.shape), p)
    to_port = lambda tree: densenet3_from_jax(jax.tree.map(np.asarray, tree), stats)[0]
    tp, ts = densenet3_from_jax(p, stats)
    ttask = Task(model=DenseNet3(depth=10, growth_rate=4), has_batch_stats=True)
    return (x, rng, jtask.loss_fn({"batch_stats": stats}), p, v,
            ttask.loss_fn(ts), tp, to_port(v), to_port)


def _cnnusps():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(8, 16, 16, 1))
    jtask = JaxTask(model=JaxCNNUSPS(dtype=jnp.float64))
    p, _ = jtask.init(jax.random.PRNGKey(0), jnp.asarray(x))
    p = jax.tree.map(lambda a: np.asarray(a, np.float64), p)
    v = jax.tree.map(lambda a: rng.normal(size=a.shape), p)
    to_port = lambda tree: cnnusps_from_jax(jax.tree.map(np.asarray, tree))
    return (x, rng, jtask.loss_fn({}), p, v, Task(model=CNNUSPS()).loss_fn({}),
            to_port(p), to_port(v), to_port)


@pytest.fixture(scope="module", params=["densenet", "cnnusps"])
def model(request):
    x, rng, jloss, jp, jv, tloss, tp, tv, to_port = {
        "densenet": _densenet, "cnnusps": _cnnusps}[request.param]()
    y = rng.integers(0, 10, size=8).astype(np.int32)
    w = np.concatenate([np.ones(6), np.zeros(2)]).astype(np.float32)
    jb = {"x": jnp.asarray(x), "y": jnp.asarray(y), "w": jnp.asarray(w)}
    tb = {"x": torch.from_numpy(x), "y": torch.from_numpy(y), "w": torch.from_numpy(w)}
    return (jax.checkpoint(jloss), jp, jb, jv), (tloss, tp, tb, tv), to_port


def _linearized(loss_fn, p, b, v):
    g, hvp_fn = tcurv.linearize_hvp(loss_fn, p, b)
    return {**{f"g:{k}": t for k, t in g.items()}, **hvp_fn(v)}


def _jax_linearized(loss_fn, p, b, v):
    g, hvp_fn = jcurv.linearize_hvp(loss_fn, p, b)
    return g, hvp_fn(v)


# name: (port function, JAX function, takes v)
FORMS = {
    "grad": (tcurv.grad, jcurv.grad, False),
    "linearize_hvp": (_linearized, _jax_linearized, True),
    "hvp": (tcurv.hvp, jcurv.hvp, True),
    "vghv": (tcurv.vghv, jcurv.vghv, True),
    "grad_micro2": (lambda *a: tcurv.grad_microbatched(*a, 2),
                    lambda *a: jcurv.grad_microbatched(*a, 2), False),
    "hvp_micro2": (lambda *a: tcurv.hvp_microbatched(*a, 2),
                   lambda *a: jcurv.hvp_microbatched(*a, 2), True),
    "vghv_micro2": (lambda *a: tcurv.vghv_microbatched(*a, 2),
                    lambda *a: jcurv.vghv_microbatched(*a, 2), True),
}


def _close(got, want, rtol):
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        w = np.asarray(w)
        np.testing.assert_allclose(np.asarray(got[k]), w, rtol=rtol,
                                   atol=rtol * np.abs(w).max(), err_msg=k)


@pytest.mark.parametrize("form", sorted(FORMS))
def test_remat_equals_no_remat_and_jax(model, form):
    (jl, jp, jb, jv), (tl, tp, tb, tv), to_port = model
    tfn, jfn, takes_v = FORMS[form]
    targs, jargs = (tp, tb, tv) if takes_v else (tp, tb), (jp, jb, jv) if takes_v else (jp, jb)
    on = tfn(tcurv.checkpointed(tl), *targs)
    off = tfn(tl, *targs)
    _close(on, off, 1e-12)
    want = jax.jit(lambda *a: jfn(jl, *a))(*jargs)
    if form == "linearize_hvp":
        g, hv = want
        want = {**{f"g:{k}": t for k, t in to_port(g).items()}, **to_port(hv)}
    else:
        want = to_port(want)
    _close(on, want, 1e-10)


def test_checkpoint_recomputes_the_forward(model):
    """The checkpoint is real: each backward pass runs the forward again."""
    _, (tl, tp, tb, tv), _ = model
    calls = []
    counted = lambda p, b: (calls.append(1), tl(p, b))[1]
    tcurv.grad(tcurv.checkpointed(counted), tp, tb)
    assert len(calls) == 2
    calls.clear()
    tcurv.grad(counted, tp, tb)
    assert len(calls) == 1


def _no_torch_func(monkeypatch):
    """Make every ``torch.func`` transform raise."""
    def refuse(*a, **k):
        raise AssertionError("a torch.func transform was reached under remat")

    for name in ("grad", "grad_and_value", "jvp", "vjp", "vmap", "jacrev",
                 "jacfwd", "hessian", "linearize"):
        monkeypatch.setattr(torch.func, name, refuse)


def test_torch_func_is_never_reached_under_remat(model, monkeypatch):
    _, (tl, tp, tb, tv), _ = model
    _no_torch_func(monkeypatch)
    with pytest.raises(AssertionError, match="torch.func"):
        torch.func.grad(tl)(tp, tb)  # the guard holds
    loss = tcurv.checkpointed(tl)
    for form, (fn, _, takes_v) in FORMS.items():
        fn(loss, tp, tb, *((tv,) if takes_v else ()))


# ---- the trainer ---------------------------------------------------------


SOLVER = dict(mu=0.01, K=0.0, pow_iter_eps=0.05, max_pow_iter=100)


def _batches(n, seed=7):
    rng = np.random.default_rng(seed)
    return [{"x": rng.normal(size=(8, 32, 32, 3)).astype(np.float32),
             "y": rng.integers(0, 10, size=8).astype(np.int32),
             "w": np.ones(8, np.float32)} for _ in range(n)]


def _pair(hvp_micro, remat):
    batch = _batches(1)[0]
    jtr = JaxTrainer(JaxTask(model=JaxDenseNet3(depth=10, growth_rate=4,
                                                dtype=jnp.float64),
                             has_batch_stats=True),
                     jax_sgd(0.1, momentum=0.9), hvp_micro=hvp_micro,
                     remat=True, **SOLVER)
    jtr.init_state(batch)
    p = jax.tree.map(lambda a: np.asarray(a, np.float64), jtr.params)
    stats = jax.tree.map(lambda a: np.asarray(a, np.float64) + 0.1,
                         jtr.model_state["batch_stats"])
    jtr.params = jax.tree.map(jnp.asarray, p)
    jtr.model_state = {"batch_stats": jax.tree.map(jnp.asarray, stats)}
    jtr.opt_state = jtr.optimizer.init(jtr.params)
    jtr.v = jax_uniform(jtr.params)
    ttr = SpectralTrainer(Task(model=DenseNet3(depth=10, growth_rate=4),
                               has_batch_stats=True),
                          topt.sgd(0.1, momentum=0.9), hvp_micro=hvp_micro,
                          remat=remat, device="cpu", **SOLVER)
    ttr.params, ttr.model_state = densenet3_from_jax(p, stats)
    ttr.opt_state = ttr.optimizer.init(ttr.params)
    ttr.v = tree_uniform_like(ttr.params)
    return jtr, ttr


@pytest.mark.parametrize("hvp_micro", [0, 2])
def test_remat_train_steps_match_jax_and_no_remat(hvp_micro, monkeypatch):
    """Two steps with ``remat=True`` against the JAX trainer's
    ``remat=True`` (rtol 1e-10) and the port's ``remat=False`` (rtol
    1e-12); ``torch.func`` refuses to run in the remat trainer."""
    jtr, on = _pair(hvp_micro, remat=True)
    _, off = _pair(hvp_micro, remat=False)
    for i, batch in enumerate(_batches(2)):
        jm = jtr.train_step(batch)
        om = off.train_step(batch)
        with monkeypatch.context() as m:
            _no_torch_func(m)
            tm = on.train_step(batch)
        assert tm["pow_iters"] == om["pow_iters"] == int(jm["pow_iters"]), i
        assert tm["g"] > 0
        for k in ("rho", "g", "gradf_norm", "gradg_norm", "norm"):
            np.testing.assert_allclose(tm[k], om[k], rtol=1e-12, err_msg=k)
            np.testing.assert_allclose(tm[k], float(jm[k]), rtol=1e-10, err_msg=k)
        _close(on.params, off.params, 1e-12)
        want = densenet3_from_jax(jax.tree.map(np.asarray, jtr.params),
                                  jax.tree.map(np.asarray, jtr.model_state["batch_stats"]))
        _close(on.params, want[0], 1e-10)
        _close(on.model_state, want[1], 1e-10)
