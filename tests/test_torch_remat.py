"""``remat``: the HVP map that keeps no graph between products
(``curvature.recompute_hvp``), the counterpart of the JAX package's
``jax.linearize(grad(jax.checkpoint(loss)))``.

At float64 on the CPU, on a small DenseNet3 (BatchNorm) and on CNNUSPS,
each curvature product as the remat trainer takes it must equal

* the same product with remat off to rtol 1e-12 (the recomputed forward
  is the same arithmetic; measured bit-equal);
* the JAX package's product of its ``jax.checkpoint``-ed loss to rtol
  1e-10.

And no ``torch.func`` transform is reached (every product is plain
autograd), the remat map really recomputes the forward per product, and
the trainer's remat steps equal the JAX trainer's (rtol 1e-10) and its
own without remat (rtol 1e-12).

The trainer's ``remat`` bounds memory as ``jax.linearize(grad(
jax.checkpoint(loss)))`` does: no tensor that autograd saved outlives an
HVP call of its map (counted with ``saved_tensors_hooks``), and under
both settings the map, with its graph, is gone before the vGHv pass.
"""

import gc
import weakref

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
from optwboundeigenval_tpu_torch.ops import spectral as tspectral
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


def _recomputed(loss_fn, p, b, v):
    g, hvp_fn = tcurv.recompute_hvp(loss_fn, p, b)
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


# the remat trainer's form of a product where it has its own: the
# linearization; every other product keeps nothing after it returns
REMAT = {"linearize_hvp": _recomputed}


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
    on = REMAT.get(form, tfn)(tl, *targs)
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
    """The remat map is real: each HVP runs the forward again, where the
    linearized map runs it once for all its products."""
    _, (tl, tp, tb, tv), _ = model
    calls = []
    counted = lambda p, b: (calls.append(1), tl(p, b))[1]
    for make, want in ((tcurv.recompute_hvp, 3), (tcurv.linearize_hvp, 1)):
        calls.clear()
        _, hvp_fn = make(counted, tp, tb)
        hvp_fn(tv)
        hvp_fn(tv)
        assert len(calls) == want, make.__name__


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
    for form, (fn, _, takes_v) in FORMS.items():
        REMAT.get(form, fn)(tl, tp, tb, *((tv,) if takes_v else ()))


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


# ---- what the remat map holds --------------------------------------------


class _Box:
    __slots__ = ("t", "__weakref__")

    def __init__(self, t):
        self.t = t


class _Saved:
    """Every tensor autograd saves under these hooks, boxed, and the boxes
    still alive (a box dies with the graph that holds it).  A box holds a
    detached alias: the saved output of an op, boxed with its
    ``grad_fn``, would make a cycle the collector cannot see."""

    def __init__(self):
        self.live = weakref.WeakSet()
        self.packed = 0

    def pack(self, t):
        box = _Box(t.detach())
        self.live.add(box)
        self.packed += 1
        return box

    @staticmethod
    def unpack(box):
        return box.t

    def held(self) -> int:
        gc.collect()
        return len(self.live)


def _port_trainer(remat):
    tr = SpectralTrainer(Task(model=DenseNet3(depth=10, growth_rate=4), has_batch_stats=True),
                         topt.sgd(0.1, momentum=0.9), remat=remat, device="cpu", **SOLVER)
    tr.init_state()
    tr.params = {k: t.double() for k, t in tr.params.items()}
    tr.model_state = {k: t.double() for k, t in tr.model_state.items()}
    tr.opt_state = tr.optimizer.init(tr.params)
    tr.v = tree_uniform_like(tr.params)
    return tr


@pytest.mark.parametrize("remat", [True, False])
def test_remat_map_keeps_no_saved_tensor_between_hvps(remat):
    """Under ``remat`` the HVP map holds only ``params`` and the batch:
    nothing autograd saved survives a call, and a second call gives the
    same product.  Without it the linearized graph stays until the map
    goes."""
    tr = _port_trainer(remat)
    batch = tr.put_batch(_batches(1)[0])
    saved = _Saved()
    with torch.autograd.graph.saved_tensors_hooks(saved.pack, saved.unpack):
        _, hvp_fn = tr._linearize(tr._loss_fn(tr.model_state), tr.params, batch)
        first = hvp_fn(tr.v)
        held = saved.held()
        second = hvp_fn(tr.v)
    assert saved.packed > 0
    assert (held == 0) if remat else (held > 0)
    _close(second, first, 0.0)
    del hvp_fn
    assert saved.held() == 0


@pytest.mark.parametrize("remat", [True, False])
def test_hvp_map_is_released_before_the_vghv(remat, monkeypatch):
    """In a step, the eigensolve's map and every tensor its graph saved
    are gone when ``penalty_and_grad`` starts; the step still runs the
    vGHv pass."""
    tr = _port_trainer(remat)
    saved, maps, seen = _Saved(), [], []
    make = "recompute_hvp" if remat else "linearize_hvp"
    real_make, real_penalty = getattr(tcurv, make), tspectral.penalty_and_grad

    def tracked(*a, **k):
        g, hvp_fn = real_make(*a, **k)
        maps.append(weakref.ref(hvp_fn))
        return g, hvp_fn

    def penalty(*a, **k):
        seen.append((maps[-1]() is None, saved.held()))
        return real_penalty(*a, **k)

    monkeypatch.setattr(tcurv, make, tracked)
    monkeypatch.setattr(tspectral, "penalty_and_grad", penalty)
    with torch.autograd.graph.saved_tensors_hooks(saved.pack, saved.unpack):
        m = tr.train_step(_batches(1)[0])
    assert m["g"] > 0 and m["gradg_norm"] > 0 and m["pow_iters"] > 1
    assert seen == [(True, 0)]
