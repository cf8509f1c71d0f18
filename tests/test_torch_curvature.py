"""The port's ``ops/curvature.py`` against the JAX package at float64 on
the CPU: ``grad``, ``hvp``, ``vghv`` and the three ``*_microbatched``
functions (whose accumulate is K1, the wrapper's plain CPU version), on
the toy MLP of ``tests/test_pallas_micro.py`` and on a small DenseNet3
with BatchNorm.  Same numpy-seeded inputs and converted weights on both
sides.  Tolerance rtol 1e-9: both sides compute the same float64 math,
summed in different orders (measured agreement ~1e-14).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optwboundeigenval_tpu.models.densenet import DenseNet3 as JaxDenseNet3
from optwboundeigenval_tpu.ops import curvature as jcurv
from optwboundeigenval_tpu.train.task import Task as JaxTask
from optwboundeigenval_tpu_torch.models.densenet import DenseNet3
from optwboundeigenval_tpu_torch.ops import curvature as tcurv
from optwboundeigenval_tpu_torch.ops import pallas_kernels
from optwboundeigenval_tpu_torch.train.task import Task
from optwboundeigenval_tpu_torch.utils.interop import densenet3_from_jax

torch.set_num_threads(1)
RTOL = 1e-9


def _close(want: dict, got: dict):
    assert sorted(want) == sorted(got)
    for k in want:
        w = np.asarray(want[k])
        np.testing.assert_allclose(got[k].numpy(), w, rtol=RTOL,
                                   atol=RTOL * np.abs(w).max(), err_msg=k)


# ---- toy MLP (tests/test_pallas_micro.py) -------------------------------


def _jax_mlp_loss(params, batch):
    x, y, w = batch["x"], batch["y"], batch["w"]
    out = jnp.tanh(x @ params["w1"]) @ params["w2"]
    per = jnp.mean((out - y) ** 2, axis=1)
    return jnp.sum(per * w) / jnp.maximum(jnp.sum(w), 1e-12)


def _torch_mlp_loss(params, batch):
    x, y, w = batch["x"], batch["y"], batch["w"]
    out = torch.tanh(x @ params["w1"]) @ params["w2"]
    per = ((out - y) ** 2).mean(dim=1)
    return (per * w).sum() / torch.clamp_min(w.sum(), 1e-12)


@pytest.fixture(scope="module")
def mlp():
    rng = np.random.default_rng(0)
    params = {"w1": rng.normal(size=(6, 5)) * 0.5,
              "w2": rng.normal(size=(5, 3)) * 0.5}
    batch = {"x": rng.normal(size=(16, 6)), "y": rng.normal(size=(16, 3)),
             "w": np.concatenate([np.ones(12), np.zeros(4)]).astype(np.float32)}
    v = {k: rng.normal(size=p.shape) for k, p in params.items()}
    t = lambda tree: {k: torch.from_numpy(a) for k, a in tree.items()}
    j = lambda tree: {k: jnp.asarray(a) for k, a in tree.items()}
    return ((_jax_mlp_loss, j(params), j(batch), j(v)),
            (_torch_mlp_loss, t(params), t(batch), t(v)))


# ---- small DenseNet3 with BatchNorm ---------------------------------------


@pytest.fixture(scope="module")
def densenet():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(8, 32, 32, 3))
    y = rng.integers(0, 10, size=8).astype(np.int32)
    w = np.concatenate([np.ones(6), np.zeros(2)]).astype(np.float32)
    jtask = JaxTask(model=JaxDenseNet3(depth=10, growth_rate=4, dtype=jnp.float64),
                    has_batch_stats=True)
    p, s = jtask.init(jax.random.PRNGKey(0), jnp.asarray(x))
    p = jax.tree.map(lambda a: np.asarray(a, np.float64), p)
    # non-trivial running stats: they must stay frozen in the loss
    stats = jax.tree.map(lambda a: np.asarray(a, np.float64) + 0.25,
                         s["batch_stats"])
    v = jax.tree.map(lambda a: rng.normal(size=a.shape), p)
    ttask = Task(model=DenseNet3(depth=10, growth_rate=4), has_batch_stats=True)
    tp, ts = densenet3_from_jax(p, stats)
    tv, _ = densenet3_from_jax(v, stats)
    jb = {"x": jnp.asarray(x), "y": jnp.asarray(y), "w": jnp.asarray(w)}
    tb = {"x": torch.from_numpy(x), "y": torch.from_numpy(y),
          "w": torch.from_numpy(w)}
    return ((jtask.loss_fn({"batch_stats": stats}), p, jb, v),
            (ttask.loss_fn(ts), tp, tb, tv), stats)


def _jax(fn, loss_fn, *args):
    """``fn(loss_fn, *args)`` compiled: eager JAX dispatches DenseNet op by
    op, several times slower than one compile."""
    return jax.jit(lambda *a: fn(loss_fn, *a))(*args)


def _as_port(tree, model_fixture):
    if model_fixture[-1] is None:
        return tree
    return densenet3_from_jax(jax.tree.map(np.asarray, tree), model_fixture[-1])[0]


@pytest.fixture(params=["mlp", "densenet"])
def case(request, mlp, densenet):
    return {"mlp": (*mlp, None), "densenet": densenet}[request.param]


def test_grad(case):
    (jl, jp, jb, _), (tl, tp, tb, _), _ = case
    _close(_as_port(_jax(jcurv.grad, jl, jp, jb), case), tcurv.grad(tl, tp, tb))


def test_hvp_and_linearize(case):
    (jl, jp, jb, jv), (tl, tp, tb, tv), _ = case
    want = _as_port(_jax(jcurv.hvp, jl, jp, jb, jv), case)
    _close(want, tcurv.hvp(tl, tp, tb, tv))
    g, hvp_fn = tcurv.linearize_hvp(tl, tp, tb)
    _close(want, hvp_fn(tv))
    _close(tcurv.grad(tl, tp, tb), g)


def test_vghv(case):
    (jl, jp, jb, jv), (tl, tp, tb, tv), _ = case
    _close(_as_port(_jax(jcurv.vghv, jl, jp, jb, jv), case),
           tcurv.vghv(tl, tp, tb, tv))


@pytest.mark.parametrize("fn", ["grad", "hvp", "vghv"])
def test_microbatched(case, fn):
    (jl, jp, jb, jv), (tl, tp, tb, tv), _ = case
    name = f"{fn}_microbatched"
    jargs, targs = (jl, jp, jb), (tl, tp, tb)
    if fn != "grad":
        jargs, targs = jargs + (jv,), targs + (tv,)
    want = _as_port(_jax(lambda *a: getattr(jcurv, name)(*a, 2), *jargs), case)
    _close(want, getattr(tcurv, name)(*targs, 2))
    assert pallas_kernels.axpy_accumulate.launches == 0


def test_microbatched_rejects_uneven_split(mlp):
    _, (tl, tp, tb, tv) = mlp
    with pytest.raises(ValueError, match="micro-batches"):
        tcurv.hvp_microbatched(tl, tp, tb, tv, 3)
