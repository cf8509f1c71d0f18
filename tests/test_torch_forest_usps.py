"""The port's ForestNet and CNNUSPS, their weight interop and the cached
``linearize_hvp`` against the JAX package at float64 on the CPU.

Same numpy-seeded inputs and the same weights (flax init, converted).
Forwards, gradients and HVPs agree to rtol 1e-10: the same float64 math
summed in other orders (measured ~1e-15).  The cached linearization (one
gradient graph, one reverse pass per HVP) is held to JAX
``linearize_hvp``, to JAX ``hvp`` and to the port's forward-over-reverse
closure, on both models and on a depth-10 DenseNet3 with BatchNorm.
Weight maps are transposes and permutations, so round trips are exact.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optwboundeigenval_tpu.models import CNNUSPS as JaxCNNUSPS
from optwboundeigenval_tpu.models import ForestNet as JaxForestNet
from optwboundeigenval_tpu.models.densenet import DenseNet3 as JaxDenseNet3
from optwboundeigenval_tpu.ops import curvature as jcurv
from optwboundeigenval_tpu.train.task import Task as JaxTask
from optwboundeigenval_tpu.utils.torch_interop import (
    convert_cnnusps_state_dict,
    convert_forestnet_state_dict,
)
from optwboundeigenval_tpu_torch.models.cnn_usps import CNNUSPS
from optwboundeigenval_tpu_torch.models.densenet import DenseNet3
from optwboundeigenval_tpu_torch.models.mlp_forest import ForestNet
from optwboundeigenval_tpu_torch.ops import curvature as tcurv
from optwboundeigenval_tpu_torch.train.task import Task
from optwboundeigenval_tpu_torch.utils import interop

torch.set_num_threads(1)
RTOL = 1e-10


def _close(want, got, what=""):
    assert sorted(want) == sorted(got)
    for k in want:
        w = np.asarray(want[k])
        np.testing.assert_allclose(np.asarray(got[k]), w, rtol=RTOL,
                                   atol=RTOL * np.abs(w).max(), err_msg=f"{what} {k}")


@functools.lru_cache(maxsize=None)
def _model(name):
    """``(jax task, flax params, batch stats or None, port task, to_port,
    x)`` with float64 flax weights and numpy inputs."""
    rng = np.random.default_rng({"forest": 0, "cnn": 1, "densenet": 2}[name])
    if name == "forest":
        jm, tm, x = JaxForestNet(dtype=jnp.float64), ForestNet(), rng.normal(size=(16, 54))
    elif name == "cnn":
        jm, tm, x = JaxCNNUSPS(dtype=jnp.float64), CNNUSPS(), rng.normal(size=(16, 16, 16, 1))
    else:
        jm, tm = JaxDenseNet3(depth=10, growth_rate=4, dtype=jnp.float64), \
            DenseNet3(depth=10, growth_rate=4)
        x = rng.normal(size=(8, 32, 32, 3))
    bn = name == "densenet"
    jtask = JaxTask(model=jm, has_batch_stats=bn)
    p, s = jtask.init(jax.random.PRNGKey(5), jnp.asarray(x))
    p = jax.tree.map(lambda a: np.asarray(a, np.float64), p)
    stats = None
    if bn:
        stats = jax.tree.map(lambda a: np.asarray(a, np.float64) + 0.25, s["batch_stats"])
        to_port = lambda tree: interop.densenet3_from_jax(tree, stats)[0]
    else:
        to_port = {"forest": interop.forestnet_from_jax,
                   "cnn": interop.cnnusps_from_jax}[name]
    return jtask, p, stats, Task(model=tm, has_batch_stats=bn), to_port, x


@functools.lru_cache(maxsize=None)
def _case(name):
    jtask, p, stats, ttask, to_port, x = _model(name)
    rng = np.random.default_rng(9)
    n = len(x)
    y = rng.integers(0, 7, size=n).astype(np.int32)
    w = np.concatenate([np.ones(n - 2), np.zeros(2)]).astype(np.float32)
    v = jax.tree.map(lambda a: rng.normal(size=a.shape), p)
    jstate = {"batch_stats": stats} if stats is not None else {}
    tp = to_port(p)
    ts = interop.densenet3_from_jax(p, stats)[1] if stats is not None else {}
    jb = {"x": jnp.asarray(x), "y": jnp.asarray(y), "w": jnp.asarray(w)}
    tb = {"x": torch.from_numpy(x), "y": torch.from_numpy(y), "w": torch.from_numpy(w)}
    return (jtask.loss_fn(jstate), p, jb, v), (ttask.loss_fn(ts), tp, tb, to_port(v)), to_port


@pytest.fixture(params=["forest", "cnn", "densenet"])
def case(request):
    return _case(request.param)


@pytest.mark.parametrize("name", ["forest", "cnn"])
def test_names_and_interop_round_trip(name):
    _, p, _, ttask, to_port, _ = _model(name)
    tp = to_port(p)
    assert sorted(tp) == sorted(k for k, _ in ttask.model.named_parameters())
    to_jax = {"forest": interop.forestnet_to_jax, "cnn": interop.cnnusps_to_jax}[name]
    back = to_jax(tp)
    assert jax.tree.structure(back) == jax.tree.structure(p)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(p)):
        np.testing.assert_array_equal(a, b)
    # the port's names and layouts are the reference torch model's: the JAX
    # package's converter of reference state dicts reads them as they are
    convert = {"forest": convert_forestnet_state_dict,
               "cnn": convert_cnnusps_state_dict}[name]
    for a, b in zip(jax.tree.leaves(convert({k: t.numpy() for k, t in tp.items()})),
                    jax.tree.leaves(p)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name,flat", [("forest", False), ("cnn", False), ("cnn", True)])
def test_forward_matches_flax(name, flat):
    jtask, p, _, ttask, to_port, x = _model(name)
    want = np.asarray(jtask.model.apply({"params": p}, jnp.asarray(x)))
    xin = x.reshape(len(x), -1) if flat else x
    got = ttask.predict(to_port(p), {}, {"x": torch.from_numpy(xin)}).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * np.abs(want).max())


def test_cnn_gemm_is_not_ported():
    """``conv_impl='gemm'`` is ported: its forward equals the JAX gemm
    model's on the same weights (and the lax forward); its derivatives are
    held to JAX's in ``tests/test_torch_misc_surface.py``."""
    _, p, _, _, to_port, x = _model("cnn")
    want = JaxCNNUSPS(dtype=jnp.float64, conv_impl="gemm").apply({"params": p}, jnp.asarray(x))
    gemm = Task(model=CNNUSPS(conv_impl="gemm"))
    got = gemm.predict(to_port(p), {}, {"x": torch.from_numpy(x)}).numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL,
                               atol=RTOL * np.abs(np.asarray(want)).max())
    lax = Task(model=CNNUSPS()).predict(to_port(p), {}, {"x": torch.from_numpy(x)}).numpy()
    np.testing.assert_allclose(got, lax, rtol=RTOL, atol=RTOL * np.abs(lax).max())
    with pytest.raises(ValueError, match="conv_impl"):
        CNNUSPS(conv_impl="fft")


def _jit(fn, loss_fn, *args):
    return jax.jit(lambda *a: fn(loss_fn, *a))(*args)


def test_cached_linearize_hvp(case):
    """Port ``linearize_hvp`` against JAX ``linearize_hvp`` and ``hvp`` and
    against the port's closure; its gradient against both gradients."""
    (jl, jp, jb, jv), (tl, tp, tb, tv), to_port = case
    jg, jhvp = jax.jit(lambda p, b, u: (lambda g, f: (g, f(u)))(
        *jcurv.linearize_hvp(jl, p, b)))(jp, jb, jv)
    want_hv = to_port(jax.tree.map(np.asarray, jhvp))
    g, hvp_fn = tcurv.linearize_hvp(tl, tp, tb)
    _close(to_port(jax.tree.map(np.asarray, jg)), g, "grad")
    _close(want_hv, hvp_fn(tv), "cached hvp")
    _close(want_hv, hvp_fn(tv), "cached hvp, second call")
    _close(to_port(jax.tree.map(np.asarray, _jit(jcurv.hvp, jl, jp, jb, jv))),
           tcurv.hvp(tl, tp, tb, tv), "closure hvp")
    assert not any(t.requires_grad for t in g.values())


@pytest.mark.parametrize("name", ["forest", "cnn"])
def test_vghv_matches_jax(name):
    """(DenseNet3's vGHv is held to JAX in ``test_torch_curvature.py``.)"""
    (jl, jp, jb, jv), (tl, tp, tb, tv), to_port = _case(name)
    _close(to_port(jax.tree.map(np.asarray, _jit(jcurv.vghv, jl, jp, jb, jv))),
           tcurv.vghv(tl, tp, tb, tv), "vghv")
