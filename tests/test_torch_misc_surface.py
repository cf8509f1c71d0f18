"""The rest of the port's surface against the JAX package at float64 on
the CPU (rtol 1e-12 unless equality is stated):

* ``CNNUSPS(conv_impl='gemm')``: the gradient and HVP of the loss, and the
  gradient to the input, against the JAX gemm model on an input with tied
  maxima in the pool windows (a constant patch; the first conv's weights
  are dyadic, so the tied values are exact on both sides); the pool alone
  on a window of zeros (``amax`` shares the gradient, ``max_pool2d`` does
  not, as JAX's reshape-max and ``nn.max_pool``);
* ``ExponentialLR`` and ``CosineAnnealingLR`` over ``3 * T_max`` epochs
  (equal: the same float64 formulas);
* the curvature oracle ``python -m optwboundeigenval_tpu_torch.hess_test
  --device cpu`` and the JAX oracle's products on the same inputs;
* ``utils/cmd.run_cmd`` (equal output) and its failure.
"""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from optwboundeigenval_tpu.models import CNNUSPS as JaxCNNUSPS
from optwboundeigenval_tpu.models.cnn_usps import reshape_max_pool2 as jax_pool
from optwboundeigenval_tpu.ops import curvature as jcurv
from optwboundeigenval_tpu.optim import schedules as jsched
from optwboundeigenval_tpu.train.task import Task as JaxTask
from optwboundeigenval_tpu.utils import cmd as jcmd
from optwboundeigenval_tpu_torch import hess_test
from optwboundeigenval_tpu_torch.models.cnn_usps import (
    CNNUSPS,
    gemm_conv3x3_same,
    reshape_max_pool2,
)
from optwboundeigenval_tpu_torch.ops import curvature as tcurv
from optwboundeigenval_tpu_torch.optim import schedules
from optwboundeigenval_tpu_torch.train.task import Task
from optwboundeigenval_tpu_torch.utils import cmd, interop

torch.set_num_threads(1)
RTOL = 1e-12
ROOT = Path(__file__).resolve().parents[1]


def _close(got, want, what=""):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * np.abs(want).max(),
                               err_msg=what)


def _tied_case():
    rng = np.random.default_rng(8)
    x = rng.normal(size=(6, 16, 16, 1))
    x[:, :8, :8, 0] = 0.5  # a constant patch: tied maxima after the first conv
    y = rng.integers(0, 10, size=6).astype(np.int32)
    w = np.array([1, 1, 1, 1, 1, 0], np.float32)
    p = JaxCNNUSPS(dtype=jnp.float64, conv_impl="gemm").init(
        jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    p = jax.tree.map(lambda a: np.asarray(a, np.float64), p)
    p["Conv_0"]["kernel"] = np.round(p["Conv_0"]["kernel"] * 16) / 16
    p["Conv_0"]["bias"] = np.full_like(p["Conv_0"]["bias"], 0.25)
    v = jax.tree.map(lambda a: rng.normal(size=a.shape), p)
    return x, y, w, p, v


def test_gemm_gradient_and_hvp_match_jax_at_ties():
    x, y, w, p, v = _tied_case()
    jtask = JaxTask(model=JaxCNNUSPS(dtype=jnp.float64, conv_impl="gemm"))
    ttask = Task(model=CNNUSPS(conv_impl="gemm"))
    jb = {"x": jnp.asarray(x), "y": jnp.asarray(y), "w": jnp.asarray(w)}
    tb = {"x": torch.from_numpy(x), "y": torch.from_numpy(y), "w": torch.from_numpy(w)}
    tp, tv = interop.cnnusps_from_jax(p), interop.cnnusps_from_jax(v)
    # the tie is there: the first pool's windows inside the patch hold four equal values
    t = torch.from_numpy(x[:1]).permute(0, 3, 1, 2)
    c1 = F.relu(gemm_conv3x3_same(t, tp["conv1.weight"], tp["conv1.bias"]))[0, :, 2:4, 2:4]
    assert bool((c1 == c1[:, :1, :1]).all()) and bool((c1 > 0).any())
    jloss = jtask.loss_fn({})
    tloss = ttask.loss_fn({})
    want_g = interop.cnnusps_from_jax(jax.tree.map(np.asarray, jax.jit(jax.grad(jloss))(p, jb)))
    want_hv = interop.cnnusps_from_jax(jax.tree.map(np.asarray, jax.jit(
        lambda p, b, u: jcurv.hvp(jloss, p, b, u))(p, jb, v)))
    got_g = tcurv.grad(tloss, tp, tb)
    got_hv = tcurv.hvp(tloss, tp, tb, tv)
    for k in want_g:
        _close(got_g[k], want_g[k], f"grad {k}")
        _close(got_hv[k], want_hv[k], f"hvp {k}")
    # the gradient to the input, where the tie split shows
    jx = jax.grad(lambda xx: jloss(p, {**jb, "x": xx}))(jb["x"])
    xx = tb["x"].clone().requires_grad_(True)
    (gx,) = torch.autograd.grad(tloss(tp, {**tb, "x": xx}), xx)
    _close(gx, jx, "input gradient")
    lax_x = jax.grad(lambda xx: JaxTask(model=JaxCNNUSPS(dtype=jnp.float64)).loss_fn({})(
        p, {**jb, "x": xx}))(jb["x"])
    assert np.abs(np.asarray(lax_x) - np.asarray(jx)).max() > 1e-6


def test_pool_shares_a_tie_as_jax_reshape_max_does():
    z = np.zeros((1, 2, 2, 1))
    want = np.asarray(jax.grad(lambda a: jax_pool(a).sum())(jnp.asarray(z)))
    t = torch.zeros(1, 1, 2, 2, dtype=torch.float64, requires_grad=True)
    (got,) = torch.autograd.grad(reshape_max_pool2(t).sum(), t)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)
    np.testing.assert_array_equal(want.ravel(), [0.25] * 4)
    (lax,) = torch.autograd.grad(F.max_pool2d(t, 2).sum(), t)
    assert sorted(lax.ravel().tolist()) == [0.0, 0.0, 0.0, 1.0]


@pytest.mark.parametrize("name", ["exponential", "cosine"])
def test_schedules_match_jax_over_three_periods(name):
    t_max = 5
    if name == "exponential":
        pair = (schedules.ExponentialLR(0.5, gamma=0.9), jsched.ExponentialLR(0.5, gamma=0.9))
    else:
        pair = (schedules.CosineAnnealingLR(0.5, T_max=t_max, eta_min=0.01),
                jsched.CosineAnnealingLR(0.5, T_max=t_max, eta_min=0.01))
    got, want = pair
    assert got.lr == want.lr
    lrs = [(got.step(1.0), want.step(1.0)) for _ in range(3 * t_max)]
    assert [a for a, _ in lrs] == [b for _, b in lrs]
    if name == "cosine":  # no clamp at T_max: the lr rises again after it
        assert lrs[t_max - 1][0] == pytest.approx(0.01) and lrs[2 * t_max - 1][0] == 0.5


def _jax_toy_loss(params, batch):
    """The toy network of the repo's ``hess_test.py`` (importing that
    script would switch JAX to float64 for the whole process)."""
    x, y = batch
    h = jax.nn.sigmoid(x @ params["w1"] + params["b1"])
    out = jax.nn.sigmoid(h @ params["w2"] + params["b2"])
    return jnp.mean((out - y) ** 2)


def test_oracle_on_the_cpu():
    out = subprocess.run([sys.executable, "-m", "optwboundeigenval_tpu_torch.hess_test",
                          "--device", "cpu"], cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().endswith("PASS") and "R2-op diff" in out.stdout
    # the port's products equal the JAX oracle's on the same toy problem
    params, batch, v = hess_test.toy_problem(3)
    diffs = hess_test.oracle(params, batch, v, "cpu")
    assert all(diffs[k] < b for k, b in hess_test.BOUNDS.items())
    jp = {k: jnp.asarray(a) for k, a in params.items()}
    jbatch = tuple(jnp.asarray(a) for a in batch)
    jv = {k: jnp.asarray(a) for k, a in v.items()}
    want = {"grad": jcurv.grad(_jax_toy_loss, jp, jbatch),
            "hvp": jcurv.hvp(_jax_toy_loss, jp, jbatch, jv),
            "vghv": jcurv.vghv(_jax_toy_loss, jp, jbatch, jv)}
    assert want["grad"]["w1"].dtype == jnp.float64
    tp = {k: torch.from_numpy(a) for k, a in params.items()}
    tbatch = tuple(torch.from_numpy(a) for a in batch)
    tv = {k: torch.from_numpy(a) for k, a in v.items()}
    got = {"grad": tcurv.grad(hess_test.toy_loss, tp, tbatch),
           "hvp": tcurv.hvp(hess_test.toy_loss, tp, tbatch, tv),
           "vghv": tcurv.vghv(hess_test.toy_loss, tp, tbatch, tv)}
    for name in want:
        for k in params:
            _close(got[name][k], np.asarray(want[name][k]), f"{name} {k}")


@pytest.mark.parametrize("use_pty", [False, True])
def test_run_cmd_matches_jax(use_pty):
    argv = [sys.executable, "-c", "import sys; print('a\\rb'); print('c', file=sys.stderr)"]
    got = cmd.run_cmd(argv, use_pty=use_pty, silent=True)
    assert got == jcmd.run_cmd(argv, use_pty=use_pty, silent=True)
    assert "b" in got and "c" in got and "a" not in got
    with pytest.raises(subprocess.CalledProcessError) as err:
        cmd.run_cmd([sys.executable, "-c", "print('x'); raise SystemExit(3)"], silent=True)
    assert err.value.returncode == 3 and "x" in err.value.output
