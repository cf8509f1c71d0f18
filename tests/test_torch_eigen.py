"""The port's ``ops/eigen.py`` and ``ops/spectral.py`` against the JAX
package at float64 on dense symmetric operators with known spectra.

The solvers must take the same decisions: equal iteration counts and
convergence flags, and ``rho``, the residual norms and ``v`` to rtol
1e-10 (the same float64 arithmetic in another summation order; measured
~1e-15).  The residual norms near convergence are differences of
vectors of norm ~|lambda|, so they also get atol 1e-14.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optwboundeigenval_tpu.ops import eigen as jeig
from optwboundeigenval_tpu.ops import spectral as jspec
from optwboundeigenval_tpu_torch.ops import eigen as teig
from optwboundeigenval_tpu_torch.ops import spectral as tspec

torch.set_num_threads(1)
RTOL = 1e-10


def _operator(n, dominant, rest_max, seed):
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.normal(size=(n, n)))
    eigs = np.concatenate([[dominant], np.linspace(0.05, rest_max, n - 1)])
    a = q @ np.diag(eigs) @ q.T
    # two leaves, so the tree inner products and norms span leaves
    split = n // 3

    def jmv(v):
        out = jnp.asarray(a) @ jnp.concatenate([v["a"], v["b"]])
        return {"a": out[:split], "b": out[split:]}

    def tmv(v):
        out = torch.from_numpy(a) @ torch.cat([v["a"], v["b"]])
        return {"a": out[:split], "b": out[split:]}

    v0 = rng.normal(size=n)
    v0 /= np.linalg.norm(v0)
    return (jmv, {"a": jnp.asarray(v0[:split]), "b": jnp.asarray(v0[split:])},
            tmv, {"a": torch.from_numpy(v0[:split]), "b": torch.from_numpy(v0[split:])})


CASES = {
    # name: (operator, solver kwargs)
    "converges": ((24, 5.0, 2.0, 0), dict(eps=1e-6, max_iter=1000)),
    "negative_dominant": ((16, -6.0, 2.0, 1), dict(eps=1e-6, max_iter=1000)),
    "damped_alpha": ((20, 4.0, 3.0, 3), dict(eps=1e-5, max_iter=1000, alpha=0.7)),
    "alpha_schedule": ((20, 4.0, 3.0, 4),
                       dict(eps=1e-5, max_iter=1000, alpha=lambda i: 1.0 / (1.0 + 0.1 * i))),
    "momentum": ((30, 4.0, 3.8, 5), dict(eps=1e-6, max_iter=1000, momentum=0.9)),
    "dim_cap": ((8, 3.0, 2.9, 7), dict(eps=1e-30, max_iter=1000)),
    "no_dim_cap": ((8, 3.0, 2.9, 7), dict(eps=1e-12, max_iter=1000, cap_by_dim=False)),
    "discard": ((24, 4.0, 3.9, 2), dict(eps=1e-12, max_iter=2)),
    "keep_bad": ((24, 4.0, 3.9, 2), dict(eps=1e-12, max_iter=2, ignore_bad_vals=False)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_estimate_dominant_eig_matches_jax(name):
    op, kw = CASES[name]
    jmv, jv0, tmv, tv0 = _operator(*op)
    want = jeig.estimate_dominant_eig(jmv, jv0, **kw)
    got = teig.estimate_dominant_eig(tmv, tv0, **kw)
    assert got.iters == int(want.iters)
    assert got.converged == bool(want.converged)
    for field in ("rho", "norm", "res_change"):
        np.testing.assert_allclose(float(getattr(got, field)),
                                   float(getattr(want, field)), rtol=RTOL,
                                   atol=1e-14, err_msg=field)
    for k in ("a", "b"):
        np.testing.assert_allclose(got.v[k].numpy(), np.asarray(want.v[k]),
                                   rtol=RTOL, atol=1e-14)
    if name == "discard":
        assert float(got.rho) == -1.0 and not got.converged
    if name == "dim_cap":
        assert got.iters == 8


def test_power_iteration_matches_jax_counter_on_stop():
    """On stop the counter holds the HVPs done and v is the one whose HVP
    was measured last (eigen.py:198-207)."""
    jmv, jv0, tmv, tv0 = _operator(12, 9.0, 1.0, 11)
    calls = []
    counted = lambda v: (calls.append(1), tmv(v))[1]
    got = teig.power_iteration(counted, tv0, eps=1e-8, max_iter=500)
    want = jeig.power_iteration(jmv, jv0, eps=1e-8, max_iter=500)
    assert got.converged and got.iters == len(calls) == int(want.iters)


def test_preconditioner_and_other_methods_are_not_ported():
    _, _, tmv, tv0 = _operator(6, 2.0, 1.0, 0)
    with pytest.raises(NotImplementedError):
        teig.estimate_dominant_eig(tmv, tv0, precond=lambda r: r)
    with pytest.raises(NotImplementedError):
        teig.estimate_dominant_eig(tmv, tv0, method="lanczos")


@pytest.mark.parametrize("rho,K,Kmin", [(5.0, 1.0, 0.0), (0.5, 1.0, 0.0),
                                        (-1.0, 0.0, 0.0), (0.2, 3.0, 1.0)])
def test_penalty_sign_and_clip_match_jax(rho, K, Kmin):
    t = torch.tensor(rho, dtype=torch.float64)
    assert float(tspec.penalty(t, K, Kmin)) == float(jspec.penalty(jnp.asarray(rho), K, Kmin))
    assert float(tspec.penalty_sign(t, K)) == float(jspec.penalty_sign(jnp.asarray(rho), K))
    g = {"a": np.array([3.0, 4.0]), "b": np.array([12.0])}
    want = jspec.clip_by_norm({k: jnp.asarray(a) for k, a in g.items()}, rho + 2.0)
    got = tspec.clip_by_norm({k: torch.from_numpy(a) for k, a in g.items()}, rho + 2.0)
    for k in g:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-15)


def test_tree_helpers_match_jax():
    from optwboundeigenval_tpu.utils import tree as jtree
    from optwboundeigenval_tpu_torch.utils import tree as ttree

    rng = np.random.default_rng(4)
    a = {"w": rng.normal(size=(3, 4)), "b": rng.normal(size=5)}
    b = {k: rng.normal(size=x.shape) for k, x in a.items()}
    ja = {k: jnp.asarray(x) for k, x in a.items()}
    jb = {k: jnp.asarray(x) for k, x in b.items()}
    ta = {k: torch.from_numpy(x) for k, x in a.items()}
    tb = {k: torch.from_numpy(x) for k, x in b.items()}
    np.testing.assert_allclose(float(ttree.tree_vdot(ta, tb)),
                               float(jtree.tree_vdot(ja, jb)), rtol=1e-14)
    assert ttree.tree_size(ta) == jtree.tree_size(ja) == 17
    ju, tu = jtree.tree_uniform_like(ja), ttree.tree_uniform_like(ta)
    for k in a:  # 1/sqrt(n) of the TOTAL size, on every leaf
        np.testing.assert_array_equal(tu[k].numpy(), np.asarray(ju[k]))
    for pred in (True, False):
        jw = jtree.tree_where(jnp.asarray(pred), ja, jb)
        tw = ttree.tree_where(torch.tensor(pred), ta, tb)
        for k in a:
            np.testing.assert_array_equal(tw[k].numpy(), np.asarray(jw[k]))
    flat, unravel = ttree.tree_ravel(ta)
    assert flat.shape == (17,)
    for k, x in unravel(flat * 2).items():
        np.testing.assert_array_equal(x.numpy(), 2 * a[k])
