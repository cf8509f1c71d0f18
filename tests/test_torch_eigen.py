"""The port's ``ops/eigen.py`` and ``ops/spectral.py`` against the JAX
package at float64 on dense symmetric operators with known spectra.

The power iteration must take the same decisions: equal iteration counts
and convergence flags, and ``rho``, the residual norms and ``v`` to rtol
1e-10 (the same float64 arithmetic in another summation order; measured
~1e-15).  The residual norms near convergence are differences of
vectors of norm ~|lambda|, so they also get atol 1e-14.

The subspace and Lanczos solvers, on a dense matrix (n = 50) and on a
small MLP's HVP: eigenvalues and ``rho`` to rtol 1e-10, iteration counts
and ``converged`` equal, residuals to rtol 1e-8 (atol 1e-13), and the
vectors up to sign (``|cos| > 1 - 1e-10``): ``eigh`` picks the signs of
its eigenvectors differently in the two backends.
"""

import jax
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
    """The preconditioned (LOBPCG) power iteration matches JAX's and
    refuses momentum; Lanczos rejects a preconditioner and an unknown
    method raises, as in JAX."""
    jmv, jv0, tmv, tv0 = _operator(16, 5.0, 2.0, 0)
    scale = lambda r: {k: 0.5 * x for k, x in r.items()}
    want = jeig.estimate_dominant_eig(jmv, jv0, precond=scale, alpha=0.7, eps=1e-6)
    got = teig.estimate_dominant_eig(tmv, tv0, precond=scale, alpha=0.7, eps=1e-6)
    assert got.iters == int(want.iters) and got.converged == bool(want.converged)
    np.testing.assert_allclose(float(got.rho), float(want.rho), rtol=RTOL)
    for k in ("a", "b"):
        np.testing.assert_allclose(got.v[k].numpy(), np.asarray(want.v[k]), rtol=RTOL,
                                   atol=1e-14)
    with pytest.raises(ValueError, match="preconditioner"):
        teig.estimate_dominant_eig(tmv, tv0, precond=scale, momentum=0.9)
    for method in ("lanczos", "lanczos_adaptive"):
        with pytest.raises(ValueError, match="preconditioner"):
            teig.estimate_dominant_eig(tmv, tv0, method=method, precond=lambda r: r)
    with pytest.raises(ValueError, match="unknown"):
        teig.estimate_dominant_eig(tmv, tv0, method="arnoldi")


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


# ---- subspace and Lanczos --------------------------------------------------


def _mlp_operator():
    """The HVP of a small MLP's loss at fixed weights, through each
    package's ``linearize_hvp``; ``{"w1", "w2"}`` flatten in the same
    order on both sides."""
    from optwboundeigenval_tpu.ops import curvature as jcurv
    from optwboundeigenval_tpu_torch.ops import curvature as tcurv

    rng = np.random.default_rng(12)
    p = {"w1": rng.normal(size=(6, 5)) * 0.5, "w2": rng.normal(size=(5, 3)) * 0.5}
    x, y = rng.normal(size=(16, 6)), rng.normal(size=(16, 3))
    jloss = lambda q, b: jnp.mean((jnp.tanh(b[0] @ q["w1"]) @ q["w2"] - b[1]) ** 2)
    tloss = lambda q, b: ((torch.tanh(b[0] @ q["w1"]) @ q["w2"] - b[1]) ** 2).mean()
    _, jmv = jcurv.linearize_hvp(jloss, {k: jnp.asarray(a) for k, a in p.items()},
                                 (jnp.asarray(x), jnp.asarray(y)))
    _, tmv = tcurv.linearize_hvp(tloss, {k: torch.from_numpy(a) for k, a in p.items()},
                                 (torch.from_numpy(x), torch.from_numpy(y)))
    v0 = rng.normal(size=45)
    v0 /= np.linalg.norm(v0)
    return (jmv, {"w1": jnp.asarray(v0[:30].reshape(6, 5)), "w2": jnp.asarray(v0[30:].reshape(5, 3))},
            tmv, {"w1": torch.from_numpy(v0[:30].reshape(6, 5)),
                  "w2": torch.from_numpy(v0[30:].reshape(5, 3))})


OPERATORS = {
    "matrix": lambda: _operator(50, 5.0, 4.2, 21),
    "mlp": _mlp_operator,
}
DOMINANT = {
    "lanczos_m10": ("lanczos_dominant", dict(m=10, eps=1e-6)),
    "lanczos_m16_free_residual": ("lanczos_dominant",
                                  dict(m=16, eps=1e-9, explicit_residual=False)),
    "adaptive_eps1e-3": ("lanczos_dominant_adaptive", dict(m_max=16, eps=1e-3)),
    "adaptive_eps1e-8": ("lanczos_dominant_adaptive", dict(m_max=16, eps=1e-8)),
    "estimate_lanczos": ("estimate_dominant_eig", dict(method="lanczos", lanczos_m=12,
                                                       eps=1e-6)),
    "estimate_adaptive_discard": ("estimate_dominant_eig",
                                  dict(method="lanczos_adaptive", lanczos_m=2, eps=1e-10)),
}


def _flat(tree):
    return np.concatenate([np.asarray(tree[k]).reshape(-1) for k in sorted(tree)])


def _same_direction(got, want):
    g, w = _flat(got), _flat(want)
    cos = abs(float(g @ w)) / (np.linalg.norm(g) * np.linalg.norm(w))
    assert cos > 1 - 1e-10, cos


@pytest.mark.parametrize("op", sorted(OPERATORS))
@pytest.mark.parametrize("case", sorted(DOMINANT))
def test_lanczos_dominant_matches_jax(case, op):
    name, kw = DOMINANT[case]
    jmv, jv0, tmv, tv0 = OPERATORS[op]()
    want = getattr(jeig, name)(jmv, jv0, **kw)
    got = getattr(teig, name)(tmv, tv0, **kw)
    assert got.iters == int(want.iters)
    assert got.converged == bool(want.converged)
    np.testing.assert_allclose(float(got.rho), float(want.rho), rtol=RTOL)
    for field in ("norm", "res_change"):
        np.testing.assert_allclose(float(getattr(got, field)),
                                   float(getattr(want, field)), rtol=1e-8,
                                   atol=1e-13, err_msg=field)
    _same_direction({k: t.numpy() for k, t in got.v.items()}, want.v)
    if case == "estimate_adaptive_discard":
        assert float(got.rho) == -1.0 and not got.converged


SPECTRUM = {
    "subspace_k3": ("subspace_iteration", dict(k=3, eps=1e-6, max_iter=60)),
    "lanczos_spectrum_k4": ("lanczos_spectrum", dict(k=4, m=20)),
    "lanczos_spectrum_free_residual": ("lanczos_spectrum",
                                       dict(k=3, m=16, explicit_residual=False)),
}


@pytest.mark.parametrize("op", sorted(OPERATORS))
@pytest.mark.parametrize("case", sorted(SPECTRUM))
def test_spectrum_solvers_match_jax(case, op):
    name, kw = SPECTRUM[case]
    jmv, jv0, tmv, tv0 = OPERATORS[op]()
    want = getattr(jeig, name)(jmv, jv0, **kw)
    tkw = dict(kw)
    if name == "subspace_iteration":
        # the JAX solver's draw with its default key, passed in
        n = sum(int(np.size(a)) for a in jv0.values())
        tkw["start"] = torch.from_numpy(np.array(
            jax.random.normal(jax.random.PRNGKey(0), (kw["k"], n), jnp.float64)))
    got = getattr(teig, name)(tmv, tv0, **tkw)
    assert got.iters == int(want.iters)
    np.testing.assert_allclose(got.eigenvalues.numpy(), np.asarray(want.eigenvalues),
                               rtol=RTOL)
    np.testing.assert_allclose(got.resid.numpy(), np.asarray(want.resid),
                               rtol=1e-8, atol=1e-13)
    for g, w in zip(got.V.numpy(), np.asarray(want.V)):
        _same_direction({"x": g}, {"x": w})


def _rank_one(n, scale=5.0):
    u = np.full(n, 1.0 / np.sqrt(n))
    a = scale * np.outer(u, u)
    return (lambda v: {"x": jnp.asarray(a) @ v["x"]}, {"x": jnp.asarray(u)},
            lambda v: {"x": torch.from_numpy(a) @ v["x"]}, {"x": torch.from_numpy(u)})


@pytest.mark.parametrize("name,kw", [("lanczos_dominant", dict(m=8)),
                                     ("lanczos_dominant_adaptive", dict(m_max=8))])
def test_lanczos_breakdown_matches_jax(name, kw):
    """A rank-1 operator: the Krylov space is invariant after one step
    (JAX tests/test_eigen.py:369 and :497); the later steps stay finite
    and the pair is exact."""
    jmv, jv0, tmv, tv0 = _rank_one(32)
    want = getattr(jeig, name)(jmv, jv0, **kw)
    got = getattr(teig, name)(tmv, tv0, **kw)
    assert got.converged and bool(torch.isfinite(got.v["x"]).all())
    np.testing.assert_allclose(float(got.rho), 5.0, rtol=1e-12)
    assert (got.iters, got.converged) == (int(want.iters), bool(want.converged))
    np.testing.assert_allclose(float(got.rho), float(want.rho), rtol=RTOL)
    _same_direction({"x": got.v["x"].numpy()}, want.v)


@pytest.mark.parametrize("explicit", [True, False])
def test_lanczos_spectrum_breakdown_masks_dead_pairs(explicit):
    """JAX tests/test_eigen.py:567: a start inside a 2-dimensional
    invariant subspace breaks down at step 2 of 8; the dead Ritz pairs
    report ``resid = inf``, never a false 0."""
    a = np.diag([5.0, 2.0, 2.0, 2.0] + [1.0] * 8)
    v0 = np.zeros(12)
    v0[:2] = 1.0
    want = jeig.lanczos_spectrum(lambda v: {"x": jnp.asarray(a) @ v["x"]},
                                 {"x": jnp.asarray(v0)}, k=4, m=8,
                                 explicit_residual=explicit)
    got = teig.lanczos_spectrum(lambda v: {"x": torch.from_numpy(a) @ v["x"]},
                                {"x": torch.from_numpy(v0)}, k=4, m=8,
                                explicit_residual=explicit)
    np.testing.assert_allclose(got.eigenvalues[:2].numpy(), [5.0, 2.0], rtol=1e-12)
    assert bool((got.resid[:2] < 1e-3).all()) and bool(torch.isinf(got.resid[2:]).all())
    np.testing.assert_array_equal(np.isinf(got.resid.numpy()), np.isinf(np.asarray(want.resid)))
    np.testing.assert_allclose(got.eigenvalues[:2].numpy(),
                               np.asarray(want.eigenvalues)[:2], rtol=RTOL)
    assert got.iters == int(want.iters)
