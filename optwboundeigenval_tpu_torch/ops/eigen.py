"""Dominant-eigenpair estimation by damped power iteration over a
matrix-free operator (counterpart of ``optwboundeigenval_tpu/ops/eigen.py``
``power_iteration`` and ``estimate_dominant_eig``).

Reference ``comp_rho`` (opt.py:418-533), kept exactly:

* warm start from the previous eigenvector, or ``1/sqrt(n)`` ones;
* ``lam = <Hv, v>`` with a sign flip for a negative eigenvalue;
* ``r = Hv - lam v``; ``rn = min(|r - r_old|, |r + r_old|)``;
* 3-way stop: any of ``|r|``, ``rn / |r_old|``, ``|dlam| / lam_old``
  below ``eps``; on stop the returned ``v`` is the one whose HVP was
  just measured and the counter holds the number of HVPs;
* damped update ``v <- v + alpha (Hv - v)``, ``alpha`` a scalar or a
  callable of the iteration index; optional heavy-ball ``momentum``;
* budget ``min(ndim, max_iter)``;
* discard: not converged -> ``rho = -1`` and ``v`` reset.

The JAX ``lax.while_loop`` becomes a Python loop.  Its stop test reads
one boolean back to the host every iteration: one device sync per HVP,
a known cost of this port (the JAX loop runs inside one program).
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional, Union

import numpy as np
import torch

from optwboundeigenval_tpu_torch.utils.tree import (
    Tree,
    tree_axpy,
    tree_norm,
    tree_scale,
    tree_size,
    tree_sub,
    tree_uniform_like,
    tree_vdot,
    tree_zeros_like,
)

MatVec = Callable[[Tree], Tree]
AlphaFn = Union[float, Callable[[int], float]]


class PowerIterResult(NamedTuple):
    """``rho``: dominant |eigenvalue| (-1 if discarded); ``v``: the
    eigenvector (next batch's warm start); ``norm``: final ``|r|``;
    ``res_change``: final ``rn``; ``iters``: HVPs performed;
    ``converged``: whether the stopping rule fired."""

    rho: torch.Tensor
    v: Tree
    norm: torch.Tensor
    res_change: torch.Tensor
    iters: int
    converged: bool


def _alpha_at(alpha: AlphaFn, i: int) -> float:
    if callable(alpha):
        return float(alpha(i))
    # the JAX solver holds a scalar alpha as a float32 array, so it
    # enters the update rounded to float32 even in float64 runs
    return float(np.float32(alpha))


def power_iteration(
    matvec: MatVec,
    v0: Tree,
    *,
    eps: float = 1e-3,
    max_iter: int = 1000,
    alpha: AlphaFn = 1.0,
    precond: Optional[MatVec] = None,
    cap_by_dim: bool = True,
    momentum: Optional[float] = None,
) -> PowerIterResult:
    """Estimate the dominant eigenpair of the symmetric ``matvec``.

    ``momentum`` runs the heavy-ball recurrence ``w = H v - beta v_prev``
    with ``beta = (momentum * lam / 2)^2`` and a joint renormalisation
    of ``(v, v_prev)``; it needs no sign flip and ignores ``alpha``."""
    if precond is not None:
        raise NotImplementedError("preconditioned (LOBPCG) power iteration "
                                  "is not ported")
    n_iters = int(min(tree_size(v0), max_iter)) if cap_by_dim else int(max_iter)
    first = next(iter(v0.values()))
    sdtype = torch.promote_types(torch.float32, first.dtype)
    zero = torch.zeros((), dtype=sdtype, device=first.device)
    inf = torch.full((), math.inf, dtype=sdtype, device=first.device)

    v, v_prev = v0, tree_zeros_like(v0)
    r_old = tree_zeros_like(v0)
    lam = lam_old = n = n_old = rn = zero
    i, done = 0, False
    while i < n_iters and not done:
        hv = matvec(v)
        lam_raw = tree_vdot(hv, v).to(sdtype)
        lam = lam_raw.abs()
        if momentum is None:
            # sign flip so lam >= 0 tracks |eigenvalue| (opt.py:458-460)
            hv = tree_scale(torch.where(lam_raw < 0, -1.0, 1.0).to(sdtype), hv)
            r = {k: h - lam * v[k] for k, h in hv.items()}
        else:
            r = {k: h - lam_raw * v[k] for k, h in hv.items()}
        n = tree_norm(r).to(sdtype)
        rn = torch.minimum(tree_norm(tree_sub(r, r_old)),
                           tree_norm(tree_axpy(1.0, r, r_old))).to(sdtype)
        stop2 = torch.where(n_old != 0, rn / n_old, inf)
        stop3 = torch.where(lam_old != 0, (lam - lam_old).abs() / lam_old, inf)
        done = bool((n < eps) | (stop2 < eps) | (stop3 < eps))  # host sync
        i += 1
        if done:
            # the reference breaks before the update: keep the v whose
            # HVP was just measured (opt.py:477-481)
            break
        if momentum is None:
            a = _alpha_at(alpha, i - 1)
            v_unnorm = tree_axpy(a, tree_sub(hv, v), v)
            v = tree_scale(1.0 / tree_norm(v_unnorm), v_unnorm)
        else:
            beta = (momentum * lam / 2.0) ** 2
            w = tree_axpy(-beta, v_prev, hv)
            c = torch.clamp_min(tree_norm(w), 1e-30)
            v, v_prev = tree_scale(1.0 / c, w), tree_scale(1.0 / c, v)
        lam_old, r_old, n_old = lam, r, n
    return PowerIterResult(rho=lam.abs(), v=v, norm=n, res_change=rn,
                           iters=i, converged=done)


def estimate_dominant_eig(
    matvec: MatVec,
    v0: Tree,
    *,
    eps: float = 1e-3,
    max_iter: int = 1000,
    alpha: AlphaFn = 1.0,
    precond: Optional[MatVec] = None,
    ignore_bad_vals: bool = True,
    cap_by_dim: bool = True,
    momentum: Optional[float] = None,
    method: str = "power",
) -> PowerIterResult:
    """Power iteration plus the reference's discard protocol: when the
    stopping rule never fired and ``ignore_bad_vals``, report
    ``rho = -1`` and reset ``v`` to the uniform start vector
    (opt.py:513-520).  Only ``method="power"`` is ported."""
    if method != "power":
        raise NotImplementedError(f"eigensolve method {method!r} is not ported")
    res = power_iteration(matvec, v0, eps=eps, max_iter=max_iter, alpha=alpha,
                          precond=precond, cap_by_dim=cap_by_dim,
                          momentum=momentum)
    if not ignore_bad_vals or res.converged:
        return res
    return res._replace(rho=torch.full_like(res.rho, -1.0),
                        v=tree_uniform_like(res.v))
