"""Eigensolvers over a matrix-free symmetric operator (counterpart of
``optwboundeigenval_tpu/ops/eigen.py``): damped power iteration, block
subspace iteration, and Lanczos with full reorthogonalisation (a fixed
depth, an early-exit depth, and the top-k spectrum).

Reference ``comp_rho`` (opt.py:418-533), kept exactly:

* warm start from the previous eigenvector, or ``1/sqrt(n)`` ones;
* ``lam = <Hv, v>`` with a sign flip for a negative eigenvalue;
* ``r = Hv - lam v``; ``rn = min(|r - r_old|, |r + r_old|)``;
* 3-way stop: any of ``|r|``, ``rn / |r_old|``, ``|dlam| / lam_old``
  below ``eps``; on stop the returned ``v`` is the one whose HVP was
  just measured and the counter holds the number of HVPs;
* damped update ``v <- v + alpha (Hv - v)``, ``alpha`` a scalar or a
  callable of the iteration index; under a preconditioner ``P`` (the
  inexact-LOBPCG mode, opt.py:426-430, 491-493) ``v <- v + alpha P(r)``
  with the residual ``r`` taken after the sign flip; optional heavy-ball
  ``momentum``;
* budget ``min(ndim, max_iter)``;
* discard: not converged -> ``rho = -1`` and ``v`` reset.

The JAX ``lax.while_loop`` becomes a Python loop.  Its stop test reads
one boolean back to the host every iteration: one device sync per HVP,
a known cost of this port (the JAX loop runs inside one program).  Each
operator call is a span ``eigen.product``, and each host read or copy
of a solver a host synchronisation (``utils/timing.py``): ``eigen.stop``
for the stop tests and the Lanczos tridiagonal's read, ``eigen.h2d`` for
the host-side Ritz results copied back to the device.

The subspace and Lanczos solvers work on one flat vector per tree
(``tree_ravel``; the operator sees the tree).  The Krylov basis is an
``(m, n)`` tensor on the device in ``promote(float32, dtype)``, and its
two-pass reorthogonalisation ``V.T @ (V @ w)`` is ``torch.matmul``.  The
``(m, m)`` tridiagonal ``eigh`` runs on the host in that dtype: the
adaptive solver reads ``alpha_j, beta_j`` back once per depth for its
stop test, as the power iteration reads its test once per HVP.

Under a data-parallel mesh (``parallel/mesh.py``) the operator returns
all-reduced products, and every stop, breakdown and convergence decision
goes through ``mesh.agree``: one collective decides for all ranks, so no
rank leaves a loop that another continues.  Under a sharding the tree
helpers reduce over the ``model`` group (``utils/tree.py``): the power
iteration keeps this rank's slices, and the flat solvers work on the
gathered vector, as one process does, and hand the operator the slices.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional, Union

import numpy as np
import torch

from optwboundeigenval_tpu_torch.parallel import mesh as meshlib
from optwboundeigenval_tpu_torch.utils import timing
from optwboundeigenval_tpu_torch.utils.tree import (
    Tree,
    tree_axpy,
    tree_norm,
    tree_ravel,
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

    ``precond`` maps the residual through an approximate inverse (the
    K-FAC apply, ``ops/kfac.precond_apply``): the update is then
    ``normalize(v + alpha * precond(r))``.  ``momentum`` runs the
    heavy-ball recurrence ``w = H v - beta v_prev`` with ``beta =
    (momentum * lam / 2)^2`` and a joint renormalisation of ``(v,
    v_prev)``; it needs no sign flip, ignores ``alpha`` and does not
    compose with ``precond``."""
    if momentum is not None and precond is not None:
        raise ValueError("momentum-accelerated power iteration does not compose "
                         "with a preconditioner; use one or the other")
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
        with timing.span("eigen.product"):
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
        done = meshlib.agree(timing.read("eigen.stop", (n < eps) | (stop2 < eps) | (stop3 < eps)))
        i += 1
        if done:
            # the reference breaks before the update: keep the v whose
            # HVP was just measured (opt.py:477-481)
            break
        if momentum is None:
            a = _alpha_at(alpha, i - 1)
            direction = tree_sub(hv, v) if precond is None else precond(r)
            v_unnorm = tree_axpy(a, direction, v)
            v = tree_scale(1.0 / tree_norm(v_unnorm), v_unnorm)
        else:
            beta = (momentum * lam / 2.0) ** 2
            w = tree_axpy(-beta, v_prev, hv)
            c = torch.clamp_min(tree_norm(w), 1e-30)
            v, v_prev = tree_scale(1.0 / c, w), tree_scale(1.0 / c, v)
        lam_old, r_old, n_old = lam, r, n
    return PowerIterResult(rho=lam.abs(), v=v, norm=n, res_change=rn,
                           iters=i, converged=done)


class SubspaceResult(NamedTuple):
    """``eigenvalues``: ``(k,)`` signed, descending by |value|; ``V``:
    ``(k, n)`` rows (the orthonormal basis, or the Ritz vectors of
    :func:`lanczos_spectrum`); ``resid``: ``(k,)`` residual norms;
    ``iters``: sweeps (subspace) or HVPs (Lanczos)."""

    eigenvalues: torch.Tensor
    V: torch.Tensor
    resid: torch.Tensor
    iters: int


def _flat_operator(matvec: MatVec, v0: Tree):
    """``(flat0, unravel, wdtype, mv)``: the start vector flattened, and
    the operator on flat vectors of ``wdtype = promote(float32, dtype)``."""
    flat0, unravel = tree_ravel(v0)
    dtype = flat0.dtype
    wdtype = torch.promote_types(torch.float32, dtype)

    def mv(u: torch.Tensor) -> torch.Tensor:
        with timing.span("eigen.product"):
            return tree_ravel(matvec(unravel(u.to(dtype))))[0].to(wdtype)

    return flat0, unravel, wdtype, mv


def _unit(u: torch.Tensor) -> torch.Tensor:
    return u / torch.clamp_min(torch.sqrt(torch.dot(u, u)), 1e-30)


def subspace_iteration(
    matvec: MatVec,
    v0: Tree,
    k: int = 4,
    *,
    eps: float = 1e-4,
    max_iter: int = 200,
    start: Optional[torch.Tensor] = None,
) -> SubspaceResult:
    """Top-k eigenpairs by block power iteration with Rayleigh-Ritz.

    The start block is ``start`` (``(k, n)``, flat in ``tree_ravel``
    order), else ``k`` normal rows drawn on the host from a generator
    seeded 0 (the JAX solver's default key 0 likewise draws the same rows
    every call); its row 0 becomes ``v0``.  Each sweep is ``k``
    HVPs, a ``(k, k)`` ``eigh`` and a QR; it stops when every Ritz
    residual is below ``eps`` (one host sync per sweep)."""
    flat0, _, dtype, mv = _flat_operator(matvec, v0)
    n = flat0.numel()
    if start is None:
        start = torch.randn((k, n), generator=torch.Generator().manual_seed(0),
                            dtype=dtype)
    V = start.to(flat0.device, dtype, copy=True)
    V[0] = flat0

    def orthonormalize(B):
        return torch.linalg.qr(B.T)[0].T

    V = orthonormalize(V)
    evals = torch.zeros(k, dtype=dtype, device=flat0.device)
    resid = torch.full((k,), math.inf, dtype=dtype, device=flat0.device)
    i, done = 0, False
    while i < max_iter and not done:
        W = torch.stack([mv(row) for row in V])
        H = V @ W.T
        evals, U = torch.linalg.eigh((H + H.T) / 2)
        order = torch.argsort(-evals.abs(), stable=True)
        evals, U = evals[order], U[:, order]
        ritz, ritz_W = U.T @ V, U.T @ W
        resid = torch.linalg.norm(ritz_W - evals[:, None] * ritz, dim=1)
        done = meshlib.agree(timing.read("eigen.stop", (resid < eps).all()))
        i += 1
        if not done:
            V = orthonormalize(ritz_W)
    return SubspaceResult(eigenvalues=evals, V=V, resid=resid, iters=i)


def _lanczos_step(mv, V: torch.Tensor, j: int, q, q_prev, beta_prev):
    """Lanczos step ``j``: ``q`` becomes basis row ``j``; returns ``(w,
    alpha_j, beta_j)``, the next direction after the three-term recurrence
    and two passes of full reorthogonalisation against the rows so far,
    and its norm."""
    V[j] = q
    w = mv(q)
    alpha = torch.dot(w, q)
    w = w - alpha * q - beta_prev * q_prev
    Vj = V[:j + 1]
    w = w - Vj.T @ (Vj @ w)
    w = w - Vj.T @ (Vj @ w)
    return w, alpha, torch.sqrt(torch.dot(w, w))


def _lanczos_basis(mv, q0: torch.Tensor, m: int):
    """``m`` Lanczos steps from ``q0``: the ``(m, n)`` basis rows and the
    tridiagonal's ``alphas`` and ``betas`` ``(m,)``, on the device.  A
    breakdown (``beta_j <= 1e-12``, an invariant Krylov space) records
    ``beta_j = 0`` and zeroes the later iterates, as the JAX scan does."""
    q = _unit(q0)
    V = torch.zeros((m, q.numel()), dtype=q.dtype, device=q.device)
    q_prev, beta_prev = torch.zeros_like(q), torch.zeros((), dtype=q.dtype, device=q.device)
    alphas, betas = [], []
    for j in range(m):
        w, alpha, beta = _lanczos_step(mv, V, j, q, q_prev, beta_prev)
        live = beta > 1e-12
        q_prev, q = q, torch.where(live, w / torch.clamp_min(beta, 1e-30), torch.zeros_like(w))
        beta_prev = torch.where(live, beta, torch.zeros_like(beta))
        alphas.append(alpha)
        betas.append(beta_prev)
    return V, torch.stack(alphas), torch.stack(betas)


def _tridiag(alphas: torch.Tensor, off: torch.Tensor) -> torch.Tensor:
    return torch.diag(alphas) + torch.diag(off, 1) + torch.diag(off, -1)


def lanczos_spectrum(
    matvec: MatVec,
    v0: Tree,
    k: int = 4,
    *,
    m: int = 32,
    explicit_residual: bool = True,
) -> SubspaceResult:
    """Top-k eigenvalues (by |value|) from one ``m``-step Lanczos build:
    ``eigenvalues`` signed, ``V`` the ``(k, n)`` unit Ritz vectors,
    ``resid`` the re-measured ``|H v - lam v|`` (``k`` more HVPs) or,
    without ``explicit_residual``, the Lanczos estimates ``|beta_m
    y_m[i]|``; ``iters`` counts HVPs.  Ritz pairs supported on the rows
    after a breakdown are spurious zeros and report ``resid = inf``."""
    flat0, _, wdtype, mv = _flat_operator(matvec, v0)
    n = flat0.numel()
    m = int(min(m, n))
    k = int(min(k, m))
    V, alphas, betas = _lanczos_basis(mv, flat0.to(wdtype), m)
    a, b = timing.to_host("eigen.stop", alphas), timing.to_host("eigen.stop", betas)
    evals, evecs = torch.linalg.eigh(_tridiag(a, b[:-1]))
    order = torch.argsort(-evals.abs(), stable=True)[:k]
    lam, Y = evals[order], evecs[:, order]
    ritz = (V.T @ timing.to_device("eigen.h2d", Y, V.device)).T
    ritz = ritz / torch.clamp_min(torch.linalg.norm(ritz, dim=1, keepdim=True), 1e-30)
    lam_dev = timing.to_device("eigen.h2d", lam, V.device)
    if explicit_residual:
        W = torch.stack([mv(r) for r in ritz])
        resid = torch.linalg.norm(W - lam_dev[:, None] * ritz, dim=1)
        iters = m + k
    else:
        resid = timing.to_device("eigen.h2d", b[-1].abs() * Y[-1, :].abs(), V.device)
        iters = m
    # row j + 1 of T is live iff beta_j > 0; a pair whose mass sits on
    # dead rows is a spurious zero
    row_live = torch.cat([torch.ones(1, dtype=torch.bool), b[:-1] > 0])
    dead = ((Y ** 2) * (~row_live)[:, None].to(Y.dtype)).sum(dim=0) > 0.5
    resid = torch.where(timing.to_device("eigen.h2d", dead, V.device),
                        torch.full_like(resid, math.inf), resid)
    return SubspaceResult(eigenvalues=lam_dev, V=ritz, resid=resid, iters=iters)


def lanczos_dominant(
    matvec: MatVec,
    v0: Tree,
    *,
    m: int = 16,
    eps: float = 1e-3,
    explicit_residual: bool = True,
) -> PowerIterResult:
    """Dominant eigenpair from an ``m``-step Lanczos build, in
    ``PowerIterResult`` form: ``rho = |lam|``; ``norm`` the re-measured
    ``|H v - lam v|`` (one more HVP, so ``iters = m + 1``) or the free
    estimate; ``res_change`` the estimate ``|beta_m y_m|``;
    ``converged`` when ``norm < eps`` or the leading Ritz value moved by
    less than ``eps`` relative between depths ``m - 1`` and ``m``."""
    flat0, unravel, wdtype, mv = _flat_operator(matvec, v0)
    n = flat0.numel()
    m = int(min(m, n))
    V, alphas, betas = _lanczos_basis(mv, flat0.to(wdtype), m)
    a, b = timing.to_host("eigen.stop", alphas), timing.to_host("eigen.stop", betas)
    T = _tridiag(a, b[:-1])
    evals, evecs = torch.linalg.eigh(T)
    idx = int(torch.argmax(evals.abs()))
    lam, y = evals[idx], evecs[:, idx]
    dlam_rel = math.inf
    if m > 1:
        lam_prev = float(torch.linalg.eigvalsh(T[:m - 1, :m - 1]).abs().max())
        if lam_prev > 0:
            dlam_rel = float((lam.abs() - lam_prev).abs() / lam_prev)
    v_flat = _unit(V.T @ timing.to_device("eigen.h2d", y, V.device))
    est = timing.to_device("eigen.h2d", b[-1].abs() * y[-1].abs(), V.device)
    lam_dev = timing.to_device("eigen.h2d", lam, V.device)
    if explicit_residual:
        r = mv(v_flat) - lam_dev * v_flat
        norm = torch.sqrt(torch.dot(r, r))
        iters = m + 1
    else:
        norm, iters = est, m
    converged = meshlib.agree(timing.read("eigen.stop", norm < eps) or dlam_rel < eps)
    return PowerIterResult(rho=lam_dev.abs(), v=unravel(v_flat.to(flat0.dtype)),
                           norm=norm, res_change=est, iters=iters, converged=converged)


def lanczos_dominant_adaptive(
    matvec: MatVec,
    v0: Tree,
    *,
    m_max: int = 16,
    eps: float = 1e-3,
) -> PowerIterResult:
    """Early-exit Lanczos (the solver of ``eigensolver='auto'``): the
    Krylov build of :func:`lanczos_dominant` stopped at the first depth
    ``j`` where the leading Ritz pair of the zero-padded ``(m_max,
    m_max)`` tridiagonal has its free residual estimate ``|beta_j y_j|``
    below ``eps``, or its value moved by less than ``eps`` relative from
    the value two depths back (from the third depth on), or the Krylov
    space broke down.  One host sync per depth;
    ``norm`` is re-measured with one more HVP, which ``iters`` counts."""
    flat0, unravel, wdtype, mv = _flat_operator(matvec, v0)
    n = flat0.numel()
    m_max = int(min(m_max, n))
    q = _unit(flat0.to(wdtype))
    dev = q.device
    V = torch.zeros((m_max, n), dtype=wdtype, device=dev)
    alphas = torch.zeros(m_max, dtype=wdtype)  # host
    betas = torch.zeros(m_max, dtype=wdtype)
    q_prev, beta_prev = torch.zeros_like(q), 0.0
    lam = lam_prev = torch.zeros((), dtype=wdtype)
    y = torch.zeros(m_max, dtype=wdtype)
    est = torch.full((), math.inf, dtype=wdtype)
    j, done = 0, False
    while j < m_max and not done:
        w, alpha, beta = _lanczos_step(mv, V, j, q, q_prev, beta_prev)
        alpha_h, beta_h = timing.to_host("eigen.stop", torch.stack([alpha, beta]))
        live = meshlib.agree(bool(beta_h > 1e-12))
        beta_rec = beta_h if live else torch.zeros_like(beta_h)
        q_prev, q = q, (w / torch.clamp_min(beta, 1e-30) if live else torch.zeros_like(w))
        beta_prev = beta_rec.item()
        alphas[j], betas[j] = alpha_h, beta_rec
        # the off-diagonal beta_j couples row j to the row not built yet
        off = betas.clone()
        off[j] = 0.0
        evals, evecs = torch.linalg.eigh(_tridiag(alphas, off[:-1]))
        idx = int(torch.argmax(evals.abs()))
        lam_j, y = evals[idx], evecs[:, idx]
        est = beta_rec.abs() * y[j].abs()
        # the JAX solver's carry compares the new leading Ritz value with
        # the one two depths back (its ``lam_prev``), and so does the port
        dlam_rel = ((lam_j.abs() - lam_prev.abs()).abs() / lam_prev.abs()
                    if lam_prev.abs() > 0 else math.inf)
        lam_prev, lam = lam, lam_j
        done = meshlib.agree(bool(est < eps) or (j >= 1 and bool(dlam_rel < eps)) or not live)
        j += 1
    v_flat = _unit(V.T @ timing.to_device("eigen.h2d", y, dev))
    lam_dev = timing.to_device("eigen.h2d", lam, dev)
    r = mv(v_flat) - lam_dev * v_flat
    return PowerIterResult(rho=lam_dev.abs(), v=unravel(v_flat.to(flat0.dtype)),
                           norm=torch.sqrt(torch.dot(r, r)),
                           res_change=timing.to_device("eigen.h2d", est, dev),
                           iters=j + 1, converged=done)


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
    lanczos_m: int = 16,
) -> PowerIterResult:
    """A dominant-eigenpair solve plus the reference's discard protocol:
    when the stopping rule never fired and ``ignore_bad_vals``, report
    ``rho = -1`` and reset ``v`` to the uniform start vector
    (opt.py:513-520).  ``method``: ``"power"`` (the reference's damped
    power iteration), ``"lanczos"`` (:func:`lanczos_dominant` at depth
    ``min(lanczos_m, max_iter)``) or ``"lanczos_adaptive"``
    (:func:`lanczos_dominant_adaptive`, depth at most that)."""
    if method in ("lanczos", "lanczos_adaptive"):
        if precond is not None:
            raise ValueError("lanczos eigensolve does not compose with a "
                             "preconditioner; use one or the other")
        solve = lanczos_dominant if method == "lanczos" else lanczos_dominant_adaptive
        depth = {"m" if method == "lanczos" else "m_max": min(lanczos_m, max_iter)}
        res = solve(matvec, v0, eps=eps, **depth)
    elif method == "power":
        res = power_iteration(matvec, v0, eps=eps, max_iter=max_iter, alpha=alpha,
                              precond=precond, cap_by_dim=cap_by_dim,
                              momentum=momentum)
    else:
        raise ValueError(f"unknown eigensolve method: {method!r}")
    if not ignore_bad_vals or res.converged:
        return res
    return res._replace(rho=torch.full_like(res.rho, -1.0),
                        v=tree_uniform_like(res.v))
