"""Gradient, Hessian-vector product and ``v^T (grad H) v`` by autograd,
and the damped power iteration of the spectral-radius recipe (its
reference code's ``comp_rho``), on flat vectors.

Power iteration from a warm start ``v``: ``lam = <H v, v>``; where it is
negative ``H v`` flips sign and ``lam`` is its magnitude; ``r = H v - lam
v``; ``rn = min(|r - r_old|, |r + r_old|)``.  It stops as soon as any of
``|r|``, ``rn / |r_old|`` and ``|lam - lam_old| / lam_old`` is below
``eps`` (the last two need a previous iteration), keeping the ``v`` whose
product it just took; else ``v <- normalise(v + alpha (H v - v))``.  At
most ``min(n, max_iter)`` products.  A solve that never stops reports
``rho = -1`` and the uniform vector where bad values are ignored.

The stop is a decision at ``eps``: a float32 run of the program and this
reference may take it one product apart when the stopping quantity lies
next to ``eps``.  ``margin`` makes the solve fork there: where the least
of the three lies within ``margin * eps`` of ``eps`` both outcomes are
followed, and every result is returned (the one of the rule as computed
here first).  The comparison keeps the result that agrees best with the
program, so an outcome of the rule the program could have taken is never
a fault.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, NamedTuple, Tuple

import torch

Tree = Dict[str, torch.Tensor]


def flat(tree: Tree) -> torch.Tensor:
    return torch.cat([t.reshape(-1) for t in tree.values()])


def unflat(vec: torch.Tensor, like: Tree) -> Tree:
    out, off = {}, 0
    for k, t in like.items():
        out[k] = vec[off:off + t.numel()].view(t.shape)
        off += t.numel()
    return out


def _leaves(params: Tree) -> Tree:
    return {k: p.detach().requires_grad_(True) for k, p in params.items()}


def grad_with_hvp(loss_of: Callable[[Tree], torch.Tensor], params: Tree
                  ) -> Tuple[torch.Tensor, Tree, Callable[[torch.Tensor], torch.Tensor]]:
    """``(loss, grad, hvp)``: the gradient taken once with its graph kept,
    and ``hvp(flat v) -> flat H v`` one reverse pass over it each call."""
    leaves = _leaves(params)
    inputs = list(leaves.values())
    with torch.enable_grad():
        loss = loss_of(leaves)
        g = torch.autograd.grad(loss, inputs, create_graph=True)

    def hvp(v: torch.Tensor) -> torch.Tensor:
        vt = unflat(v, leaves)
        hv = torch.autograd.grad(g, inputs, [vt[k] for k in leaves], retain_graph=True)
        return torch.cat([h.reshape(-1) for h in hv])

    return loss.detach(), {k: t.detach() for k, t in zip(leaves, g)}, hvp


def vghv(loss_of: Callable[[Tree], torch.Tensor], params: Tree, v: torch.Tensor) -> Tree:
    """The gradient of ``<H(p) v, v>`` with respect to ``p``."""
    leaves = _leaves(params)
    inputs = list(leaves.values())
    vt = unflat(v, leaves)
    with torch.enable_grad():
        g = torch.autograd.grad(loss_of(leaves), inputs, create_graph=True)
        hv = torch.autograd.grad(g, inputs, [vt[k] for k in leaves], create_graph=True)
        num = torch.stack([torch.dot(h.reshape(-1), vt[k].reshape(-1))
                           for k, h in zip(leaves, hv)]).sum()
        out = torch.autograd.grad(num, inputs)
    return dict(zip(leaves, out))


class Eig(NamedTuple):
    rho: float
    v: torch.Tensor
    iters: int
    converged: bool


def uniform(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.full((n,), 1.0 / math.sqrt(float(n)), dtype=like.dtype, device=like.device)


def power_iteration(hvp: Callable[[torch.Tensor], torch.Tensor], v0: torch.Tensor, *,
                    eps: float, max_iter: int, ignore_bad_vals: bool, alpha: float = 1.0,
                    margin: float = 0.0, max_results: int = 3) -> List[Eig]:
    """Every result the rule may give from ``v0`` (see the module), the
    one of the rule as computed here first, at most ``max_results``."""
    n_max = int(min(v0.numel(), max_iter))

    def solve(v, r_old, n_old, lam_old, i, budget):
        others: List[Eig] = []
        while True:
            hv = hvp(v)
            lam_raw = float(torch.dot(hv, v))
            lam = abs(lam_raw)
            if lam_raw < 0:
                hv = -hv
            r = hv - lam * v
            n = float(torch.linalg.vector_norm(r))
            rn = min(float(torch.linalg.vector_norm(r - r_old)),
                     float(torch.linalg.vector_norm(r + r_old)))
            crit = min(n, rn / n_old if n_old != 0 else math.inf,
                       abs(lam - lam_old) / lam_old if lam_old != 0 else math.inf)
            i += 1
            fork = (abs(crit - eps) <= margin * eps and i < n_max
                    and budget - len(others) > 1)
            if crit < eps:
                if fork:  # the other outcome: one more product
                    u = v + alpha * (hv - v)
                    others += solve(u / torch.linalg.vector_norm(u), r, n, lam, i,
                                    budget - len(others) - 1)
                return [Eig(lam, v, i, True)] + others
            if fork:  # the other outcome: stop here
                others.append(Eig(lam, v, i, True))
            v = v + alpha * (hv - v)
            v = v / torch.linalg.vector_norm(v)
            if i >= n_max:
                return [Eig(lam, v, i, False)] + others
            r_old, n_old, lam_old = r, n, lam

    out = []
    for e in solve(v0, torch.zeros_like(v0), 0.0, 0.0, 0, max_results)[:max_results]:
        if not e.converged and ignore_bad_vals:
            e = Eig(-1.0, uniform(v0.numel(), v0), e.iters, False)
        out.append(e)
    return out
