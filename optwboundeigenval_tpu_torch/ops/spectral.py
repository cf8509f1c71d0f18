"""Spectral band penalty ``g`` and its gradient (counterpart of
``optwboundeigenval_tpu/ops/spectral.py``).

* ``g = max(0, rho - K, Kmin - rho)`` (comp_g, opt.py:574-578);
* ``grad g = sign * grad rho``, ``sign = +1`` if ``rho > K`` else ``-1``,
  computed only when ``g > 0`` (opt.py:631-636);
* ``grad rho = v^T (grad H) v``, optionally norm-clipped (opt.py:535-542);
* ``p = grad f + mu * grad g`` (opt.py:639).

The JAX ``lax.cond`` gate becomes a Python ``if`` on ``g > 0`` (one
host sync, ``spectral.gate`` in ``utils/timing.py``), so the third-order
pass (the span ``vghv.pass``) is skipped when the penalty is off.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from optwboundeigenval_tpu_torch.ops.curvature import (
    LossFn,
    vghv,
    vghv_microbatched,
)
from optwboundeigenval_tpu_torch.parallel import mesh as meshlib
from optwboundeigenval_tpu_torch.utils import timing
from optwboundeigenval_tpu_torch.utils.tree import (
    Tree,
    tree_axpy,
    tree_norm,
    tree_scale,
    tree_zeros_like,
)


def penalty(rho: torch.Tensor, K: float, Kmin: float = 0.0) -> torch.Tensor:
    """``max(0, rho - K, Kmin - rho)``.  A discarded ``rho = -1`` gives
    ``g = 1`` when ``Kmin = 0``, as in the reference (opt.py:517)."""
    return torch.maximum(torch.clamp_min(rho - K, 0.0), Kmin - rho)


def penalty_sign(rho: torch.Tensor, K: float) -> torch.Tensor:
    """``+1`` if ``rho > K`` else ``-1`` (opt.py:633)."""
    return torch.where(rho > K, 1.0, -1.0).to(rho.dtype)


def clip_by_norm(g: Tree, max_norm: Optional[float]) -> Tree:
    """Scale ``g`` down to ``max_norm`` if it is longer (opt.py:539-542)."""
    if max_norm is None:
        return g
    norm = tree_norm(g)
    scale = torch.where(norm > max_norm, max_norm / norm, torch.ones_like(norm))
    return tree_scale(scale, g)


class SpectralGrad(NamedTuple):
    g: torch.Tensor  # penalty value
    grad_g: Tree  # zero when inactive
    grad_rho: Tree  # zero when inactive


def penalty_and_grad(
    loss_fn: LossFn,
    params: Tree,
    batch,
    v: Tree,
    rho: torch.Tensor,
    *,
    K: float,
    Kmin: float = 0.0,
    gradg_clip: Optional[float] = None,
    num_micro: int = 1,
) -> SpectralGrad:
    """``g`` and ``grad g`` with the reference's gating; ``num_micro > 1``
    micro-batches the third-order pass."""
    g = penalty(rho, K, Kmin)
    if not meshlib.agree(timing.read("spectral.gate", g > 0)):
        z = tree_zeros_like(params)
        return SpectralGrad(g=g, grad_g=z, grad_rho=z)
    with timing.span("vghv.pass"):
        if num_micro > 1:
            gr = vghv_microbatched(loss_fn, params, batch, v, num_micro)
        else:
            gr = vghv(loss_fn, params, batch, v)
        gr = clip_by_norm(gr, gradg_clip)
    return SpectralGrad(g=g, grad_g=tree_scale(penalty_sign(rho, K), gr),
                        grad_rho=gr)


def regularized_direction(grad_f: Tree, grad_g: Tree, mu) -> Tree:
    """``p = grad f + mu * grad g`` (opt.py:639)."""
    return tree_axpy(mu, grad_g, grad_f)
