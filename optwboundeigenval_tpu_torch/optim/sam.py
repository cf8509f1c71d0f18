"""Sharpness-Aware Minimization (counterpart of
``optwboundeigenval_tpu/optim/sam.py``; reference sam.py:6-65 and its
two-step protocol, opt.py:688-694), as one functional step:

1. perturb ``w + rho * d / |d|`` along the (regularized) direction ``d``
   (the adaptive variant scales by ``w^2`` and measures ``|w| d``);
2. the plain-loss gradient at the perturbed point, from ``grad_fn``;
3. the base optimizer's step with that gradient at the ORIGINAL ``w``.

SAM's state is the base optimizer's state, so ``set_learning_rate``
reaches the base's ``lr``.
"""

from __future__ import annotations

from optwboundeigenval_tpu_torch.optim.api import Optimizer
from optwboundeigenval_tpu_torch.utils.tree import tree_norm


def SAM(base: Optimizer, rho: float = 0.05, adaptive: bool = False) -> Optimizer:
    if rho < 0.0:
        raise ValueError(f"Invalid rho, should be non-negative: {rho}")

    def step(direction, state, params, *, grad_fn=None, **_):
        if grad_fn is None:
            raise ValueError("SAM needs grad_fn (a second forward and backward)")
        scaled = ({k: p.abs() * direction[k] for k, p in params.items()}
                  if adaptive else direction)
        scale = rho / (tree_norm(scaled) + 1e-12)
        perturbed = {k: w + (w ** 2 if adaptive else 1.0) * direction[k] * scale
                     for k, w in params.items()}
        _, grads2 = grad_fn(perturbed)
        return base.step(grads2, state, params)

    return Optimizer(name="SAM", init=base.init, step=step, slices=base.slices)
