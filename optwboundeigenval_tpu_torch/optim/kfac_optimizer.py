"""The K-FAC natural-gradient optimizer (counterpart of
``optwboundeigenval_tpu/optim/kfac_optimizer.py``; reference
``KFACOptimizer``, kfac.py:11-191, and its protocol, opt.py:645-652):

* the covariance statistics refresh when ``steps % TCov == 0``, from
  ``stats_fn`` (a capture at the pre-step parameters, with sampled
  targets under ``kfac_rand``), and the inverses when ``steps % TInv ==
  0``: host ``if``s, so the other steps run neither the capture nor the
  ``eigh``s;
* the natural gradient of the incoming (regularized) direction per
  factored layer, rescaled by the KL clip ``nu = min(1, sqrt(kl_clip /
  sum(nat * d * lr^2)))`` summed over the FACTORED layers only
  (kfac.py:132-148); the other entries keep the raw direction;
* weight decay from ``20 * TCov`` steps on, then SGD with momentum
  (kfac.py:150-173).

``build_extra_state`` puts identity factors into the state at the
trainer's ``init_state`` (the reference builds them with its hooks,
kfac.py:67-79).  ``lr`` is a float32 value, as the JAX state holds it.
"""

from __future__ import annotations

import numpy as np
import torch

from optwboundeigenval_tpu_torch.ops import kfac as kfac_ops
from optwboundeigenval_tpu_torch.optim.api import Optimizer


def KFAC(lr: float = 0.001, momentum: float = 0.9, stat_decay: float = 0.95,
         damping: float = 0.001, kl_clip: float = 0.001, weight_decay: float = 0.0,
         TCov: int = 10, TInv: int = 100, batch_averaged: bool = True,
         kfac_rand: bool = True) -> Optimizer:

    def init(params):
        return {"steps": 0, "momentum": {k: torch.zeros_like(p) for k, p in params.items()},
                "factors": None, "lr": float(np.float32(lr))}

    def build_extra_state(state, task, params, model_state):
        return {**state, "factors": kfac_ops.init_factors(task.model, params)}

    def step(direction, state, params, *, stats_fn=None, rng=None, **_):
        if stats_fn is None or state["factors"] is None:
            raise ValueError("KFAC needs stats_fn and the factors of build_extra_state")
        steps, factors = state["steps"], state["factors"]
        if steps % TCov == 0:
            factors = kfac_ops.update_factors(factors, stats_fn(params, rng), params,
                                              stat_decay, batch_averaged)
        if steps % TInv == 0:
            factors = kfac_ops.compute_inverses(factors)

        nat = kfac_ops.apply_to_tree(factors, direction, damping)
        # the JAX state's lr is float32, and so is its square (kfac.py:135-139)
        lr2 = float(np.float32(state["lr"]) ** 2)
        keys = [k for name in factors for k in (f"{name}.weight", f"{name}.bias")
                if k in direction]
        vg_sum = torch.stack([(nat[k] * direction[k]).sum() * lr2 for k in keys]).sum()
        nu = torch.where(vg_sum > 0, torch.clamp(torch.sqrt(kl_clip / vg_sum), max=1.0),
                         torch.ones_like(vg_sum))
        factored = set(keys)
        d_p = {k: nu * nat[k] if k in factored else d for k, d in direction.items()}
        if weight_decay != 0 and steps >= 20 * TCov:
            d_p = {k: d + weight_decay * params[k] for k, d in d_p.items()}
        new_m = {k: momentum * state["momentum"][k] + d for k, d in d_p.items()}
        lr_now = state["lr"]
        new_params = {k: p - lr_now * new_m[k] for k, p in params.items()}
        return new_params, {**state, "steps": steps + 1, "momentum": new_m,
                            "factors": factors}

    return Optimizer(name="KFAC", init=init, step=step, lr_float32=True,
                     needs_stats=True, kfac_rand=kfac_rand,
                     build_extra_state=build_extra_state, slices=False)
