"""Entropy-SGD (counterpart of ``optwboundeigenval_tpu/optim/entropy_sgd.py``;
reference optim.py:10-104): ``L`` inner Langevin (SGLD) steps around the
anchor ``w`` with the scope ``g = g0 (1 + g1)^t`` growing with the outer
step ``t``, their iterates averaged into ``<w>`` with ``beta1`` 0.75 at
the inner rate 0.1, then an outer (Nesterov-)momentum step on ``w -
<w>``.

* ``recompute_grads=True`` (the default, the upstream algorithm) takes a
  fresh gradient each inner step; ``False`` is the reference training
  loop's stale-gradient closure (opt.py:676-687), where each inner step
  reuses the previous one's direction.
* The first step warm-starts the outer momentum buffer with the entry
  direction (optim.py:43-46), not zeros.
* The closure's loss and error % at the anchor, ``err_fn(w)``, are kept
  in the state as ``mf``/``merr`` (the trainer reports them).
* The noise is standard normal, drawn on the host from ``rng`` (the
  trainer's ``torch.Generator``) one leaf at a time, unless ``noise`` —
  one ``{name: tensor}`` per inner step — is given.
* ``lr`` and the scope are float32 values, as the JAX state holds them
  (entropy_sgd.py:72, 99), so float64 runs agree with the JAX package's.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from optwboundeigenval_tpu_torch.optim.api import Optimizer


def accuracy(output: torch.Tensor, target: torch.Tensor, topk=(1,)):
    """precision@k percentages, the reference closure's helper
    (optim.py:107-121; entropy_sgd.py:41-51)."""
    pred = torch.argsort(output, dim=-1, descending=True, stable=True)[:, :max(topk)]
    correct = pred == target[:, None]
    return [100.0 * correct[:, :k].any(dim=1).to(torch.float32).mean() for k in topk]


def _scope(g0: float, g1: float, t: int) -> float:
    """``g0 * (1 + g1) ** t`` in float32 (entropy_sgd.py:99)."""
    f32 = lambda x: torch.tensor(x, dtype=torch.float32)
    return float(f32(g0) * f32(1 + g1) ** f32(float(t)))


def EntropySGD(lr: float = 0.1, momentum: float = 0.9, damp: float = 0.0,
               weight_decay: float = 0.0, nesterov: bool = True, L: int = 0,
               eps: float = 1e-4, g0: float = 1e-4, g1: float = 1e-3,
               inner_lr: float = 0.1, beta1: float = 0.75,
               recompute_grads: bool = True) -> Optimizer:

    def init(params):
        dev = next(iter(params.values())).device if params else None
        zero = lambda: torch.zeros((), dtype=torch.float32, device=dev)
        return {"t": 0, "mdw": {k: torch.zeros_like(p) for k, p in params.items()},
                "lr": float(np.float32(lr)), "mf": zero(), "merr": zero()}

    def momentum_step(dw, mdw, w):
        if weight_decay > 0:
            dw = {k: d + weight_decay * w[k] for k, d in dw.items()}
        if momentum > 0:
            mdw = {k: momentum * mdw[k] + (1 - damp) * d for k, d in dw.items()}
            dw = ({k: d + momentum * mdw[k] for k, d in dw.items()}
                  if nesterov else mdw)
        return dw, mdw

    def step(direction, state, params, *, grad_fn=None, rng=None, err_fn=None,
             noise=None, **_):
        if L > 0 and (grad_fn is None or (rng is None and noise is None)):
            raise ValueError("EntropySGD needs grad_fn (inner SGLD) and rng (noise)")
        mf, merr = err_fn(params) if err_fn is not None else (state["mf"], state["merr"])
        g_scope = _scope(g0, g1, state["t"])
        noise_scale = eps / math.sqrt(0.5 * inner_lr)
        wc = params  # the anchor
        if L > 0:
            w, mw = params, params
            lmdw = {k: torch.zeros_like(p) for k, p in params.items()}
            dw = direction
            for j in range(L):
                if recompute_grads:
                    _, dw = grad_fn(w)
                dw, lmdw = momentum_step(dw, lmdw, w)
                z = noise[j] if noise is not None else {
                    k: torch.randn(p.shape, generator=rng, dtype=p.dtype).to(p.device)
                    for k, p in w.items()}
                dw = {k: d - g_scope * (wc[k] - w[k]) + noise_scale * z[k]
                      for k, d in dw.items()}
                w = {k: p - inner_lr * dw[k] for k, p in w.items()}
                mw = {k: beta1 * m + (1 - beta1) * w[k] for k, m in mw.items()}
            outer_grad = {k: wc[k] - m for k, m in mw.items()}
        else:
            outer_grad = direction
        # the reference warm-starts the outer buffer with the entry
        # direction on the first step (optim.py:43-46)
        mdw_prev = direction if state["t"] == 0 else state["mdw"]
        dw, mdw = momentum_step(outer_grad, mdw_prev, wc)
        lr_now = state["lr"]
        new_params = {k: p - lr_now * dw[k] for k, p in wc.items()}
        return new_params, {**state, "t": state["t"] + 1, "mdw": mdw,
                            "mf": mf, "merr": merr}

    return Optimizer(name="EntropySGD", init=init, step=step, lr_float32=True,
                     wants_err=True, slices=False)
