"""The reference's spectral-regularised steps and audit batches.

A step on a batch, from ``(params, BatchNorm state, optimizer state,
v)``: the gradient of the training loss (train mode: batch statistics,
the running ones untouched) with its graph kept; ``rho`` and ``v`` by
the power iteration from the carried ``v``; the penalty ``g = max(0, rho
- K, Kmin - rho)`` and, where it is positive, ``grad g = s * v^T (grad
H) v`` with ``s = +1`` where ``rho > K`` and -1 else, clipped in norm to
``gradg_clip`` where one is set; the direction ``grad f + mu * grad g``
through the optimizer; the running statistics advanced on the batch at
the parameters before the step, ``(1 - m) * running + m * batch``.

An audit batch is the same without the penalty and the optimizer: the
gradient's graph, ``rho`` and ``v`` from the carried ``v``, the running
statistics advanced.

Where the power iteration forks (``solver.power_iteration``'s
``margin``), each outcome is followed as a path of its own, up to
``max_paths``.

The optimizers are torch.optim's with coupled weight decay: SGD with
momentum (``t = d + m t``, ``p -= lr t``) and Adam (``p -= lr m_hat /
(sqrt(v_hat) + eps)``), ``d = direction + weight_decay * p``.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from portbench.reference.losses import LOSSES
from portbench.reference.models import Model
from portbench.reference.solver import flat, grad_with_hvp, power_iteration, uniform, unflat, vghv

Tree = Dict[str, torch.Tensor]


def optimizer_init(spec: dict, params: Tree) -> dict:
    zeros = {k: torch.zeros_like(p) for k, p in params.items()}
    if spec["name"] == "sgd":
        return {"trace": zeros}
    return {"count": 0, "m": zeros, "v": {k: torch.zeros_like(p) for k, p in params.items()}}


def optimizer_step(spec: dict, state: dict, params: Tree, direction: Tree):
    """``(new params, new state, d)``, ``d`` the decayed direction the
    moments take in."""
    wd = spec.get("weight_decay", 0.0)
    d = {k: g + wd * params[k] for k, g in direction.items()} if wd else direction
    lr = spec["lr"]
    if spec["name"] == "sgd":
        trace = {k: g + spec["momentum"] * state["trace"][k] for k, g in d.items()}
        return {k: p - lr * trace[k] for k, p in params.items()}, {"trace": trace}, d
    b1, b2, eps = spec["b1"], spec["b2"], spec["eps"]
    count = state["count"] + 1
    m = {k: (1 - b1) * g + b1 * state["m"][k] for k, g in d.items()}
    v = {k: (1 - b2) * g * g + b2 * state["v"][k] for k, g in d.items()}
    c1, c2 = 1 - b1 ** count, 1 - b2 ** count
    new = {k: p - lr * ((m[k] / c1) / (torch.sqrt(v[k] / c2) + eps)) for k, p in params.items()}
    return new, {"count": count, "m": m, "v": v}, d


@torch.no_grad()
def bn_update(model: Model, params: Tree, state: Tree, x: torch.Tensor, momentum: float) -> Tree:
    stats: Tree = {}
    model.forward(params, state, x, True, stats)
    return {k: (1 - momentum) * s + momentum * stats[k] for k, s in state.items()}


def _norm_clip(tree: Tree, max_norm) -> Tree:
    if max_norm is None:
        return tree
    norm = float(torch.linalg.vector_norm(flat(tree)))
    return tree if norm <= max_norm else {k: t * (max_norm / norm) for k, t in tree.items()}


def follow(model: Model, hp: dict, params: Tree, state: Tree, batches: List[dict], *,
           train: bool, v0: Optional[Tree] = None, opt0: Optional[dict] = None,
           margin: float = 0.0, max_paths: int = 4) -> List[dict]:
    """Steps (``train``) or audit batches over ``batches`` from
    ``(params, state)``, the optimizer's state ``opt0`` (its initial state
    where it is None) and ``v0`` (the uniform vector where it is None).  Each path: ``rho``, ``gradf_norm`` and ``iters`` a batch; under
    ``train`` ``g1`` and ``d1``, the first step's direction before and
    after the weight decay; the final
    ``params``, ``state``, ``v`` (a tree)."""
    loss = LOSSES[hp["loss"]]
    n = sum(p.numel() for p in params.values())
    first = next(iter(params.values()))
    start = uniform(n, first) if v0 is None else flat({k: v0[k] for k in params})
    paths = [{"params": params, "state": state, "v": start,
              "opt": (opt0 or optimizer_init(hp["optimizer"], params)) if train else None,
              "rho": [], "gradf_norm": [], "iters": [], "d1": None, "g1": None}]
    for batch in batches:
        grown = []
        for j, path in enumerate(paths):
            p, s = path["params"], path["state"]

            def loss_of(leaves, s=s):
                return loss(model.forward(leaves, s, batch["x"], True), batch["y"], batch["w"])

            _, grad_f, hvp = grad_with_hvp(loss_of, p)
            room = max_paths - len(grown) - (len(paths) - j - 1)
            eigs = power_iteration(hvp, path["v"], eps=hp["pow_iter_eps"],
                                   max_iter=hp["max_pow_iter"],
                                   ignore_bad_vals=hp["ignore_bad_vals"],
                                   margin=margin, max_results=max(1, room))
            del hvp
            new_state = bn_update(model, p, s, batch["x"], hp["bn_momentum"])
            gnorm = float(torch.linalg.vector_norm(flat(grad_f)))
            for e in eigs:
                out = {"state": new_state, "v": e.v, "rho": path["rho"] + [e.rho],
                       "gradf_norm": path["gradf_norm"] + [gnorm],
                       "iters": path["iters"] + [e.iters], "d1": path["d1"], "g1": path["g1"],
                       "params": p, "opt": path["opt"]}
                if train:
                    direction = grad_f
                    g = max(0.0, e.rho - hp["K"], hp["Kmin"] - e.rho)
                    if g > 0:
                        gr = _norm_clip(vghv(loss_of, p, e.v), hp.get("gradg_clip"))
                        sign = 1.0 if e.rho > hp["K"] else -1.0
                        direction = {k: t + hp["mu"] * sign * gr[k] for k, t in grad_f.items()}
                    out["params"], out["opt"], d = optimizer_step(
                        hp["optimizer"], path["opt"], p, direction)
                    if out["d1"] is None:
                        out["d1"], out["g1"] = d, direction
                grown.append(out)
        paths = grown
    for path in paths:
        path["v"] = unflat(path["v"], params)
    return paths
