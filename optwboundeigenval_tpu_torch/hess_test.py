"""The curvature oracle (counterpart of the repo's ``hess_test.py``, the
reference's hessTest): the port's ``curvature.grad``, ``hvp`` and
``vghv`` on a toy 2-layer sigmoid/MSE network in float64, against a dense
``torch.autograd.functional.hessian`` and against central differences of
``v^T H(p) v``.  Passes when the norm differences are under 1e-12
(gradient), 1e-12 (HVP) and 1e-6 (vGHv, the finite-difference step).

    python -m optwboundeigenval_tpu_torch.hess_test [--device cpu]

It runs on the GPU unless ``--device cpu`` is given, and raises on a
machine without one.
"""

from __future__ import annotations

import argparse
import sys
from typing import Dict

import numpy as np
import torch

from optwboundeigenval_tpu_torch.ops import curvature
from optwboundeigenval_tpu_torch.train.trainer import resolve_device
from optwboundeigenval_tpu_torch.utils.tree import tree_ravel

BOUNDS = {"grad": 1e-12, "hvp": 1e-12, "vghv": 1e-6}
FD_EPS = 1e-6


def toy_loss(params, batch):
    x, y = batch
    h = torch.sigmoid(x @ params["w1"] + params["b1"])
    out = torch.sigmoid(h @ params["w2"] + params["b2"])
    return torch.mean((out - y) ** 2)


def toy_problem(seed: int = 1226):
    """``(params, batch, v)`` as numpy float64: a 5-4-3 network, 7 rows."""
    rng = np.random.default_rng(seed)
    params = {"w1": rng.normal(size=(5, 4)), "b1": rng.normal(size=4),
              "w2": rng.normal(size=(4, 3)), "b2": rng.normal(size=3)}
    batch = (rng.normal(size=(7, 5)), rng.uniform(size=(7, 3)))
    v = {k: rng.normal(size=a.shape) for k, a in params.items()}
    return params, batch, v


def oracle(params, batch, v, device) -> Dict[str, float]:
    """The norm differences ``{"grad", "hvp", "vghv"}`` of the port's
    products against the dense oracle on ``device``, in float64."""
    put = lambda a: torch.as_tensor(a, dtype=torch.float64, device=device)
    params = {k: put(a) for k, a in params.items()}
    batch = tuple(put(a) for a in batch)
    v = {k: put(a) for k, a in v.items()}
    flat, unravel = tree_ravel(params)
    v_flat, _ = tree_ravel(v)
    f = lambda p: toy_loss(unravel(p), batch)

    def hessian(p):
        return torch.autograd.functional.hessian(f, p)

    with torch.enable_grad():
        p = flat.clone().requires_grad_(True)
        g_exact = torch.autograd.grad(f(p), p)[0]
    hv_exact = hessian(flat) @ v_flat
    rayleigh = lambda p: v_flat @ hessian(p) @ v_flat
    basis = torch.eye(flat.numel(), dtype=flat.dtype, device=device) * FD_EPS
    vghv_fd = torch.stack([(rayleigh(flat + e) - rayleigh(flat - e)) / (2 * FD_EPS)
                           for e in basis])

    ours = {"grad": curvature.grad(toy_loss, params, batch),
            "hvp": curvature.hvp(toy_loss, params, batch, v),
            "vghv": curvature.vghv(toy_loss, params, batch, v)}
    exact = {"grad": g_exact, "hvp": hv_exact, "vghv": vghv_fd}
    return {k: float(torch.linalg.norm(tree_ravel(ours[k])[0] - exact[k])) for k in ours}


def main(argv=None) -> Dict[str, float]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cpu, or the GPU by default")
    device = resolve_device(ap.parse_args(argv).device)
    diffs = oracle(*toy_problem(), device)
    print(f"device: {device}")
    print(f"grad diff:  {diffs['grad']:.3e}")
    print(f"R-op diff:  {diffs['hvp']:.3e}")
    print(f"R2-op diff: {diffs['vghv']:.3e}")
    for k, bound in BOUNDS.items():
        if not diffs[k] < bound:
            raise AssertionError(f"{k} diff {diffs[k]:.3e} is not under {bound:g}")
    print("PASS")
    return diffs


if __name__ == "__main__":
    main(sys.argv[1:])
