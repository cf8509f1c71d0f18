"""The comparison that decides ``correct``: the numbers the program's
outputs give against the reference's, each held to its limit
(``limits/<workload>.json``).

Steps: the first ``follow_steps`` of a run, which set-up drives through
the window's own call, followed from the benchmark's own start; and
``check_units`` steps of the window drawn from the seed, each followed
from the program's own state before it (parameters, optimizer state,
running statistics, eigenvector):

* ``rho``: the largest relative gap of a step's ``rho``;
* ``gradf``: the relative gap of ``|grad f|`` at the first step of each
  run of steps followed, where both sides take the gradient at the same
  parameters (the step returns no loss; the norm of its gradient stands
  in for it; in float32 the later followed steps' norms drift apart as
  far as TF32 moves them);
* ``grad``: the direction the optimizer took in at that first step
  (worked out from its state before and after), by the worst leaf:
  ``| |a_k| - |b_k| | / max(|b_k|, median_j |b_j|)``;
* ``change``: the parameters' change over the steps, by the worst leaf
  as ``grad``, leaving out the leaves whose first reference gradient is
  under a thousandth of the median leaf's (their gradient is rounding:
  a bias before a BatchNorm);
* ``bn``: the running statistics' change, by the worst leaf;
* ``v``: ``1 - |cos|`` of the last step's eigenvector.

Audit batches (the set-up's first batches, and a sample of the window's
drawn from the seed, each from the program's own state before it):
``rho``, ``bn`` and ``v`` as above, the largest over the batches.

Where the reference forked at a stop (``reference/solver.py``), the path
whose worst number against its limit is least is taken.  ``worst_leaf``
names, for the record, the leaf each leaf-wise number was read at.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch

Tree = Dict[str, torch.Tensor]


def _norms(tree: Tree) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(t.double())) for k, t in tree.items()}


def _median(values) -> float:
    v = sorted(values)
    return v[len(v) // 2] if len(v) % 2 else 0.5 * (v[len(v) // 2 - 1] + v[len(v) // 2])


def leaf_gaps(prog: Tree, ref: Tree, keep: Optional[List[str]] = None):
    """``(gap, leaf)``: the worst leaf's ``| |a_k| - |b_k| | / max(|b_k|,
    median |b|)`` and its name."""
    keys = list(ref) if keep is None else keep
    a, b = _norms({k: prog[k] for k in keys}), _norms({k: ref[k] for k in keys})
    med = _median(b.values())
    gaps = {k: abs(a[k] - b[k]) / max(b[k], med, 1e-300) for k in keys}
    worst_key = max(gaps, key=gaps.get, default="")
    return gaps.get(worst_key, 0.0), worst_key



def rel_gap(prog: float, ref: float) -> float:
    if prog == ref:
        return 0.0
    if ref == -1.0 or prog == -1.0:  # one side discarded, the other not
        return math.inf
    return abs(prog - ref) / max(abs(ref), 1e-300)


def cos_gap(prog: Tree, ref: Tree) -> float:
    dot = sum(float(torch.dot(prog[k].reshape(-1).double(), t.reshape(-1).double()))
              for k, t in ref.items())
    na = math.sqrt(sum(v * v for v in _norms(prog).values()))
    nb = math.sqrt(sum(v * v for v in _norms(ref).values()))
    return max(0.0, 1.0 - abs(dot) / max(na * nb, 1e-300))


def sub(a: Tree, b: Tree) -> Tree:
    return {k: a[k].double() - b[k].double() for k in b}


def step_numbers(prog: dict, path: dict, params0: Tree, state0: Tree) -> Dict[str, float]:
    """Steps from ``(params0, state0)``.  ``prog``: the program's ``rho``,
    ``gradf_norm`` (lists, a step each), ``d1`` (the first step's
    direction), ``params``, ``state``, ``v`` after the steps; ``path``: the
    reference's."""
    d1 = _norms(path["g1"])
    med = _median(d1.values())
    keep = [k for k, n in d1.items() if n >= 1e-3 * med]
    grad, at_grad = leaf_gaps(prog["d1"], path["d1"])
    change, at_change = leaf_gaps(sub(prog["params"], params0), sub(path["params"], params0),
                                  keep)
    bn, at_bn = leaf_gaps(sub(prog["state"], state0), sub(path["state"], state0))
    return {
        "rho": max(rel_gap(a, b) for a, b in zip(prog["rho"], path["rho"])),
        "gradf": rel_gap(prog["gradf_norm"][0], path["gradf_norm"][0]),
        "grad": grad, "change": change, "bn": bn,
        "v": cos_gap(prog["v"], path["v"]),
        "worst_leaf": {"grad": at_grad, "change": at_change, "bn": at_bn,
                       "left_out": len(d1) - len(keep)},
    }


def audit_numbers(prog: dict, path: dict, state0: Tree) -> Dict[str, float]:
    """One audit run of batches from one state: ``prog`` and ``path`` hold
    ``rho`` (a list), ``state`` and ``v`` after them."""
    bn, at_bn = leaf_gaps(sub(prog["state"], state0), sub(path["state"], state0))
    return {
        "rho": max(rel_gap(a, b) for a, b in zip(prog["rho"], path["rho"])),
        "bn": bn, "v": cos_gap(prog["v"], path["v"]), "worst_leaf": {"bn": at_bn},
    }


def worst(numbers: Dict[str, float], limits: Dict[str, float]) -> float:
    return max(numbers[k] / limits[k] for k in limits if k in numbers)


def best_path(prog: dict, paths: List[dict], numbers_of, limits: Dict[str, float]
              ) -> Dict[str, float]:
    """The numbers of the reference path that agrees best with ``prog``."""
    found = [numbers_of(prog, p) for p in paths]
    return min(found, key=lambda n: worst(n, limits))


def merge(readings: List[Dict[str, float]]) -> Dict[str, float]:
    """Each number's largest reading (the diagnostic ``worst_leaf`` of the
    first)."""
    return {k: max(r[k] for r in readings if k in r) if k != "worst_leaf" else readings[0][k]
            for k in readings[0]}
