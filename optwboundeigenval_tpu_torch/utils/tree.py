"""Vector-space helpers over parameter dicts (``{name: tensor}``).

Counterpart of ``optwboundeigenval_tpu/utils/tree.py``: the eigensolver
keeps its vectors in parameter layout, one tensor per leaf, and needs
only inner products, axpy, scaling and the deterministic start vector.
All helpers are functional (they return new tensors) and work inside
``torch.func`` transforms.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Tuple

import torch

Tree = Dict[str, torch.Tensor]


def tree_vdot(a: Tree, b: Tree) -> torch.Tensor:
    """Inner product ``<a, b>`` (0-d tensor)."""
    return torch.stack(
        [torch.dot(x.reshape(-1), b[k].reshape(-1)) for k, x in a.items()]
    ).sum()


def tree_norm(a: Tree) -> torch.Tensor:
    return torch.sqrt(tree_vdot(a, a))


def tree_scale(alpha, a: Tree) -> Tree:
    return {k: alpha * x for k, x in a.items()}


def tree_sub(a: Tree, b: Tree) -> Tree:
    return {k: x - b[k] for k, x in a.items()}


def tree_axpy(alpha, x: Tree, y: Tree) -> Tree:
    """``alpha * x + y``."""
    return {k: alpha * xi + y[k] for k, xi in x.items()}


def tree_zeros_like(a: Tree) -> Tree:
    return {k: torch.zeros_like(x) for k, x in a.items()}


def tree_size(a: Tree) -> int:
    """Total number of scalars (the reference's ``ndim``, opt.py:252)."""
    return sum(x.numel() for x in a.values())


def tree_uniform_like(a: Tree) -> Tree:
    """The reference's start vector ``1/sqrt(n) * ones`` with ``n`` the
    TOTAL size over all leaves (opt.py:324-325)."""
    val = 1.0 / math.sqrt(float(tree_size(a)))
    return {k: torch.full_like(x, val) for k, x in a.items()}


def tree_where(pred: torch.Tensor, a: Tree, b: Tree) -> Tree:
    """``a`` where the 0-d boolean ``pred`` holds, else ``b``, leaf by
    leaf, without reading ``pred`` back to the host."""
    return {k: torch.where(pred, x, b[k]) for k, x in a.items()}


def tree_ravel(a: Tree) -> Tuple[torch.Tensor, Callable[[torch.Tensor], Tree]]:
    """Flatten to one 1-D tensor; returns ``(vector, unravel)``."""
    shapes = [(k, x.shape, x.numel()) for k, x in a.items()]
    flat = torch.cat([x.reshape(-1) for x in a.values()]) if a else torch.zeros(0)

    def unravel(vec: torch.Tensor) -> Tree:
        out, off = {}, 0
        for k, shape, n in shapes:
            out[k] = vec[off:off + n].reshape(shape)
            off += n
        return out

    return flat, unravel
