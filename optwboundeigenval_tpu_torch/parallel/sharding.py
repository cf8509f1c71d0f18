"""Parameter sharding over the mesh's ``model`` axis (counterpart of
``optwboundeigenval_tpu/parallel/sharding.py``).

The JAX package shards the trailing (output-feature) dimension of every
kernel of at least ``min_elems`` values whose trailing dimension divides
the ``model`` axis, and lets XLA partition the matmuls.  The port's
``nn.Linear`` weight is ``(out, in)`` and its ``nn.Conv2d`` weight ``(out,
in, kh, kw)`` (``utils/interop.py`` transposes flax's ``(in, out)`` and
``(kh, kw, in, out)`` into them), so the same output feature is dim 0
here, and :func:`infer_param_specs` applies JAX's size and divisibility
tests to it.

A rank keeps only its slice of a sharded leaf: rows ``[c D / M, (c + 1)
D / M)`` of dim 0 for model coordinate ``c`` of ``M``.  That holds for
``params``, the eigenvector ``v`` and the params-shaped optimizer state
(:func:`shard_params`, :meth:`Sharding.local`).  The model sees whole
weights: under an active sharding (``mesh.active(mesh, sharding)``)
``Task`` gathers the sharded leaves before each forward
(:meth:`Sharding.gather`), each slice zero-padded to the full shape and
summed over the ``model`` group by ``mesh.all_sum_diff``.  The sum of one
value and zeros is that value, so the gather is exact; its backward is
the same all-reduce followed by the slice (a reduce-scatter), which
autograd differentiates again, so the gradient, the HVP and the vGHv of
a sharded leaf come out as this rank's slices.  What the sharding divides
is the memory of the parameters, the eigenvector and the optimizer
state; every rank of a ``model`` group computes whole layers.

A leaf is this rank's slice when its sharded dimension is shorter than
the full shape's (:meth:`Sharding.is_local`); a full-shaped leaf under a
sharding, such as the gathered tree that K-FAC works on, is treated as
replicated everywhere.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from optwboundeigenval_tpu_torch.parallel import mesh as meshlib
from optwboundeigenval_tpu_torch.parallel.mesh import Mesh

Tree = Dict[str, torch.Tensor]


def infer_param_specs(params: Tree, mesh: Mesh, min_elems: int = 2**16
                      ) -> Dict[str, Optional[int]]:
    """Per leaf, the dimension it is sharded along over ``model`` (the
    output feature, dim 0), or None where it is replicated: JAX's rule of
    ``ndim >= 2``, ``size >= min_elems`` and a divisible output feature."""
    model = mesh.model

    def spec(x: torch.Tensor) -> Optional[int]:
        if model > 1 and x.dim() >= 2 and x.numel() >= min_elems and x.shape[0] % model == 0:
            return 0
        return None

    return {k: spec(x) for k, x in params.items()}


@dataclasses.dataclass(frozen=True, eq=False)
class Sharding:
    """The sharded leaves of a parameter tree on ``mesh``: their dims and
    full shapes, by leaf name."""

    mesh: Mesh
    dims: Dict[str, int]
    shapes: Dict[str, torch.Size]

    def is_local(self, name: str, t: torch.Tensor) -> bool:
        """Whether ``t`` under ``name`` is this rank's slice of a sharded
        leaf (not the full leaf)."""
        d = self.dims.get(name)
        return (d is not None and isinstance(t, torch.Tensor) and t.dim() == len(self.shapes[name])
                and t.shape[d] != self.shapes[name][d])

    def numel(self, name: str, t: torch.Tensor) -> int:
        """The full leaf's number of values."""
        return self.shapes[name].numel() if self.is_local(name, t) else t.numel()

    def _slice(self, name: str, full: torch.Tensor) -> torch.Tensor:
        d = self.dims[name]
        per = full.shape[d] // self.mesh.model
        return full.narrow(d, self.mesh.model_coord * per, per)

    def local(self, tree):
        """``tree`` (nested dicts) with every full-shaped sharded leaf cut
        to this rank's slice (a copy); the rest as it is."""
        if not isinstance(tree, dict):
            return tree
        out = {}
        for k, t in tree.items():
            if isinstance(t, dict):
                out[k] = self.local(t)
            elif (k in self.dims and isinstance(t, torch.Tensor)
                  and t.shape == self.shapes[k]):
                out[k] = self._slice(k, t).clone()
            else:
                out[k] = t
        return out

    def _padded(self, name: str, t: torch.Tensor) -> torch.Tensor:
        d, c, m = self.dims[name], self.mesh.model_coord, self.mesh.model
        per = t.shape[d]
        zeros = lambda n: torch.zeros(t.shape[:d] + (n * per,) + t.shape[d + 1:],
                                      dtype=t.dtype, device=t.device)
        return torch.cat([zeros(c), t, zeros(m - 1 - c)], d)

    def gather(self, tree: Tree) -> Tree:
        """Full leaves for this rank's slices, in one all-reduce over the
        ``model`` group of the zero-padded slices laid end to end
        (``mesh.all_sum_diff``: autograd goes through it to any order
        where the slices require grad); the other leaves as they are."""
        split = [k for k, t in tree.items() if self.is_local(k, t)]
        if not split:
            return tree
        padded = [self._padded(k, tree[k]) for k in split]
        flat = torch.cat([p.reshape(-1) for p in padded])
        if meshlib.current() is None:
            raise RuntimeError("gathering sharded leaves needs their mesh active")
        flat = meshlib.all_sum_diff(flat, "model")
        out, off = dict(tree), 0
        for k, p in zip(split, padded):
            out[k] = flat[off:off + p.numel()].view(p.shape)
            off += p.numel()
        return out

    def gather_tree(self, tree):
        """``tree`` (nested dicts) with every sharded leaf gathered:
        checkpoints and the optimizers that work on whole layers."""
        if not isinstance(tree, dict):
            return tree
        nested = {k: self.gather_tree(t) for k, t in tree.items() if isinstance(t, dict)}
        flat = self.gather({k: t for k, t in tree.items() if not isinstance(t, dict)})
        return {k: nested[k] if k in nested else flat[k] for k in tree}


class Sharded(dict):
    """A tree of this rank's slices, carrying its :class:`Sharding`; the
    trainer takes the sharding from the params it is given."""

    def __init__(self, tree: Tree, sharding: Sharding):
        super().__init__(tree)
        self.sharding = sharding


def sharding_of(params: Tree, mesh: Mesh, min_elems: int = 2**16) -> Optional[Sharding]:
    """The :class:`Sharding` of full ``params`` on ``mesh``; None where no
    leaf shards."""
    dims = {k: d for k, d in infer_param_specs(params, mesh, min_elems).items()
            if d is not None}
    if not dims:
        return None
    return Sharding(mesh=mesh, dims=dims, shapes={k: params[k].shape for k in dims})


def shard_params(tree: Tree, mesh: Mesh, min_elems: int = 2**16) -> Tree:
    """This rank's slices of a full params-shaped tree (the params, the
    eigenvector, a moment of the optimizer) by :func:`infer_param_specs`,
    as a :class:`Sharded` tree; a :class:`Sharded` tree comes back as it
    is, and a tree with no leaf to shard too."""
    if isinstance(tree, Sharded):
        return tree
    sharding = sharding_of(tree, mesh, min_elems)
    return tree if sharding is None else Sharded(sharding.local(tree), sharding)


def gather_params(tree: Tree, sharding: Optional[Sharding]) -> Tree:
    """The full tree of ``tree``'s slices (every rank of the mesh calls
    it); ``tree`` itself without a sharding."""
    if sharding is None:
        return tree
    with meshlib.active(sharding.mesh, sharding):
        return sharding.gather_tree(tree)
