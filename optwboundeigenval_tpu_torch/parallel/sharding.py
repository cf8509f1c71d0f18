"""Tensor parallelism over the mesh's ``model`` axis (counterpart of
``optwboundeigenval_tpu/parallel/sharding.py``).

The JAX package shards the output features of every kernel of at least
``min_elems`` values whose output-feature dimension divides the ``model``
axis, and XLA partitions the matmuls and convolutions: each device
computes its own output columns.  flax keeps the output feature last
(``(in, out)``, ``(kh, kw, in, out)``, an embedding's ``(num,
features)``).  torch keeps it where the layer type puts it
(``utils/interop.py`` maps the one layout to the other):

* ``Conv2d`` ``(out, in, kh, kw)`` and ``Linear`` ``(out, in)``: dim 0;
* ``ConvTranspose2d`` ``(in, out, kh, kw)`` and ``Embedding`` ``(num,
  features)``: dim 1.

:func:`infer_param_specs` applies JAX's size and divisibility tests to
that dimension, taken from the layer that owns the leaf
(:func:`output_dims`).

A rank keeps only its slice of a sharded leaf: indices ``[c D / M, (c +
1) D / M)`` of the output-feature dimension for model coordinate ``c``
of ``M``.  That holds for ``params``, the eigenvector ``v`` and the
params-shaped optimizer state (:func:`shard_params`,
:meth:`Sharding.local`).  A layer whose weight arrives as such a slice
(``models/layers.py``, the gemm conv of ``models/cnn_usps.py``) computes
its own output columns, without the bias.  :func:`assemble_columns`
then zero-pads them to the full width at this rank's offset, sums that
over the ``model`` group (``mesh.all_sum_diff``) and adds the whole
bias.  The sum of one value and zeros is that value, so the whole output
is exact.  The assembly's backward is the same all-reduce of the output
gradient, then the slice.  So a rank's weight slice gets its complete
gradient, and its share of the input's gradient comes from its own
columns.  The sum of a replicated leaf's shares over the world
(``mesh.all_sum_tree``) completes them; autograd differentiates all of
it again for the HVP and the vGHv.  gloo has no reduce-scatter, so the
assembly is an all-reduce of zero-padded activations: each forward sends
every sharded layer's whole output, and no weight.

A leaf is this rank's slice when its sharded dimension is shorter than
the full shape's (:meth:`Sharding.is_local`).  A full-shaped weight
computes its whole layer, under a sharding too: K-FAC's capture, the
checkpoints and the ``.pt`` export work on the gathered tree
(:meth:`Sharding.gather_tree`).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from optwboundeigenval_tpu_torch.parallel import mesh as meshlib
from optwboundeigenval_tpu_torch.parallel.mesh import Mesh

Tree = Dict[str, torch.Tensor]

# weight layouts by where the output feature sits
_OUT_FIRST = (nn.Conv2d, nn.Linear)
_OUT_SECOND = (nn.ConvTranspose2d, nn.Embedding)


def output_dims(model: nn.Module) -> Dict[str, int]:
    """The output-feature dimension of each layer weight of ``model``, by
    parameter name: 0 for ``Conv2d`` and ``Linear``, 1 for
    ``ConvTranspose2d`` and ``Embedding``."""
    out = {}
    for name, m in model.named_modules():
        if isinstance(m, _OUT_FIRST + _OUT_SECOND):
            out[f"{name}.weight" if name else "weight"] = 0 if isinstance(m, _OUT_FIRST) else 1
    return out


def infer_param_specs(params: Tree, mesh: Mesh, min_elems: int = 2**16,
                      model: Optional[nn.Module] = None) -> Dict[str, Optional[int]]:
    """Per leaf, the dimension it is sharded along over ``model`` (its
    output feature), or None where it is replicated: JAX's rule of ``ndim
    >= 2``, ``size >= min_elems`` and a divisible output feature.  The
    output feature is that of the layer of ``model`` owning the leaf
    (:func:`output_dims`); without ``model`` it is dim 0, the ``Conv2d``
    and ``Linear`` layout.  A leaf that would shard and is no layer's
    weight of ``model`` raises."""
    axis = mesh.model
    dims = output_dims(model) if model is not None else None

    def spec(name: str, x: torch.Tensor) -> Optional[int]:
        if axis == 1 or x.dim() < 2 or x.numel() < min_elems:
            return None
        if dims is not None and name not in dims:
            raise TypeError(f"{name}: no layer of the model gives its output feature")
        d = 0 if dims is None else dims[name]
        return d if x.shape[d] % axis == 0 else None

    return {k: spec(k, x) for k, x in params.items()}


def assemble_columns(y: torch.Tensor, full: int, dim: int,
                     bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A layer's whole output from ``y``, this rank's columns along
    ``dim`` of its ``full`` output features: ``y`` zero-padded to the
    full width at this rank's offset, summed over the active mesh's
    ``model`` group by ``mesh.all_sum_diff`` (differentiable to any
    order), plus ``bias`` (whole, broadcast along ``dim``).  The sum of
    one value and zeros is exact in any dtype."""
    mesh = meshlib.current()
    if mesh is None:
        raise RuntimeError("a layer holding a slice of its weight needs its mesh active")
    dim %= y.dim()
    per, c = y.shape[dim], mesh.model_coord
    if per * mesh.model != full:
        raise ValueError(f"{per} output columns a rank on a model axis of {mesh.model} "
                         f"do not make {full}")
    out = F.pad(y, [0, 0] * (y.dim() - 1 - dim) + [c * per, full - (c + 1) * per])
    out = meshlib.all_sum_diff(out, "model")
    if bias is None:
        return out
    return out + bias.reshape((-1,) + (1,) * (y.dim() - 1 - dim))


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
        ``model`` group of the zero-padded slices laid end to end (not
        differentiated: the paths that take whole layers, K-FAC, the flat
        solvers, the optimizers that step on whole layers, the
        checkpoints); the other leaves as they are."""
        split = [k for k, t in tree.items() if self.is_local(k, t)]
        if not split:
            return tree
        padded = [self._padded(k, tree[k]) for k in split]
        flat = torch.cat([p.reshape(-1) for p in padded])
        if meshlib.current() is None:
            raise RuntimeError("gathering sharded leaves needs their mesh active")
        flat = meshlib.all_sum(flat, "model")
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


def sharding_of(params: Tree, mesh: Mesh, min_elems: int = 2**16,
                model: Optional[nn.Module] = None) -> Optional[Sharding]:
    """The :class:`Sharding` of full ``params`` (of ``model``'s layers,
    :func:`infer_param_specs`) on ``mesh``; None where no leaf shards."""
    dims = {k: d for k, d in infer_param_specs(params, mesh, min_elems, model).items()
            if d is not None}
    if not dims:
        return None
    return Sharding(mesh=mesh, dims=dims, shapes={k: params[k].shape for k in dims})


def shard_params(tree: Tree, mesh: Mesh, min_elems: int = 2**16,
                 model: Optional[nn.Module] = None) -> Tree:
    """This rank's slices of a full params-shaped tree (the params, the
    eigenvector, a moment of the optimizer) of ``model``'s layers by
    :func:`infer_param_specs`, as a :class:`Sharded` tree; a
    :class:`Sharded` tree comes back as it is, and a tree with no leaf to
    shard too."""
    if isinstance(tree, Sharded):
        return tree
    sharding = sharding_of(tree, mesh, min_elems, model)
    return tree if sharding is None else Sharded(sharding.local(tree), sharding)


def gather_params(tree: Tree, sharding: Optional[Sharding]) -> Tree:
    """The full tree of ``tree``'s slices (every rank of the mesh calls
    it); ``tree`` itself without a sharding."""
    if sharding is None:
        return tree
    with meshlib.active(sharding.mesh, sharding):
        return sharding.gather_tree(tree)
