"""Matrix-free curvature: gradients, Hessian-vector products and the
third-order directional derivative ``v^T (grad H) v`` (counterpart of
``optwboundeigenval_tpu/ops/curvature.py``).

A loss function maps ``(params, batch) -> scalar`` with ``params`` a
dict of tensors.  Every product is plain autograd over the loss:

* ``grad`` = one reverse pass;
* ``hvp`` = reverse over reverse, ``autograd.grad(g, p, v)`` with ``g``
  taken with ``create_graph=True``; nothing is kept after it returns;
* ``linearize_hvp`` = the gradient's graph kept, one reverse pass per HVP;
  ``recompute_hvp`` = nothing kept, each HVP a whole ``hvp`` (the
  ``remat`` option: ``jax.linearize(grad(jax.checkpoint(loss)))`` keeps
  only its inputs and recomputes forward and gradient per product);
* ``vghv`` = ``autograd.grad(<hv, v>, p)`` with ``hv`` taken with
  ``create_graph=True``.

Plain autograd, not ``torch.func``: on an H100 the autograd forms were as
fast or faster than ``torch.func``'s ``jvp(grad)`` and
``grad(<jvp(grad), v>)`` on every model of the package (PERF.md, section
6).  No ``torch.utils.checkpoint`` either: a product's later reverse
passes keep what a checkpoint recomputes in the earlier ones, so it
lowers no peak here and only adds a forward.

The ``*_microbatched`` variants split the batch into contiguous slices
``[i*mb, (i+1)*mb)`` (BatchNorm statistics are per slice, as in the JAX
package) and sum ``scale_m * term_m`` with ``scale_m = sum(w_m) /
max(sum(w), 1e-12)``, exact for weighted-mean losses.  ``scale_m`` stays
a device tensor and the running sum goes through the CUDA kernel
``ops/pallas_kernels.axpy_accumulate``.
A dropout loss closes over its step's key (``Task.loss_fn``), so every
slice is given the same key and, the slices sharing one shape, draws the
same masks, as the JAX package's micro-batched passes do.

Under a data-parallel mesh (``parallel/mesh.py``, ``active``) the loss is
this rank's share of the global batch's, and every public product here
returns the sum of the ranks' shares, one all-reduce of all leaves: the
gradient and its loss, each HVP (``hvp``, ``linearize_hvp``'s and
``recompute_hvp``'s maps) and the vGHv.  A micro-batched product sums
its slices on the rank first (the accumulate kernel runs on local sums)
and reduces once; slice ``i`` is then every rank's slice ``i``, whose
BatchNorm statistics and weight are taken over the ranks together.
Under a sharding (``parallel/sharding.py``) the products of a sharded
leaf are this rank's slice, summed over its ``data`` group, and those of
a replicated leaf are summed over the world (``mesh.all_sum_tree``, the
convention of ``parallel/mesh.py``); the accumulate kernel runs on the
local slices.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch

from optwboundeigenval_tpu_torch.ops.pallas_kernels import axpy_accumulate
from optwboundeigenval_tpu_torch.parallel import mesh as meshlib

Tree = Dict[str, torch.Tensor]
LossFn = Callable[[Tree, Any], torch.Tensor]


def _leaves(params: Tree) -> Tree:
    return {k: p.detach().requires_grad_(True) for k, p in params.items()}


def _value_and_grad(loss_fn: LossFn, params: Tree, batch) -> Tuple[torch.Tensor, Tree]:
    leaves = _leaves(params)
    with torch.enable_grad():
        loss = loss_fn(leaves, batch)
        g = torch.autograd.grad(loss, list(leaves.values()))
    return loss.detach(), dict(zip(leaves, g))


def value_and_grad(loss_fn: LossFn, params: Tree, batch) -> Tuple[torch.Tensor, Tree]:
    """``(loss, gradient)`` at ``params`` (reference ``prepare_grad``,
    opt.py:175-192)."""
    loss, g = _value_and_grad(loss_fn, params, batch)
    if meshlib.current() is None:
        return loss, g
    out = meshlib.all_sum_tree({"": loss.reshape(1), **g})
    return out.pop("").reshape(()), out


def grad(loss_fn: LossFn, params: Tree, batch) -> Tree:
    """Gradient of the loss at ``params``."""
    return value_and_grad(loss_fn, params, batch)[1]


def _hv(loss_fn: LossFn, params: Tree, batch, v: Tree, create_graph: bool):
    """``(leaves, hv)`` with ``hv = H v`` by reverse over reverse; under
    ``create_graph`` its graph is kept for one more pass."""
    leaves = _leaves(params)
    inputs = list(leaves.values())
    with torch.enable_grad():
        g = torch.autograd.grad(loss_fn(leaves, batch), inputs, create_graph=True)
        hv = torch.autograd.grad(g, inputs, [v[k] for k in leaves],
                                 create_graph=create_graph)
    return leaves, hv


def _hvp(loss_fn: LossFn, params: Tree, batch, v: Tree) -> Tree:
    leaves, hv = _hv(loss_fn, params, batch, v, create_graph=False)
    return dict(zip(leaves, hv))


def hvp(loss_fn: LossFn, params: Tree, batch, v: Tree) -> Tree:
    """``H(params) @ v`` (reference ``HVPOperator.Hv``, opt.py:77-108); the
    second pass builds no graph, so nothing outlives the call."""
    return meshlib.all_sum_tree(_hvp(loss_fn, params, batch, v))


def linearize_hvp(loss_fn: LossFn, params: Tree, batch
                  ) -> Tuple[Tree, Callable[[Tree], Tree]]:
    """``(grad, hvp_fn)`` for one batch, the gradient taken once and kept.

    The counterpart of ``jax.linearize(grad(loss))``: one reverse pass with
    ``create_graph=True`` builds the gradient's graph, and every
    ``hvp_fn(v)`` is one reverse pass over that graph,
    ``autograd.grad(grad, params, v)`` (the reference's ``stored_grad``,
    opt.py:86-99).  The graph lives as long as ``hvp_fn``.  The returned
    gradient is detached."""
    leaves = _leaves(params)
    inputs = list(leaves.values())
    with torch.enable_grad():
        g = torch.autograd.grad(loss_fn(leaves, batch), inputs, create_graph=True)

    def hvp_fn(v: Tree) -> Tree:
        hv = torch.autograd.grad(g, inputs, [v[k] for k in leaves],
                                 retain_graph=True)
        return meshlib.all_sum_tree(dict(zip(leaves, hv)))

    return meshlib.all_sum_tree({k: t.detach() for k, t in zip(leaves, g)}), hvp_fn


def recompute_hvp(loss_fn: LossFn, params: Tree, batch
                  ) -> Tuple[Tree, Callable[[Tree], Tree]]:
    """``(grad, hvp_fn)`` for one batch with no graph kept between calls:
    the ``remat`` counterpart of :func:`linearize_hvp`.  ``hvp_fn`` holds
    only ``params`` and ``batch``, and each call is one whole
    :func:`hvp`, a forward and a gradient recomputed per product, as
    ``jax.linearize(grad(jax.checkpoint(loss)))`` recomputes them."""
    return grad(loss_fn, params, batch), lambda v: hvp(loss_fn, params, batch, v)


def _vghv(loss_fn: LossFn, params: Tree, batch, v: Tree) -> Tree:
    leaves, hv = _hv(loss_fn, params, batch, v, create_graph=True)
    with torch.enable_grad():
        rayleigh_num = torch.stack([torch.dot(h.reshape(-1), v[k].reshape(-1))
                                    for k, h in zip(leaves, hv)]).sum()
        out = torch.autograd.grad(rayleigh_num, list(leaves.values()))
    return dict(zip(leaves, out))


def vghv(loss_fn: LossFn, params: Tree, batch, v: Tree) -> Tree:
    """``v^T (grad H) v``: the gradient of ``<H(p) v, v>`` with respect
    to ``p``, a third reverse pass over the HVP's graph (reference
    ``HVPOperator.vGHv``, opt.py:110-152)."""
    return meshlib.all_sum_tree(_vghv(loss_fn, params, batch, v))


def _batch_weight(batch) -> torch.Tensor:
    """Total example weight over the mesh's ranks: ``sum(w)``, else the
    leading dimension."""
    if "w" in batch:
        return meshlib.all_sum(batch["w"].sum())
    return meshlib.all_sum(torch.tensor(float(len(batch["x"])), device=batch["x"].device))


def _micro_batches(batch, num_micro: int):
    """Yield ``(micro_batch, scale_m)`` over contiguous slices."""
    lead = len(next(iter(batch.values())))
    if lead % num_micro:
        raise ValueError(f"batch of {lead} does not split into {num_micro} "
                         "equal micro-batches")
    mb = lead // num_micro
    w_total = torch.clamp_min(_batch_weight(batch), 1e-12)
    for i in range(num_micro):
        mbatch = {k: t[i * mb:(i + 1) * mb] for k, t in batch.items()}
        yield mbatch, _batch_weight(mbatch) / w_total


def _flat_like(tree: Tree) -> Tree:
    """Uninitialised leaves shaped and typed like ``tree``'s: views into one
    buffer a dtype (a tree at bfloat16 compute may mix bfloat16 and
    float32 leaves), at offsets padded to 4 values (8 in bfloat16), so each
    leaf is 16-byte aligned."""
    groups: Dict[torch.dtype, list] = {}
    for k, t in tree.items():
        groups.setdefault(t.dtype, []).append(k)
    out = {}
    for dtype, keys in groups.items():
        pad = max(4, 16 // torch.empty((), dtype=dtype).element_size())
        offsets = [0]
        for k in keys:
            offsets.append(offsets[-1] + -(-tree[k].numel() // pad) * pad)
        buf = torch.empty(offsets[-1], dtype=dtype, device=tree[keys[0]].device)
        for k, o in zip(keys, offsets):
            out[k] = buf[o:o + tree[k].numel()].view(tree[k].shape)
    return {k: out[k] for k in tree}


def _accumulate(terms) -> Tree:
    """``sum_m scale_m * term_m`` through the in-place kernel, one call over
    all leaves per micro-batch; the first writes ``scale_0 * term_0``
    (``init``), so the accumulator needs no zero fill."""
    acc = None
    for term, scale in terms:
        init = acc is None
        if init:
            acc = _flat_like(term)
        axpy_accumulate(list(acc.values()), [term[k].contiguous() for k in acc],
                        scale, init=init)
    return acc


def hvp_microbatched(loss_fn: LossFn, params: Tree, batch, v: Tree,
                     num_micro: int) -> Tree:
    """HVP summed over ``num_micro`` micro-batches: activations held at
    O(B / num_micro), exact for weighted-mean losses."""
    return meshlib.all_sum_tree(_accumulate((_hvp(loss_fn, params, mb, v), s)
                                            for mb, s in _micro_batches(batch, num_micro)))


def grad_microbatched(loss_fn: LossFn, params: Tree, batch,
                      num_micro: int) -> Tree:
    """Gradient summed over micro-batches (same exactness as
    :func:`hvp_microbatched`)."""
    return meshlib.all_sum_tree(_accumulate((_value_and_grad(loss_fn, params, mb)[1], s)
                                            for mb, s in _micro_batches(batch, num_micro)))


def vghv_microbatched(loss_fn: LossFn, params: Tree, batch, v: Tree,
                      num_micro: int) -> Tree:
    """``v^T (grad H) v`` summed over micro-batches: the third-order pass
    holds the largest residual set, so the ``hvp_micro`` memory bound
    must hold here too."""
    return meshlib.all_sum_tree(_accumulate((_vghv(loss_fn, params, mb, v), s)
                                            for mb, s in _micro_batches(batch, num_micro)))


def loss_grad_hvp_vghv(loss_fn: LossFn, params: Tree, batch, v: Tree
                       ) -> Tuple[torch.Tensor, Tree, Callable[[Tree], Tree], Tree]:
    """``(loss, grad, hvp_fn, vghv)`` for one batch (JAX
    ``curvature.loss_grad_hvp_vghv``): the loss and gradient, the kept
    linearization's HVP map and ``v^T (grad H) v``.  The trainer composes
    the pieces itself, so that the vGHv pass runs only when the penalty is
    active."""
    loss, grads = value_and_grad(loss_fn, params, batch)
    _, hvp_fn = linearize_hvp(loss_fn, params, batch)
    return loss, grads, hvp_fn, vghv(loss_fn, params, batch, v)
