"""Matrix-free curvature: gradients, Hessian-vector products and the
third-order directional derivative ``v^T (grad H) v`` (counterpart of
``optwboundeigenval_tpu/ops/curvature.py``).

A loss function maps ``(params, batch) -> scalar`` with ``params`` a
dict of tensors.  Every product is a ``torch.func`` composition:

* ``hvp``  = forward-over-reverse, ``jvp(grad(loss))``;
* ``vghv`` = ``grad_p <jvp(grad(loss))(p; v), v>``, one reverse pass
  over the HVP.

The ``*_microbatched`` variants split the batch into contiguous slices
``[i*mb, (i+1)*mb)`` (BatchNorm statistics are per slice, as in the JAX
package) and sum ``scale_m * term_m`` with ``scale_m = sum(w_m) /
max(sum(w), 1e-12)``, exact for weighted-mean losses.  ``scale_m`` stays
a device tensor and the running sum goes through the CUDA kernel
``ops/pallas_kernels.axpy_accumulate``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch
from torch.func import grad as _grad
from torch.func import jvp

from optwboundeigenval_tpu_torch.ops.pallas_kernels import axpy_accumulate
from optwboundeigenval_tpu_torch.utils.tree import tree_vdot

Tree = Dict[str, torch.Tensor]
LossFn = Callable[[Tree, Any], torch.Tensor]


def grad(loss_fn: LossFn, params: Tree, batch) -> Tree:
    """Gradient of the loss at ``params`` (reference ``prepare_grad``,
    opt.py:175-192)."""
    return _grad(loss_fn)(params, batch)


def hvp(loss_fn: LossFn, params: Tree, batch, v: Tree) -> Tree:
    """``H(params) @ v`` by forward-over-reverse (reference
    ``HVPOperator.Hv``, opt.py:77-108)."""
    return jvp(lambda p: _grad(loss_fn)(p, batch), (params,), (v,))[1]


def linearize_hvp(loss_fn: LossFn, params: Tree, batch
                  ) -> Tuple[Tree, Callable[[Tree], Tree]]:
    """``(grad, hvp_fn)`` for one batch.

    Unlike the JAX version this is NOT a cached linearization: ``hvp_fn``
    re-runs the whole forward-over-reverse pass on every call."""
    return grad(loss_fn, params, batch), lambda v: hvp(loss_fn, params, batch, v)


def vghv(loss_fn: LossFn, params: Tree, batch, v: Tree) -> Tree:
    """``v^T (grad H) v``: the gradient of ``<H(p) v, v>`` with respect
    to ``p`` (reference ``HVPOperator.vGHv``, opt.py:110-152)."""

    def rayleigh_num(p):
        return tree_vdot(hvp(loss_fn, p, batch, v), v)

    return _grad(rayleigh_num)(params)


def _batch_weight(batch) -> torch.Tensor:
    """Total example weight: ``sum(w)``, else the leading dimension."""
    if "w" in batch:
        return batch["w"].sum()
    return torch.tensor(float(len(batch["x"])), device=batch["x"].device)


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


def _accumulate(terms) -> Tree:
    """``sum_m scale_m * term_m`` through the in-place kernel (which takes
    contiguous leaves only)."""
    acc = None
    for term, scale in terms:
        if acc is None:
            acc = {k: torch.zeros(t.shape, dtype=t.dtype, device=t.device)
                   for k, t in term.items()}
        for k, a in acc.items():
            axpy_accumulate(a, term[k].contiguous(), scale)
    return acc


def hvp_microbatched(loss_fn: LossFn, params: Tree, batch, v: Tree,
                     num_micro: int) -> Tree:
    """HVP summed over ``num_micro`` micro-batches: activations held at
    O(B / num_micro), exact for weighted-mean losses."""
    return _accumulate((hvp(loss_fn, params, mb, v), s)
                       for mb, s in _micro_batches(batch, num_micro))


def grad_microbatched(loss_fn: LossFn, params: Tree, batch,
                      num_micro: int) -> Tree:
    """Gradient summed over micro-batches (same exactness as
    :func:`hvp_microbatched`)."""
    return _accumulate((grad(loss_fn, params, mb), s)
                       for mb, s in _micro_batches(batch, num_micro))


def vghv_microbatched(loss_fn: LossFn, params: Tree, batch, v: Tree,
                      num_micro: int) -> Tree:
    """``v^T (grad H) v`` summed over micro-batches: the third-order pass
    holds the largest residual set, so the ``hvp_micro`` memory bound
    must hold here too."""
    return _accumulate((vghv(loss_fn, params, mb, v), s)
                       for mb, s in _micro_batches(batch, num_micro))
