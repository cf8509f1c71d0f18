"""Spectral band penalty ``g`` and its gradient (counterpart of
``optwboundeigenval_tpu/ops/spectral.py``).

* ``g = max(0, rho - K, Kmin - rho)`` (comp_g, opt.py:574-578);
* ``grad g = sign * grad rho``, ``sign = +1`` if ``rho > K`` else ``-1``,
  computed only when ``g > 0`` (opt.py:631-636);
* ``grad rho = v^T (grad H) v``, optionally norm-clipped (opt.py:535-542);
* ``p = grad f + mu * grad g`` (opt.py:639).

The JAX ``lax.cond`` gate becomes a Python ``if`` on ``g > 0`` (one
host sync, ``spectral.gate`` in ``utils/timing.py``), so the third-order
pass (the span ``vghv.pass``) is skipped when the penalty is off.

The pass after the gate (``vghv`` then ``clip_by_norm``) reads nothing on
the host, and its shapes are fixed by the batch's, so on a CUDA device it
can run as one CUDA graph (:class:`VghvGraphs`, which the trainer owns):
thousands of kernel launches a step become one.  The route depends only
on what is observable here (:func:`graphable`): a CUDA device, no mesh,
one micro-batch and no dropout key; every other pass runs op by op
(:func:`eager_pass`).  A graph is captured the second time its signature
(the model, every leaf's, buffer's and batch entry's name, shape, dtype
and device, and ``gradg_clip``) is seen, so the first pass warms cuDNN
and cuBLAS and an epoch's odd last batch stays eager.  Each pass counts
its route in the program's recording: ``vghv.eager``, ``vghv.capture``
or ``vghv.replay`` (``utils/timing.counted``).
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional

import torch

from optwboundeigenval_tpu_torch.ops.curvature import (
    LossFn,
    _flat_like,
    vghv,
    vghv_microbatched,
)
from optwboundeigenval_tpu_torch.parallel import mesh as meshlib
from optwboundeigenval_tpu_torch.utils import timing
from optwboundeigenval_tpu_torch.utils.tree import (
    Tree,
    tree_axpy,
    tree_norm,
    tree_scale,
    tree_zeros_like,
)


def penalty(rho: torch.Tensor, K: float, Kmin: float = 0.0) -> torch.Tensor:
    """``max(0, rho - K, Kmin - rho)``.  A discarded ``rho = -1`` gives
    ``g = 1`` when ``Kmin = 0``, as in the reference (opt.py:517)."""
    return torch.maximum(torch.clamp_min(rho - K, 0.0), Kmin - rho)


def penalty_sign(rho: torch.Tensor, K: float) -> torch.Tensor:
    """``+1`` if ``rho > K`` else ``-1`` (opt.py:633)."""
    return torch.where(rho > K, 1.0, -1.0).to(rho.dtype)


def clip_by_norm(g: Tree, max_norm: Optional[float]) -> Tree:
    """Scale ``g`` down to ``max_norm`` if it is longer (opt.py:539-542)."""
    if max_norm is None:
        return g
    norm = tree_norm(g)
    scale = torch.where(norm > max_norm, max_norm / norm, torch.ones_like(norm))
    return tree_scale(scale, g)


class SpectralGrad(NamedTuple):
    g: torch.Tensor  # penalty value
    grad_g: Tree  # zero when inactive
    grad_rho: Tree  # zero when inactive


def _pass(loss_fn: LossFn, params: Tree, batch, v: Tree,
          gradg_clip: Optional[float], num_micro: int = 1) -> Tree:
    """``v^T (grad H) v``, micro-batched when ``num_micro > 1``, clipped."""
    if num_micro > 1:
        gr = vghv_microbatched(loss_fn, params, batch, v, num_micro)
    else:
        gr = vghv(loss_fn, params, batch, v)
    return clip_by_norm(gr, gradg_clip)


def eager_pass(loss_fn: LossFn, params: Tree, batch, v: Tree,
               gradg_clip: Optional[float], num_micro: int = 1) -> Tree:
    """The vGHv pass op by op (the route ``vghv.eager``)."""
    with timing.counted("vghv.eager"):
        return _pass(loss_fn, params, batch, v, gradg_clip, num_micro)


def graphable(device: torch.device, num_micro: int, key) -> bool:
    """Whether the vGHv pass may run as a CUDA graph: on a CUDA device,
    under no mesh (its collectives and ``mesh.agree`` read the host), on
    the whole batch (the micro-batched pass goes through K1) and with no
    dropout ``key`` (masks drawn a step)."""
    return (device.type == "cuda" and meshlib.current() is None and num_micro <= 1
            and key is None)


def _inputs(params: Tree, model_state: Tree, batch, v: Tree) -> List[torch.Tensor]:
    return [*params.values(), *model_state.values(), *batch.values(), *v.values()]


def _copy(dst: List[torch.Tensor], src: List[torch.Tensor]) -> None:
    """``dst[i] <- src[i]``: one multi-tensor copy a dtype."""
    groups: Dict[torch.dtype, tuple] = {}
    for d, s in zip(dst, src):
        group = groups.setdefault(d.dtype, ([], []))
        group[0].append(d)
        group[1].append(s)
    for d, s in groups.values():
        torch._foreach_copy_(d, s)


class _Graph(NamedTuple):
    graph: "torch.cuda.CUDAGraph"
    inputs: List[torch.Tensor]  # static, in the order of _inputs
    outputs: Tree  # static, overwritten by every replay

    def result(self) -> Tree:
        """A copy of the outputs that the next replay leaves alone."""
        out = _flat_like(self.outputs)
        _copy(list(out.values()), list(self.outputs.values()))
        return out


class VghvGraphs:
    """The vGHv pass as CUDA graphs of ``task`` (``train/task.Task``: its
    ``model`` and ``loss_fn(model_state)``), one a signature, all in one
    private memory pool, held as long as this object.

    A captured graph reads static copies of the parameters, the BatchNorm
    buffers the loss closes over (the loss is rebuilt over the copies, so
    no replay reads a step's freed state), the batch's entries and ``v``;
    a replay refreshes them with one multi-tensor copy a dtype, launches
    the graph and copies its outputs out the same way, so nothing returned
    aliases what the next replay writes.  The replay runs the kernels the
    eager pass runs, at its precision.  A capture that fails (out of
    device memory, or an operation a capture refuses) frees what it took,
    and its signature stays eager."""

    def __init__(self, task):
        self.task = task
        self._seen = set()
        self._graphs: Dict[tuple, Optional[_Graph]] = {}  # None: stays eager
        self._pool = None
        self._stream = None

    def _signature(self, params, model_state, batch, v, gradg_clip) -> tuple:
        return (id(self.task.model), gradg_clip) + tuple(
            tuple((k, tuple(t.shape), t.dtype, t.device) for k, t in tree.items())
            for tree in (params, model_state, batch, v))

    def __call__(self, loss_fn: LossFn, params: Tree, batch, v: Tree, model_state: Tree,
                 gradg_clip: Optional[float]) -> Tree:
        """The pass: eager the first time its signature is seen, captured
        and run the second, replayed after."""
        sig = self._signature(params, model_state, batch, v, gradg_clip)
        if sig not in self._seen:
            self._seen.add(sig)
            return eager_pass(loss_fn, params, batch, v, gradg_clip)
        if sig not in self._graphs:
            self._graphs[sig] = graph = self.capture(params, batch, v, model_state, gradg_clip)
            if graph is not None:
                return graph.result()
        graph = self._graphs[sig]
        if graph is None:
            return eager_pass(loss_fn, params, batch, v, gradg_clip)
        return self.replay(graph, params, batch, v, model_state)

    def capture(self, params, batch, v, model_state, gradg_clip) -> Optional[_Graph]:
        """A graph of the pass over static copies of these inputs, run once
        (the route ``vghv.capture``, counted also where it fails); None
        where the capture failed: out of device memory, or an operation
        that a capture refuses."""
        device = next(iter(v.values())).device
        with timing.counted("vghv.capture"), torch.cuda.device(device):
            static = [{k: t.clone() for k, t in tree.items()}
                      for tree in (params, model_state, batch, v)]
            inputs = _inputs(*static)
            loss_fn = self.task.loss_fn(static[1])
            if self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
                self._stream = torch.cuda.Stream()
            graph, outputs, failed = torch.cuda.CUDAGraph(), None, False
            self._stream.wait_stream(torch.cuda.current_stream())
            try:
                with torch.cuda.stream(self._stream):
                    # as torch.cuda.graph's recipe: a pass on the capture stream,
                    # so that no library state is first made under capture, then
                    # the cache emptied, so the capture can take what that held
                    _pass(loss_fn, static[0], static[2], static[3], gradg_clip)
                    torch.cuda.empty_cache()
                    # thread_local: a loader's thread may touch the device meanwhile
                    graph.capture_begin(pool=self._pool, capture_error_mode="thread_local")
                    try:
                        outputs = _pass(loss_fn, static[0], static[2], static[3], gradg_clip)
                    finally:
                        graph.capture_end()
            except RuntimeError:  # out of memory, or an operation the capture refused
                failed = True
            torch.cuda.current_stream().wait_stream(self._stream)
            if failed:
                del graph, inputs, static, outputs, loss_fn
                torch.cuda.empty_cache()
                return None
            graph.replay()
            return _Graph(graph, inputs, outputs)

    def replay(self, graph: _Graph, params, batch, v, model_state) -> Tree:
        """The pass by ``graph`` on these inputs (the route ``vghv.replay``)."""
        with timing.counted("vghv.replay"):
            _copy(graph.inputs, _inputs(params, model_state, batch, v))
            graph.graph.replay()
            return graph.result()


def penalty_and_grad(
    loss_fn: LossFn,
    params: Tree,
    batch,
    v: Tree,
    rho: torch.Tensor,
    *,
    K: float,
    Kmin: float = 0.0,
    gradg_clip: Optional[float] = None,
    num_micro: int = 1,
    graphs: Optional[VghvGraphs] = None,
    model_state: Optional[Tree] = None,
    key=None,
) -> SpectralGrad:
    """``g`` and ``grad g`` with the reference's gating; ``num_micro > 1``
    micro-batches the third-order pass.  Given ``graphs`` and the
    ``model_state`` that ``loss_fn`` closes over (under dropout ``key``),
    a pass that :func:`graphable` admits runs through ``graphs``."""
    g = penalty(rho, K, Kmin)
    if not meshlib.agree(timing.read("spectral.gate", g > 0)):
        z = tree_zeros_like(params)
        return SpectralGrad(g=g, grad_g=z, grad_rho=z)
    with timing.span("vghv.pass"):
        device = next(iter(v.values())).device
        if graphs is not None and model_state is not None and graphable(device, num_micro, key):
            gr = graphs(loss_fn, params, batch, v, model_state, gradg_clip)
        else:
            gr = eager_pass(loss_fn, params, batch, v, gradg_clip, num_micro)
    return SpectralGrad(g=g, grad_g=tree_scale(penalty_sign(rho, K), gr),
                        grad_rho=gr)


def regularized_direction(grad_f: Tree, grad_g: Tree, mu) -> Tree:
    """``p = grad f + mu * grad g`` (opt.py:639)."""
    return tree_axpy(mu, grad_g, grad_f)
