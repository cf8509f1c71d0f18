"""Data-parallel training over ``torch.distributed`` (counterpart of the
``data`` axis of ``optwboundeigenval_tpu/parallel/mesh.py``).

The JAX package shards each batch over a ``data`` mesh axis and lets XLA
insert the ``psum`` of every batch reduction.  Here each rank of a process
group is one data shard on one device and the reductions are explicit:

* every rank holds its own rows of the global batch (a ``host_shard``
  loader's batches, or :func:`shard_batch` of a global batch) and the
  replicated ``params``, ``model_state``, ``opt_state`` and ``v``
  (:func:`replicate`, a broadcast from rank 0);
* a loss under :func:`active` is the rank's share of the global
  weighted mean, ``sum(w * l)`` over its rows divided by the all-reduced
  ``sum(w)``; the gradient, every HVP and the vGHv are sums of those
  shares (``ops/curvature.py`` all-reduces them), and so are the K-FAC
  covariances;
* BatchNorm's statistics cover the global batch through
  :func:`all_sum_diff`, an all-reduce that autograd differentiates to
  any order (the vGHv pass differentiates BatchNorm three times);
* a host-side decision, such as an eigensolver's stop test, is taken
  once for all ranks by :func:`agree` (a MIN of the flags), so no rank
  leaves a loop that another rank continues.

``make_mesh(model > 1)`` raises: the ``model`` axis (tensor parallelism)
is ROADMAP.md item 12.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist

_ACTIVE = contextvars.ContextVar("data_parallel_mesh", default=None)


def init_distributed(coordinator: Optional[str] = None, *,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     backend: Optional[str] = None, device=None) -> None:
    """Join the process group of ``num_processes`` ranks at ``coordinator``
    (``host:port``) as rank ``process_id``; a no-op without a coordinator
    (one process).  ``backend`` defaults to NCCL for a rank on the card
    (``device`` None or CUDA) and gloo for ``device="cpu"``."""
    if coordinator is None:
        return
    if backend is None:
        backend = "gloo" if device is not None and torch.device(device).type == "cpu" else "nccl"
    dist.init_process_group(backend=backend, init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id)


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """One rank's view of a ``(data, model)`` mesh over the default process
    group (no group: a world of one): this rank's device, the axis sizes
    and its place on the ``data`` axis."""

    device: torch.device
    data: int
    model: int
    rank: int

    @property
    def distributed(self) -> bool:
        """Whether collectives go through a process group (a one-rank
        group included)."""
        return dist.is_available() and dist.is_initialized()

    @property
    def writer(self) -> bool:
        """Rank 0 writes the logs and checkpoints."""
        return self.rank == 0


def _rank_device(device, rank: int) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: make_mesh places each rank on the GPU "
                               "unless device='cpu' is passed")
        return torch.device("cuda", rank % torch.cuda.device_count())
    return torch.device(device)


def make_mesh(data: Optional[int] = None, model: int = 1, device=None) -> Mesh:
    """This rank's mesh over the initialised process group (a world of one
    without one): ``data`` ranks, ``data`` defaulting to the world size,
    each on ``device`` (default: the card of index ``rank % count``)."""
    if model > 1:
        raise NotImplementedError(
            f"make_mesh(model={model}): the model axis (tensor parallelism) is not "
            "ported; ROADMAP.md item 12")
    initialised = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if initialised else 1
    rank = dist.get_rank() if initialised else 0
    data = world if data is None else int(data)
    if data != world:
        raise ValueError(f"make_mesh(data={data}) over a world of {world} ranks: "
                         "each rank is one data shard")
    device = _rank_device(device, rank)
    if device.type == "cuda":
        torch.cuda.set_device(device)  # where NCCL puts this rank's buffers
    return Mesh(device=device, data=data, model=int(model), rank=rank)


@contextlib.contextmanager
def active(mesh: Optional[Mesh]):
    """Losses, BatchNorm, dropout, the curvature products and the
    eigensolvers inside reduce over ``mesh`` (nothing with None)."""
    token = _ACTIVE.set(mesh)
    try:
        yield
    finally:
        _ACTIVE.reset(token)


def current() -> Optional[Mesh]:
    """The active mesh, if it spans a process group."""
    mesh = _ACTIVE.get()
    return mesh if mesh is not None and mesh.distributed else None


def all_sum(t: torch.Tensor) -> torch.Tensor:
    """Sum of ``t`` over the active mesh's ranks (``t`` itself without
    one); not differentiable."""
    mesh = current()
    if mesh is None:
        return t
    out = t.detach().clone()
    dist.all_reduce(out)
    return out


def all_sum_tree(tree: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Every leaf summed over the active mesh, in one all-reduce of the
    leaves laid end to end."""
    mesh = current()
    if mesh is None or not tree:
        return tree
    leaves = list(tree.values())
    flat = torch.cat([t.detach().reshape(-1).to(leaves[0].dtype) for t in leaves])
    dist.all_reduce(flat)
    out, off = {}, 0
    for k, t in tree.items():
        out[k] = flat[off:off + t.numel()].view(t.shape).to(t.dtype)
        off += t.numel()
    return out


def all_sum_diff(t: torch.Tensor) -> torch.Tensor:
    """Sum of ``t`` over the active mesh that autograd differentiates (its
    backward is the same all-reduce of the incoming gradient, itself
    differentiable)."""
    mesh = current()
    if mesh is None:
        return t
    from torch.distributed.nn.functional import all_reduce

    return all_reduce(t)


def agree(flag: bool) -> bool:
    """``flag`` taken as one decision for every rank: true only where it
    holds on all of them."""
    mesh = current()
    if mesh is None:
        return bool(flag)
    t = torch.tensor([1 if flag else 0], dtype=torch.int32, device=mesh.device)
    dist.all_reduce(t, op=dist.ReduceOp.MIN)
    return bool(t.item())


def global_rows(n_local: int):
    """``(first row, global rows)`` of this rank's ``n_local`` rows in the
    global batch (every rank holds as many)."""
    mesh = current()
    if mesh is None:
        return 0, n_local
    return mesh.rank * n_local, mesh.data * n_local


def all_gather_rows(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The ranks' ``t`` (equal shapes) stacked along dim 0 in rank order."""
    if not mesh.distributed:
        return t
    parts = [torch.empty_like(t) for _ in range(mesh.data)]
    dist.all_gather(parts, t.contiguous())
    return torch.cat(parts)


def broadcast_object(obj, mesh: Optional[Mesh]):
    """Rank 0's ``obj`` on every rank (``obj`` itself without a group)."""
    if mesh is None or not mesh.distributed:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0,
                               device=mesh.device if mesh.device.type == "cuda" else None)
    return box[0]


def replicate(tree, mesh: Optional[Mesh]):
    """Rank 0's tensors of ``tree`` (nested dicts) broadcast in place to
    every rank; returns ``tree``."""
    if mesh is None or not mesh.distributed or tree is None:
        return tree
    if isinstance(tree, dict):
        for v in tree.values():
            replicate(v, mesh)
    elif isinstance(tree, torch.Tensor):
        dist.broadcast(tree, src=0)
    return tree


def shard_batch(batch: Dict[str, Any], mesh: Mesh) -> Dict[str, Any]:
    """This rank's contiguous block of a global batch, rows ``[r B / n,
    (r + 1) B / n)`` of every entry, as the JAX package's ``data`` sharding
    lays a batch over its devices."""
    out = {}
    for k, x in batch.items():
        n = len(x)
        if n % mesh.data:
            raise ValueError(f"a batch of {n} rows does not split over {mesh.data} ranks")
        per = n // mesh.data
        out[k] = x[mesh.rank * per:(mesh.rank + 1) * per]
    return out

