"""Data and tensor parallelism over ``torch.distributed`` (counterpart of
``optwboundeigenval_tpu/parallel/mesh.py``).

The JAX package lays its devices out as a ``(data, model)`` mesh, shards
each batch over ``data`` and lets XLA insert the ``psum`` of every
reduction.  Here each rank of a process group is one device of the mesh
and the reductions are explicit.  Rank ``r`` sits at data coordinate
``r // model`` and model coordinate ``r % model`` (JAX's
``np.asarray(devices).reshape(data, model)``); its ``data`` group holds
the ranks of its model coordinate and its ``model`` group those of its
data coordinate.

* Every rank holds the rows of its data coordinate (a ``host_shard``
  loader's batches fed by the data coordinate, or :func:`shard_batch` of
  a global batch), so the ranks of one ``model`` group hold the same
  rows; ``params``, ``model_state``, ``opt_state`` and ``v`` start
  replicated (:func:`replicate`, a broadcast from rank 0), and
  ``parallel/sharding.py`` may then keep only this rank's slice of the
  large leaves, split over the ``model`` group.
* The reduction convention.  Each rank's loss is its data shard's share
  of the global weighted mean (its rows' weighted sum over the
  ``data``-summed total weight), divided by ``model``: the sum over all
  ``data * model`` ranks is the global loss.  Sums of data -- the total
  weight, W-BCE's class counts, BatchNorm's statistics
  (:func:`all_sum_diff`), the K-FAC covariances, loss values for the
  logs -- run over the ``data`` group (:func:`all_sum`), so each row
  counts once.  A gradient, HVP or vGHv (:func:`all_sum_tree`) sums a
  replicated leaf over the world and a sharded leaf over its ``data``
  group: the ``model``-group sum of a sharded leaf already happens in
  the autograd graph.  There a sharded layer computes its own output
  columns and assembles the whole output by an :func:`all_sum_diff` over
  the ``model`` group (``sharding.assemble_columns``), whose backward
  all-reduces the output gradient, so the weight slice's gradient is
  complete on its rank.  The input's gradient leaves the layer as this
  rank's share, from its columns; the world sum of a replicated leaf
  completes those shares with the ``1 / model`` loss shares of the rest
  of the graph.  With ``model = 1`` the ``data`` group is the world and
  all of this is plain data parallelism.
* :func:`all_sum_diff` is an all-reduce that autograd differentiates to
  any order (the vGHv pass differentiates BatchNorm three times).
* A host-side decision, such as an eigensolver's stop test, is taken
  once for all ranks of the world by :func:`agree` (a MIN of the flags),
  so no rank leaves a loop that another rank continues.
* No fallback: a group that cannot be formed or a collective that fails
  raises.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist

_ACTIVE = contextvars.ContextVar("mesh", default=(None, None))


def init_distributed(coordinator: Optional[str] = None, *,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     backend: Optional[str] = None, device=None, **kw) -> None:
    """Join the process group of ``num_processes`` ranks at ``coordinator``
    (``host:port``) as rank ``process_id``; a no-op without a coordinator
    (one process).  ``backend`` defaults to NCCL for a rank on the card
    (``device`` None or CUDA) and gloo for ``device="cpu"``.  The other
    keywords go to ``dist.init_process_group``, as the JAX package's go to
    ``jax.distributed.initialize``: ``timeout=datetime.timedelta(...)``
    bounds how long a collective waits for a rank that never makes it
    (gloo's default is 30 minutes)."""
    if coordinator is None:
        return
    if backend is None:
        backend = "gloo" if device is not None and torch.device(device).type == "cpu" else "nccl"
    dist.init_process_group(backend=backend, init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id, **kw)


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """One rank's view of a ``(data, model)`` mesh over the default process
    group (no group: a world of one): this rank's device, the axis sizes,
    its rank, and the process groups of its ``data`` and ``model`` axes
    (None where the axis is the whole world or this rank alone)."""

    device: torch.device
    data: int
    model: int
    rank: int
    data_group: Any = None
    model_group: Any = None

    @property
    def distributed(self) -> bool:
        """Whether collectives go through a process group (a one-rank
        group included)."""
        return dist.is_available() and dist.is_initialized()

    @property
    def writer(self) -> bool:
        """Rank 0 writes the logs and checkpoints."""
        return self.rank == 0

    @property
    def world(self) -> int:
        return self.data * self.model

    @property
    def data_coord(self) -> int:
        return self.rank // self.model

    @property
    def model_coord(self) -> int:
        return self.rank % self.model


def _rank_device(device, rank: int) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: make_mesh places each rank on the GPU "
                               "unless device='cpu' is passed")
        return torch.device("cuda", rank % torch.cuda.device_count())
    return torch.device(device)


def _axis_groups(data: int, model: int, rank: int):
    """``(data group, model group)`` of ``rank``; every rank creates every
    group of an axis that is neither the world nor one rank, in the same
    order, as ``dist.new_group`` requires."""
    data_group = model_group = None
    if model > 1 and data > 1:
        for m in range(model):
            g = dist.new_group([d * model + m for d in range(data)])
            if rank % model == m:
                data_group = g
        for d in range(data):
            g = dist.new_group([d * model + m for m in range(model)])
            if rank // model == d:
                model_group = g
    return data_group, model_group


def make_mesh(data: Optional[int] = None, model: int = 1, device=None) -> Mesh:
    """This rank's mesh over the initialised process group (a world of one
    without one): ``data * model`` ranks, ``data`` defaulting to the world
    size over ``model``, each on ``device`` (default: the card of index
    ``rank % count``)."""
    initialised = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if initialised else 1
    rank = dist.get_rank() if initialised else 0
    model = int(model)
    data = world // model if data is None else int(data)
    if model < 1 or data * model != world:
        raise ValueError(f"make_mesh(data={data}, model={model}) over a world of {world} "
                         "ranks: the mesh must hold every rank once")
    device = _rank_device(device, rank)
    if device.type == "cuda":
        torch.cuda.set_device(device)  # where NCCL puts this rank's buffers
    data_group, model_group = _axis_groups(data, model, rank) if initialised else (None, None)
    return Mesh(device=device, data=data, model=model, rank=rank,
                data_group=data_group, model_group=model_group)


@contextlib.contextmanager
def active(mesh: Optional[Mesh], sharding=None):
    """Losses, BatchNorm, dropout, the curvature products and the
    eigensolvers inside reduce over ``mesh`` (nothing with None); under a
    ``sharding`` (``parallel/sharding.py``) the sharded layers compute
    their own output columns and the tree helpers reduce the sharded
    leaves over the ``model`` group."""
    token = _ACTIVE.set((mesh, sharding))
    try:
        yield
    finally:
        _ACTIVE.reset(token)


def current() -> Optional[Mesh]:
    """The active mesh, if it spans a process group."""
    mesh = _ACTIVE.get()[0]
    return mesh if mesh is not None and mesh.distributed else None


def current_sharding():
    """The active sharding, if its mesh spans a process group."""
    return _ACTIVE.get()[1] if current() is not None else None


def _axis(mesh: Mesh, axis: str):
    """``(size, group)`` of ``axis`` ("world", "data" or "model") for
    ``mesh``'s rank; group None is the default group."""
    if axis == "world":
        return mesh.world, None
    if axis == "data":
        return mesh.data, mesh.data_group
    if axis == "model":
        return mesh.model, mesh.model_group
    raise ValueError(f"unknown mesh axis {axis!r}")


def all_sum(t: torch.Tensor, axis: str = "data") -> torch.Tensor:
    """Sum of ``t`` over the active mesh's ``axis`` (``t`` itself without
    a mesh or on an axis of one rank); not differentiable."""
    mesh = current()
    if mesh is None or _axis(mesh, axis)[0] == 1:
        return t
    out = t.detach().clone()
    dist.all_reduce(out, group=_axis(mesh, axis)[1])
    return out


def _all_sum_flat(tree: Dict[str, torch.Tensor], axis: str) -> Dict[str, torch.Tensor]:
    """Every leaf of ``tree`` summed over ``axis``, in one all-reduce of
    the leaves laid end to end."""
    mesh = current()
    size, group = _axis(mesh, axis)
    if size == 1 or not tree:
        return tree
    leaves = list(tree.values())
    flat = torch.cat([t.detach().reshape(-1).to(leaves[0].dtype) for t in leaves])
    dist.all_reduce(flat, group=group)
    out, off = {}, 0
    for k, t in tree.items():
        out[k] = flat[off:off + t.numel()].view(t.shape).to(t.dtype)
        off += t.numel()
    return out


def all_sum_tree(tree: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A gradient-like tree (gradient, HVP, vGHv, loss under a key that is
    no leaf's) summed over the active mesh: a replicated leaf over the
    world, a sharded leaf (this rank's slice, under the active sharding)
    over its ``data`` group."""
    mesh = current()
    if mesh is None or not tree:
        return tree
    sharding = current_sharding()
    if sharding is None:
        return _all_sum_flat(tree, "world")
    split = {k: t for k, t in tree.items() if sharding.is_local(k, t)}
    rest = _all_sum_flat({k: t for k, t in tree.items() if k not in split}, "world")
    split = _all_sum_flat(split, "data")
    return {k: split[k] if k in split else rest[k] for k in tree}


def all_sum_diff(t: torch.Tensor, axis: str = "data") -> torch.Tensor:
    """Sum of ``t`` over the active mesh's ``axis`` that autograd
    differentiates (its backward is the same all-reduce of the incoming
    gradient, itself differentiable)."""
    mesh = current()
    if mesh is None or _axis(mesh, axis)[0] == 1:
        return t
    from torch.distributed.nn.functional import all_reduce

    return all_reduce(t, group=_axis(mesh, axis)[1])


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
    global batch (every data coordinate holds as many)."""
    mesh = current()
    if mesh is None:
        return 0, n_local
    return mesh.data_coord * n_local, mesh.data * n_local


def all_gather_rows(t: torch.Tensor, mesh: Mesh, axis: str = "world") -> torch.Tensor:
    """The ranks' ``t`` (equal shapes) of ``axis`` stacked along dim 0 in
    rank order: one all-reduce of ``t`` placed in a zero block at this
    rank's offset (gloo reduces CUDA tensors, and does not gather them)."""
    size, group = _axis(mesh, axis)
    if not mesh.distributed or size == 1:
        return t
    index = {"world": mesh.rank, "data": mesh.data_coord, "model": mesh.model_coord}[axis]
    out = torch.zeros((size * t.shape[0],) + tuple(t.shape[1:]), dtype=t.dtype, device=t.device)
    out[index * t.shape[0]:(index + 1) * t.shape[0]] = t
    dist.all_reduce(out, group=group)
    return out


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
    """This rank's contiguous block of a global batch, rows ``[c B / n,
    (c + 1) B / n)`` of every entry with ``c`` the data coordinate and
    ``n`` the ``data`` size, as the JAX package's ``data`` sharding lays a
    batch over its devices (the ``model`` replicas hold the same rows)."""
    out = {}
    for k, x in batch.items():
        n = len(x)
        if n % mesh.data:
            raise ValueError(f"a batch of {n} rows does not split over {mesh.data} ranks")
        per = n // mesh.data
        out[k] = x[mesh.data_coord * per:(mesh.data_coord + 1) * per]
    return out
