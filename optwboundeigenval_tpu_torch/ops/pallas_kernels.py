"""Hand-written CUDA kernels of the curvature hot path (the module keeps
the name of its JAX counterpart, ``optwboundeigenval_tpu/ops/pallas_kernels.py``).

:func:`axpy_accumulate` — in-place ``acc += alpha * delta`` over one
tensor or a list of leaves, in one launch.

* Replaces the Pallas TPU kernel ``optwboundeigenval_tpu/ops/pallas_kernels.py
  ::axpy_accumulate`` (``pl.pallas_call`` at its line 71), the running
  sum ``acc += scale_m * term_m`` of the micro-batched HVP, gradient and
  vGHv (``ops/curvature.py``).
* Bound: bytes.  Each element reads ``acc`` and ``delta`` and writes
  ``acc`` — 12 bytes in float32 (24 in float64) for 2 flops; under
  ``init`` it never reads ``acc``, 8 bytes (16).  The least time is
  bytes over 3.35 TB/s on an H100 (DenseNet-40: 176,122 values,
  2.11 MB, 0.63 us per full-model accumulate).
* Design: ``csrc/axpy_accumulate.cu`` takes the whole tree in one launch.
  The per-leaf table ``(acc, delta, n, first_chunk, aligned)`` is packed
  here (:func:`pack_tables`) and passed by value as a kernel parameter;
  the leaves are cut into chunks of 8 KB, one block per chunk, 16-byte
  loads where both pointers of a leaf are aligned, a masked tail.  A
  list longer than the table (:data:`TABLE_CAPACITY` leaves) takes
  ``ceil(leaves / TABLE_CAPACITY)`` launches.  It works in place (the TPU
  kernel wrote a fresh output) and reads ``alpha`` from device memory,
  so the micro-batch weight never forces a host sync.
* Dtypes: float32 and float64 (the TPU kernel's), and bfloat16, which the
  TPU kernel refuses: the gemm CNNUSPS at bfloat16 compute holds its conv
  parameters in bfloat16 (as the JAX model does), so its trees mix
  bfloat16 and float32 leaves.  The wrapper groups the leaves by dtype and
  launches once per group; a bfloat16 leaf is summed in float32 against a
  float32 ``alpha`` and rounded once to bfloat16 (round to nearest even),
  ``fl_bf16(fl32(acc + fl32(alpha * delta)))``: the JAX trainer's ``a +
  scale * d`` on such a leaf, float32 by promotion, cast back to the
  leaf's dtype (the JAX trainer's micro-batched scan refuses the change of
  dtype; the port keeps the leaf's).

The wrapper takes the plain version only for tensors on the CPU; for
CUDA tensors it launches the kernel or raises.  Nothing differentiates
through the accumulate (it sums detached terms, outside every autograd
pass), so there is no ``autograd.Function``.
"""

from __future__ import annotations

import ctypes
import functools
from operator import attrgetter
from typing import List, Sequence, Tuple, Union

import numpy as np
import torch

from optwboundeigenval_tpu_torch.utils import cuda_build

_SOURCE = "axpy_accumulate"
# must equal kCap and kChunkBytes of csrc/axpy_accumulate.cu (checked at load)
TABLE_CAPACITY = 1024
CHUNK_BYTES = 8192
_ENTRIES = {torch.float32: "axpy_accumulate_tree_f32",
            torch.float64: "axpy_accumulate_tree_f64",
            torch.bfloat16: "axpy_accumulate_tree_bf16"}
# the dtype each entry sums in and reads alpha in
_SUM_DTYPE = {torch.float32: torch.float32, torch.float64: torch.float64,
              torch.bfloat16: torch.float32}

Leaves = Union[torch.Tensor, Sequence[torch.Tensor]]
_T = torch.Tensor
_device = attrgetter("device")
_dtype = attrgetter("dtype")
_requires_grad = attrgetter("requires_grad")


def axpy_accumulate_plain(acc: Leaves, delta: Leaves, alpha: torch.Tensor,
                          *, init: bool = False) -> Leaves:
    """Plain PyTorch version: ``acc <- fl(acc + fl(alpha * delta))`` per
    leaf, the rounding of the kernel and of the JAX accumulate
    ``a + scale * d``; under ``init``, ``acc <- fl(alpha * delta)``.  A
    bfloat16 leaf is summed in float32 and rounded once on the store,
    ``(acc.float() + alpha * delta.float()).to(torch.bfloat16)``."""
    single = isinstance(acc, torch.Tensor)
    for a, d in zip(*((acc,), (delta,)) if single else (acc, delta)):
        if a.dtype == torch.bfloat16:
            t = alpha.float() * d.float()
            a.copy_(t if init else a.float() + t)
        elif init:
            torch.mul(d, alpha, out=a)
        else:
            a.add_(d * alpha)
    return acc


def _leaves(acc: Leaves, delta: Leaves) -> Tuple[List[_T], List[_T]]:
    if isinstance(acc, torch.Tensor) and isinstance(delta, torch.Tensor):
        return [acc], [delta]
    if isinstance(acc, torch.Tensor) or isinstance(delta, torch.Tensor):
        raise TypeError("acc and delta must both be tensors or both sequences")
    return list(acc), list(delta)


def _check(accs: List[_T], deltas: List[_T], alpha: torch.Tensor):
    if not isinstance(alpha, torch.Tensor) or alpha.dim() != 0:
        raise TypeError("alpha must be a 0-d tensor")
    if len(accs) != len(deltas):
        raise ValueError(f"length mismatch: {len(accs)} acc leaves vs "
                         f"{len(deltas)} delta leaves")
    if list(map(_T.size, accs)) != list(map(_T.size, deltas)):
        i = next(i for i, (a, d) in enumerate(zip(accs, deltas)) if a.shape != d.shape)
        raise ValueError(f"shape mismatch at leaf {i}: acc {tuple(accs[i].shape)} "
                         f"vs delta {tuple(deltas[i].shape)}")
    if any(map(_requires_grad, accs)):
        raise ValueError("axpy_accumulate works in place and is not "
                         "differentiable; acc must not require grad")
    devices = set(map(_device, accs + deltas))
    if len(devices | {alpha.device}) > 1:
        raise ValueError(f"device mismatch: leaves on {sorted(map(str, devices))}, "
                         f"alpha on {alpha.device}")
    if list(map(_dtype, accs)) != list(map(_dtype, deltas)):
        i = next(i for i, (a, d) in enumerate(zip(accs, deltas)) if a.dtype != d.dtype)
        raise TypeError(f"dtype mismatch at leaf {i}: acc {accs[i].dtype} "
                        f"vs delta {deltas[i].dtype}")


def pack_tables(acc_ptrs: Sequence[int], delta_ptrs: Sequence[int],
                sizes: Sequence[int], itemsize: int) -> List[Tuple[np.ndarray, int]]:
    """The kernel's launch tables for one accumulate, one per launch.

    Each is ``(rows, chunks)``: ``rows`` a C-contiguous int64 array of
    ``(acc_ptr, delta_ptr, n, first_chunk, aligned)`` per leaf, at most
    :data:`TABLE_CAPACITY` rows; ``chunks`` the launch's chunk count.  A leaf of
    ``n`` values takes ``ceil(n / (CHUNK_BYTES / itemsize))`` chunks,
    numbered from 0 in each launch; ``aligned`` is 1 where both pointers
    are 16-byte aligned.  Empty leaves take no row."""
    acc_p = np.asarray(acc_ptrs, dtype=np.int64)
    delta_p = np.asarray(delta_ptrs, dtype=np.int64)
    n = np.asarray(sizes, dtype=np.int64)
    keep = n > 0
    acc_p, delta_p, n = acc_p[keep], delta_p[keep], n[keep]
    chunk = CHUNK_BYTES // itemsize
    chunks = (n + chunk - 1) // chunk
    aligned = ((acc_p | delta_p) & 15) == 0
    tables = []
    for lo in range(0, len(n), TABLE_CAPACITY):
        hi = lo + TABLE_CAPACITY
        c = chunks[lo:hi]
        total = int(c.sum())
        if total > np.iinfo(np.int32).max:
            raise ValueError(f"{total} chunks in one launch exceed the kernel's int32 index")
        first = np.cumsum(c) - c
        rows = np.stack([acc_p[lo:hi], delta_p[lo:hi], n[lo:hi], first,
                         aligned[lo:hi].astype(np.int64)], axis=1)
        tables.append((np.ascontiguousarray(rows), total))
    return tables


@functools.cache
def _kernels():
    lib = cuda_build.load(_SOURCE)
    for name, want in (("axpy_tree_capacity", TABLE_CAPACITY),
                       ("axpy_tree_chunk_bytes", CHUNK_BYTES)):
        got = getattr(lib, name)()
        if got != want:
            raise RuntimeError(f"{_SOURCE}.cu {name} is {got}, the wrapper packs for {want}")
    fns = {}
    for dtype, name in _ENTRIES.items():
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
                       ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[dtype] = fn
    return fns


def dtype_groups(accs: List[_T], deltas: List[_T]) -> List[Tuple[List[_T], List[_T]]]:
    """The leaves grouped by dtype, in order of first appearance: one
    ``(accs, deltas)`` pair a dtype, each launched on its own."""
    if len(set(map(_dtype, accs))) == 1:
        return [(accs, deltas)]
    groups = {}
    for a, d in zip(accs, deltas):
        ga, gd = groups.setdefault(a.dtype, ([], []))
        ga.append(a)
        gd.append(d)
    return list(groups.values())


def _launch(accs: List[_T], deltas: List[_T], alpha: torch.Tensor, init: bool):
    groups = dtype_groups(accs, deltas)
    bad = [g[0][0].dtype for g in groups if g[0][0].dtype not in _ENTRIES]
    if bad:
        raise TypeError("axpy_accumulate takes float32, float64 or bfloat16 on the card, "
                        f"got {bad}")
    if not all(map(_T.is_contiguous, accs + deltas)):
        raise ValueError("acc and delta leaves must be contiguous")
    stream = torch.cuda.current_stream(accs[0].device).cuda_stream
    for ga, gd in groups:
        dtype = ga[0].dtype
        a = alpha if alpha.dtype == _SUM_DTYPE[dtype] else alpha.to(_SUM_DTYPE[dtype])
        fn = _kernels()[dtype]
        tables = pack_tables(list(map(_T.data_ptr, ga)), list(map(_T.data_ptr, gd)),
                             list(map(_T.numel, ga)), ga[0].element_size())
        for rows, chunks in tables:
            err = fn(rows.ctypes.data, len(rows), chunks, a.data_ptr(), int(init), stream)
            if err != 0:
                raise RuntimeError(f"axpy_accumulate launch failed: CUDA error {err}")
            axpy_accumulate.launches += 1


def axpy_accumulate(acc: Leaves, delta: Leaves, alpha: torch.Tensor,
                    *, init: bool = False) -> Leaves:
    """``acc += alpha * delta`` in place, over one tensor or over equal-length
    sequences of same-shaped leaves; returns ``acc``.  Under ``init`` it
    writes ``acc = alpha * delta`` and never reads ``acc``.

    ``alpha`` is a 0-d tensor on the same device; each leaf of ``acc``
    has its ``delta``'s dtype.  On the CPU this is the plain version (any
    float dtype); on a CUDA device it launches the kernel (float32,
    float64 or bfloat16, contiguous leaves), once per dtype of the tree
    and ``TABLE_CAPACITY`` non-empty leaves of it, or raises."""
    accs, deltas = _leaves(acc, delta)
    _check(accs, deltas, alpha)
    if not accs:
        return acc
    device = accs[0].device
    if device.type == "cpu":
        return axpy_accumulate_plain(acc, delta, alpha, init=init)
    if device.type != "cuda":
        raise ValueError(f"axpy_accumulate runs on cpu or cuda, not {device}")
    _launch(accs, deltas, alpha, init)
    return acc


# launches of the CUDA kernel since the count was last set to 0
axpy_accumulate.launches = 0
