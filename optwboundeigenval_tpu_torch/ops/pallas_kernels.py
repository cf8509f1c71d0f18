"""Hand-written CUDA kernels of the curvature hot path (the module keeps
the name of its JAX counterpart, ``optwboundeigenval_tpu/ops/pallas_kernels.py``).

:func:`axpy_accumulate` — in-place ``acc += alpha * delta``.

* Replaces the Pallas TPU kernel ``optwboundeigenval_tpu/ops/pallas_kernels.py
  ::axpy_accumulate`` (``pl.pallas_call`` at its line 71), the running
  sum ``acc += scale_m * hv_m`` of the micro-batched HVP, gradient and
  vGHv (``ops/curvature.py``).
* Bound: bytes.  Each element reads ``acc`` and ``delta`` and writes
  ``acc`` — 12 bytes for 2 flops — so the least time is
  ``12 * n / 3.35 TB/s`` on an H100 (DenseNet-40: 176,122 values,
  2.11 MB, 0.63 us per full-model accumulate).
* Design: ``csrc/axpy_accumulate.cu`` streams with 16-byte loads where
  both pointers are aligned, masks the tail instead of padding to tiles,
  works in place (the TPU kernel wrote a fresh output), and reads
  ``alpha`` from device memory, so the micro-batch weight ratio never
  forces a host sync.  One launch per parameter leaf (119 per
  DenseNet-40 accumulate): at these sizes launch cost, not bytes,
  dominates.

The wrapper takes the plain version only for tensors on the CPU; for a
CUDA tensor it launches the kernel or raises.  Nothing differentiates
through the accumulate (it runs outside every ``torch.func`` transform),
so there is no ``autograd.Function``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from optwboundeigenval_tpu_torch.utils import cuda_build

_SOURCE = "axpy_accumulate"


def axpy_accumulate_plain(acc: torch.Tensor, delta: torch.Tensor,
                          alpha: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: ``acc <- fl(acc + fl(alpha * delta))``, the
    rounding of the kernel and of the JAX accumulate ``a + scale * d``."""
    return acc.add_(delta * alpha)


def _check(acc: torch.Tensor, delta: torch.Tensor, alpha: torch.Tensor):
    if not isinstance(alpha, torch.Tensor) or alpha.dim() != 0:
        raise TypeError("alpha must be a 0-d tensor")
    if acc.shape != delta.shape:
        raise ValueError(f"shape mismatch: acc {tuple(acc.shape)} vs "
                         f"delta {tuple(delta.shape)}")
    if acc.requires_grad:
        raise ValueError("axpy_accumulate works in place and is not "
                         "differentiable; acc must not require grad")
    if not (acc.device == delta.device == alpha.device):
        raise ValueError(f"device mismatch: acc {acc.device}, delta "
                         f"{delta.device}, alpha {alpha.device}")


@functools.cache
def _kernel():
    fn = cuda_build.load(_SOURCE).axpy_accumulate_f32
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(acc: torch.Tensor, delta: torch.Tensor, alpha: torch.Tensor):
    for name, t in (("acc", acc), ("delta", delta), ("alpha", alpha)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32 on the card, got {t.dtype}")
    if not (acc.is_contiguous() and delta.is_contiguous()):
        raise ValueError("acc and delta must be contiguous")
    err = _kernel()(acc.data_ptr(), delta.data_ptr(), alpha.data_ptr(),
                    acc.numel(),
                    torch.cuda.current_stream(acc.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"axpy_accumulate launch failed: CUDA error {err}")
    axpy_accumulate.launches += 1


def axpy_accumulate(acc: torch.Tensor, delta: torch.Tensor,
                    alpha: torch.Tensor) -> torch.Tensor:
    """``acc += alpha * delta`` in place; returns ``acc``.

    ``alpha`` is a 0-d tensor on the same device.  On the CPU this is the
    plain version (any float dtype); on a CUDA device it launches the
    kernel (float32, contiguous) or raises."""
    _check(acc, delta, alpha)
    if acc.device.type == "cpu":
        return axpy_accumulate_plain(acc, delta, alpha)
    if acc.device.type != "cuda":
        raise ValueError(f"axpy_accumulate runs on cpu or cuda, not {acc.device}")
    if acc.numel():
        _launch(acc, delta, alpha)
    return acc


# launches of the CUDA kernel since the count was last set to 0
axpy_accumulate.launches = 0
