"""PyTorch/CUDA port of ``optwboundeigenval_tpu`` for an NVIDIA H100.

Module names follow the JAX package, so each function's counterpart is
found at the same relative path.  The package imports ``torch`` and
never JAX or the JAX package; its entry points run on the GPU unless the
caller passes ``device="cpu"``.
"""
