"""The benchmark of ``optwboundeigenval_tpu_torch`` on one NVIDIA H100
(README.md).  Nothing here imports JAX or the JAX package."""
