"""ops/spectral.py: the penalty and its gradient, the vGHv pass."""

TARGETS = [("optwboundeigenval_tpu_torch.ops.spectral", "penalty_and_grad", "vghv")]
