"""ops/eigen.py: the dominant-eigenpair solve, its products, vector
updates and one host read of the stop test a product."""

TARGETS = [("optwboundeigenval_tpu_torch.ops.eigen", "estimate_dominant_eig", "eigensolver")]
