"""ops/curvature.py: an HVP that recomputes forward and gradient (the
map ``recompute_hvp`` returns calls it once a product)."""

TARGETS = [("optwboundeigenval_tpu_torch.ops.curvature", "hvp", "hvp")]
