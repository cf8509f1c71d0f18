"""train/trainer.py: the gradient and HVP map, the optimizer step and
the BatchNorm update of a step or an audit batch."""

TARGETS = [
    ("optwboundeigenval_tpu_torch.train.trainer", "SpectralTrainer._linearize", "gradient"),
    ("optwboundeigenval_tpu_torch.train.trainer", "SpectralTrainer._opt_step", "optimizer"),
    ("optwboundeigenval_tpu_torch.train.trainer", "SpectralTrainer._advance_stats", "bn"),
]
