"""Synthetic stand-in datasets (copied from
``optwboundeigenval_tpu/data/synthetic.py``; only ``make_images`` so far).
The port runs without network access, so CIFAR has a deterministic
stand-in with the real shapes and label space."""

from __future__ import annotations

import numpy as np


def make_images(
    n: int,
    shape=(16, 16, 1),
    n_classes: int = 10,
    seed: int = 1226,
    noise: float = 0.35,
):
    """Class-templated images (per-class random smooth template + noise)."""
    rng = np.random.default_rng(seed)
    templates = rng.normal(size=(n_classes,) + tuple(shape)).astype(np.float32)
    # smooth templates along H and W for image-like structure
    for _ in range(2):
        templates = (
            templates
            + np.roll(templates, 1, axis=1)
            + np.roll(templates, -1, axis=1)
            + np.roll(templates, 1, axis=2)
            + np.roll(templates, -1, axis=2)
        ) / 5.0
    y = rng.integers(0, n_classes, size=n)
    x = templates[y] + rng.normal(size=(n,) + tuple(shape)).astype(np.float32) * noise
    return x.astype(np.float32), y.astype(np.int32)
