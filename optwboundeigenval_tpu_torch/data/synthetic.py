"""Synthetic stand-in datasets (copied from
``optwboundeigenval_tpu/data/synthetic.py``: ``make_classification`` and
``make_images``).  The port runs without network access, so Forest, USPS
and CIFAR have deterministic stand-ins with the real shapes and label
spaces."""

from __future__ import annotations

import numpy as np


def make_classification(
    n: int,
    n_features: int,
    n_classes: int,
    seed: int = 1226,
    noise: float = 0.8,
):
    """Gaussian class-cluster data, linearly separable up to noise."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n_classes, n_features)) * 2.0
    y = rng.integers(0, n_classes, size=n)
    x = centers[y] + rng.normal(size=(n, n_features)) * noise
    return x.astype(np.float32), y.astype(np.int32)


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
