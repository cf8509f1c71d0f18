"""Synthetic stand-in datasets (copied from
``optwboundeigenval_tpu/data/synthetic.py``: ``make_classification``,
``make_images`` and ``make_multilabel``).  The port runs without network
access, so Forest, USPS, CIFAR and the chest x-ray sets have
deterministic stand-ins with the real shapes and label spaces."""

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


def make_multilabel(
    n: int,
    shape=(64, 64, 3),
    n_classes: int = 14,
    seed: int = 1226,
    nan_frac: float = 0.0,
):
    """Multi-label images, a fraction ``nan_frac`` of the labels NaN (the
    uncertain labels CheXpert and MIMIC map to NaN, dcnn.py:92-145)."""
    rng = np.random.default_rng(seed)
    templates = rng.normal(size=(n_classes,) + tuple(shape)).astype(np.float32)
    y = (rng.random((n, n_classes)) < 0.3).astype(np.float32)
    x = np.einsum("nc,c...->n...", y, templates) / np.sqrt(n_classes)
    x = x + rng.normal(size=(n,) + tuple(shape)).astype(np.float32) * 0.5
    if nan_frac > 0:
        mask = rng.random((n, n_classes)) < nan_frac
        y = y.copy()
        y[mask] = np.nan
    return x.astype(np.float32), y
