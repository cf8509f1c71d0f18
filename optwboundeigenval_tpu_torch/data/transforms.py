"""Host-side augmentation recipes (counterpart of
``optwboundeigenval_tpu/data/transforms.py``).

Reference recipes:
  * USPS ``aug_trans``: random crop with padding 1 + rotation ±15°, and
    crop padding 2 + rotation ±30° (usps_data.py:25-33);
  * CIFAR: RandomAffine translate(0.1) + horizontal flip
    (cifar_data.py:98-106).

A recipe is a loader hook ``fn(x, rng)`` over an NHWC float batch.  By
default it runs the C++ batch functions of ``native/`` seeded with
``rng.integers(0, 2**63)``, one draw per batch, as the JAX package does;
a failed build raises.  ``use_native=False`` selects the numpy/scipy
per-image functions below, another random stream.
"""

from __future__ import annotations

import numpy as np
from scipy import ndimage

from optwboundeigenval_tpu_torch import native


def random_crop_pad(x: np.ndarray, pad: int, rng: np.random.Generator):
    """Pad by ``pad`` on each side then randomly crop back (torchvision
    RandomCrop(size, padding=pad))."""
    n, h, w, c = x.shape
    xp = np.pad(x, ((0, 0), (pad, pad), (pad, pad), (0, 0)))
    out = np.empty_like(x)
    offs = rng.integers(0, 2 * pad + 1, size=(n, 2))
    for i in range(n):
        oy, ox = offs[i]
        out[i] = xp[i, oy : oy + h, ox : ox + w, :]
    return out


def random_rotation(x: np.ndarray, degrees: float, rng: np.random.Generator):
    out = np.empty_like(x)
    angles = rng.uniform(-degrees, degrees, size=x.shape[0])
    for i in range(x.shape[0]):
        out[i] = ndimage.rotate(
            x[i], angles[i], axes=(0, 1), reshape=False, order=1, mode="nearest"
        )
    return out


def random_translate(x: np.ndarray, frac: float, rng: np.random.Generator):
    n, h, w, c = x.shape
    out = np.empty_like(x)
    shifts = rng.uniform(-frac, frac, size=(n, 2)) * [h, w]
    for i in range(n):
        out[i] = ndimage.shift(
            x[i], (shifts[i][0], shifts[i][1], 0), order=1, mode="nearest"
        )
    return out


def random_hflip(x: np.ndarray, rng: np.random.Generator, p: float = 0.5):
    flip = rng.random(x.shape[0]) < p
    out = x.copy()
    out[flip] = out[flip][:, :, ::-1, :]
    return out


def usps_augment(pad: int = 1, degrees: float = 15.0, use_native: bool = True):
    """usps_data.py:25-33 recipe (pad 1 / rot 15 or pad 2 / rot 30)."""

    def fn(x: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        flat = x.ndim == 2
        if flat:
            x = x.reshape(-1, 16, 16, 1)
        if use_native:
            x = native.crop_pad_rotate(x, pad, degrees, int(rng.integers(0, 2**63)))
        else:
            x = random_rotation(random_crop_pad(x, pad, rng), degrees, rng)
        return x.reshape(x.shape[0], -1) if flat else x

    return fn


def cifar_augment(translate: float = 0.1, use_native: bool = True):
    """cifar_data.py:98-106 recipe."""

    def fn(x: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        if use_native:
            return native.translate_hflip(x, translate, int(rng.integers(0, 2**63)))
        return random_hflip(random_translate(x, translate, rng), rng)

    return fn
