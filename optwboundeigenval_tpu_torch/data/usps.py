"""USPS loaders (counterpart of ``optwboundeigenval_tpu/data/usps.py``).

Reference surface (usps_data.py): ``get_train_valid_loader`` (1/7 valid
split, seed 1226), ``get_train_loader_na`` (its non-augmented twin) and
``get_test_loader``.  Reads the libsvm-format ``usps.bz2`` /
``usps.t.bz2`` from ``root`` when present, else a deterministic
synthetic stand-in with the same shapes (7,291 train and 2,007 test
16x16x1 images, 10 classes).  ``augment=True`` puts the reference's
crop-pad 1 + rotation 15 degrees (``transforms.usps_augment``) on the train
loader; ``get_test_loader(augment=True)`` returns the two augmented test
loaders.  ``get_mnist_loader`` (MNIST resized to 16x16, the OOD test set)
reads the raw idx files from ``root`` when present; ``get_gan_loader``
reads a generated or constructed ``.npz`` (``x`` (N, 16, 16, 1) float32,
``y`` int32, the JAX package's layout); each falls back to a synthetic
stand-in.
"""

from __future__ import annotations

import bz2
import os
from typing import Tuple

import numpy as np

from optwboundeigenval_tpu_torch.data.loaders import ArrayLoader, train_valid_split
from optwboundeigenval_tpu_torch.data.synthetic import make_images
from optwboundeigenval_tpu_torch.data.transforms import usps_augment

SEED = 1226  # usps_data.py:27-28
N_TRAIN, N_TEST = 7291, 2007  # official USPS split sizes


def _read_libsvm_bz2(path: str) -> Tuple[np.ndarray, np.ndarray]:
    xs, ys = [], []
    with bz2.open(path, "rt") as fh:
        for line in fh:
            parts = line.split()
            ys.append(int(float(parts[0])) - 1)  # labels 1..10 -> 0..9
            row = np.zeros(256, np.float32)
            for tok in parts[1:]:
                i, v = tok.split(":")
                row[int(i) - 1] = float(v)
            xs.append(row)
    x = np.stack(xs).reshape(-1, 16, 16, 1)
    # libsvm USPS is in [-1, 1]; map to [0, 1] like torchvision ToTensor
    x = (x + 1.0) / 2.0
    return x.astype(np.float32), np.asarray(ys, np.int32)


def load_usps(root: str = "./data", train: bool = True):
    fname = os.path.join(root, "usps.bz2" if train else "usps.t.bz2")
    if os.path.exists(fname):
        return _read_libsvm_bz2(fname)
    n = N_TRAIN if train else N_TEST
    return make_images(n, shape=(16, 16, 1), n_classes=10,
                       seed=SEED if train else SEED + 1)


def get_train_valid_loader(batch_size: int = 128, augment: bool = False,
                           valid_size: float = 1.0 / 7, root: str = "./data",
                           seed: int = SEED):
    """``(train_loader, valid_loader)``: 1/7 validation split from a seeded
    permutation; the train loader shuffles."""
    x, y = load_usps(root, train=True)
    tr_idx, va_idx = train_valid_split(len(x), valid_size, seed)
    aug = usps_augment(pad=1, degrees=15) if augment else None
    train_loader = ArrayLoader(x[tr_idx], y[tr_idx], batch_size, shuffle=True,
                               seed=seed, augment=aug)
    return train_loader, ArrayLoader(x[va_idx], y[va_idx], batch_size)


def get_train_loader_na(batch_size: int = 128, valid_size: float = 1.0 / 7,
                        root: str = "./data", seed: int = SEED):
    """Non-augmented, unshuffled twin of the train loader
    (usps_data.py:146-155)."""
    x, y = load_usps(root, train=True)
    tr_idx, _ = train_valid_split(len(x), valid_size, seed)
    return ArrayLoader(x[tr_idx], y[tr_idx], batch_size)


def get_test_loader(batch_size: int = 128, augment: bool = False,
                    root: str = "./data", seed: int = SEED):
    """The plain test loader, or with ``augment`` the reference's two
    augmented ones as a list: crop-pad 1 + rotation 15 from ``seed`` and
    crop-pad 2 + rotation 30 from ``seed + 1`` (usps_data.py:25-33)."""
    x, y = load_usps(root, train=False)
    if not augment:
        return ArrayLoader(x, y, batch_size, seed=seed)
    return [ArrayLoader(x, y, batch_size, seed=seed,
                        augment=usps_augment(pad=1, degrees=15)),
            ArrayLoader(x, y, batch_size, seed=seed + 1,
                        augment=usps_augment(pad=2, degrees=30))]


def get_mnist_loader(batch_size: int = 128, root: str = "./data"):
    """MNIST's test set resized to 16x16 (linear ``ndimage.zoom``) as an OOD
    test set (usps_data.py:209-265), from ``t10k-images-idx3-ubyte`` and
    ``t10k-labels-idx1-ubyte`` under ``root``; else 2,000 synthetic rows."""
    img_f = os.path.join(root, "t10k-images-idx3-ubyte")
    lbl_f = os.path.join(root, "t10k-labels-idx1-ubyte")
    if os.path.exists(img_f) and os.path.exists(lbl_f):
        from scipy import ndimage

        with open(img_f, "rb") as fh:
            fh.read(16)
            x = np.frombuffer(fh.read(), np.uint8).reshape(-1, 28, 28)
        with open(lbl_f, "rb") as fh:
            fh.read(8)
            y = np.frombuffer(fh.read(), np.uint8).astype(np.int32)
        x = ndimage.zoom(x.astype(np.float32) / 255.0, (1, 16 / 28, 16 / 28), order=1)
        x = x[..., None].astype(np.float32)
    else:
        x, y = make_images(2000, shape=(16, 16, 1), n_classes=10, seed=SEED + 7)
    return ArrayLoader(x, y, batch_size)


def get_gan_loader(batch_size: int = 128, file: str = "gan_usps.npz", root: str = "./data"):
    """A saved generated dataset (usps_data.py:268-295): ``<root>/<file>``,
    an ``.npz`` of ``x`` and ``y`` as ``analysis/gan_train.generate_dataset``
    and ``analysis/distance.create_dist_dataset`` write it; else 1,024
    synthetic rows."""
    path = os.path.join(root, file)
    if os.path.exists(path):
        with np.load(path) as z:
            return ArrayLoader(z["x"], z["y"], batch_size)
    x, y = make_images(1024, shape=(16, 16, 1), n_classes=10, seed=SEED + 13)
    return ArrayLoader(x, y, batch_size)
