"""CIFAR-10/100 loaders (counterpart of ``optwboundeigenval_tpu/data/cifar.py``).

Reads the standard python pickle batches from
``root/cifar-10-batches-py`` (or ``cifar-100-python``) when present,
else a synthetic stand-in of 4,096 examples (seed 1226).  Per-channel
mean/std normalisation over the train set, valid split 0.2, and a
non-augmented twin of the train loader.  The augmentation recipe
(RandomAffine translate + HFlip) is not ported yet: ``augment=True``
raises.
"""

from __future__ import annotations

import os
import pickle

import numpy as np

from optwboundeigenval_tpu_torch.data.loaders import ArrayLoader, train_valid_split
from optwboundeigenval_tpu_torch.data.synthetic import make_images

SEED = 1226


def _load_pickle_batches(root: str, name: str, train: bool):
    if name == "cifar10":
        d = os.path.join(root, "cifar-10-batches-py")
        files = [f"data_batch_{i}" for i in range(1, 6)] if train else ["test_batch"]
        label_key = b"labels"
    else:
        d = os.path.join(root, "cifar-100-python")
        files = ["train"] if train else ["test"]
        label_key = b"fine_labels"
    if not os.path.isdir(d):
        return None
    xs, ys = [], []
    for f in files:
        # the dataset's own pickle files, as published
        with open(os.path.join(d, f), "rb") as fh:
            entry = pickle.load(fh, encoding="bytes")
        xs.append(entry[b"data"])
        ys.extend(entry[label_key])
    x = np.concatenate(xs).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    return x.astype(np.float32) / 255.0, np.asarray(ys, np.int32)


def load_cifar(root: str = "./data", name: str = "cifar10", train: bool = True):
    """``(x, y)`` with ``x`` NHWC float32 in [0, 1]."""
    out = _load_pickle_batches(root, name, train)
    if out is not None:
        return out
    ncls = 10 if name == "cifar10" else 100
    n = min(50000 if train else 10000, 4096)
    return make_images(n, shape=(32, 32, 3), n_classes=ncls,
                       seed=SEED if train else SEED + 1)


def get_train_valid_loader(
    batch_size: int = 32,
    augment: bool = True,
    valid_size: float = 0.2,
    root: str = "./data",
    name: str = "cifar10",
    seed: int = SEED,
):
    """``(train_loader, valid_loader, train_loader_na)``."""
    if augment:
        raise NotImplementedError(
            "CIFAR augmentation is not ported yet; pass augment=False")
    x, y = load_cifar(root, name, train=True)
    x = (x - x.mean(axis=(0, 1, 2))) / x.std(axis=(0, 1, 2))
    tr_idx, va_idx = train_valid_split(len(x), valid_size, seed)
    train_loader = ArrayLoader(x[tr_idx], y[tr_idx], batch_size, shuffle=True,
                               seed=seed)
    valid_loader = ArrayLoader(x[va_idx], y[va_idx], batch_size)
    train_loader_na = ArrayLoader(x[tr_idx], y[tr_idx], batch_size)
    return train_loader, valid_loader, train_loader_na


def get_test_loader(batch_size: int = 32, root: str = "./data",
                    name: str = "cifar10"):
    xtr, _ = load_cifar(root, name, train=True)
    mean, std = xtr.mean(axis=(0, 1, 2)), xtr.std(axis=(0, 1, 2))
    x, y = load_cifar(root, name, train=False)
    return ArrayLoader((x - mean) / std, y, batch_size)
