"""CIFAR-10/100 loaders (counterpart of ``optwboundeigenval_tpu/data/cifar.py``).

Reads the standard python pickle batches from
``root/cifar-10-batches-py`` (or ``cifar-100-python``) when present,
else a synthetic stand-in of 4,096 examples (seed 1226).  Per-channel
mean/std normalisation over the train set, valid split 0.2, and a
non-augmented twin of the train loader.  ``augment=True`` puts the
reference's RandomAffine translate(0.1) + HFlip
(``transforms.cifar_augment``) on the train loader only.
"""

from __future__ import annotations

import functools
import os
import pickle

import numpy as np

from optwboundeigenval_tpu_torch.data.loaders import ArrayLoader, train_valid_split
from optwboundeigenval_tpu_torch.data.synthetic import make_images
from optwboundeigenval_tpu_torch.data.transforms import cifar_augment

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


@functools.lru_cache(maxsize=None)
def _stand_in(name: str, train: bool):
    """The synthetic stand-in, drawn once a process and read-only: a config
    of the CIFAR family draws it three times a build."""
    ncls = 10 if name == "cifar10" else 100
    n = min(50000 if train else 10000, 4096)
    x, y = make_images(n, shape=(32, 32, 3), n_classes=ncls,
                       seed=SEED if train else SEED + 1)
    x.setflags(write=False)
    y.setflags(write=False)
    return x, y


def load_cifar(root: str = "./data", name: str = "cifar10", train: bool = True):
    """``(x, y)`` with ``x`` NHWC float32 in [0, 1]."""
    out = _load_pickle_batches(root, name, train)
    if out is not None:
        return out
    return _stand_in(name, train)


def get_train_valid_loader(
    batch_size: int = 32,
    augment: bool = True,
    valid_size: float = 0.2,
    root: str = "./data",
    name: str = "cifar10",
    seed: int = SEED,
):
    """``(train_loader, valid_loader, train_loader_na)``; ``augment``
    applies to the shuffling train loader alone."""
    x, y = load_cifar(root, name, train=True)
    x = (x - x.mean(axis=(0, 1, 2))) / x.std(axis=(0, 1, 2))
    tr_idx, va_idx = train_valid_split(len(x), valid_size, seed)
    train_loader = ArrayLoader(x[tr_idx], y[tr_idx], batch_size, shuffle=True,
                               seed=seed, augment=cifar_augment() if augment else None)
    valid_loader = ArrayLoader(x[va_idx], y[va_idx], batch_size)
    train_loader_na = ArrayLoader(x[tr_idx], y[tr_idx], batch_size)
    return train_loader, valid_loader, train_loader_na


def get_test_loader(batch_size: int = 32, root: str = "./data",
                    name: str = "cifar10"):
    xtr, _ = load_cifar(root, name, train=True)
    mean, std = xtr.mean(axis=(0, 1, 2)), xtr.std(axis=(0, 1, 2))
    x, y = load_cifar(root, name, train=False)
    return ArrayLoader((x - mean) / std, y, batch_size)
