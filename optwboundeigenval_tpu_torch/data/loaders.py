"""Host-side batching (copied from ``optwboundeigenval_tpu/data/loaders.py``).

* numpy arrays on the host; batches are dicts ``{"x", "y", "w"}``;
* the final partial batch is padded to the full batch size with
  zero-weight rows (``w = 0``), so weighted means stay exact and every
  step sees one shape;
* deterministic shuffling from a seed (reference seed 1226);
* an optional per-batch host augmentation hook.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterator, Optional

import numpy as np


class ArrayLoader:
    """Iterable over padded, weighted batches of (x, y)."""

    def __init__(
        self,
        x: np.ndarray,
        y: np.ndarray,
        batch_size: int = 128,
        *,
        shuffle: bool = False,
        seed: int = 0,
        pad: bool = True,
        drop_remainder: bool = False,
        augment: Optional[Callable[[np.ndarray, np.random.Generator], np.ndarray]] = None,
    ):
        if len(x) != len(y):
            raise ValueError(f"{len(x)} inputs but {len(y)} targets")
        self.x = np.asarray(x)
        self.y = np.asarray(y)
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.pad = pad
        self.drop_remainder = drop_remainder
        self.augment = augment
        self._rng = np.random.default_rng(seed)
        self._epoch = 0

    def __len__(self) -> int:
        n = len(self.x)
        if self.drop_remainder:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    @property
    def num_examples(self) -> int:
        return len(self.x)

    def _padded(self, xb, yb, w):
        padn = self.batch_size - len(xb)
        if self.pad and padn > 0:
            xb = np.concatenate([xb, np.zeros((padn,) + xb.shape[1:], xb.dtype)])
            yb = np.concatenate([yb, np.zeros((padn,) + yb.shape[1:], yb.dtype)])
            w = np.concatenate([w, np.zeros(padn, np.float32)])
        return {"x": xb, "y": yb, "w": w}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        n = len(self.x)
        idx = np.arange(n)
        if self.shuffle:
            self._rng.shuffle(idx)
        self._epoch += 1
        bs = self.batch_size
        stop = (n // bs) * bs if self.drop_remainder else n
        for start in range(0, stop, bs):
            take = idx[start : start + bs]
            xb = self.x[take]
            if self.augment is not None:
                xb = self.augment(xb, self._rng)
            yield self._padded(xb, self.y[take], np.ones(len(take), np.float32))

    def random_batch(self, rng: Optional[np.random.Generator] = None):
        """One uniformly random batch (the reference estimates epoch-end
        rho on a random batch, opt.py:604-612)."""
        rng = rng or self._rng
        n = len(self.x)
        take = rng.choice(n, size=min(self.batch_size, n), replace=False)
        return self._padded(self.x[take], self.y[take],
                            np.ones(len(take), np.float32))


def train_valid_split(
    n: int, valid_fraction: float, seed: int = 1226
) -> tuple[np.ndarray, np.ndarray]:
    """Deterministic index split over a seeded permutation."""
    rng = np.random.default_rng(seed)
    idx = rng.permutation(n)
    n_valid = int(np.floor(valid_fraction * n))
    return idx[n_valid:], idx[:n_valid]
