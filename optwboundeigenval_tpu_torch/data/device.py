"""Device-resident dataset loader (counterpart of
``optwboundeigenval_tpu/data/device.py``).

:class:`DeviceArrayLoader` holds the whole ``(x, y)`` on the device, put
there once.  The shuffle is the host loader's numpy permutation (same
seed, same batch order), so only a batch's row indices cross to the
device, and a batch is an ``index_select`` there.  The padded tail batch
takes row 0 and multiplies it by the ``w > 0`` mask, which gives the host
loader's zero rows exactly, so a run is the same from either loader.
``w`` stays a host array: the trainer sums it on the host.

Layout: the dataset is held as the host loader holds it, images NHWC
(``(B, 32, 32, 3)`` for CIFAR), and every batch leaves the loader NHWC;
the models permute their input to NCHW once, at their first layer
(``models/densenet.py``, ``models/cxr.py``, ``models/cnn_usps.py``).
:func:`flip_crop` therefore works on NHWC, as the JAX package's crop.

``augment(x, generator)`` runs on the device on each ``__iter__`` batch
(never on ``random_batch``).  Its random numbers come from a
``torch.Generator`` on the batch's device seeded from the loader's seed
and the number of batches augmented so far, as ``models/dropout.py``
seeds its masks: jax.random's draws cannot be reproduced, so
:func:`cifar_augment_device` draws its own and hands them to the pure
:func:`flip_crop`, which the tests hold to JAX with JAX's draws.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterator, Optional

import numpy as np
import torch
import torch.nn.functional as F


def flip_crop(x: torch.Tensor, flip: torch.Tensor, offsets: torch.Tensor,
              pad: int = 4) -> torch.Tensor:
    """Flip the NHWC images ``x`` left-right where ``flip`` (``(B,)``
    bool), zero-pad ``pad`` pixels on each side and crop back to the input
    size at ``offsets`` (``(B, 2)`` integers in ``[0, 2 pad]``, rows then
    columns): the JAX package's ``cifar_augment_device`` given its draws."""
    b, h, w, _ = x.shape
    x = torch.where(flip.to(torch.bool)[:, None, None, None], x.flip(2), x)
    xp = F.pad(x, (0, 0, pad, pad, pad, pad))
    offsets = offsets.to(device=x.device, dtype=torch.long)
    rows = offsets[:, 0, None] + torch.arange(h, device=x.device)
    cols = offsets[:, 1, None] + torch.arange(w, device=x.device)
    batch = torch.arange(b, device=x.device)[:, None, None]
    return xp[batch, rows[:, :, None], cols[:, None, :]]


def cifar_augment_device(x: torch.Tensor, generator: torch.Generator,
                         pad: int = 4, flip_p: float = 0.5) -> torch.Tensor:
    """The CIFAR recipe on the device: a random horizontal flip and a
    random crop after ``pad`` pixels of zero padding, the draws from
    ``generator`` (on ``x``'s device)."""
    b = x.shape[0]
    flip = torch.rand(b, generator=generator, device=x.device) < flip_p
    offsets = torch.randint(0, 2 * pad + 1, (b, 2), generator=generator, device=x.device)
    return flip_crop(x, flip, offsets, pad)


def _seed(seed: int, n: int) -> int:
    state = np.random.SeedSequence([seed, n]).generate_state(2, np.uint32)
    return int(state[0]) << 32 | int(state[1])


class DeviceArrayLoader:
    """The :class:`~optwboundeigenval_tpu_torch.data.loaders.ArrayLoader`
    interface over a dataset on ``device`` (default: the card; a machine
    without one raises unless ``device="cpu"``), yielding ``{"x": tensor,
    "y": tensor, "w": np.ndarray}``.  ``transform`` is a deterministic
    map of each gathered batch (e.g. uint8 to normalised float, so the
    dataset sits on the device in a quarter of the bytes); ``augment(x,
    generator)`` the random one."""

    def __init__(self, x: np.ndarray, y: np.ndarray, batch_size: int = 128, *,
                 shuffle: bool = False, seed: int = 0, pad: bool = True,
                 drop_remainder: bool = False,
                 transform: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
                 augment: Optional[Callable[[torch.Tensor, torch.Generator],
                                            torch.Tensor]] = None,
                 device=None):
        from optwboundeigenval_tpu_torch.train.trainer import resolve_device

        if len(x) != len(y):
            raise ValueError(f"{len(x)} inputs but {len(y)} targets")
        self.device = resolve_device(device)
        self.x = torch.as_tensor(np.asarray(x), device=self.device)
        self.y = torch.as_tensor(np.asarray(y), device=self.device)
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.pad = pad
        self.drop_remainder = drop_remainder
        self.transform = transform
        self.augment = augment
        self.seed = seed
        self._rng = np.random.default_rng(seed)
        self._augmented = 0  # batches augmented so far: the draw count
        self._epoch = 0

    def __len__(self) -> int:
        n = len(self.x)
        if self.drop_remainder:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    @property
    def num_examples(self) -> int:
        return len(self.x)

    def _emit(self, take: np.ndarray, use_aug: bool = False) -> Dict[str, object]:
        w = np.ones(len(take), np.float32)
        padn = self.batch_size - len(take)
        if self.pad and padn > 0:
            take = np.concatenate([take, np.zeros(padn, take.dtype)])
            w = np.concatenate([w, np.zeros(padn, np.float32)])
        idx = torch.as_tensor(take, dtype=torch.long).to(self.device, non_blocking=True)
        xb, yb = self.x.index_select(0, idx), self.y.index_select(0, idx)
        if self.transform is not None:
            xb = self.transform(xb)
        if use_aug and self.augment is not None:
            self._augmented += 1
            g = torch.Generator(device=self.device)
            g.manual_seed(_seed(self.seed, self._augmented))
            xb = self.augment(xb, g)
        keep = torch.as_tensor(w > 0).to(self.device, non_blocking=True)
        xb = xb * keep.reshape((-1,) + (1,) * (xb.dim() - 1)).to(xb.dtype)
        yb = yb * keep.reshape((-1,) + (1,) * (yb.dim() - 1)).to(yb.dtype)
        return {"x": xb, "y": yb, "w": w}

    def __iter__(self) -> Iterator[Dict[str, object]]:
        n = len(self.x)
        idx = np.arange(n)
        if self.shuffle:
            self._rng.shuffle(idx)
        self._epoch += 1
        bs = self.batch_size
        stop = (n // bs) * bs if self.drop_remainder else n
        for start in range(0, stop, bs):
            yield self._emit(idx[start:start + bs], use_aug=True)

    def random_batch(self, rng: Optional[np.random.Generator] = None):
        """One uniformly random batch, not augmented."""
        rng = rng or self._rng
        n = len(self.x)
        return self._emit(rng.choice(n, size=min(self.batch_size, n), replace=False))


def as_device_loader(loader, transform=None, augment=None, device=None) -> DeviceArrayLoader:
    """A :class:`DeviceArrayLoader` over a host ``ArrayLoader``'s data, its
    batch size, padding and shuffle stream (the generator's state is
    copied, so the batch order continues from the point of conversion).
    A host augment hook cannot move to the device: without a device
    ``augment`` it raises."""
    if getattr(loader, "augment", None) is not None and augment is None:
        raise ValueError("the loader has a host augment hook; pass a device augment= "
                         "(e.g. cifar_augment_device) or keep the host loader")
    dev = DeviceArrayLoader(loader.x, loader.y, batch_size=loader.batch_size,
                            shuffle=loader.shuffle, pad=loader.pad,
                            drop_remainder=loader.drop_remainder,
                            transform=transform, augment=augment, device=device)
    dev._rng.bit_generator.state = loader._rng.bit_generator.state
    return dev
