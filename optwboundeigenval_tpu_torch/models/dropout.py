"""Dropout under one key per step (PyTorch's counterpart of flax's
``nn.Dropout`` as the JAX package's models use it).

The JAX trainer splits one dropout key a step and closes the loss over
it, so the gradient, every HVP of the eigensolver, the vGHv pass and the
BatchNorm update see the same masks: the Hessian of one network
realisation, a symmetric operator.  flax draws a site's mask from the key
folded with the site's path, so a pass given the same key draws the same
mask at a site for the same shape; a micro-batched pass, whose slices
share a shape, draws one mask for every slice.

Here the rule is the same.  A train-mode :class:`Dropout` reads the key
that :func:`keyed` set (``Task`` sets it around each forward it runs) and
draws its keep mask from a ``torch.Generator`` on the tensor's device,
seeded by the key and the site's module name (:func:`name_sites`): the
mask depends on the key, the site, the shape and the device only, so a
recomputed forward (``curvature.recompute_hvp``) and every micro-batch
draw it again bit for bit.  Kept values are scaled by ``1 / keep``, as
flax does.  A train-mode pass with no key raises, as flax does without a
``dropout`` rng.

:func:`inject` replaces the draw with given masks, ``masks(key, site,
shape) -> keep mask``: the tests inject the masks flax drew, and the card
is held to the CPU with the same masks.

Under a data-parallel mesh (``parallel/mesh.py``) a site's mask is drawn
for the global batch's shape and each rank takes the rows of its data
coordinate, as flax's mask over a sharded batch is one global draw, so a
run on several ranks sees the masks of a run on one.
"""

from __future__ import annotations

import contextlib
import contextvars
import zlib
from typing import Callable, List, Optional

import numpy as np
import torch
from torch import nn

from optwboundeigenval_tpu_torch.parallel import mesh as meshlib

_KEY = contextvars.ContextVar("dropout_key", default=None)
_MASKS = contextvars.ContextVar("dropout_masks", default=None)


def step_key(seed: int, n: int) -> int:
    """The ``n``-th dropout key of a run seeded with ``seed`` (a
    non-negative int below 2**63)."""
    state = np.random.SeedSequence([seed, n]).generate_state(2, np.uint32)
    return int(state[0]) << 31 | int(state[1]) >> 1


@contextlib.contextmanager
def keyed(key: Optional[int]):
    """Train-mode dropout inside draws its masks from ``key``."""
    token = _KEY.set(key)
    try:
        yield
    finally:
        _KEY.reset(token)


@contextlib.contextmanager
def inject(masks: Callable[[int, str, tuple], torch.Tensor]):
    """Dropout inside takes ``masks(key, site, shape)`` (true where kept)
    instead of drawing."""
    token = _MASKS.set(masks)
    try:
        yield
    finally:
        _MASKS.reset(token)


def name_sites(model: nn.Module) -> None:
    """Give every :class:`Dropout` of ``model`` its module name as its site."""
    for name, m in model.named_modules():
        if isinstance(m, Dropout):
            m.site = name


def sites(model: nn.Module) -> List[str]:
    """The sites of ``model``'s active dropout layers, in module order (the
    order a forward pass of the port's models reaches them)."""
    return [m.site for m in model.modules() if isinstance(m, Dropout) and m.rate > 0]


def keep_mask(key: int, site: str, x: torch.Tensor, keep: float,
              shape: Optional[tuple] = None) -> torch.Tensor:
    """The keep mask of ``site`` for ``shape`` (default ``x``'s) under
    ``key``, drawn on ``x``'s device."""
    seed = np.random.SeedSequence([key, zlib.crc32(site.encode())]).generate_state(
        2, np.uint32)
    g = torch.Generator(device=x.device)
    g.manual_seed(int(seed[0]) << 32 | int(seed[1]))
    return torch.rand(x.shape if shape is None else shape, generator=g,
                      device=x.device) < keep


class Dropout(nn.Module):
    """flax ``nn.Dropout(rate)``: in train mode ``x * mask / (1 - rate)``
    with the mask of the current key, else ``x``."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = float(rate)
        self.site = ""

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if not train or self.rate == 0.0:
            return x
        key = _KEY.get()
        if key is None:
            raise RuntimeError(f"train-mode dropout at {self.site!r} needs a key: "
                               "build the Task with has_dropout=True and pass the step's key")
        keep = 1.0 - self.rate
        first, rows = meshlib.global_rows(x.shape[0])
        shape = (rows,) + tuple(x.shape[1:])
        masks = _MASKS.get()
        if masks is None:
            mask = keep_mask(key, self.site, x, keep, shape)
        else:
            mask = masks(key, self.site, shape)
        mask = mask[first:first + x.shape[0]]
        return x * mask.to(x.device, x.dtype) / keep
