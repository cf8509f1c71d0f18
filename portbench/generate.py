"""Weights and data from the seed, on the device, in a few large draws.

One ``torch.Generator`` on the device, seeded with ``--seed``, draws in
this order: every normal weight in one call, every uniform weight in
one call, the class templates, the labels and the noise of all the
cell's batches.  Each leaf takes its slice of a draw, scaled to its
initialisation (``reference/models.py``): He or LeCun normal convs,
the classifier normal or uniform, BatchNorm scale 1 and bias 0, running
mean 0 and variance 1, conv biases 0.

The images are stand-ins in the dataset's shape: templates ``T`` (one a
class, normal), and for class labels ``x = T[y] + noise * z`` with ``y``
uniform over the classes; for multi-label rows ``x = (y @ T) /
sqrt(classes) + noise * z`` with each label positive at
``positive_rate``; ``z`` normal.  Every row has weight 1.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

from portbench.reference.models import Model

Tree = Dict[str, torch.Tensor]


def generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed) % (2 ** 63))


def make_state(model: Model, gen: torch.Generator, device, dtype) -> Tuple[Tree, Tree]:
    """``(params, running statistics)`` of ``model``."""
    leaves = model.leaves()
    drawn = {}
    for kind, draw in (("normal", torch.randn), ("uniform", torch.rand)):
        mine = [(name, shape, init) for name, shape, init in leaves if init[0] == kind]
        total = sum(math.prod(shape) for _, shape, _ in mine)
        if not total:
            continue
        buf = draw(total, generator=gen, device=device, dtype=dtype)
        off = 0
        for name, shape, init in mine:
            n = math.prod(shape)
            t = buf[off:off + n].view(shape)
            drawn[name] = t * init[1] if kind == "normal" else (2.0 * t - 1.0) * init[1]
            off += n

    def fixed(shape, init):
        fill = torch.ones if init[0] == "ones" else torch.zeros
        return fill(shape, device=device, dtype=dtype)

    params = {name: drawn[name] if name in drawn else fixed(shape, init)
              for name, shape, init in leaves}
    state = {name: fixed(shape, init) for name, shape, init in model.buffers()}
    return params, state


def make_batches(data: dict, batch_size: int, n_batches: int, gen: torch.Generator,
                 device, dtype) -> List[dict]:
    """``n_batches`` batches ``{"x", "y", "w"}``: ``x`` and ``y`` on the
    device, ``w`` a host array, as a host loader hands the weights."""
    shape = tuple(data["shape"])
    classes = data["classes"]
    rows = batch_size * n_batches
    templates = torch.randn((classes,) + shape, generator=gen, device=device, dtype=dtype)
    if data["labels"] == "multilabel":
        u = torch.rand((rows, classes), generator=gen, device=device, dtype=dtype)
        y = (u < data["positive_rate"]).to(dtype)
        x = torch.einsum("nc,c...->n...", y, templates) / math.sqrt(classes)
    else:
        y = torch.randint(0, classes, (rows,), generator=gen, device=device)
        x = templates[y]
    x = x + data["noise"] * torch.randn(x.shape, generator=gen, device=device, dtype=dtype)
    w = np.ones(batch_size, np.float32)
    return [{"x": x[i * batch_size:(i + 1) * batch_size], "y": y[i * batch_size:(i + 1) * batch_size],
             "w": w} for i in range(n_batches)]
