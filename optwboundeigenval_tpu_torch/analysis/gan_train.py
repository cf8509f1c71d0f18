"""Conditional-GAN training (counterpart of
``optwboundeigenval_tpu/analysis/gan_train.py``; reference gan.py and
cGAN.py main loops).

A step is the generator update, then ``d_iter`` discriminator updates
(gan.py d_iter loop), with the label tricks of gan.py:174-184: ``rand``
draws the real target from U(1 - rand, 1) and the fake one from U(0,
rand) per example; ``smooth`` (an extension, exclusive with ``rand``)
sets the real target to 1 - smooth; ``swap`` exchanges the batch's real
and fake targets with that probability, one draw per batch.  The
generator's loss targets the (possibly swapped) real target (gan.py:205).

Every random number of a step comes from :func:`cgan_draws`: the noise,
the generated labels, the targets, the swap and the discriminator's
dropout keep masks, one set for the generator's pass and the real batch
and one for the fake batch, as the JAX step reuses its dropout key.  A
test passes ``draws`` to inject them.

The optimizers are optax's ``adam``, or ``adamw`` when ``weight_decay >
0``, with optax's formulas (``scale_by_adam``, ``add_decayed_weights``,
``scale_by_learning_rate``), and ``cosine_schedule`` is optax's
``cosine_decay_schedule`` over ``n_epochs * (len(x) // batch_size)``
steps.  Generated datasets are ``.npz`` files with ``x`` (N, H, W, 1)
float32 and ``y`` int32, the JAX package's layout, read by
``data/usps.get_gan_loader``.
"""

from __future__ import annotations

import math
import os
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
from torch import nn

from optwboundeigenval_tpu_torch.models.gan import DROPOUT
from optwboundeigenval_tpu_torch.utils.precision import host


def bce_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean binary cross entropy from logits (``torch.maximum`` splits the
    gradient at 0 as ``jnp.maximum`` does)."""
    return torch.mean(torch.maximum(logits, torch.zeros_like(logits)) - logits * targets
                      + torch.log1p(torch.exp(-logits.abs())))


def cosine_decay(lr: float, decay_steps: int) -> Callable[[int], float]:
    """optax's ``cosine_decay_schedule(lr, decay_steps)``."""
    return lambda count: lr * (0.5 * (1 + math.cos(math.pi * min(count, decay_steps)
                                                   / decay_steps)))


class OptaxAdam:
    """optax ``adam`` (``weight_decay == 0``) or ``adamw`` over a module's
    parameters, updated in place: ``mu``, ``nu`` and ``count`` are its
    state, ``lr(count)`` the learning rate of each update."""

    def __init__(self, module: nn.Module, lr: Callable[[int], float], b1: float, b2: float,
                 weight_decay: float = 0.0, eps: float = 1e-8):
        self.params = dict(module.named_parameters())
        self.lr, self.b1, self.b2, self.eps, self.wd = lr, b1, b2, eps, weight_decay
        self.count = 0
        self.mu = {k: torch.zeros_like(p) for k, p in self.params.items()}
        self.nu = {k: torch.zeros_like(p) for k, p in self.params.items()}

    @torch.no_grad()
    def step(self, grads) -> None:
        b1, b2 = self.b1, self.b2
        count = self.count + 1
        step_size = -self.lr(self.count)
        for (k, p), g in zip(self.params.items(), grads):
            mu = (1 - b1) * g + b1 * self.mu[k]
            nu = (1 - b2) * (g * g) + b2 * self.nu[k]
            u = (mu / (1 - b1 ** count)) / (torch.sqrt(nu / (1 - b2 ** count)) + self.eps)
            if self.wd:
                u = u + self.wd * p
            p.add_(step_size * u)
            self.mu[k], self.nu[k] = mu, nu
        self.count = count


def cgan_draws(gen: torch.Generator, *, batch_size: int, latent_dim: int, n_classes: int,
               rand: float, smooth: float, swap: float, dropout_shapes, dtype,
               device) -> Dict[str, object]:
    """One step's random numbers: ``z`` (B, latent), ``gen_labels`` (B,),
    ``valid``/``fake`` (B, 1), ``flip`` (a 0-d bool tensor, the swap), and
    ``keep1``/``keep2`` (the discriminator's keep masks for the generator's
    pass and the real batch, and for the fake batch)."""
    draw = lambda *shape: torch.rand(shape, generator=gen, device=device, dtype=dtype)
    z = torch.randn((batch_size, latent_dim), generator=gen, device=device, dtype=dtype)
    gen_labels = torch.randint(0, n_classes, (batch_size,), generator=gen, device=device)
    if rand > 0:
        valid, fake = (1.0 - rand) + rand * draw(batch_size, 1), rand * draw(batch_size, 1)
    else:
        valid = torch.full((batch_size, 1), 1.0 - smooth, device=device, dtype=dtype)
        fake = torch.zeros((batch_size, 1), device=device, dtype=dtype)
    flip = draw() < swap
    keep = lambda: [draw(batch_size, *s) < 1.0 - DROPOUT for s in dropout_shapes]
    return {"z": z, "gen_labels": gen_labels, "valid": valid, "fake": fake, "flip": flip,
            "keep1": keep(), "keep2": keep()}


def train_cgan(x: np.ndarray, y: np.ndarray, generator: nn.Module, discriminator: nn.Module,
               *, n_epochs: int = 50, batch_size: int = 64, lr: float = 2e-4,
               b1: float = 0.5, b2: float = 0.999, latent_dim: int = 100,
               n_classes: int = 10, d_iter: int = 1, smooth: float = 0.0,
               swap: float = 0.0, rand: float = 0.0, weight_decay: float = 0.0,
               cosine_schedule: bool = False, seed: int = 0, log_every: int = 10,
               sample_interval: int = 0, sample_dir: str = "./images", device=None,
               draws: Optional[Callable[[int], dict]] = None):
    """Train ``generator`` and ``discriminator`` in place on ``device``
    (default: the card) and return ``(history, g_opt, d_opt)``: ``history``
    holds ``(epoch, mean d_loss, mean g_loss)`` per epoch, the others are
    the two :class:`OptaxAdam` states.  ``draws(step)`` replaces
    :func:`cgan_draws` (the batch order is the JAX package's, a numpy
    permutation per epoch from ``seed``).  ``sample_interval > 0`` saves a
    one-row-per-class sample grid as ``<sample_dir>/<batches>.npz`` every
    that many batches (gan.py:149-160)."""
    from optwboundeigenval_tpu_torch.train.trainer import resolve_device

    if rand > 0 and smooth > 0:
        raise ValueError("rand and smooth are mutually exclusive label tricks; "
                         "pass rand=0 to use deterministic smoothing")
    device = resolve_device(device)
    generator.to(device)
    discriminator.to(device)
    dtype = next(generator.parameters()).dtype
    nb = len(x) // batch_size
    sched = cosine_decay(lr, n_epochs * max(nb, 1)) if cosine_schedule else (lambda _: lr)
    g_opt = OptaxAdam(generator, sched, b1, b2, weight_decay)
    d_opt = OptaxAdam(discriminator, sched, b1, b2, weight_decay)
    gen = torch.Generator(device=device).manual_seed(seed)
    if draws is None:
        shapes = discriminator.dropout_shapes
        draws = lambda _step: cgan_draws(
            gen, batch_size=batch_size, latent_dim=latent_dim, n_classes=n_classes,
            rand=rand, smooth=smooth, swap=swap, dropout_shapes=shapes, dtype=dtype,
            device=device)
    xs = torch.as_tensor(np.asarray(x), device=device)
    ys = torch.as_tensor(np.asarray(y), device=device).long()
    g_params, d_params = list(g_opt.params.values()), list(d_opt.params.values())

    history: List[tuple] = []
    order_rng = np.random.default_rng(seed)
    batches_done = 0
    for epoch in range(n_epochs):
        order = torch.as_tensor(order_rng.permutation(len(x))[: nb * batch_size], device=device)
        g_losses, d_losses = [], []
        for i in range(nb):
            take = order[i * batch_size:(i + 1) * batch_size]
            real, labels = xs[take], ys[take]
            d = draws(batches_done)
            flip = torch.as_tensor(d["flip"], device=device)
            valid = torch.where(flip, d["fake"], d["valid"])
            fake = torch.where(flip, d["valid"], d["fake"])
            gen_labels = d["gen_labels"].long()

            # the generator update: the loss targets the swapped ``valid``
            gen_imgs = generator(d["z"], gen_labels, train=True)
            g_loss = bce_logits(discriminator(gen_imgs, gen_labels, train=True,
                                              keep=d["keep1"]), valid)
            g_opt.step(torch.autograd.grad(g_loss, g_params))
            gen_imgs = gen_imgs.detach()

            for _ in range(d_iter):
                d_loss = (bce_logits(discriminator(real, labels, train=True, keep=d["keep1"]),
                                     valid)
                          + bce_logits(discriminator(gen_imgs, gen_labels, train=True,
                                                     keep=d["keep2"]), fake)) / 2
                d_opt.step(torch.autograd.grad(d_loss, d_params))
            g_losses.append(g_loss.detach())
            d_losses.append(d_loss.detach())
            batches_done += 1
            if sample_interval and batches_done % sample_interval == 0:
                save_sample(generator, batches_done, latent_dim, n_classes, seed, sample_dir)
        history.append((epoch, float(torch.stack(d_losses).mean()),
                        float(torch.stack(g_losses).mean())))
        if epoch % log_every == 0:
            print(f"{epoch}\t{history[-1][1]:f}\t{history[-1][2]:f}", flush=True)
    return history, g_opt, d_opt


@torch.no_grad()
def _sample(generator: nn.Module, z: torch.Tensor, labels: torch.Tensor) -> np.ndarray:
    return host(generator(z, labels, train=False))


def save_sample(generator, batches_done, latent_dim, n_classes, seed, sample_dir):
    """A sample grid, one row per class, as ``<sample_dir>/<batches_done>.npz``
    (``imgs``, ``labels``; the reference's sample_image, gan.py:149-160)."""
    device = next(generator.parameters()).device
    gen = torch.Generator(device=device).manual_seed(seed + batches_done)
    z = torch.randn((n_classes * n_classes, latent_dim), generator=gen, device=device)
    labels = torch.arange(n_classes, device=device).repeat_interleave(n_classes)
    os.makedirs(sample_dir, exist_ok=True)
    np.savez(os.path.join(sample_dir, f"{batches_done}.npz"),
             imgs=_sample(generator, z, labels), labels=labels.cpu().numpy())


def generate_dataset(generator: nn.Module, *, n_images: int = 2048, latent_dim: int = 100,
                     n_classes: int = 10, seed: int = 0,
                     out_path: str = "./data/gan_usps.npz") -> str:
    """``n_images`` labelled samples of ``generator`` (eval mode) saved as an
    ``.npz`` of ``x`` float32 and ``y`` int32 (the reference saves a
    TensorDataset ``.pt``, gan.py:294-296)."""
    device = next(generator.parameters()).device
    gen = torch.Generator(device=device).manual_seed(seed)
    z = torch.randn((n_images, latent_dim), generator=gen, device=device)
    labels = torch.randint(0, n_classes, (n_images,), generator=gen, device=device)
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    np.savez(out_path, x=_sample(generator, z, labels).astype(np.float32),
             y=labels.cpu().numpy().astype(np.int32))
    return out_path
