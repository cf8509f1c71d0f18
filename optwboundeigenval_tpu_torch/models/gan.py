"""Conditional GANs that synthesize shifted USPS test sets (counterpart of
``optwboundeigenval_tpu/models/gan.py``):

* ``gan.py`` (MLP cGAN, gan.py:53-296): a label-embedding MLP generator
  (blocks ``n -> 2n -> 4n -> 8n`` with BatchNorm and LeakyReLU 0.2, Tanh
  out) and an MLP discriminator with dropout 0.4 (logits out);
* ``cGAN.py`` (DC-cGAN, cGAN.py:80-256): a transposed-convolution
  generator and a convolution discriminator at 32x32, the label embedded
  as an extra input channel.

Images are NHWC at the modules' boundary, as in the JAX package and the
port's other models; the convolutions run in NCHW.  ``forward(..., train)``
takes the mode explicitly.  Train mode updates the BatchNorm running
statistics in place (flax momentum 0.9 is torch's 0.1; the running
variance is the unbiased one, as ``models/norm.py`` of the JAX package
stores it), and the MLP discriminator's dropout takes its keep masks as
an argument (``keep``), so that the training loop draws every random
number in one place (``analysis/gan_train.cgan_draws``).

flax's ``ConvTranspose`` (kernel = stride, ``padding='SAME'``, no kernel
transpose) is ``conv_transpose2d(stride=k, padding=0)`` with the kernel
flipped in both spatial axes; ``utils/interop.py`` does the flip.  The
DC discriminator flattens its last map in HWC order, as the JAX model
does, so its dense kernel needs no permutation.

``dtype`` (each network) is the JAX modules' compute dtype: the dense,
conv, transposed-conv and embedding layers compute in it
(``models/layers.py``) and ``BatchNorm`` reduces in float32, keeps its
running statistics in float32 and returns in it; ``None``, the default,
computes in the parameters' dtype.  Inputs are cast to the parameters'
dtype, not the compute dtype: the JAX networks concatenate (or multiply)
a float32 input with a bfloat16 embedding, which promotes to float32,
and the next layer casts.

``reset_parameters(generator)`` draws flax's initialisation from the
generator: dense, conv and transposed-conv kernels normal with variance
``1 / fan_in`` (untruncated), embeddings normal with variance ``1 /
features``, biases 0, BatchNorm scale 1 and bias 0.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from optwboundeigenval_tpu_torch.models.layers import Conv2d, ConvTranspose2d, Embedding, Linear

DROPOUT = 0.4  # the MLP discriminator's rate (gan.py Discriminator)


def leaky_relu(x: torch.Tensor, slope: float = 0.2) -> torch.Tensor:
    """flax's ``leaky_relu``: ``x`` where ``x >= 0``, else ``slope * x``."""
    return torch.where(x >= 0, x, slope * x)


class BatchNorm(nn.Module):
    """BatchNorm over dim 1 of ``(B, C)`` or ``(B, C, H, W)``, as explicit
    ops: batch mean and two-pass biased variance in train mode, where the
    running statistics also update in place (``(1 - m) * running + m *
    batch``, unbiased variance); the running statistics in eval mode.  A
    compute ``dtype``: reduced and normalised in at least float32, the
    output cast to it (``models/norm.py``)."""

    def __init__(self, num_features: int, eps: float = 1e-5, momentum: float = 0.1,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.eps, self.momentum, self.dtype = eps, momentum, dtype
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def reset_parameters(self) -> None:
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()
            self.running_mean.zero_()
            self.running_var.fill_(1.0)

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        if self.dtype is not None:
            x = x.to(torch.promote_types(self.dtype, torch.float32))
        shape = (1, -1) + (1,) * (x.dim() - 2)
        if train:
            dims = (0,) + tuple(range(2, x.dim()))
            mean = x.mean(dims)
            y = x - mean.reshape(shape)
            var = (y * y).mean(dims)
            n = x.numel() // x.shape[1]
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(1 - m).add_(m * mean)
                self.running_var.mul_(1 - m).add_(m * var * (n / max(n - 1.0, 1.0)))
        else:
            y, var = x - self.running_mean.reshape(shape), self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        out = y * mul.reshape(shape) + self.bias.reshape(shape)
        return out if self.dtype is None else out.to(self.dtype)


@torch.no_grad()
def flax_init(model: nn.Module, generator: Optional[torch.Generator] = None) -> None:
    """flax's default initialisation (untruncated), drawn from ``generator``."""
    for m in model.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d, nn.ConvTranspose2d)):
            w = m.weight
            fan_in = w.shape[1] if isinstance(m, nn.Linear) else (
                w[0].numel() if isinstance(m, nn.Conv2d) else w.shape[0] * w[0, 0].numel())
            w.normal_(0.0, 1.0 / math.sqrt(fan_in), generator=generator)
            m.bias.zero_()
        elif isinstance(m, nn.Embedding):
            m.weight.normal_(0.0, 1.0 / math.sqrt(m.weight.shape[1]), generator=generator)
        elif isinstance(m, BatchNorm):
            m.reset_parameters()


def _dropout(x: torch.Tensor, keep: Optional[torch.Tensor]) -> torch.Tensor:
    """flax ``Dropout(0.4)`` with its keep mask given: ``x / 0.6`` where kept."""
    return torch.where(keep, x / (1.0 - DROPOUT), torch.zeros_like(x))


class MLPGenerator(nn.Module):
    """gan.py Generator: ``[embed(label), z]`` through dense blocks of
    ``n, 2n, 4n, 8n`` (BatchNorm from the second on, with the reference's
    ``BatchNorm1d(out, 0.8)``, which sets eps 0.8, not the momentum), a
    dense layer to the image and Tanh; (B, H, W, C) out."""

    def __init__(self, n_classes: int = 10, latent_dim: int = 100,
                 img_shape: Tuple[int, int, int] = (16, 16, 1), n: int = 128,
                 generator: Optional[torch.Generator] = None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.n_classes, self.latent_dim, self.img_shape = n_classes, latent_dim, tuple(img_shape)
        widths = (n, 2 * n, 4 * n, 8 * n)
        self.label_emb = Embedding(n_classes, n_classes, compute_dtype=dtype)
        ins = (latent_dim + n_classes,) + widths[:-1]
        self.fc = nn.ModuleList(Linear(i, o, compute_dtype=dtype) for i, o in zip(ins, widths))
        self.bn = nn.ModuleList(BatchNorm(w, eps=0.8, dtype=dtype) for w in widths[1:])
        self.out = Linear(widths[-1], math.prod(self.img_shape), compute_dtype=dtype)
        self.reset_parameters(generator)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        flax_init(self, generator)

    def forward(self, z: torch.Tensor, labels: torch.Tensor, train: bool = True):
        x = torch.cat([self.label_emb(labels), z.to(self.out.weight.dtype)], dim=-1)
        for i, fc in enumerate(self.fc):
            x = fc(x)
            if i > 0:  # the first block is unnormalised (gan.py:66)
                x = self.bn[i - 1](x, train)
            x = leaky_relu(x)
        return torch.tanh(self.out(x)).reshape((-1,) + self.img_shape)


class MLPDiscriminator(nn.Module):
    """gan.py Discriminator, logits out: ``[flat image, embed(label)]``
    through dense ``4n`` (LeakyReLU), twice dense ``4n``, dropout 0.4 and
    LeakyReLU, then dense 1.  In train mode ``keep`` holds the two dropout
    layers' keep masks, each (B, 4n) boolean."""

    def __init__(self, n_classes: int = 10, img_dim: int = 256, n: int = 128,
                 generator: Optional[torch.Generator] = None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.label_emb = Embedding(n_classes, n_classes, compute_dtype=dtype)
        self.fc1 = Linear(img_dim + n_classes, 4 * n, compute_dtype=dtype)
        self.fc2 = Linear(4 * n, 4 * n, compute_dtype=dtype)
        self.fc3 = Linear(4 * n, 4 * n, compute_dtype=dtype)
        self.fc4 = Linear(4 * n, 1, compute_dtype=dtype)
        self.reset_parameters(generator)

    @property
    def dropout_shapes(self) -> Sequence[Tuple[int]]:
        """The trailing shape of each dropout layer's keep mask."""
        return ((self.fc2.out_features,), (self.fc3.out_features,))

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        flax_init(self, generator)

    def forward(self, img: torch.Tensor, labels: torch.Tensor, train: bool = True,
                keep: Optional[Sequence[torch.Tensor]] = None):
        if train and keep is None:
            raise ValueError("a train-mode MLPDiscriminator needs its dropout keep masks")
        x = img.reshape(img.shape[0], -1).to(self.fc1.weight.dtype)
        x = leaky_relu(self.fc1(torch.cat([x, self.label_emb(labels)], dim=-1)))
        for i, fc in enumerate((self.fc2, self.fc3)):
            x = fc(x)
            if train:
                x = _dropout(x, keep[i])
            x = leaky_relu(x)
        return self.fc4(x)


class DCGenerator(nn.Module):
    """cGAN.py DCGAN generator: ``z * embed(label)`` as a 1x1 map through
    transposed convolutions of stride 4, 2, 2 (BatchNorm, ReLU) and 2, then
    Tanh; (B, 32, 32, 1) out."""

    def __init__(self, n_classes: int = 10, latent_dim: int = 100, feat: int = 64,
                 generator: Optional[torch.Generator] = None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.latent_dim = latent_dim
        self.label_emb = Embedding(n_classes, latent_dim, compute_dtype=dtype)
        plan = ((latent_dim, 4 * feat, 4), (4 * feat, 2 * feat, 2), (2 * feat, feat, 2))
        self.deconv = nn.ModuleList(ConvTranspose2d(i, o, k, stride=k, compute_dtype=dtype)
                                    for i, o, k in plan)
        self.bn = nn.ModuleList(BatchNorm(o, dtype=dtype) for _, o, _ in plan)
        self.out = ConvTranspose2d(feat, 1, 2, stride=2, compute_dtype=dtype)
        self.reset_parameters(generator)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        flax_init(self, generator)

    def forward(self, z: torch.Tensor, labels: torch.Tensor, train: bool = True):
        x = z.to(self.out.weight.dtype) * self.label_emb(labels)
        x = x.reshape(-1, self.latent_dim, 1, 1)
        for deconv, bn in zip(self.deconv, self.bn):
            x = F.relu(bn(deconv(x), train))
        return torch.tanh(self.out(x)).permute(0, 2, 3, 1)


class DCDiscriminator(nn.Module):
    """cGAN.py DCGAN discriminator: the label embedded as a (32, 32) channel
    beside the image, three 4x4 stride-2 convolutions padded by 1 with
    LeakyReLU 0.2, the HWC flatten and dense 1; logits out."""

    dropout_shapes: Sequence[Tuple[int]] = ()

    def __init__(self, n_classes: int = 10, feat: int = 64, img_size: int = 32,
                 generator: Optional[torch.Generator] = None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.img_size = img_size
        self.label_emb = Embedding(n_classes, img_size * img_size, compute_dtype=dtype)
        chans = (2, feat, 2 * feat, 4 * feat)
        self.conv = nn.ModuleList(Conv2d(i, o, 4, stride=2, padding=1, compute_dtype=dtype)
                                  for i, o in zip(chans[:-1], chans[1:]))
        self.fc = Linear(4 * feat * (img_size // 8) ** 2, 1, compute_dtype=dtype)
        self.reset_parameters(generator)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        flax_init(self, generator)

    def forward(self, img: torch.Tensor, labels: torch.Tensor, train: bool = True,
                keep: Optional[Sequence[torch.Tensor]] = None):
        s = self.img_size
        label = self.label_emb(labels).reshape(-1, 1, s, s)
        x = torch.cat([img.to(self.fc.weight.dtype).permute(0, 3, 1, 2), label], dim=1)
        for conv in self.conv:
            x = leaky_relu(conv(x))
        return self.fc(x.permute(0, 2, 3, 1).reshape(x.shape[0], -1))
