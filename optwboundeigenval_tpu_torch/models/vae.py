"""VAE over a feature trunk, and its loss (counterpart of
``optwboundeigenval_tpu/models/vae.py``): the reference's ``VAE``
(dcnn.py:343-372) and ``VLoss`` (dcnn.py:403-414).

The encoder is a trunk of ``models/backbones.py`` (NCHW in and out) or
any module of the port that maps the batch to features (a ``ForestNet``);
its ReLU'd output, if a map, is reduced by a spatial max, ``mu_fc`` and ``logv_fc`` give
``(mu, logvar)``, ``z = mu + exp(logvar / 2) * noise`` in train mode (``mu``
in eval mode), and ``de1`` (ReLU) and ``de2`` decode ``outnum`` logits.
An image input is NHWC, as the JAX batch is, permuted to NCHW once.  The train
mode's standard-normal ``noise`` comes from an explicit ``generator`` on
the parameters' device, or is given (``noise=``), which is how the tests
inject the JAX package's draw.  Like the reference, no config uses it;
``train/legacy.train2_epoch`` trains it.  ``dtype`` is the JAX model's
compute dtype of the four dense layers (``None``: the parameters'); the
encoder has its own, and the noise is drawn in ``std``'s dtype, as
``jax.random.normal(rng, std.shape, std.dtype)`` draws it.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from optwboundeigenval_tpu_torch.models.activations import relu
from optwboundeigenval_tpu_torch.models.layers import Linear
from optwboundeigenval_tpu_torch.models.mlp_forest import reset_torch_default
from optwboundeigenval_tpu_torch.train.task import weighted_bce_with_logits


class VAE(nn.Module):
    def __init__(self, encoder: nn.Module, znum: int = 128, hnum: int = 256,
                 outnum: int = 14, in_features: Optional[int] = None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.encoder = encoder
        in_features = in_features or encoder.out_channels
        self.mu_fc = Linear(in_features, znum, compute_dtype=dtype)
        self.logv_fc = Linear(in_features, znum, compute_dtype=dtype)
        self.de1 = Linear(znum, hnum, compute_dtype=dtype)
        self.de2 = Linear(hnum, outnum, compute_dtype=dtype)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        self.encoder.reset_parameters(generator)
        for m in (self.mu_fc, self.logv_fc, self.de1, self.de2):
            reset_torch_default(m, generator)

    def forward(self, x: torch.Tensor, train: bool = False,
                stats_out: Optional[dict] = None,
                noise: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        """``(logits, mu, logvar)``; train mode needs ``noise`` or a
        ``generator``."""
        if x.dim() == 4:
            x = x.permute(0, 3, 1, 2).contiguous()
        x = x.to(self.mu_fc.weight.dtype)
        h = relu(self.encoder(x, train, stats_out))
        h = torch.amax(h, dim=(2, 3)) if h.dim() == 4 else h
        mu, logvar = self.mu_fc(h), self.logv_fc(h)
        if train:
            std = torch.exp(0.5 * logvar)
            if noise is None:
                if generator is None:
                    raise ValueError("a train-mode VAE pass needs noise or a generator")
                noise = torch.randn(std.shape, generator=generator, device=std.device,
                                    dtype=std.dtype)
            z = mu + std * noise.to(std.device, std.dtype)
        else:
            z = mu
        return self.de2(relu(self.de1(z))), mu, logvar


def vae_loss(outputs, y, w=None, kl_weight: float = 0.0) -> torch.Tensor:
    """W-BCE reconstruction plus ``kl_weight`` times the KL divergence."""
    recon, mu, logvar = outputs
    kld = -0.5 * torch.sum(1 + logvar - mu ** 2 - torch.exp(logvar))
    return weighted_bce_with_logits(recon, y, w) + kl_weight * kld
