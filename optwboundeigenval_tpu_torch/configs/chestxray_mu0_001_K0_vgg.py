"""Chest x-ray VGG16-bn spectral reg (reference params/chestxray_mu0_001_K0_vgg.py).

``options(**overrides)`` takes ``key=value`` overrides as ``main`` does.
"""

from optwboundeigenval_tpu_torch.configs._cxr_family import chestxray_config


def options(**overrides):
    return chestxray_config(**{"mu": 0.001, "K": 0.0, "enc": "vgg16_bn", **overrides})
