"""Chest x-ray VGG16-bn unregularized (reference params/chestxray_mu0_vgg.py).

``options(**overrides)`` takes ``key=value`` overrides as ``main`` does.
"""

from optwboundeigenval_tpu_torch.configs._cxr_family import chestxray_config


def options(**overrides):
    return chestxray_config(**{"mu": 0.0, "K": 0.0, "enc": "vgg16_bn", **overrides})
