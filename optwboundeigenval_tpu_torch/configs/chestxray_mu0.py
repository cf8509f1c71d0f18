"""Chest x-ray DenseNet121 recipe (reference params/chestxray_mu0.py).

``options(**overrides)`` takes ``key=value`` overrides as ``main`` does.
"""

from optwboundeigenval_tpu_torch.configs._cxr_family import chestxray_config


def options(**overrides):
    return chestxray_config(**{"mu": 0.0, "K": 0.0, **overrides})
