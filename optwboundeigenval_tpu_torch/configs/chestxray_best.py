"""Chest x-ray best unregularized model (reference params/chestxray_best.py).

``options(**overrides)`` takes ``key=value`` overrides as ``main`` does.
"""

from optwboundeigenval_tpu_torch.configs._cxr_family import chestxray_config


def options(**overrides):
    return chestxray_config(**{"mu": 0.0, "K": 0.0, "best_reg": True, **overrides})
