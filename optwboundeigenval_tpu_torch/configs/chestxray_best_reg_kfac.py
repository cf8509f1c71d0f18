"""Chest x-ray KFAC comparator (reference params/chestxray_best_reg_KFAC.py).

``options(**overrides)`` takes ``key=value`` overrides as ``main`` does.
"""

from optwboundeigenval_tpu_torch.configs._cxr_family import chestxray_config


def options(**overrides):
    return chestxray_config(**{"mu": 0.0, "K": 0.0, "optimizer": "kfac", "pow_iter": False,
                               "best_reg": True, **overrides})
