"""Chest x-ray Asymmetric Valley comparator
(reference params/chestxray_best_reg_AsymmetricValley.py).

``options(**overrides)`` takes ``key=value`` overrides as ``main`` does.
"""

from optwboundeigenval_tpu_torch.configs._cxr_family import chestxray_config


def options(**overrides):
    return chestxray_config(**{"mu": 0.0, "K": 0.0, "optimizer": "sgd",
                               "asymmetric_valley": True, "best_reg": True,
                               "swa_start": 20, "sgd_start": 30, "max_iter": 40,
                               **overrides})
