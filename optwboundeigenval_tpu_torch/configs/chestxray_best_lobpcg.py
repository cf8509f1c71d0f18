"""Chest x-ray best model with LOBPCG eigensolver
(reference params/chestxray_best_lobpcg.py; its dead `res_step` option is
intentionally not reproduced — consumed by nothing in the reference).

``options(**overrides)`` takes ``key=value`` overrides as ``main`` does.
"""

from optwboundeigenval_tpu_torch.configs._cxr_family import chestxray_config


def options(**overrides):
    return chestxray_config(**{"mu": 0.01, "K": 0.0, "best_reg": True, "lobpcg": True,
                               "kfac_batch": 8, **overrides})
