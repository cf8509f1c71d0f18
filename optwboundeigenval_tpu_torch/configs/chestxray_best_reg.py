"""Chest x-ray best regularized model (reference params/chestxray_best_reg.py:
Adam 1e-5, rand_init, gradg_clip=100, accauc sigmoid eval, TenCrop).

``options(**overrides)`` takes ``key=value`` overrides as ``main`` does.
"""

from optwboundeigenval_tpu_torch.configs._cxr_family import chestxray_config


def options(**overrides):
    return chestxray_config(**{"mu": 0.01, "K": 0.0, "best_reg": True, **overrides})
