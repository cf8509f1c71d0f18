"""USPS CNN recipe, mu 0.1, K 2.0 (reference params/usps_CNN_mu0_1_K2.py).

``options(**overrides)`` takes ``key=value`` overrides as ``main`` does.
"""

from optwboundeigenval_tpu_torch.configs._families import usps_config


def options(**overrides):
    return usps_config(**{"mu": 0.1, "K": 2.0, **overrides})
