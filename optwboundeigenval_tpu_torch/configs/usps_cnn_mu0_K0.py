"""USPS CNN recipe, mu 0.0, K 0.0 (reference params/usps_CNN_mu0_K0.py).

``options(**overrides)`` takes ``key=value`` overrides as ``main`` does.
"""

from optwboundeigenval_tpu_torch.configs._families import usps_config


def options(**overrides):
    return usps_config(**{"mu": 0.0, "K": 0.0, **overrides})
