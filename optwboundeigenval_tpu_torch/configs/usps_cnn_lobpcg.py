"""USPS CNN with the LOBPCG eigensolver (reference params/usps_CNN_lobpcg.py).

``options(**overrides)`` takes ``key=value`` overrides as ``main`` does.
"""

from optwboundeigenval_tpu_torch.configs._families import lobpcg_alpha, usps_config


def options(**overrides):
    return usps_config(**{"mu": 0.01, "K": 0.0, "lobpcg": True, "kfac_batch": 8,
                          "kfac_rand": False, "pow_iter_alpha": lobpcg_alpha,
                          **overrides})
