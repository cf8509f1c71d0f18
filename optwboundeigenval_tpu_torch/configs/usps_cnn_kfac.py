"""USPS CNN with the K-FAC comparator (reference params/usps_CNN_KFAC.py).

``options(**overrides)`` takes ``key=value`` overrides as ``main`` does.
"""

from optwboundeigenval_tpu_torch.configs._families import usps_config


def options(**overrides):
    return usps_config(**{"mu": 0.0, "K": 0.0, "optimizer": "kfac", "pow_iter": False,
                          "ignore_bad_vals": False, **overrides})
