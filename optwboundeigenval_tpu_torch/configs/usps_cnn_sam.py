"""USPS CNN with the SAM comparator (reference params/usps_SAM.py).

``options(**overrides)`` takes ``key=value`` overrides as ``main`` does.
"""

from optwboundeigenval_tpu_torch.configs._families import usps_config


def options(**overrides):
    return usps_config(**{"mu": 0.0, "K": 0.0, "optimizer": "sam", "pow_iter": False,
                          **overrides})
