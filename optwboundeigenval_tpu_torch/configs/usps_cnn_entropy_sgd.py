"""USPS CNN with the Entropy-SGD comparator (reference params/usps_CNN_EntropySGD.py).

``options(**overrides)`` takes ``key=value`` overrides as ``main`` does.
"""

from optwboundeigenval_tpu_torch.configs._families import usps_config


def options(**overrides):
    return usps_config(**{"mu": 0.0, "K": 0.0, "optimizer": "entropy_sgd",
                          "pow_iter": False, "ignore_bad_vals": False, **overrides})
