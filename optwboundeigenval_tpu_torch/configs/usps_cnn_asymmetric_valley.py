"""USPS CNN with the Asymmetric Valley trainer: SGD, SWA from epoch 161, the
SGD hunt from 201, 250 epochs (reference params/usps_CNN_AsymmetricValley.py).

``options(**overrides)`` takes ``key=value`` overrides as ``main`` does.
"""

from optwboundeigenval_tpu_torch.configs._families import usps_config


def options(**overrides):
    return usps_config(**{"mu": 0.0, "K": 0.0, "optimizer": "sgd",
                          "asymmetric_valley": True, "swa_start": 161,
                          "sgd_start": 201, "max_iter": 250, **overrides})
