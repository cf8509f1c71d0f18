"""Forest with the Asymmetric Valley trainer: SWA from epoch 161, the SGD
hunt from 201, 250 epochs (reference params/forest_AsymmetricValley.py).

``options(**overrides)`` takes ``key=value`` overrides as ``main`` does.
"""

from optwboundeigenval_tpu_torch.configs._families import forest_config


def options(**overrides):
    return forest_config(**{"mu": 0.0, "K": 0.0, "asymmetric_valley": True,
                            "swa_start": 161, "sgd_start": 201, "max_iter": 250,
                            **overrides})
