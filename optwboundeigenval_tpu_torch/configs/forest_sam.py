"""Forest with the SAM comparator (reference params/forest_SAM.py).

``options(**overrides)`` takes ``key=value`` overrides as ``main`` does.
"""

from optwboundeigenval_tpu_torch.configs._families import forest_config


def options(**overrides):
    return forest_config(**{"mu": 0.0, "K": 0.0, "optimizer": "sam", "pow_iter": False,
                            **overrides})
