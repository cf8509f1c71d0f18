"""Forest with the Entropy-SGD comparator (reference params/forest_EntropySGD.py).

``options(**overrides)`` takes ``key=value`` overrides as ``main`` does.
"""

from optwboundeigenval_tpu_torch.configs._families import forest_config


def options(**overrides):
    return forest_config(**{"mu": 0.0, "K": 0.0, "optimizer": "entropy_sgd", "pow_iter": False,
                            **overrides})
