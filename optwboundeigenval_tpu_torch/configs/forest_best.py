"""Forest CoverType MLP recipe: mu 0.0028, K 1, SGD lr 0.5, LambdaLR
1/(1+k) (reference params/forest_best.py).

``options(**overrides)`` takes ``key=value`` overrides as ``main`` does.
"""

from optwboundeigenval_tpu_torch.configs._families import forest_config


def options(**overrides):
    return forest_config(**{"mu": 0.0028, "K": 1.0, **overrides})
