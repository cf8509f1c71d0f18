"""Forest CoverType MLP, the unregularized control: mu 0, K 0 (reference
params/forest_unreg.py).

``options(**overrides)`` takes ``key=value`` overrides as ``main`` does.
"""

from optwboundeigenval_tpu_torch.configs._families import forest_config


def options(**overrides):
    return forest_config(**{"mu": 0.0, "K": 0.0, **overrides})
