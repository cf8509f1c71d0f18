"""Forest with the LOBPCG eigensolver: alpha(k) = exp(-4k - 2), kfac_batch 8,
kfac_rand False (reference params/forest_lobpcg.py).

``options(**overrides)`` takes ``key=value`` overrides as ``main`` does.
"""

from optwboundeigenval_tpu_torch.configs._families import forest_config, lobpcg_alpha


def options(**overrides):
    return forest_config(**{"mu": 0.0028, "K": 1.0, "lobpcg": True, "kfac_batch": 8,
                            "kfac_rand": False, "pow_iter_alpha": lobpcg_alpha,
                            "header": "Forest_LOBPCG", "verbose": True, **overrides})
