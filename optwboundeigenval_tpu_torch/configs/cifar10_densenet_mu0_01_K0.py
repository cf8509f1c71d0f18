"""CIFAR-10 DenseNet-40-12 recipe (reference params/cifar10_DenseNet_mu0_01_K0.py).

``options(**overrides)`` takes ``key=value`` overrides as ``main.py``
does, e.g. ``options(remat=False, hvp_micro=2, augment=False)``.
"""

from optwboundeigenval_tpu_torch.configs._families import cifar10_config


def options(**overrides):
    return cifar10_config(**{"mu": 0.01, "K": 0.0, **overrides})
