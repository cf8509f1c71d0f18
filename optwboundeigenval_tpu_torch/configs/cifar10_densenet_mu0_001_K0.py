"""CIFAR-10 DenseNet-40-12 recipe, mu 0.001, K 0.0 (reference params/cifar10_DenseNet_mu0_001_K0.py).

``options(**overrides)`` takes ``key=value`` overrides as ``main`` does,
e.g. ``options(remat=False, augment=False)``.
"""

from optwboundeigenval_tpu_torch.configs._families import cifar10_config


def options(**overrides):
    return cifar10_config(**{"mu": 0.001, "K": 0.0, **overrides})
