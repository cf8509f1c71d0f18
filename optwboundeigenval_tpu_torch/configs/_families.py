"""Config factories (counterpart of ``optwboundeigenval_tpu/configs/_families.py``;
only the CIFAR-10 family so far).

CIFAR-10: params/cifar10_DenseNet_mu0_01_K100.py — DenseNet-40-12, SGD
lr 0.1 momentum 0.9 weight decay 1e-4, milestone LR 1 / 0.2 / 0.04 at
epochs 60 / 80, batch 32, pow_iter_eps 0.05, max_pow_iter 100.  The
defaults are the JAX package's; ``remat=True`` and ``augment=True`` are
not ported yet and raise until overridden.
"""

from __future__ import annotations


def cifar10_config(
    mu=0.01,
    K=100.0,
    Kmin=0.0,
    pow_iter: bool = True,
    batch_size: int = 32,
    max_iter: int = 100,
    augment: bool = True,
    **extra,
):
    from optwboundeigenval_tpu_torch.data import cifar
    from optwboundeigenval_tpu_torch.models.densenet import DenseNet3
    from optwboundeigenval_tpu_torch.optim import schedules
    from optwboundeigenval_tpu_torch.optim.api import sgd

    opt = {
        "seed": 1226,
        "tol": 0.001,
        "mu": mu,
        "K": K,
        "Kmin": Kmin,
        "batch_size": batch_size,
        "max_iter": max_iter,
        "header": "CIFAR10_DenseNet",
        "model": DenseNet3(depth=40, growth_rate=12, num_classes=10),
        "has_batch_stats": True,
        "loss": "cross_entropy",
        "pow_iter": pow_iter,
        "pow_iter_eps": 0.05,
        "max_pow_iter": 100,
        "remat": True,
        "defer_metrics": True,
    }
    (
        opt["train_loader"],
        opt["valid_loader"],
        opt["train_loader_na"],
    ) = cifar.get_train_valid_loader(batch_size=batch_size, augment=augment)
    opt["test_loader"] = [cifar.get_test_loader(batch_size=batch_size)]
    opt["optimizer"] = sgd(0.1, momentum=0.9, weight_decay=1e-4)

    def alpha(i):
        if i < 60:
            return 1.0
        elif i < 80:
            return 0.2
        return 0.2**2

    opt["scheduler"] = schedules.LambdaLR(0.1, alpha)
    opt.update(extra)
    return opt
