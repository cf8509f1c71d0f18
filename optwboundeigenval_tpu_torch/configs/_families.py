"""Config factories (counterpart of ``optwboundeigenval_tpu/configs/_families.py``):
the USPS, Forest and CIFAR-10 families.  Each returns the options dict
of ``train/driver.py``; keyword overrides land in it last, so
``forest_config(device="cpu", max_iter=2)`` works as ``main``'s
``key=value`` arguments do.

USPS: params/usps_CNN_mu0_01_K0.py — the CNN, Adam lr 1e-3, batch 128,
cross entropy, tol 0.001; ``test_loader_aug`` holds the two augmented
test loaders, which ``aug_test=True`` evaluates.

Forest: params/forest_best.py — the MLP, SGD lr 0.5 with LambdaLR
``1 / (1 + k)`` on the optimizer's own base lr, mu 0.0028, K 1, batch
128; the comparators take ``lr`` 0.5 from here, USPS's their defaults.

Both take ``lobpcg`` (params/forest_lobpcg.py: the K-FAC-preconditioned
power iteration) and ``asymmetric_valley`` (the Asymmetric Valley
trainer), and ``optimizer`` one of ``adam``, ``sgd``, ``sam`` (SAM over
SGD, rho 0.05), ``entropy_sgd`` (L 5) and ``kfac``.

CIFAR-10: params/cifar10_DenseNet_mu0_01_K100.py — DenseNet-40-12, SGD
lr 0.1 momentum 0.9 weight decay 1e-4, milestone LR 1 / 0.2 / 0.04 at
epochs 60 / 80, batch 32, pow_iter_eps 0.05, max_pow_iter 100, with the
JAX package's defaults ``augment=True``, ``remat=True`` and
``defer_metrics=True``.
"""

from __future__ import annotations

import torch


def lobpcg_alpha(i: int) -> float:
    """The LOBPCG recipes' damping ``exp(-4 i - 2)`` (params/forest_lobpcg.py),
    in float32 as the JAX configs compute it on a float32 ``i``."""
    return float(torch.exp(torch.tensor(-4.0 * i - 2.0, dtype=torch.float32)))


def usps_config(
    mu=0.01,
    K=0.0,
    Kmin=0.0,
    optimizer: str = "adam",
    pow_iter: bool = True,
    lobpcg: bool = False,
    asymmetric_valley: bool = False,
    batch_size: int = 128,
    max_iter: int = 100,
    augment: bool = False,
    **extra,
):
    from optwboundeigenval_tpu_torch.data import usps
    from optwboundeigenval_tpu_torch.models.cnn_usps import CNNUSPS

    opt = {
        "seed": 1226,
        "tol": 0.001,
        "mu": mu,
        "K": K,
        "Kmin": Kmin,
        "batch_size": batch_size,
        "max_iter": max_iter,
        "header": "USPS",
        "model": CNNUSPS(),
        "loss": "cross_entropy",
        "pow_iter": pow_iter,
        "lobpcg": lobpcg,
        "asymmetric_valley": asymmetric_valley,
    }
    opt["train_loader"], opt["valid_loader"] = usps.get_train_valid_loader(
        batch_size=batch_size, augment=augment)
    opt["train_loader_na"] = usps.get_train_loader_na(batch_size=batch_size)
    opt["test_loader"] = [usps.get_test_loader(batch_size=batch_size)]
    opt["test_loader_aug"] = usps.get_test_loader(batch_size=batch_size,
                                                  augment=True)
    opt["optimizer"] = _make_optimizer(optimizer, default_adam=True)
    opt.update(extra)
    return opt


def forest_config(
    mu=0.0028,
    K=1.0,
    Kmin=0.0,
    optimizer: str = "sgd",
    pow_iter: bool = True,
    lobpcg: bool = False,
    asymmetric_valley: bool = False,
    batch_size: int = 128,
    max_iter: int = 100,
    lr: float = 0.5,
    data_root: str = "./data",
    **extra,
):
    from optwboundeigenval_tpu_torch.data import forest
    from optwboundeigenval_tpu_torch.models.mlp_forest import ForestNet
    from optwboundeigenval_tpu_torch.optim import schedules

    opt = {
        "seed": 1226,
        "tol": 0.001,
        "mu": mu,
        "K": K,
        "Kmin": Kmin,
        "batch_size": batch_size,
        "max_iter": max_iter,
        "header": "Forest",
        "model": ForestNet(),
        "loss": "cross_entropy",
        "pow_iter": pow_iter,
        "lobpcg": lobpcg,
        "asymmetric_valley": asymmetric_valley,
    }
    opt.update(forest.get_data(data_root))
    opt["optimizer"] = _make_optimizer(optimizer, lr=lr)
    # beta(k) = 1/(1+k) on the optimizer's base lr (params/forest_best.py)
    base_lr = opt["optimizer"].get_learning_rate(opt["optimizer"].init({}))
    opt["scheduler"] = schedules.LambdaLR(base_lr, lambda k: 1.0 / (1.0 + k))
    opt.update(extra)
    return opt


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


def _make_optimizer(name: str, lr: float = None, default_adam: bool = False):
    """The optimizer ``name`` at the JAX package's default rates
    (_families.py:177-191)."""
    from optwboundeigenval_tpu_torch.optim.api import adam, sgd
    from optwboundeigenval_tpu_torch.optim.entropy_sgd import EntropySGD
    from optwboundeigenval_tpu_torch.optim.kfac_optimizer import KFAC
    from optwboundeigenval_tpu_torch.optim.sam import SAM

    name = name.lower()
    if name == "adam":
        return adam(lr or 1e-3)
    if name == "sgd":
        return sgd(lr or (0.1 if not default_adam else 0.5))
    if name == "sam":
        return SAM(sgd(lr or 0.1), rho=0.05)
    if name == "entropy_sgd":
        return EntropySGD(lr=lr or 0.1, L=5)
    if name == "kfac":
        return KFAC(lr=lr or 0.001)
    raise ValueError(f"unknown optimizer {name}")
