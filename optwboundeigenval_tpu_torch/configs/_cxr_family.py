"""Chest x-ray config factory (counterpart of
``optwboundeigenval_tpu/configs/_cxr_family.py``), the JAX recipe
unchanged: params/chestxray_best_reg.py and the mu/K grid
params/chestxray_mu*.py.

``CXRModel`` (DenseNet-121 trunk by default, ``enc`` picks another) on
NIH ChestX-ray14 with 14 outputs, weighted BCE with logits, Adam lr 1e-5
and weight decay 1e-5 under ``ReduceLROnPlateau(patience=5)`` fed the
train loss, batch 4, ``test_func='accauc sigmoid'``, ``pow_iter_eps``
0.1, ``max_pow_iter`` 100, ``remat``, ``defer_metrics``,
``ignore_bad_vals=False``; the plain test cascade off (``test=False``)
and ``comp_test`` on over the NIH test set and the CheXpert and MIMIC
validation sets, whose 13-class spaces meet NIH's in the classes they
share (``model_class_to_idx``).  ``best_reg`` adds ``rand_init``,
``gradg_clip`` 100 and ``eigensolver='auto'`` (the early-exit Lanczos
solver under ``rand_init``; LOBPCG resolves to its own).  The other
optimizers take the JAX package's rates: SGD 0.01 momentum 0.9, SAM
over SGD 0.01 (rho 0.05), Entropy-SGD 0.01 (L 5), K-FAC 0.001.

Roots come from ``NIH_CXR_ROOT``, ``CHEXPERT_ROOT`` and ``MIMIC_CXR_ROOT``
(real images need PIL); where ``NIH_CXR_ROOT`` is unset the loaders are
the 64 px synthetic stand-ins.  ``options(**overrides)`` lands the
overrides last, as ``main``'s ``key=value`` arguments.
"""

from __future__ import annotations

import os


def chestxray_config(
    mu=0.01,
    K=0.0,
    Kmin=0.0,
    enc: str = "densenet121",
    optimizer: str = "adam",
    pow_iter: bool = True,
    lobpcg: bool = False,
    asymmetric_valley: bool = False,
    batch_size: int = 4,
    max_iter: int = 50,
    best_reg: bool = False,
    image_size: int = 224,
    synthetic_n: int = 128,
    **extra,
):
    from optwboundeigenval_tpu_torch.data import chestxray as cxr
    from optwboundeigenval_tpu_torch.models.cxr import CXRModel
    from optwboundeigenval_tpu_torch.optim import schedules
    from optwboundeigenval_tpu_torch.optim.api import adam, sgd
    from optwboundeigenval_tpu_torch.optim.entropy_sgd import EntropySGD
    from optwboundeigenval_tpu_torch.optim.kfac_optimizer import KFAC
    from optwboundeigenval_tpu_torch.optim.sam import SAM

    nih_root = os.environ.get("NIH_CXR_ROOT")
    chexpert_root = os.environ.get("CHEXPERT_ROOT")
    mimic_root = os.environ.get("MIMIC_CXR_ROOT")
    size = image_size if nih_root else 64

    opt = {
        "seed": 1226,
        "tol": 0.001,
        "mu": mu,
        "K": K,
        "Kmin": Kmin,
        "batch_size": batch_size,
        "max_iter": max_iter,
        "header": f"chestxray_{enc}",
        "model": CXRModel(backbone=enc, outnum=14),
        "has_batch_stats": True,
        "loss": "weighted_bce_with_logits",
        "test_func": "accauc sigmoid",
        "pow_iter": pow_iter,
        "pow_iter_eps": 0.1,
        "max_pow_iter": 100,
        "remat": True,
        "defer_metrics": True,
        "ignore_bad_vals": False,
        "lobpcg": lobpcg,
        "asymmetric_valley": asymmetric_valley,
        "crops": False,
        "model_class_to_idx": cxr.NIH_CLASSES,
        "test": False,
        "comp_test": True,
    }
    if best_reg:
        opt.update({"rand_init": True, "gradg_clip": 100.0, "eigensolver": "auto"})

    common = dict(batch_size=batch_size, size=size, synthetic_n=synthetic_n)
    opt["train_loader"] = cxr.get_nih_loader("train", root=nih_root, **common)
    opt["valid_loader"] = cxr.get_nih_loader("validation", root=nih_root, **common)
    opt["test_loader"] = [
        cxr.get_nih_loader("test", root=nih_root, **common),
        cxr.get_chexpert_loader("validation", root=chexpert_root, **common),
        cxr.get_mimic_loader("validation", root=mimic_root, **common),
    ]

    name = optimizer.lower()
    if name == "adam":
        opt["optimizer"] = adam(1e-5, weight_decay=1e-5)
        opt["scheduler"] = schedules.ReduceLROnPlateau(1e-5, patience=5)
    elif name == "sgd":
        opt["optimizer"] = sgd(0.01, momentum=0.9)
    elif name == "sam":
        opt["optimizer"] = SAM(sgd(0.01), rho=0.05)
    elif name == "entropy_sgd":
        opt["optimizer"] = EntropySGD(lr=0.01, L=5)
    elif name == "kfac":
        opt["optimizer"] = KFAC(lr=0.001)
    else:
        raise ValueError(name)
    opt.update(extra)
    return opt
