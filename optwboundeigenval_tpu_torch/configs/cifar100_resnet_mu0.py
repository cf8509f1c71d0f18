"""CIFAR-100 ResNet50-head recipe (reference params/cifar100_ResNet_mu0.py):
``CXRModel(backbone="resnet50", outnum=100)`` on CIFAR-100 with Adam 1e-3,
no scheduler, unregularized (``mu`` 0, ``K`` 0); the rest is the CIFAR-10
DenseNet-40 recipe's (batch 32, augmentation, ``remat``,
``defer_metrics``, ``pow_iter_eps`` 0.05).

``options(**overrides)`` takes ``key=value`` overrides as ``main`` does.
"""

from optwboundeigenval_tpu_torch.configs._families import cifar10_config


def options(**overrides):
    from optwboundeigenval_tpu_torch.data import cifar
    from optwboundeigenval_tpu_torch.models.cxr import CXRModel
    from optwboundeigenval_tpu_torch.optim.api import adam

    opt = cifar10_config(**{"mu": 0.0, "K": 0.0, **overrides})
    bs = opt["batch_size"]
    (opt["train_loader"], opt["valid_loader"], opt["train_loader_na"]) = \
        cifar.get_train_valid_loader(batch_size=bs, augment=overrides.get("augment", True),
                                     name="cifar100")
    opt["test_loader"] = [cifar.get_test_loader(batch_size=bs, name="cifar100")]
    opt.update(model=CXRModel(backbone="resnet50", outnum=100), optimizer=adam(1e-3),
               scheduler=None, header="CIFAR100_ResNet")
    opt.update({k: v for k, v in overrides.items()
                if k in ("model", "optimizer", "scheduler", "header")})
    return opt
