"""Config driver (counterpart of ``optwboundeigenval_tpu/train/driver.py``).

A config module exports ``options(**overrides) -> dict`` holding live
objects (model, optimizer, loaders) and run flags, the reference's
python-module-as-config pattern (opt.py:1990-1994).  ``build_trainer``
passes that dict into the trainer constructor by reflection
(``missing_params``/``arg_dic``, opt.py:1940-1965, with ``tol`` read as
``eps``), and ``run`` executes the cascade train -> test -> parse ->
aug_test -> comp_test -> rho_test -> saliency -> jaccard -> jaccard_comp
off the option flags (opt.py:2018-2102; ``comp_test`` is
``analysis/comp.py``, the chest x-ray recipes' cross-dataset evaluation
over the classes shared with ``model_class_to_idx``).

The analysis routes run on the first test loader (``saliency``: every
test loader): ``saliency`` writes up to ``max_img`` (10) maps
(``analysis/saliency.saliency_maps``); ``jaccard`` audits the trained
model's maps against a baseline, ``baseline_trainer`` or a trainer of the
same options loaded from ``comp_fname`` (the first of a list), with
``saliency_method`` (``saliency``, ``guided`` or ``gradcam`` on the
module ``cam_layer``) and ``max_img`` (25) triptychs; ``jaccard_comp``
compares the model with the trainers ``comp_trainers``.  CSVs go to the
trainer's ``log_dir`` (the JAX driver writes them to ``./logs``), figures
and the saliency ``.npz`` to ``plot_dir`` (``./plots``).  ``jaccard``
without a baseline and ``jaccard_comp`` without ``comp_trainers`` raise
(the JAX driver skips them without a word).
``pretrained_npz`` overlays converted ImageNet weights on the fresh
parameters before training (``models/backbones.load_pretrained_npz``,
scoped by ``pretrained_prefix``, default ``"features"``).

``asymmetric_valley=True`` builds ``AsymmetricValleyTrainer`` with its
own keywords (``swa_start``, ``sgd_start``, ...) beside the trainer's
(JAX driver.py:56-69).  An option that is neither a trainer argument,
an Asymmetric Valley argument nor one the driver reads raises, so a
setting the port does not implement is never dropped without a word.
``has_dropout=True`` builds a dropout ``Task``: the trainer draws one
dropout key a step (``models/dropout.py``).  ``device_data=True`` puts
the train set on the trainer's device (``data/device.as_device_loader``,
with ``device_transform`` and ``device_augment``, e.g.
``cifar_augment_device`` in place of a host augmentation; a
``PrefetchLoader`` around the train loader is dropped); a train loader
that is not an ``ArrayLoader`` then raises (JAX driver.py:106-120 keeps
it on the host without a word).  ``mesh`` is the trainer's
(``parallel/mesh.py``).

``allow_tf32`` (default False) sets whether the card's float32
convolutions and matmuls may run in TF32 (``utils/precision.set_tf32``,
both flags from the one option); ``run`` sets it before it builds the
trainer and prints both settings.  The JAX package has no such switch.
A model's compute dtype comes in with the live ``model`` option, as in
the JAX package (``options(model=DenseNet3(dtype=torch.bfloat16))``).
"""

from __future__ import annotations

import importlib
import inspect
from typing import Any, Dict

import numpy as np

from optwboundeigenval_tpu_torch.analysis.comp import comp_test
from optwboundeigenval_tpu_torch.analysis.jaccard import jaccard_audit, jaccard_comp
from optwboundeigenval_tpu_torch.analysis.saliency import saliency_maps
from optwboundeigenval_tpu_torch.data.device import as_device_loader
from optwboundeigenval_tpu_torch.data.loaders import ArrayLoader
from optwboundeigenval_tpu_torch.models.backbones import load_pretrained_npz
from optwboundeigenval_tpu_torch.train.asymmetric_valley import AsymmetricValleyTrainer
from optwboundeigenval_tpu_torch.train.task import Task, losses
from optwboundeigenval_tpu_torch.train.trainer import SpectralTrainer
from optwboundeigenval_tpu_torch.utils import precision

_REPLACE = {"tol": "eps"}  # option name -> trainer argument (driver.py:52)
# options the driver and the task read, beside the trainer's arguments
_DRIVER_KEYS = {
    "task", "model", "loss", "has_batch_stats", "has_dropout", "optimizer",
    "scheduler", "inputs", "target", "inputs_valid", "target_valid",
    "inputs_test", "target_test", "train_loader", "valid_loader",
    "train_loader_na", "test_loader", "test_loader_aug", "train", "test",
    "fname", "aug_test", "rho_test", "crops", "asymmetric_valley", "comp_test",
    "pretrained_npz", "pretrained_prefix", "model_class_to_idx",
    # the analysis routes
    "saliency", "jaccard", "jaccard_comp", "comp_fname", "baseline_trainer",
    "comp_trainers", "saliency_method", "cam_layer", "max_img",
    # the test cascade's class subsetting (test_model's keywords)
    "classes", "model_classes", "other_classes",
    # data facts the Forest loader returns beside its arrays
    "scaler_mean", "scaler_scale",
    # the train set on the device
    "device_data", "device_transform", "device_augment",
    # TF32 in the card's float32 convolutions and matmuls
    "allow_tf32",
}
_TEST_KEYS = ("classes", "model_classes", "other_classes")


def arg_dic(fn, options: Dict[str, Any], replace=None) -> Dict[str, Any]:
    """Filter ``options`` down to the keyword arguments ``fn`` accepts
    (opt.py:1963-1965); ``replace`` maps option names to argument names
    (opt.py:2009)."""
    names = set(inspect.signature(fn).parameters)
    out = {k: v for k, v in options.items() if k in names}
    for src, dst in (replace or {}).items():
        if src in options and dst in names:
            out[dst] = options[src]
    return out


def _check_known(options: Dict[str, Any]) -> None:
    known = (set(inspect.signature(SpectralTrainer.__init__).parameters)
             | set(inspect.signature(AsymmetricValleyTrainer.__init__).parameters)
             | set(_REPLACE) | _DRIVER_KEYS)
    unknown = sorted(set(options) - known)
    if unknown:
        raise NotImplementedError(f"options {unknown} are not known to the port")
    if options.get("jaccard") and not (options.get("baseline_trainer") is not None
                                       or options.get("comp_fname")):
        raise ValueError("jaccard=True needs baseline_trainer or comp_fname")
    if options.get("jaccard_comp") and not options.get("comp_trainers"):
        raise ValueError("jaccard_comp=True needs comp_trainers")


def build_trainer(options: Dict[str, Any]) -> SpectralTrainer:
    """The trainer a config's options describe (an
    ``AsymmetricValleyTrainer`` under ``asymmetric_valley``).
    ``options["device"]`` (default: the card) is where it runs."""
    _check_known(options)
    task = options.get("task")
    if task is None:
        loss = options.get("loss", "cross_entropy")
        if isinstance(loss, str):
            loss = losses[loss]
        task = Task(
            model=options["model"],
            loss=loss,
            has_batch_stats=options.get("has_batch_stats", False),
            has_dropout=options.get("has_dropout", False),
        )
    kwargs = arg_dic(SpectralTrainer.__init__, options, replace=_REPLACE)
    trainer = SpectralTrainer
    if options.get("asymmetric_valley"):
        kwargs = {**arg_dic(AsymmetricValleyTrainer.__init__, options), **kwargs}
        trainer = AsymmetricValleyTrainer
    for k in ("task", "optimizer", "scheduler"):
        kwargs.pop(k, None)
    return trainer(task, options["optimizer"], options.get("scheduler"), **kwargs)


def _loaders(options, batch_size):
    """Wrap raw arrays into loaders (assert_dl, opt.py:1969-1973)."""

    def get(key_loader, key_x, key_y):
        if options.get(key_loader) is not None:
            return options[key_loader]
        if options.get(key_x) is not None:
            return ArrayLoader(np.asarray(options[key_x]),
                               np.asarray(options[key_y]), batch_size)
        return None

    train_loader = get("train_loader", "inputs", "target")
    valid_loader = get("valid_loader", "inputs_valid", "target_valid")
    test_loaders = get("test_loader", "inputs_test", "target_test")
    if test_loaders is not None and not isinstance(test_loaders, list):
        test_loaders = [test_loaders]
    return train_loader, valid_loader, test_loaders


def run(options: Dict[str, Any]) -> SpectralTrainer:
    """Execute the cascade (opt.py:2012-2102) and return the trainer."""
    print(precision.describe(precision.set_tf32(options.get("allow_tf32", False))))
    trainer = build_trainer(options)
    train_loader, valid_loader, test_loaders = _loaders(
        options, options.get("batch_size", 128))
    if options.get("device_data"):
        # a prefetch thread hides host batch assembly, which the device
        # dataset does away with
        train_loader = getattr(train_loader, "loader", train_loader)
        if not isinstance(train_loader, ArrayLoader):
            raise ValueError("device_data=True needs an ArrayLoader train loader, "
                             f"not {type(train_loader).__name__}")
        train_loader = as_device_loader(train_loader, transform=options.get("device_transform"),
                                        augment=options.get("device_augment"),
                                        device=trainer.device)
    train_loader_na = options.get("train_loader_na")
    crops = options.get("crops", False)

    if options.get("pretrained_npz"):
        trainer.init_state()
        trainer.params, trainer.model_state = load_pretrained_npz(
            trainer.task.model, trainer.params, trainer.model_state,
            options["pretrained_npz"], prefix=options.get("pretrained_prefix", "features"))

    if options.get("train", True):
        trainer.train(train_loader=train_loader, valid_loader=valid_loader,
                      train_loader_na=train_loader_na, crops=crops)
    else:
        trainer.model_load(options.get("fname"))

    if options.get("test", True) and test_loaders:
        subset = {k: options[k] for k in _TEST_KEYS if k in options}
        for tl in test_loaders:
            trainer.test_set(loader=tl, label="Test", crops=crops, **subset)

    trainer.parse()

    if options.get("aug_test", False) and options.get("test_loader_aug") is not None:
        tla = options["test_loader_aug"]
        for tl in tla if isinstance(tla, list) else [tla]:
            trainer.test_set(loader=tl, label="Aug Test", crops=crops)

    if options.get("comp_test", False) and test_loaders:
        comp_test(trainer, test_loaders, options)

    if options.get("rho_test", False):
        trainer.rho_test(loader=train_loader_na if train_loader_na is not None
                         else train_loader)

    if test_loaders:
        _analysis(trainer, test_loaders, options)
    return trainer


def _analysis(trainer, test_loaders, options) -> None:
    """The saliency, jaccard and jaccard_comp routes (JAX driver.py:195-229)."""
    plot_dir = options.get("plot_dir", "./plots")
    method = options.get("saliency_method", "saliency")
    cam_layer = options.get("cam_layer")
    if options.get("saliency", False):
        for tl in test_loaders:
            saliency_maps(trainer, tl, max_img=options.get("max_img", 10), plot_dir=plot_dir)
    if options.get("jaccard", False):
        baseline = options.get("baseline_trainer")
        if baseline is None:
            baseline = build_trainer(options)
            fname = options["comp_fname"]
            baseline.model_load(fname[0] if isinstance(fname, list) else fname)
        jaccard_audit(trainer, baseline, test_loaders[0], max_img=options.get("max_img", 25),
                      method=method, layer_path=cam_layer, log_dir=trainer.log_dir,
                      plot_dir=plot_dir)
    if options.get("jaccard_comp", False):
        jaccard_comp([trainer] + list(options["comp_trainers"]), test_loaders[0],
                     method=method, layer_path=cam_layer, log_dir=trainer.log_dir)


def main(config_name: str, **overrides) -> SpectralTrainer:
    """``run`` on the options of the config module ``config_name``."""
    return run(importlib.import_module(config_name).options(**overrides))
