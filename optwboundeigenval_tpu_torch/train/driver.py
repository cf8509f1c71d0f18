"""Config driver (counterpart of ``optwboundeigenval_tpu/train/driver.py``;
only the trainer construction is ported, the run cascade waits).

A config module exports ``options(**overrides) -> dict`` holding live
objects (model, optimizer, loaders) and run flags, the reference's
python-module-as-config pattern (opt.py:1990-1994).  ``build_trainer``
filters that dict into the trainer constructor by reflection
(``missing_params``/``arg_dic``, opt.py:1940-1965).
"""

from __future__ import annotations

import inspect
from typing import Any, Dict

from optwboundeigenval_tpu_torch.train.task import Task, losses
from optwboundeigenval_tpu_torch.train.trainer import SpectralTrainer


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


def build_trainer(options: Dict[str, Any]) -> SpectralTrainer:
    """The trainer a config's options describe.  ``options["device"]``
    (default: the card) is where it runs."""
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
    if options.get("asymmetric_valley", False):
        raise NotImplementedError("AsymmetricValleyTrainer is not ported")
    kwargs = arg_dic(SpectralTrainer.__init__, options)
    for k in ("task", "optimizer", "scheduler"):
        kwargs.pop(k, None)
    return SpectralTrainer(task, options["optimizer"], options.get("scheduler"),
                           **kwargs)
