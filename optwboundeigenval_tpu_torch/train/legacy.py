"""Legacy standalone training loops (counterpart of
``optwboundeigenval_tpu/train/legacy.py``): the reference's chest x-ray
helpers from before ``OptWBoundEignVal`` (dcnn.py:418-579), plain
unregularized epochs, ``validate``, the sigmoid ``test`` with per-class
AUC, and copy-on-best checkpoints.

Two quirks of the JAX package, kept so that the loops agree with it:
``train_epoch`` updates the BatchNorm running statistics at the
POST-step parameters (the spectral trainer does it at the pre-step
ones), and ``train2_epoch`` never updates them (its step returns no model
state).  Randomness comes from a ``torch.Generator``: the optimizer's
``rng``, a dropout task's key per batch, the VAE's noise per batch
(``noises`` gives them instead).  The AUC is the port's numpy one
(``trainer.roc_auc``): a class with one label value gives NaN where
sklearn raises.
"""

from __future__ import annotations

import os
import shutil
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
from torch.func import functional_call

from optwboundeigenval_tpu_torch.ops import curvature
from optwboundeigenval_tpu_torch.train import checkpoints
from optwboundeigenval_tpu_torch.train.trainer import roc_auc
from optwboundeigenval_tpu_torch.utils.precision import host


class AverageMeter:
    """Running average (dcnn.py AverageMeter)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val: float, n: int = 1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)


def _put(data, device):
    return {k: torch.as_tensor(v, device=device) for k, v in data.items()}


def _device(params):
    return next(iter(params.values())).device


def _nreal(data) -> int:
    return int(np.sum(np.asarray(data["w"]) > 0))


def train_epoch(task, params, model_state, opt, opt_state, loader,
                generator: Optional[torch.Generator] = None):
    """One plain epoch (dcnn.py:418-460): per batch the loss gradient, the
    optimizer's step, then the BatchNorm statistics at the new
    parameters.  Returns ``(params, model_state, opt_state, mean loss)``,
    the loss averaged over the real rows."""
    device = _device(params)
    meter = AverageMeter()
    for data in loader:
        batch = _put(data, device)
        key = (int(torch.randint(0, 2 ** 62, (), generator=generator))
               if task.has_dropout else None)
        loss_fn = task.loss_fn(model_state, key)
        loss, grads = curvature.value_and_grad(loss_fn, params, batch)
        params, opt_state = opt.step(
            grads, opt_state, params,
            grad_fn=lambda p: curvature.value_and_grad(loss_fn, p, batch), rng=generator)
        if task.has_batch_stats:
            model_state = task.train_loss(params, model_state, batch, key)[1]
        meter.update(float(loss), _nreal(data))
    return params, model_state, opt_state, meter.avg


def train2_epoch(model, params, model_state, opt, opt_state, loader,
                 generator: Optional[torch.Generator] = None, kl_weight: float = 0.0,
                 noises: Optional[Sequence[torch.Tensor]] = None):
    """One VAE epoch (dcnn.py:453-487): ``model`` returns ``(logits, mu,
    logvar)`` and the loss is ``models/vae.vae_loss``.  The reparameterising
    noise of batch ``i`` is ``noises[i]``, else drawn from ``generator``;
    the BatchNorm statistics do not move.  Returns ``(params, model_state,
    opt_state, mean loss)``."""
    from optwboundeigenval_tpu_torch.models.vae import vae_loss

    device = _device(params)
    meter = AverageMeter()
    for i, data in enumerate(loader):
        batch = _put(data, device)
        noise = None if noises is None else noises[i]
        if noise is None:
            noise = _draw_noise(params, batch, generator)

        def loss_fn(p, b, noise=noise):
            out = functional_call(model, (p, model_state), (b["x"],),
                                  {"train": True, "noise": noise})
            return vae_loss(out, b["y"], b.get("w"), kl_weight=kl_weight)

        loss, grads = curvature.value_and_grad(loss_fn, params, batch)
        params, opt_state = opt.step(
            grads, opt_state, params,
            grad_fn=lambda p: curvature.value_and_grad(loss_fn, p, batch), rng=generator)
        meter.update(float(loss), _nreal(data))
    return params, model_state, opt_state, meter.avg


def _draw_noise(params, batch, generator):
    """A standard-normal draw shaped like the batch's ``mu``."""
    if generator is None:
        raise ValueError("train2_epoch needs a generator or the noises")
    like = params["mu_fc.weight"]
    return torch.randn((len(batch["x"]), like.shape[0]), generator=generator,
                       device=like.device, dtype=like.dtype)


@torch.no_grad()
def validate(task, params, model_state, loader) -> Tuple[float, float]:
    """Mean eval loss and accuracy (%) over the real rows (dcnn.py
    validate): argmax for labels, ``logit > 0`` against ``y > 0.5`` per
    entry for multi-label targets."""
    device = _device(params)
    losses, accs = AverageMeter(), AverageMeter()
    for data in loader:
        loss, out = task.eval_loss(params, model_state, _put(data, device))
        nreal = _nreal(data)
        y = np.asarray(data["y"])[:nreal]
        o = host(out)[:nreal]
        if y.ndim == 1:
            acc = float(np.mean(np.argmax(o, axis=1) == y)) * 100
        else:
            acc = float(np.mean((o > 0) == (y > 0.5))) * 100
        losses.update(float(loss), nreal)
        accs.update(acc, nreal)
    return losses.avg, accs.avg


@torch.no_grad()
def test(task, params, model_state, loader) -> Tuple:
    """The sigmoid test pass (dcnn.py:548-579): sigmoid outputs over the
    loader's real rows, the AUC of each class and their mean.  Returns
    ``(roc, avgroc, (labels, outputs))``."""
    device = _device(params)
    outputs, labels = [], []
    for data in loader:
        out = torch.sigmoid(task.predict(params, model_state, _put(data, device)))
        nreal = _nreal(data)
        outputs.append(host(out)[:nreal])
        labels.append(np.asarray(data["y"])[:nreal])
    outputs = np.concatenate(outputs)
    labels = np.concatenate(labels)
    if labels.ndim == 1:
        roc = np.array([roc_auc(labels, outputs.reshape(len(labels), -1)[:, -1])])
    else:
        roc = np.array([roc_auc(labels[:, c], outputs[:, c]) for c in range(labels.shape[1])])
    return roc, float(roc.mean()), (labels, outputs)


def save_checkpoint_copy_on_best(payload: dict, is_best: bool,
                                 path: str = "./models/checkpoint.pt",
                                 best_path: Optional[str] = None) -> str:
    """Write ``payload`` to ``path`` (the port's ``.pt`` format) and, when
    ``is_best``, copy it to ``best_path`` (default ``<stem>_best.pt``);
    returns the path of the copy, else ``path``."""
    checkpoints.save_checkpoint(path, payload)
    if not is_best:
        return path
    if best_path is None:
        stem, ext = os.path.splitext(path)
        best_path = f"{stem}_best{ext}"
    shutil.copyfile(path, best_path)
    return best_path
