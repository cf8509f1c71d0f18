"""The Asymmetric Valley trainer: SWA averaging and an SGD/SWA
interpolation sweep (counterpart of
``optwboundeigenval_tpu/train/asymmetric_valley.py``; reference
asymmetric_valley.py:15-345):

* the trapezoid learning-rate schedule (``schedule_lr``, :43-52) and
  plain, unregularized epochs (``train_epoch``, :265-308);
* from ``swa_start``: the running average of the weights with ``1/(n+1)``
  mixing (:446-449), and at ``eval_freq`` the SWA model's BatchNorm
  statistics recomputed by :func:`bn_update` (:488-523);
* from ``sgd_start``: ``iter2`` (:71-89), which reloads the SGD weights
  of the last SWA checkpoint and hunts for an SGD point with a lower
  train loss but a higher validation loss than the SWA point;
* the linear sweep between the SGD and SWA solutions over ``2 *
  distances + division_part + 1`` points (``interpolation``, :91-156),
  train and validation loss and accuracy at each, into the four
  ``asymmetric_valley_*_results.txt`` files of ``log_dir``, and their
  plots into ``plot_dir`` when matplotlib imports (a line on standard
  output says when it does not);
* checkpoints ``<header2>_av_<tag>.pt`` holding the SGD and SWA weights.

Its epochs, evaluations and BatchNorm averaging are loops of their own,
written for one process: a ``mesh`` raises ``ValueError``.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from optwboundeigenval_tpu_torch.analysis.plots import pyplot
from optwboundeigenval_tpu_torch.ops import curvature
from optwboundeigenval_tpu_torch.train import checkpoints
from optwboundeigenval_tpu_torch.train.trainer import CKPT_BEST, SpectralTrainer, _as_loader
from optwboundeigenval_tpu_torch.utils.precision import host


def bn_update(task, params, model_state, loader, put_batch):
    """BatchNorm running statistics recomputed as the cumulative average
    of the per-batch statistics over ``loader`` (reference bn_update,
    asymmetric_valley.py:488-523); a no-op without BatchNorm."""
    if not task.has_batch_stats or not model_state:
        return model_state
    acc, n = None, 0
    for data in loader:
        stats = task.batch_stats(params, model_state, put_batch(data))
        acc = stats if acc is None else {k: a + (stats[k] - a) / (n + 1)
                                         for k, a in acc.items()}
        n += 1
    return model_state if acc is None else {**model_state, **acc}


class AsymmetricValleyTrainer(SpectralTrainer):
    def __init__(self, task, optimizer, scheduler=None, *, swa: bool = True,
                 swa_start: int = 161, sgd_start: int = 201, swa_c_epochs: int = 1,
                 swa_lr: float = 0.05, eval_freq: int = 5, save_freq: int = 5,
                 division_part: int = 40, distances: int = 20, max_iter: int = 250,
                 plot_dir: str = "./plots", **kw):
        if kw.get("mesh") is not None:
            raise ValueError("the Asymmetric Valley trainer runs in one process: no mesh")
        super().__init__(task, optimizer, scheduler, max_iter=max_iter, **kw)
        self.swa = swa
        self.swa_start = swa_start
        self.sgd_start = sgd_start
        self.swa_c_epochs = swa_c_epochs
        self.swa_lr = swa_lr
        self.eval_freq = eval_freq
        self.save_freq = save_freq
        self.division_part = division_part
        self.distances = distances
        self.plot_dir = plot_dir
        self.swa_params = None
        self.swa_model_state = None
        self.swa_n = 0
        self.lr_init: Optional[float] = None
        self.swa_path: Optional[str] = None
        self.sgd_path: Optional[str] = None
        self.train_res_swa = None
        self.valid_res_swa = None
        self.interpolated = False
        self.steps_done = 0  # optimizer steps taken, all epochs

    def schedule_lr(self) -> float:
        """The trapezoid schedule (asymmetric_valley.py:43-52)."""
        t = self.i / (self.swa_start if self.swa else self.max_iter)
        lr_ratio = (self.swa_lr / self.lr_init) if self.swa else 0.01
        if t <= 0.5:
            factor = 1.0
        elif t <= 0.9:
            factor = 1.0 - (1.0 - lr_ratio) * (t - 0.5) / 0.4
        else:
            factor = lr_ratio
        return self.lr_init * factor

    def train_epoch(self, loader) -> dict:
        """A plain epoch (asymmetric_valley.py:265-308): the optimizer's
        step on the loss gradient, the BatchNorm statistics at the NEW
        parameters; returns the weighted train loss and the accuracy.  The
        steps' host time goes to ``timers`` as ``G``."""
        loss_sum, n_sum = 0.0, 0.0
        for data in loader:
            with self.timers("G"):
                batch = self.put_batch(data)
                key = self._dropout_key()
                loss_fn = self._loss_fn(self.model_state, key)
                loss, grads = curvature.value_and_grad(loss_fn, self.params, batch)
                self.params, self.opt_state = self.optimizer.step(
                    grads, self.opt_state, self.params,
                    grad_fn=lambda p: curvature.value_and_grad(loss_fn, p, batch),
                    rng=self.generator)
                self.model_state = self._advance_stats(self.params, self.model_state, batch, key)
                bw = float(np.sum(data["w"]))
                loss_sum += float(loss) * bw
            n_sum += bw
            self.steps_done += 1
        self.f = loss_sum / max(n_sum, 1.0)
        return {"loss": self.f, "accuracy": self.evaluate(loader)["accuracy"]}

    def evaluate(self, loader, params=None, model_state=None) -> dict:
        params = self.params if params is None else params
        model_state = self.model_state if model_state is None else model_state
        loss_sum, correct, n_sum = 0.0, 0.0, 0.0
        for data in loader:
            loss, out = self.task.eval_loss(params, model_state, self.put_batch(data))
            nreal = int(np.sum(np.asarray(data["w"]) > 0))
            pred = np.argmax(host(out)[:nreal], axis=1)
            correct += float(np.sum(pred == np.asarray(data["y"])[:nreal]))
            loss_sum += float(loss) * nreal
            n_sum += nreal
        return {"loss": loss_sum / max(n_sum, 1.0),
                "accuracy": correct / max(n_sum, 1.0) * 100.0}

    def _save_full(self, tag: str) -> str:
        path = os.path.join(self.model_dir, f"{self.header2}_av_{tag}.pt")
        checkpoints.save_checkpoint(path, {
            "state_dict": {"params": self.params, "model_state": self.model_state},
            "swa_state_dict": ({"params": self.swa_params,
                                "model_state": self.swa_model_state} if self.swa else {}),
            "swa_n": self.swa_n, "epoch": self.i})
        return path

    def _lr_init(self) -> float:
        if self.lr_init is None:
            self.lr_init = float(self.optimizer.get_learning_rate(self.opt_state) or 0.1)
        return self.lr_init

    def iter_epoch(self, train_loader) -> None:
        """An epoch of the SWA phase (asymmetric_valley.py:54-69)."""
        self._lr_init()
        self.opt_state = self.optimizer.set_learning_rate(self.opt_state, self.schedule_lr())
        self.train_epoch(train_loader)
        if (self.swa and (self.i + 1) >= self.swa_start
                and (self.i + 1 - self.swa_start) % self.swa_c_epochs == 0):
            if self.swa_params is None:
                self.swa_params = self.params
                self.swa_model_state = self.model_state
                self.swa_n = 1
            else:
                alpha = 1.0 / (self.swa_n + 1)
                self.swa_params = {k: s * (1 - alpha) + self.params[k] * alpha
                                   for k, s in self.swa_params.items()}
                self.swa_n += 1
            if (self.i == 0 or self.i % self.eval_freq == self.eval_freq - 1
                    or self.i == self.sgd_start - 2):
                self.swa_model_state = bn_update(self.task, self.swa_params,
                                                 self.model_state, train_loader, self.put_batch)
        if (self.i + 1) % self.save_freq == 0:
            self.swa_path = self._save_full(f"ep{self.i + 1}")

    def iter2(self, train_loader, valid_loader) -> None:
        """After ``sgd_start`` (asymmetric_valley.py:71-89): from the SGD
        weights of the last SWA checkpoint, look for an SGD point with a
        lower train loss and a higher validation loss than the SWA
        point's."""
        if self.train_res_swa is None:
            self.train_res_swa = self.evaluate(train_loader)
            self.valid_res_swa = self.evaluate(valid_loader)
            if self.swa_path is not None:
                payload = checkpoints.load_checkpoint(self.swa_path)["state_dict"]
                self.params = checkpoints.restore_like(self.params, payload["params"])
                self.model_state = checkpoints.restore_like(self.model_state,
                                                            payload["model_state"])
            self.model_state = bn_update(self.task, self.params, self.model_state,
                                         train_loader, self.put_batch)
        self.opt_state = self.optimizer.set_learning_rate(self.opt_state, self.lr_init)
        train_res = self.train_epoch(train_loader)
        valid_res = self.evaluate(valid_loader)
        if (train_res["loss"] < self.train_res_swa["loss"]
                and valid_res["loss"] > self.valid_res_swa["loss"]):
            self.sgd_path = self._save_full(f"sgd_ep{self.i + 1}")

    def interpolation(self, train_loader, valid_loader) -> None:
        """The sweep between the SGD and SWA solutions
        (asymmetric_valley.py:91-156); nothing when either is missing."""
        if self.sgd_path is None or self.swa_path is None:
            return
        load = lambda path, key: checkpoints.restore_like(
            self.params, checkpoints.load_checkpoint(path)[key]["params"])
        vec_1, vec_2 = load(self.sgd_path, "state_dict"), load(self.swa_path, "swa_state_dict")
        n_pts = self.distances * 2 + self.division_part + 1
        results = {k: np.zeros(n_pts) for k in
                   ("train_loss", "test_loss", "train_acc", "test_acc")}
        for idx in range(n_pts):
            t = (idx - self.distances) / self.division_part
            p = {k: b + t * (vec_1[k] - b) for k, b in vec_2.items()}
            ms = bn_update(self.task, p, self.model_state, train_loader, self.put_batch)
            tr = self.evaluate(train_loader, p, ms)
            te = self.evaluate(valid_loader, p, ms)
            results["train_loss"][idx] = tr["loss"]
            results["train_acc"][idx] = tr["accuracy"]
            results["test_loss"][idx] = te["loss"]
            results["test_acc"][idx] = te["accuracy"]
        os.makedirs(self.log_dir, exist_ok=True)
        for key, values in results.items():
            np.savetxt(os.path.join(self.log_dir, f"asymmetric_valley_{key}_results.txt"),
                       values)
        self.interpolated = True
        plt = pyplot("asymmetric valley")
        if plt is None:
            return
        os.makedirs(self.plot_dir, exist_ok=True)
        for key, values in results.items():
            plt.cla()
            plt.plot(values)
            plt.savefig(os.path.join(self.plot_dir, f"asymmetric_valley_{key}_results.png"))

    def train(self, inputs=None, target=None, inputs_valid=None, target_valid=None,
              train_loader=None, valid_loader=None, train_loader_na=None,
              crops: bool = False):
        if train_loader is None:
            train_loader = _as_loader((inputs, target), self.batch_size)
        if valid_loader is None:
            if inputs_valid is None:
                raise ValueError("AsymmetricValley requires validation data")
            valid_loader = _as_loader((inputs_valid, target_valid), self.batch_size)
        # the JAX trainer draws an example batch here (a shuffling
        # loader's order depends on it)
        next(iter(train_loader))
        self.init_state()
        self._lr_init()
        os.makedirs(self.log_dir, exist_ok=True)
        os.makedirs(self.model_dir, exist_ok=True)
        with open(self.log_file, "w") as fh:
            fh.write("epoch\t f\t rho\t h\t norm\t val_acc\t val_f1\n")
        f_hist = []
        for self.i in range(self.max_iter):
            if (self.i + 1) >= self.sgd_start:
                self.iter2(train_loader, valid_loader)
            else:
                self.iter_epoch(train_loader)
            self.save()
            _, self.val_acc, val_f1 = self.test_model(loader=valid_loader)
            if self.val_acc > self.best_val_acc:
                self.best_val_acc = self.val_acc
                self.best_rho = self.rho
                self.best_iter = self.i
                self.save(CKPT_BEST)
            with open(self.log_file, "a") as fh:
                fh.write(f"{self.i}\t {self.f:f}\t {self.rho:f}\t {self.h:f}\t "
                         f"{self.norm:f}\t {self.val_acc:f}\t {val_f1:f}\n")
            f_hist.append(float(self.f))
            if self.i >= self.min_iter - 1:
                window = f_hist[-10:]
                if float(np.std(window) / np.abs(np.mean(window))) <= self.eps:
                    break
        with open(self.log_file, "a") as fh:
            fh.write(f"Best Validation Iterate: {self.best_iter}\n")
            fh.write(f"Best Validation Accuracy: {self.best_val_acc}\n")
            fh.write(f"Rho: {self.best_rho}\n")
        self.interpolation(train_loader, valid_loader)
        eval_loader = train_loader_na if train_loader_na is not None else train_loader
        self.test_set(loader=eval_loader, label="Train", crops=crops)
