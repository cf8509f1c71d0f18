"""SpectralTrainer — the spectral-regularized training run on the card
(counterpart of ``optwboundeigenval_tpu/train/trainer.py``).

A step (``_step_body``, reference ``iter()`` body, opt.py:580-763):

1. gradient of the task loss and an HVP map: the cached linearization
   (``curvature.linearize_hvp``), or micro-batched passes through the
   CUDA accumulate kernel when ``hvp_micro > 1``; under ``remat`` the
   map keeps no graph, each HVP recomputing forward and gradient
   (``curvature.recompute_hvp``);
2. ``rho`` by the ``eigensolver`` (damped power iteration, or Lanczos at
   a fixed or early-exit depth), warm-started from the carried
   eigenvector, or from the uniform vector under ``rand_init``; under
   ``lobpcg`` the power iteration's residual goes through the K-FAC
   inverse (``ops/kfac.py``), whose factors are refitted every
   ``kfac_batch`` batches at the pre-step parameters (``_refresh_precond``);
3. the penalty ``g`` and, when ``g > 0``, ``grad g`` from the vGHv pass,
   with the HVP map and its graph dropped first;
4. ``p = grad f + mu * grad g`` and the optimizer step, with the JAX
   package's protocol (``grad_fn``, ``rng``, ``stats_fn``, ``err_fn``;
   ``optim/api.py``) for SAM, Entropy-SGD and K-FAC;
5. the BatchNorm running statistics, updated on the full batch at the
   PRE-step parameters (the reference advances them in comp_rho's
   forward, before the step mutates the weights).

A dropout task (``Task(has_dropout=True)``) draws one dropout key a step
(``_dropout_key``, a stream of its own from the seed): the gradient,
every HVP, the vGHv pass, the BatchNorm update and the SAM and
Entropy-SGD closures all see its masks (JAX trainer lines 517-518, 633,
654); a K-FAC capture, the epoch-end ``rho`` and each audit batch draw
fresh keys, and the optimizer's own randomness stays on the trainer's
generator.

An epoch (``iter_epoch``) runs the steps, recomputes ``f`` over the
train set in eval mode and ``rho`` on one random batch, and sets
``h = f + mu * g``; ``train`` loops epochs with the reference's TSV log,
best-model checkpoint and coefficient-of-variation stop; ``test_model``,
``test_set``, ``rho_test`` and ``parse`` are the evaluation cascade, and
``rho_test_fused`` and ``spectrum_test`` the JAX package's audits of
``rho`` from a fresh start and of the top-k spectrum per batch.

State ``(params, model_state, opt_state, v)`` is carried explicitly as
dicts of tensors.  Entry points run on the card: ``device=None`` means
``cuda``, and a machine without one raises; pass ``device="cpu"`` to run
on the CPU.

Execution knobs (JAX trainer lines 241-288), each leaving the trajectory
as it is:

* ``scan_steps = k > 1`` with ``defer_metrics``, not ``verbose`` and no
  preconditioner (else the per-step path runs, as in JAX): the epoch's
  steps run in chunks of ``k`` batches, each chunk moved to the device in
  one stacked transfer (pinned host memory, ``non_blocking``; a
  ``torch.stack`` on the device for device-resident batches) and its
  steps run back to back with no host read of their metrics, the
  dropout keys drawn in the per-step order.  The epoch-end ``f`` is
  computed chunk by chunk, per-batch losses on the device, times the
  host weights, summed on the host.  What JAX makes one program per chunk
  stays ``k`` steps here: the eigensolvers test their stop on the host
  every iteration (``ops/eigen.py``), so a chunk cannot be one launch;
  a stop test on the device is an open performance question.
* ``donate``: the committed ``params``, ``model_state``, ``opt_state`` and
  ``v`` keep their storage across steps (each step's result is copied
  into it, ``data_ptr()`` unchanged), the counterpart of XLA's buffer
  donation; as in JAX a fetched step whose norms are not finite then
  commits anyway (recovery is the checkpoint reload), and the
  ``defer_metrics`` epoch-start snapshot is a clone.
* ``mem_track``: the running maximum of ``torch.cuda.memory_allocated``
  after each step (0 on the CPU), printed as the JAX trainer prints it.
* ``profile_dir``/``profile_epoch``: that epoch runs under
  ``torch.profiler`` (CPU and, on the card, CUDA activity) and its Chrome
  trace goes to ``<profile_dir>/<header2>_epoch<i>.json``.
* ``mesh`` (``parallel/mesh.py``): data parallelism over a process
  group.  Each rank's batches are its rows of the global batch, the
  state is broadcast from rank 0 at ``init_state``, ``resume`` and
  ``model_load``, the losses, curvature products, BatchNorm statistics,
  K-FAC statistics and eigensolver decisions reduce over the ranks
  (``active``), ``test_model`` gathers each rank's outputs, and rank 0
  alone writes logs and checkpoints.  On a ``(data, model)`` mesh,
  assigning ``params`` sharded by ``parallel.shard_params`` makes the
  trainer keep this rank's slices of the large leaves: the
  params-shaped ``opt_state`` and ``v`` are cut to them too, the steps,
  epochs, eigensolvers, LOBPCG and evaluation run under that sharding
  (each sharded layer computes its own output columns,
  ``parallel/sharding.py``), K-FAC's capture and the optimizers that
  work on whole layers (K-FAC, Entropy-SGD) run on the gathered tree,
  and ``save``/``save_full`` write the gathered tree, so the files
  equal one process's; ``resume`` and ``model_load`` cut them again.
"""

from __future__ import annotations

import functools
import math
import os
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from optwboundeigenval_tpu_torch.data.loaders import ArrayLoader
from optwboundeigenval_tpu_torch.models import dropout
from optwboundeigenval_tpu_torch.ops import curvature, eigen, kfac, spectral
from optwboundeigenval_tpu_torch.optim.api import Optimizer
from optwboundeigenval_tpu_torch.parallel import mesh as meshlib
from optwboundeigenval_tpu_torch.parallel.sharding import Sharded, gather_params, output_dims
from optwboundeigenval_tpu_torch.train import checkpoints
from optwboundeigenval_tpu_torch.train.task import Task
from optwboundeigenval_tpu_torch.utils.precision import host
from optwboundeigenval_tpu_torch.utils.timing import Timers
from optwboundeigenval_tpu_torch.utils.tree import (
    tree_axpy,
    tree_norm,
    tree_uniform_like,
)


def resolve_device(device=None) -> torch.device:
    """``None`` means the card; raise rather than run silently on the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: optwboundeigenval_tpu_torch runs on the GPU "
                "unless device='cpu' is passed")
        device = "cuda"
    return torch.device(device)


def _same_device(a: torch.device, b: torch.device) -> bool:
    return a.type == b.type and (a.index or 0) == (b.index or 0)


def _copy_into(old, new):
    """``new``'s values in ``old``'s storage: tensors copied in place,
    nested dicts recursively, anything else (numbers, a tensor of another
    shape) replaced; returns ``old``."""
    for k, t in new.items():
        o = old.get(k)
        if isinstance(t, dict) and isinstance(o, dict):
            _copy_into(o, t)
        elif (isinstance(t, torch.Tensor) and isinstance(o, torch.Tensor)
              and o.shape == t.shape and o.dtype == t.dtype and o is not t):
            o.copy_(t)
        elif o is not t:
            old[k] = t
    return old


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.clone() if isinstance(tree, torch.Tensor) else tree


def _on_mesh(method):
    """Run ``method`` with the trainer's mesh and sharding active
    (``parallel/mesh.py``)."""
    @functools.wraps(method)
    def run(self, *args, **kwargs):
        with meshlib.active(self.mesh, self._sharding):
            return method(self, *args, **kwargs)
    return run

CKPT = "_trained_model.pt"
CKPT_BEST = "_trained_model_best.pt"
CKPT_FULL = "_full.pt"


def _check_batch_counts(loader, mesh) -> None:
    """Raise unless every rank of ``mesh`` yields as many batches from its
    ``loader`` (a loop of collectives would hang on the odd one out)."""
    counts = torch.tensor([len(loader)], device=mesh.device)
    counts = meshlib.all_gather_rows(counts, mesh).tolist()
    if min(counts) != max(counts):
        raise ValueError(f"loaders yield unequal batch counts {counts} across ranks; "
                         "pad the dataset so every rank yields as many batches")


def _as_loader(data, batch_size) -> ArrayLoader:
    if isinstance(data, ArrayLoader):
        return data
    x, y = data
    return ArrayLoader(np.asarray(x), np.asarray(y), batch_size=batch_size)


def resolve_eigensolver(eigensolver: str, rand_init: bool, pow_iter_eps: float,
                       momentum: Optional[float], lanczos_m: Optional[int],
                       lobpcg: bool = False):
    """``(method, lanczos_m)`` for the trainer's options (JAX trainer
    lines 151-178).  ``'auto'`` takes the early-exit Lanczos solver where
    power iteration needs many HVPs (``rand_init``, or ``pow_iter_eps <=
    5e-3``) and power iteration elsewhere or with ``momentum`` or
    ``lobpcg``; its depth cap defaults to ``clip(2 ceil(log10(1 / eps)) +
    2, 4, 16)``, any other solver's to 16."""
    if eigensolver not in ("power", "lanczos", "auto"):
        raise ValueError(f"unknown eigensolver: {eigensolver!r}")
    if eigensolver == "lanczos" and lobpcg:
        raise ValueError("eigensolver='lanczos' does not compose with lobpcg")
    if eigensolver == "lanczos" and momentum is not None:
        raise ValueError("eigensolver='lanczos' does not compose with pow_iter_momentum")
    method = eigensolver
    if eigensolver == "auto":
        method = ("lanczos_adaptive" if momentum is None and not lobpcg
                  and (rand_init or pow_iter_eps <= 5e-3) else "power")
    if lanczos_m is None:
        lanczos_m = 16
        if eigensolver == "auto":
            depth = 2 * math.ceil(math.log10(1.0 / max(pow_iter_eps, 1e-12))) + 2
            lanczos_m = int(min(16, max(4, depth)))
    return method, int(lanczos_m)


def f1_micro(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    """sklearn's ``f1_score(y_true, y_pred, average="micro")`` for class
    labels (1-D) or label indicators (2-D): ``2 tp / (|true| + |pred|)``,
    0 when both are empty."""
    if y_true.ndim > 1:
        t, p = y_true > 0.5, y_pred > 0.5
        tp, n_true, n_pred = np.sum(t & p), np.sum(t), np.sum(p)
    else:
        tp, n_true = np.sum(y_true == y_pred), len(y_true)
        n_pred = n_true
    denom = n_true + n_pred
    return float(2 * tp / denom) if denom else 0.0


def roc_auc(y_true: np.ndarray, score: np.ndarray) -> float:
    """sklearn's ``roc_auc_score`` for binary labels, as the Mann-Whitney
    statistic over average ranks (a tie counts one half); NaN where
    ``y_true`` holds one class only (sklearn raises there, and the JAX
    package records NaN)."""
    pos = y_true == 1
    n_pos = int(pos.sum())
    n_neg = len(y_true) - n_pos
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    _, inv, counts = np.unique(score, return_inverse=True, return_counts=True)
    ranks = (np.cumsum(counts) - (counts - 1) / 2.0)[inv]
    return float((ranks[pos].sum() - n_pos * (n_pos + 1) / 2.0) / (n_pos * n_neg))


def confusion_matrix(y_true: np.ndarray, y_pred: np.ndarray) -> np.ndarray:
    """sklearn's ``confusion_matrix``: rows are true labels, columns
    predicted ones, over the sorted labels that occur in either."""
    labels = np.union1d(y_true, y_pred)
    ti, pi = np.searchsorted(labels, y_true), np.searchsorted(labels, y_pred)
    cm = np.zeros((len(labels), len(labels)), np.int64)
    np.add.at(cm, (ti, pi), 1)
    return cm


class SpectralTrainer:
    """The JAX trainer's constructor (reference opt.py:239-316).  ``mu``
    is a scalar or a callable of the epoch index; ``pow_iter_alpha`` a
    scalar or a callable of the power-iteration index.  Under a ``mesh``
    the trainer runs on the mesh's device (``device``, if given, must be
    it)."""

    def __init__(
        self,
        task: Task,
        optimizer: Optimizer,
        scheduler=None,
        *,
        mu: Union[float, Callable[[int], float]] = 0.0,
        K: float = 0.0,
        Kmin: float = 0.0,
        eps: float = -1.0,
        pow_iter_eps: float = 1e-3,
        batch_size: int = 128,
        min_iter: int = 10,
        max_iter: int = 100,
        max_pow_iter: int = 1000,
        pow_iter: bool = True,
        ignore_bad_vals: bool = True,
        rand_init: bool = False,
        pow_iter_alpha: Union[float, Callable] = 1.0,
        pow_iter_momentum: Optional[float] = None,
        eigensolver: str = "power",
        lanczos_m: Optional[int] = None,
        gradg_clip: Optional[float] = None,
        best_h: bool = False,
        btch_h: bool = False,
        verbose: bool = False,
        header: str = "",
        test_func: str = "maxacc",
        lobpcg: bool = False,
        kfac_rand: bool = True,
        kfac_ema: bool = False,
        precond_builder: Optional[Callable] = None,
        kfac_batch: int = 1,
        mesh=None,
        seed: int = 1226,
        mem_track: bool = False,
        remat: bool = False,
        hvp_micro: int = 0,
        defer_metrics: bool = False,
        scan_steps: int = 1,
        donate: bool = False,
        full_ckpt: bool = False,
        profile_dir: Optional[str] = None,
        profile_epoch: int = 0,
        log_dir: str = "./logs",
        model_dir: str = "./models",
        device=None,
    ):
        if mesh is not None:
            if device is not None and not _same_device(resolve_device(device), mesh.device):
                raise ValueError(f"device={device!r} is not the mesh's {mesh.device}")
            device = mesh.device
        self.device = resolve_device(device)
        self.mesh = mesh
        self._writer = mesh is None or mesh.writer
        self.task = task
        self.optimizer = optimizer
        self.scheduler = scheduler
        self.mu = mu
        self.K = float(K)
        self.Kmin = float(Kmin)
        self.eps = eps
        self.pow_iter_eps = pow_iter_eps
        self.batch_size = batch_size
        self.min_iter = min_iter
        self.max_iter = max_iter
        self.max_pow_iter = max_pow_iter
        self.pow_iter = pow_iter
        self.ignore_bad_vals = ignore_bad_vals
        self.pow_iter_alpha = pow_iter_alpha
        if pow_iter_momentum is not None and lobpcg:
            raise ValueError("pow_iter_momentum does not compose with lobpcg")
        self.pow_iter_momentum = pow_iter_momentum
        self.rand_init = rand_init
        self.eigensolver_requested = eigensolver
        self.eigensolver, self.lanczos_m = resolve_eigensolver(
            eigensolver, rand_init, pow_iter_eps, pow_iter_momentum, lanczos_m,
            lobpcg)
        # LOBPCG: the power iteration's residual through the K-FAC inverse
        # (opt.py:426-430, 491-493), its factors refitted every kfac_batch
        # batches; without kfac_ema each refit starts from identity, the
        # reference's effective behaviour (its K-FAC step counter never
        # advances in this mode, so its hooks re-initialise the factors)
        self.lobpcg = lobpcg
        self.kfac_rand = kfac_rand
        self.kfac_ema = kfac_ema
        if lobpcg and precond_builder is None:
            precond_builder = kfac.precond_apply
        self.precond_builder = precond_builder
        self.kfac_batch = kfac_batch
        self._precond_state = None
        self._kfac_iter = kfac_batch
        # remat: an HVP map that keeps no graph between products (_linearize)
        self.remat = remat
        self.gradg_clip = gradg_clip
        self.best_h_val = best_h
        self.verbose = verbose
        self.test_func = test_func
        self.hvp_micro = int(hvp_micro)
        # defer_metrics: commit every step and check the gradient norms
        # once per epoch, restoring the epoch-start state on a non-finite
        # one (ignored when verbose, whose per-batch lines need the values)
        self.defer_metrics = defer_metrics
        # a save_full checkpoint at every epoch end, for an exact resume
        self.full_ckpt = full_ckpt
        self.seed = seed
        self.generator = torch.Generator().manual_seed(seed)
        self._np_rng = np.random.default_rng(seed)
        self._dropout_draws = 0  # dropout keys drawn so far (_dropout_key)
        self.log_dir = log_dir
        self.model_dir = model_dir
        self.mem_track = mem_track
        self.mem_max = 0  # running max of the device memory allocated
        self.scan_steps = int(scan_steps)
        self.donate = donate
        self.profile_dir = profile_dir
        self.profile_epoch = profile_epoch

        # file stem: header_OptName[_btchN]_muM_KX[_KminY] (opt.py:290-302)
        mname = "Func" if callable(mu) else str(mu)
        self.header = header
        self.header2 = f"{header}_{optimizer.name}"
        self.header2 += f"_btch{batch_size}" if btch_h else ""
        self.header2 += f"_mu{mname}_K{K}"
        self.header2 += f"_Kmin{Kmin}" if Kmin > 0 else ""
        self.log_file = os.path.join(log_dir, self.header2 + ".log")
        self.verbose_log_file = os.path.join(log_dir, self.header2 + "_verbose.log")

        self._sharding = None  # set by assigning sharded params
        self.params = None
        self.model_state = None
        self.opt_state = None
        self.v = None
        self.i = 0  # epoch counter
        self.f = 0.0
        self.g = 0.0
        self.h = 0.0
        self.rho = 0.0
        self.norm = 0.0
        self.val_acc = 0.0
        self.best_val_acc = 0.0
        self.best_h = 0.0
        self.best_rho = 0.0
        self.best_iter = 0
        # power iterations of each step of the last epoch, and their mean
        self.epoch_pow_iters: List[int] = []
        self.mean_pow_iters = float("nan")
        self._h_hist: List[float] = []
        self._resume_epoch = 0
        self.timers = Timers()

    # ------------------------------------------------------------------
    # state
    # ------------------------------------------------------------------
    def init_state(self) -> None:
        """Draw fresh parameters from the trainer's seed; set up the
        optimizer state and the uniform start vector."""
        if self.params is not None:
            return
        self.params, self.model_state = self.task.init(self.generator, self.device)
        self.opt_state = self.optimizer.init(self.params)
        if self.optimizer.build_extra_state is not None:
            # model-shaped optimizer state: the K-FAC factors
            self.opt_state = self.optimizer.build_extra_state(
                self.opt_state, self.task, self.params, self.model_state)
        self.v = tree_uniform_like(self.params)
        self._replicate()

    @property
    def params(self):
        return self._params

    @params.setter
    def params(self, value) -> None:
        """Params from ``parallel.shard_params`` (a ``Sharded`` tree) shard
        the trainer: from then on it keeps this rank's slices, and the
        params-shaped leaves of ``opt_state`` and ``v`` are cut to them
        here."""
        sharding = getattr(value, "sharding", None)
        if sharding is not None and self._sharding is None:
            if self.mesh is None or sharding.mesh is not self.mesh:
                raise ValueError("sharded params need the trainer's mesh")
            dims = output_dims(self.task.model)
            wrong = sorted(k for k, d in sharding.dims.items() if dims.get(k) != d)
            if wrong:
                raise ValueError(f"{wrong} are sharded along another dimension than their "
                                 "layers' output feature: shard_params(..., model=model)")
            self._sharding = sharding
            self.opt_state = sharding.local(self.opt_state)
            if self.v is not None:
                self.v = Sharded(sharding.local(self.v), sharding)
        self._params = value

    def _full(self, tree):
        """``tree`` with its sharded leaves gathered (every rank calls it)."""
        return gather_params(tree, self._sharding)

    def _replicate(self) -> None:
        """Under a mesh, rank 0's state on every rank."""
        for tree in (self.params, self.model_state, self.opt_state, self.v):
            meshlib.replicate(tree, self.mesh)

    def _broadcast(self, obj):
        """Rank 0's ``obj`` on every rank of the mesh (``obj`` without one)."""
        return meshlib.broadcast_object(obj, self.mesh)

    def mem_check(self) -> int:
        """The running maximum of the device memory allocated
        (``torch.cuda.memory_allocated``, XLA's ``bytes_in_use``; 0 on the
        CPU), printed when it grows (opt.py:318-322)."""
        if not self.mem_track:
            return self.mem_max
        used = (torch.cuda.memory_allocated(self.device)
                if self.device.type == "cuda" else 0)
        if used > self.mem_max:
            self.mem_max = used
            print(f"Running Max device memory used (in bytes): {used}")
        return self.mem_max

    @property
    def ndim(self) -> int:
        """The number of parameters (of the full leaves under a sharding)."""
        sh = self._sharding
        return sum(sh.numel(k, p) if sh else p.numel() for k, p in self.params.items())

    def put_batch(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """Batch (numpy arrays or tensors) to tensors on the trainer's device."""
        return {k: torch.as_tensor(v, device=self.device) for k, v in batch.items()}

    def _mu_now(self) -> float:
        return float(self.mu(self.i) if callable(self.mu) else self.mu)

    # ------------------------------------------------------------------
    # one step
    # ------------------------------------------------------------------
    def _loss_fn(self, model_state, key=None):
        return self.task.loss_fn(model_state, key)

    def _dropout_key(self) -> Optional[int]:
        """The next key of the run's dropout stream; None without dropout,
        so a task without it draws nothing."""
        if not self.task.has_dropout:
            return None
        self._dropout_draws += 1
        return dropout.step_key(self.seed, self._dropout_draws)

    def _linearize(self, loss_fn, params, batch):
        """``(grad f, hvp_fn)`` on the full batch: the kept gradient graph,
        or under ``remat`` a map that holds only ``params`` and ``batch``
        and recomputes forward and gradient per HVP, as
        ``jax.linearize(grad(jax.checkpoint(loss)))`` does."""
        if self.remat:
            return curvature.recompute_hvp(loss_fn, params, batch)
        return curvature.linearize_hvp(loss_fn, params, batch)

    def _step_body(self, params, model_state, opt_state, v, batch, mu,
                   precond_state=None, key=None):
        """Pure per-batch step under the dropout ``key``: returns
        ``(params, model_state, opt_state, v, metrics)`` with the metrics as
        device tensors."""
        loss_fn = self._loss_fn(model_state, key)
        if self.hvp_micro > 1:
            # memory-bounded path: O(B / micro) activations per pass, and
            # nothing kept between passes
            grads_f = curvature.grad_microbatched(loss_fn, params, batch,
                                                  self.hvp_micro)
            hvp_fn = lambda u: curvature.hvp_microbatched(
                loss_fn, params, batch, u, self.hvp_micro)
        else:
            grads_f, hvp_fn = self._linearize(loss_fn, params, batch)

        gradf_norm = tree_norm(grads_f)
        eig = self._eig(hvp_fn, self._start(v), precond_state) if self.pow_iter else None
        # the vGHv pass builds its own graph: the linearized one goes first
        del hvp_fn
        if eig is not None:
            sg = spectral.penalty_and_grad(
                loss_fn, params, batch, eig.v, eig.rho, K=self.K,
                Kmin=self.Kmin, gradg_clip=self.gradg_clip,
                num_micro=self.hvp_micro,
            )
            direction = spectral.regularized_direction(grads_f, sg.grad_g, mu)
            new_v = eig.v
            metrics = {
                "rho": eig.rho, "norm": eig.norm, "res_change": eig.res_change,
                "pow_iters": eig.iters, "converged": eig.converged, "g": sg.g,
                "gradf_norm": gradf_norm, "gradg_norm": tree_norm(sg.grad_g),
            }
        else:
            direction, new_v = grads_f, v
            zero = torch.zeros((), dtype=gradf_norm.dtype, device=self.device)
            metrics = {
                "rho": zero, "norm": zero, "res_change": zero, "pow_iters": 0,
                "converged": True, "g": zero, "gradf_norm": gradf_norm,
                "gradg_norm": zero,
            }

        new_params, new_opt_state = self._opt_step(
            direction, opt_state, params, **self._opt_kwargs(loss_fn, model_state, batch))
        if self.optimizer.wants_err:
            # the closure's loss and error % (optim.py:24)
            metrics["opt_mf"] = new_opt_state["mf"]
            metrics["opt_merr"] = new_opt_state["merr"]
        # BN running statistics at the PRE-step params (opt.py:180-186, 421)
        new_model_state = self._advance_stats(params, model_state, batch, key)
        return new_params, new_model_state, new_opt_state, new_v, metrics

    def _opt_step(self, direction, opt_state, params, **kw):
        """The optimizer's step; under a sharding an optimizer that works on
        whole layers (``slices=False``) steps on the gathered trees, and
        this rank keeps the slices of its result."""
        sh = self._sharding
        if sh is None or self.optimizer.slices:
            return self.optimizer.step(direction, opt_state, params, **kw)
        new_params, new_state = self.optimizer.step(
            sh.gather_tree(direction), sh.gather_tree(opt_state), sh.gather_tree(params), **kw)
        return sh.local(new_params), sh.local(new_state)

    def _opt_kwargs(self, loss_fn, model_state, batch):
        """The optimizer protocol's keywords for this batch (JAX trainer
        lines 589-635): the plain-loss ``grad_fn``, the trainer's
        generator, K-FAC's ``stats_fn`` (a capture at the parameters it is
        given, with sampled targets under the optimizer's ``kfac_rand`` and
        masks of a key of its own) and Entropy-SGD's ``err_fn``."""
        kw = {"grad_fn": lambda p: curvature.value_and_grad(loss_fn, p, batch),
              "rng": self.generator}
        if self.optimizer.needs_stats:
            def stats_fn(p, rng):
                targets = (kfac.sample_fisher_targets(self.task, p, model_state, batch, rng)
                           if self.optimizer.kfac_rand else None)
                return kfac.capture(self.task, p, model_state, batch, targets,
                                    key=self._dropout_key())[1]
            kw["stats_fn"] = stats_fn
        if self.optimizer.wants_err:
            kw["err_fn"] = lambda p: self._closure_err(p, model_state, batch)
        return kw

    def _closure_err(self, params, model_state, batch):
        """Entropy-SGD's closure (opt.py:673-687, JAX trainer lines
        603-618): ``(loss, error %)`` of the eval-mode outputs on the
        batch, the error in float32 as the JAX package computes it."""
        out = self.task.predict(params, model_state, batch)
        loss = meshlib.all_sum(self.task.loss(out, batch["y"], batch.get("w")))
        y, w = batch["y"], batch.get("w")
        if out.dim() > 1 and y.dim() > 1:  # multi-label
            correct = ((out > 0) == (y > 0.5)).to(torch.float32).mean(dim=-1)
        else:
            correct = (out.argmax(dim=-1) == y).to(torch.float32)
        if meshlib.current() is not None:  # the global batch's
            w = torch.ones_like(correct) if w is None else w.to(torch.float32)
            num, den = meshlib.all_sum(torch.stack([(correct * w).sum(), w.sum()]))
            acc = num / torch.clamp_min(den, 1e-12)
        elif w is None:
            acc = correct.mean()
        else:
            w = w.to(torch.float32)
            acc = (correct * w).sum() / torch.clamp_min(w.sum(), 1e-12)
        return loss, 100.0 * (1.0 - acc)

    def _start(self, v):
        """The eigensolver's start: the carried ``v``, or the uniform
        vector under ``rand_init``."""
        return tree_uniform_like(v) if self.rand_init else v

    def _eig(self, hvp_fn, v0, precond_state=None):
        precond = None
        if self.precond_builder is not None and precond_state is not None:
            precond = lambda r: self.precond_builder(precond_state, r)
        return eigen.estimate_dominant_eig(
            hvp_fn, v0, eps=self.pow_iter_eps, max_iter=self.max_pow_iter,
            alpha=self.pow_iter_alpha, precond=precond,
            ignore_bad_vals=self.ignore_bad_vals, momentum=self.pow_iter_momentum,
            method=self.eigensolver, lanczos_m=self.lanczos_m,
        )

    def _refresh_precond(self, batch):
        """LOBPCG: refit the K-FAC factors at the current parameters every
        ``kfac_batch`` calls (opt.py:426-430; JAX trainer lines 787-809),
        the first call included; from the previous factors under
        ``kfac_ema``, else from identity."""
        if self.precond_builder is None:
            return
        if self._kfac_iter >= self.kfac_batch:
            prev = self._precond_state if self.kfac_ema else None
            self._precond_state = kfac.fit_factors(
                self.task, self.params, self.model_state, batch, self.generator,
                prev=prev, sample_targets=self.kfac_rand, key=self._dropout_key())
            self._kfac_iter = 1
        else:
            self._kfac_iter += 1

    def _advance_stats(self, params, model_state, batch, key=None):
        if not self.task.has_batch_stats:
            return model_state
        return self.task.train_loss(params, model_state, batch, key)[1]

    def _kept(self, old, new):
        """``new``, under ``donate`` in the storage of ``old``."""
        return _copy_into(old, new) if self.donate else new

    def _commit(self, params, model_state, opt_state, v) -> None:
        """Make a step's result the trainer's state."""
        self.params, self.model_state, self.opt_state, self.v = (
            self._kept(self.params, params), self._kept(self.model_state, model_state),
            self._kept(self.opt_state, opt_state), self._kept(self.v, v))

    @_on_mesh
    def train_step(self, batch: Dict[str, Any], mu: Optional[float] = None,
                   fetch: bool = True) -> Dict[str, Any]:
        """Run ONE spectral-regularized step on ``batch`` and commit the
        new ``(params, model_state, opt_state, v)``.

        Returns the metrics as host values plus ``step_ok``.  A step whose
        gradient norms are not finite is NOT committed (the caller
        decides on a rollback, opt.py:696-708), unless ``donate``: then,
        as in JAX, it commits and the rollback is the only recovery.
        ``fetch=False`` (the ``defer_metrics`` path) commits
        unconditionally and returns the tensor metrics on the device,
        unread."""
        if self.params is None:
            self.init_state()
        if mu is None:
            mu = self._mu_now()
        dev_batch = self.put_batch(batch)
        key = self._dropout_key()
        self._refresh_precond(dev_batch)
        out = self._step_body(self.params, self.model_state, self.opt_state,
                              self.v, dev_batch, float(mu), self._precond_state, key)
        new_params, new_model_state, new_opt_state, new_v, metrics = out
        if not fetch:
            self._commit(new_params, new_model_state, new_opt_state, new_v)
            return metrics
        # one device-to-host transfer for all tensor metrics
        keys = [k for k, m in metrics.items() if isinstance(m, torch.Tensor)]
        values = torch.stack([metrics[k].to(torch.float64) for k in keys]).tolist()
        metrics.update(zip(keys, values))
        step_ok = meshlib.agree(bool(np.isfinite(metrics["gradf_norm"])
                                     and np.isfinite(metrics["gradg_norm"])))
        if step_ok or self.donate:
            self._commit(new_params, new_model_state, new_opt_state, new_v)
        if step_ok:
            self.rho = metrics["rho"]
            self.norm = metrics["norm"]
            self.g = metrics["g"]
        metrics["step_ok"] = step_ok
        return metrics

    def _rho_step(self, batch):
        """comp_rho without an optimizer step (epoch-end ``g``, rho_test):
        the full-batch cached linearization even when ``hvp_micro > 1``,
        then the BN running statistics advance, as the reference's
        train-mode forward does (opt.py:421, 882-910), under a fresh
        dropout key (JAX trainer lines 1025-1034).  Returns ``(eig,
        new_model_state)``."""
        key = self._dropout_key()
        _, hvp_fn = self._linearize(self._loss_fn(self.model_state, key), self.params, batch)
        eig = self._eig(hvp_fn, self._start(self.v), self._precond_state)
        return eig, self._advance_stats(self.params, self.model_state, batch, key)

    # ------------------------------------------------------------------
    # epoch loop (reference iter(), opt.py:580-763)
    # ------------------------------------------------------------------
    def trace_file(self, epoch: int) -> str:
        """Where ``profile_dir``'s trace of ``epoch`` goes (one file a rank
        under a mesh of several)."""
        rank = f"_rank{self.mesh.rank}" if self.mesh is not None and self.mesh.world > 1 else ""
        return os.path.join(self.profile_dir, f"{self.header2}_epoch{epoch}{rank}.json")

    @_on_mesh
    def iter_epoch(self, train_loader: ArrayLoader) -> None:
        loader_device = getattr(train_loader, "device", None)
        if loader_device is not None and not _same_device(torch.device(loader_device),
                                                          self.device):
            raise ValueError(f"the train loader's data are on {loader_device}, "
                             f"the trainer runs on {self.device}")
        if not (self.profile_dir and self.i == self.profile_epoch):
            self._iter_epoch_body(train_loader)
            return
        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=activities) as prof:
            self._iter_epoch_body(train_loader)
        os.makedirs(self.profile_dir, exist_ok=True)
        path = self.trace_file(self.i)
        prof.export_chrome_trace(path)
        if not os.path.isfile(path):  # the exporter logs a failure and returns
            raise RuntimeError(f"torch.profiler wrote no trace to {path}")

    def _iter_epoch_body(self, train_loader) -> None:
        mu = self._mu_now()
        rbatch = int(self._np_rng.integers(0, max(len(train_loader), 1)))
        rdata = None
        vlog: List[str] = []
        istart = time.perf_counter()
        defer = self.defer_metrics and not self.verbose
        deferred: List[Dict[str, Any]] = []
        self.epoch_pow_iters = []
        if defer:
            # the recovery point if a deferred step turns out non-finite:
            # steps return new tensors, so holding the old dicts is a copy
            # (the preconditioner too: its refits read the committed
            # params); a donated state is overwritten in place, so then
            # it is a clone
            snapshot = (self.params, self.model_state, self.opt_state, self.v,
                        self._precond_state, self._kfac_iter)
            if self.donate:
                snapshot = tuple(_clone(t) for t in snapshot[:4]) + snapshot[4:]
        use_scan = self.scan_steps > 1 and defer and self.precond_builder is None
        if use_scan:
            rdata = self._scan_epoch_steps(train_loader, mu, rbatch, deferred)
        for j, data in (() if use_scan else enumerate(train_loader)):
            if j == rbatch:
                rdata = data
            with self.timers("G"):
                metrics = self.train_step(data, mu=mu, fetch=not defer)
            self.epoch_pow_iters.append(metrics["pow_iters"])
            if defer:
                deferred.append(metrics)
                self.mem_check()
                continue
            # NaN rollback: reload the last epoch checkpoint (opt.py:696-708)
            if not metrics["step_ok"]:
                ckpt = os.path.join(self.model_dir, self.header2 + CKPT)
                if self._broadcast(os.path.exists(ckpt)):
                    self.model_load(ckpt)
                continue
            self.mem_check()
            if self.verbose:
                vlog.append(f"{j}\t {self.rho:f}\t {self.norm:f}\t "
                            f"{metrics['gradf_norm']:f}\t "
                            f"{metrics['gradg_norm']:f}")
        if defer and deferred:
            # ONE host read per epoch; on any non-finite step restore the
            # epoch-start state (params AND optimizer buffers)
            norms = torch.cat([torch.stack([m["gradf_norm"], m["gradg_norm"]]).reshape(-1)
                               for m in deferred])
            if not meshlib.agree(bool(torch.isfinite(norms).all())):
                (self.params, self.model_state, self.opt_state, self.v,
                 self._precond_state, self._kfac_iter) = snapshot

        if self.epoch_pow_iters:
            self.mean_pow_iters = float(np.mean(self.epoch_pow_iters))
        if self.verbose:
            head = "batch\t rho\t norm\t gradf\t gradg\n" if self.i == 0 else ""
            self._write(self.verbose_log_file, head + "\n".join(vlog) + "\n",
                        "w" if self.i == 0 else "a")

        # epoch end: weighted-mean f over all batches in eval mode
        # (opt.py:730-739), g on one random batch (opt.py:740)
        with self.timers("Test"):
            if use_scan:
                self.f = self._scan_epoch_eval(train_loader)
            else:
                f_sum, w_sum = 0.0, 0.0
                for data in train_loader:
                    loss, _ = self.task.eval_loss(self.params, self.model_state,
                                                  self.put_batch(data))
                    loss, bw = meshlib.all_sum(loss), self._global_weight(data["w"])
                    f_sum = f_sum + loss * bw
                    w_sum += bw
                self.f = float(f_sum) / max(w_sum, 1.0)

        if self.pow_iter and rdata is not None:
            batch = self.put_batch(rdata)
            # the kfac_batch counter ticks on every comp_rho, this one too
            # (opt.py:426-430), so the refit cadence shifts one slot an epoch
            self._refresh_precond(batch)
            eig, model_state = self._rho_step(batch)
            self.v, self.model_state = self._kept(self.v, eig.v), self._kept(self.model_state,
                                                                             model_state)
            self.rho = float(eig.rho)
            self.norm = float(eig.norm)
            self.g = float(spectral.penalty(
                torch.tensor(self.rho, dtype=torch.float64), self.K, self.Kmin))
        self.h = self.f + mu * self.g

        if self.scheduler is not None:
            lr = self.scheduler.step(self.f)
            self.opt_state = self.optimizer.set_learning_rate(self.opt_state, lr)

        self.timers.totals["Iteration"] = (self.timers.totals.get("Iteration", 0.0)
                                           + time.perf_counter() - istart)
        if self.verbose:
            self._write(self.verbose_log_file,
                        self.timers.report(["G", "Test", "Iteration"]) + "\n")

    def _global_weight(self, w) -> float:
        """``sum(w)`` of a batch, over the ranks of an active mesh."""
        if meshlib.current() is None:
            return float(np.sum(w))
        return float(meshlib.all_sum(torch.tensor(float(np.sum(w)), dtype=torch.float64,
                                                  device=self.device)))

    # ------------------------------------------------------------------
    # chunks of scan_steps batches (JAX trainer lines 1063-1130)
    # ------------------------------------------------------------------
    def _put_stacked(self, batches) -> Dict[str, torch.Tensor]:
        """``k`` batches stacked along a new leading axis on the device in
        one transfer each entry: host arrays through pinned memory with
        ``non_blocking``, device tensors by ``torch.stack`` there."""
        out = {}
        for k, first in batches[0].items():
            if isinstance(first, torch.Tensor):
                out[k] = torch.stack([b[k] for b in batches]).to(self.device)
                continue
            host = torch.from_numpy(np.stack([np.asarray(b[k]) for b in batches]))
            if self.device.type == "cuda":
                host = host.pin_memory()
            out[k] = host.to(self.device, non_blocking=True)
        return out

    def _scan_epoch_steps(self, train_loader, mu, rbatch, deferred):
        """The epoch's steps in chunks of ``scan_steps`` batches (a short
        last chunk too); returns the epoch's random batch."""
        rdata, buf = None, []
        for j, data in enumerate(train_loader):
            if j == rbatch:
                rdata = data
            buf.append(data)
            if len(buf) == self.scan_steps:
                self._run_scan_chunk(buf, mu, deferred)
                buf = []
        if buf:
            self._run_scan_chunk(buf, mu, deferred)
        return rdata

    def _run_scan_chunk(self, buf, mu, deferred) -> None:
        """One chunk: its batches in one stacked transfer, its dropout keys
        in the per-step order, its steps back to back, committed without a
        host read; the chunk's norms stay on the device."""
        if self.params is None:
            self.init_state()
        stacked = self._put_stacked(buf)
        keys = [self._dropout_key() for _ in buf]
        gradf, gradg = [], []
        with self.timers("G"):
            for i, key in enumerate(keys):
                batch = {k: t[i] for k, t in stacked.items()}
                *state, metrics = self._step_body(self.params, self.model_state,
                                                  self.opt_state, self.v, batch,
                                                  float(mu), None, key)
                self._commit(*state)
                gradf.append(metrics["gradf_norm"])
                gradg.append(metrics["gradg_norm"])
                self.epoch_pow_iters.append(metrics["pow_iters"])
        deferred.append({"gradf_norm": torch.stack(gradf), "gradg_norm": torch.stack(gradg)})
        self.mem_check()

    def _scan_epoch_eval(self, train_loader) -> float:
        """The epoch-end weighted-mean ``f`` chunk by chunk: each chunk's
        per-batch losses stay on the device until every chunk has run,
        then times the host weights, summed on the host (JAX trainer
        lines 1105-1130)."""
        chunks, buf = [], []

        def flush():
            stacked = self._put_stacked(buf)
            losses = torch.stack([
                self.task.eval_loss(self.params, self.model_state,
                                    {k: t[i] for k, t in stacked.items()})[0]
                for i in range(len(buf))])
            chunks.append((meshlib.all_sum(losses),
                           np.asarray([self._global_weight(b["w"]) for b in buf])))
            buf.clear()

        for data in train_loader:
            buf.append(data)
            if len(buf) == self.scan_steps:
                flush()
        if buf:
            flush()
        f_sum = sum(float(np.sum(host(l) * b)) for l, b in chunks)
        w_sum = sum(float(np.sum(b)) for _, b in chunks)
        return f_sum / max(w_sum, 1.0)

    # ------------------------------------------------------------------
    # full training (reference train(), opt.py:771-871)
    # ------------------------------------------------------------------
    def train(self, inputs=None, target=None, inputs_valid=None,
              target_valid=None, train_loader: Optional[ArrayLoader] = None,
              valid_loader: Optional[ArrayLoader] = None,
              train_loader_na: Optional[ArrayLoader] = None,
              crops: bool = False):
        start = time.time()
        if train_loader is None:
            if inputs is None or target is None:
                raise ValueError("No input data")
            train_loader = _as_loader((inputs, target), self.batch_size)
        if valid_loader is None and inputs_valid is not None:
            valid_loader = _as_loader((inputs_valid, target_valid), self.batch_size)

        # the JAX trainer draws an example batch here; drawing it too keeps
        # a shuffling loader's order the same in both
        next(iter(train_loader))
        self.init_state()

        os.makedirs(self.log_dir, exist_ok=True)
        os.makedirs(self.model_dir, exist_ok=True)
        has_valid = valid_loader is not None
        start_epoch, self._resume_epoch = self._resume_epoch, 0
        if start_epoch == 0 or not os.path.exists(self.log_file):
            self._write(self.log_file, "epoch\t f\t rho\t h\t norm"
                        + ("\t val_acc\t val_f1" if has_valid else "") + "\n", "w")
        if start_epoch == 0:
            self._h_hist = []
        for self.i in range(start_epoch, self.max_iter):
            self.iter_epoch(train_loader)
            self.save()

            row = f"{self.i}\t {self.f:f}\t {self.rho:f}\t {self.h:f}\t {self.norm:f}"
            if has_valid:
                _, self.val_acc, val_f1 = self.test_model(loader=valid_loader)
                if self.val_acc is None:  # 'conf': no accuracy, no best model
                    self.val_acc, val_f1 = float("nan"), float("nan")
                # best_h compares with `>` though h is minimised: the
                # reference's rule (opt.py:821-825)
                if self.best_h_val and self.h > self.best_h:
                    self.best_h = self.h
                    self._new_best()
                elif not self.best_h_val and self.val_acc > self.best_val_acc:
                    self.best_val_acc = self.val_acc
                    self._new_best()
                row += f"\t {self.val_acc:f}\t {val_f1:f}"
            self._write(self.log_file, row + "\n")
            self._h_hist.append(float(self.h))
            # after the append, so the checkpoint's CoV window holds this
            # epoch (the JAX trainer saves first, and a resume from its
            # per-epoch checkpoint misses the last h)
            if self.full_ckpt:
                self.save_full()

            # coefficient-of-variation stop over the last 10 h
            # (opt.py:841-845); eps defaults to -1, which never stops
            if self.i >= self.min_iter - 1 and len(self._h_hist) >= 2:
                window = self._h_hist[-10:]
                if self._agree(float(np.std(window) / np.abs(np.mean(window))) <= self.eps):
                    break

        elapsed = time.time() - start
        best = (f"Best H: {self.best_h}" if self.best_h_val
                else f"Best Validation Accuracy: {self.best_val_acc}")
        self._write(self.log_file,
                    f"Time elapsed: {elapsed // 3600:2.0f} hrs, "
                    f"{(elapsed % 3600) // 60:2.0f} min, {elapsed % 60:4.2f} sec\n"
                    f"Best Iterate: {self.best_iter}\n{best}\nRho: {self.best_rho}\n")

        # the best model on the train set (opt.py:868-871)
        if has_valid:
            self.test_set(loader=train_loader_na if train_loader_na is not None
                          else train_loader, label="Train", crops=crops)

    def _write(self, path: str, text: str, mode: str = "a") -> None:
        """Write ``text`` to the log ``path``; under a mesh rank 0 alone
        writes."""
        if self._writer:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            with open(path, mode) as fh:
                fh.write(text)

    def _agree(self, flag: bool) -> bool:
        """A host decision taken once for every rank of the mesh."""
        with meshlib.active(self.mesh):
            return meshlib.agree(flag)

    def _new_best(self):
        self.best_rho = self.rho
        self.best_iter = self.i
        self.save(CKPT_BEST)

    # ------------------------------------------------------------------
    # evaluation (reference test_model, opt.py:912-1039)
    # ------------------------------------------------------------------
    def test_model(self, x=None, y=None, loader=None, classes=None,
                   model_classes=None, other_classes=None, crops: bool = False):
        """``(loss, accuracy, F1)`` over ``loader`` (JAX trainer lines
        1243-1372), the loss the mean of per-batch losses weighted by the
        batch's real rows.

        ``test_func`` picks the rest: ``'sigmoid'``/``'logit'`` put the
        outputs through a sigmoid after the loss; ``'max'`` predicts the
        arg max, else the outputs over 0.5; ``'acc'`` is the accuracy %.
        With ``'auc'`` the accuracy slot holds the ``nanmean`` over
        classes of the per-class ROC AUC (NaN labels masked, NaN for a
        class with one label value) and the F1 slot the mean per-class
        micro-F1; with ``'conf'`` the confusion matrix goes to
        ``<header2>_conf_matrix.csv`` and both are None; otherwise both
        are per-batch means weighted like the loss.

        ``classes`` keeps those target columns and ``model_classes`` (or
        ``classes``) those output columns, before the loss;
        ``other_classes`` keeps, in the AUC, the rows whose NaN-skipping
        count of positives outside ``classes`` is one of them.  A 5-D
        batch under ``crops`` is ``(B, crops, H, W, C)``, and the outputs
        are the mean over its crops.

        Under a mesh of several ranks each rank runs its own rows and the
        outputs are gathered (:meth:`_eval_outputs_sharded`), so every rank
        returns the one-device metrics."""
        if loader is None:
            loader = _as_loader((x, y), self.batch_size)
        if isinstance(other_classes, int):
            other_classes = [other_classes]
        if self.mesh is not None and self.mesh.world > 1:
            loader = self._eval_outputs_sharded(loader, crops)
        tf = self.test_func
        f_list, acc_list, f1_list, sizes = [], [], [], []
        outputs_all, labels_all, oc = [], [], []
        for data in loader:
            nreal = int(np.sum(np.asarray(data["w"]) > 0))
            if "ops" in data:
                ops, out_dtype = data["ops"][:nreal], None
            else:
                # the loss in the outputs' dtype, as the JAX package takes
                # it; the metrics on their values widened to float32
                out = self._predict(data, crops)
                ops, out_dtype = host(out)[:nreal], out.dtype
            target = np.asarray(data["y"])[:nreal]
            sizes.append(nreal)
            if other_classes is not None and classes is not None:
                rest = [i for i in range(target.shape[1]) if i not in classes]
                oc.extend(np.nansum(target[:, rest], axis=1))
            # class subsetting before the loss (reference comp_f, opt.py:558-563)
            if classes is not None and target.ndim > 1:
                target = target[:, classes]
                ops = ops[:, model_classes if model_classes is not None else classes]
            out = torch.from_numpy(ops)
            f_list.append(float(self.task.loss(out.to(out_dtype or out.dtype),
                                               torch.from_numpy(target), None)))
            if "sigmoid" in tf or "logit" in tf:
                ops = 1.0 / (1.0 + np.exp(-ops))
            predicted = (np.argmax(ops, axis=1) if "max" in tf
                         else (ops > 0.5).astype(np.float32))
            if "acc" in tf:
                acc_list.append(float(np.mean(predicted == target)) * 100)
            if "auc" in tf or "conf" in tf:
                outputs_all.append(ops if "auc" in tf else predicted)
                labels_all.append(target)
            else:
                f1_list.append(f1_micro(target, predicted))
        if "auc" in tf:
            labels, outputs = np.concatenate(labels_all), np.concatenate(outputs_all)
            keep = (None if other_classes is None
                    else np.asarray([o in other_classes for o in oc], bool))
            roc, f1s = [], []
            for i in range(outputs.shape[1]):
                o2, l2 = outputs[:, i], labels[:, i]
                if keep is not None:
                    o2, l2 = o2[keep], l2[keep]
                good = l2 == l2  # NaN-label masking (opt.py:1015-1017)
                o2, l2 = o2[good], l2[good]
                roc.append(roc_auc(l2, o2))
                f1s.append(f1_micro(l2, (o2 > 0.5).astype(np.float32)))
            test_acc, test_f1 = float(np.nanmean(roc)), float(np.mean(f1s))
        elif "conf" in tf:
            cm = confusion_matrix(np.concatenate(labels_all), np.concatenate(outputs_all))
            if self._writer:
                os.makedirs(self.log_dir, exist_ok=True)
                np.savetxt(os.path.join(self.log_dir, self.header2 + "_conf_matrix.csv"),
                           cm, delimiter=",")
            test_acc = test_f1 = None
        else:
            test_acc = float(np.average(acc_list, weights=sizes))
            test_f1 = float(np.average(f1_list, weights=sizes))
        return float(np.average(f_list, weights=sizes)), test_acc, test_f1

    def _predict(self, data, crops: bool = False) -> torch.Tensor:
        """Eval-mode outputs of a batch; a 5-D batch under ``crops`` is
        ``(B, crops, H, W, C)`` and gives the mean over its crops."""
        batch = self.put_batch(data)
        xb = batch["x"]
        with meshlib.active(self.mesh, self._sharding):  # the sharded layers' columns
            if crops and xb.dim() == 5:
                flat = {**batch, "x": xb.reshape((-1,) + tuple(xb.shape[2:]))}
                out = self.task.predict(self.params, self.model_state, flat)
                return out.reshape(xb.shape[0], xb.shape[1], -1).mean(dim=1)
            return self.task.predict(self.params, self.model_state, batch)

    def _eval_is_contributor(self) -> bool:
        """Whether this rank's evaluation rows count (JAX trainer lines
        380-413): the lowest rank of each data coordinate contributes, its
        ``model``-axis replicas would send ``w = 0``.  Ranks lie ``(data,
        model)`` in order, so that is ``rank % model == 0``, every rank
        while the ``model`` axis is 1."""
        return self.mesh.rank % self.mesh.model == 0

    def _eval_outputs_sharded(self, loader, crops: bool = False):
        """Evaluation over a mesh (JAX trainer lines 415-496): each rank
        runs the forward pass on its local rows only, and the outputs,
        labels and weights are gathered, never the inputs.  A
        ``host_shard`` loader's batches are the rank's rows already; from
        a loader that gives every rank the same batches each rank of the
        world takes its stripe of ``ceil(B / ranks)`` rows, the tail
        clamped and weighted 0.  Under a sharding the ranks of a ``model``
        group compute one forward together, so the stripes are the data
        coordinates' and the ``model`` replicas send ``w = 0``, as they
        do from a ``host_shard`` loader.  Rows of weight 0 are dropped
        after the gather; the outputs keep their dtype (JAX casts them to
        float32)."""
        mesh = self.mesh
        _check_batch_counts(loader, mesh)
        sharded = getattr(loader, "host_shard", None) is not None
        split = self._sharding is not None
        contributes = self._eval_is_contributor() if sharded or split else True
        parts, part = (mesh.data, mesh.data_coord) if split else (mesh.world, mesh.rank)
        for data in loader:
            w = np.asarray(data["w"], np.float32)
            data = dict(data)
            if not sharded:
                n = len(w)
                chunk = -(-n // parts)
                idx = np.arange(part * chunk, (part + 1) * chunk)
                valid = idx < n
                idx = np.minimum(idx, n - 1)
                data = {k: v[idx] for k, v in data.items()}
                w = w[idx] * valid
            if not contributes:
                w = np.zeros_like(w)
            ops = self._predict(data, crops)
            gather = lambda t: host(meshlib.all_gather_rows(
                torch.as_tensor(t).to(mesh.device), mesh))
            ops, yb, wb = gather(ops), gather(data["y"]), gather(w)
            keep = wb > 0
            yield {"ops": ops[keep], "y": yb[keep], "w": np.ones(int(keep.sum()), np.float32)}

    def test_model_best(self, x=None, y=None, loader=None, fname=None, **kw):
        self.model_load(fname)
        return self.test_model(x, y, loader, **kw)

    def test_set(self, x=None, y=None, loader=None, fname=None, label="Train", **kw):
        loss, acc, f1 = self.test_model_best(x, y, loader, fname, **kw)
        self._write(self.log_file, f"{label} Loss: {loss}\n{label} Accuracy: {acc}\n"
                    f"{label} F1: {f1}\n")
        return loss, acc, f1

    @_on_mesh
    def rho_test(self, x=None, y=None, loader=None, fname=None):
        """``rho`` on every batch of ``loader`` (opt.py:882-910): writes
        ``<header2>_rho_test.csv`` with rows ``batch, rho, norm, iters,
        res_change, seconds`` and returns the columns after the first,
        averaged with the batches' weights."""
        if fname is not None:
            self.model_load(fname)
        if loader is None:
            loader = _as_loader((x, y), self.batch_size)
        rows, sizes = [], []
        for j, data in enumerate(loader):
            batch = self.put_batch(data)
            t0 = time.perf_counter()
            eig, self.model_state = self._rho_step(batch)
            rho, norm, res = torch.stack(
                [eig.rho, eig.norm, eig.res_change]).to(torch.float64).tolist()
            dt = time.perf_counter() - t0
            self.v = eig.v
            rows.append([j, rho, norm, eig.iters, res, dt])
            sizes.append(self._global_weight(data["w"]))
        return self._rho_csv(rows, sizes)

    def _rho_csv(self, rows, sizes):
        arr = np.asarray(rows, dtype=float)
        if self._writer:
            os.makedirs(self.log_dir, exist_ok=True)
            np.savetxt(os.path.join(self.log_dir, self.header2 + "_rho_test.csv"),
                       arr, delimiter=",")
        return np.average(arr, axis=0, weights=sizes)[1:]

    @_on_mesh
    def rho_test_fused(self, x=None, y=None, loader=None, fname=None):
        """The JAX package's all-batch ``rho`` audit, batch by batch: every
        batch starts from the uniform vector (the reference's
        ``random_v``, opt.py:324-325) instead of the previous batch's
        eigenvector, the BN running statistics do not advance and
        ``self.v`` is left alone.  Writes ``rho_test``'s CSV schema; the
        time column is each batch's wall time, sync included.  (The JAX
        version runs its batches ``vmap``-ed in one program; here each is
        its own solve.)  Under a preconditioner, whose refits are
        sequential state, it is :meth:`rho_test` (JAX trainer lines
        1464-1468)."""
        if self.precond_builder is not None:
            return self.rho_test(x=x, y=y, loader=loader, fname=fname)
        if fname is not None:
            self.model_load(fname)
        if loader is None:
            loader = _as_loader((x, y), self.batch_size)
        rows, sizes = [], []
        for j, data in enumerate(loader):
            batch = self.put_batch(data)
            t0 = time.perf_counter()
            _, hvp_fn = self._linearize(self._loss_fn(self.model_state, self._dropout_key()),
                                        self.params, batch)
            eig = self._eig(hvp_fn, tree_uniform_like(self.params))
            rho, norm, res = torch.stack(
                [eig.rho, eig.norm, eig.res_change]).to(torch.float64).tolist()
            rows.append([j, rho, norm, eig.iters, res, time.perf_counter() - t0])
            sizes.append(self._global_weight(data["w"]))
        return self._rho_csv(rows, sizes)

    @_on_mesh
    def spectrum_test(self, x=None, y=None, loader=None, k: int = 4,
                      eps: float = 1e-4, max_iter: int = 200,
                      method: str = "subspace", lanczos_m: int = 0,
                      starts: Optional[Sequence] = None):
        """The leading ``k`` eigenvalues of each batch's Hessian; writes
        ``<header2>_spectrum_test.csv``, one row per batch: the
        eigenvalues, their residuals, the sweeps or HVPs.

        ``method="subspace"`` runs block power iteration to ``eps`` within
        ``max_iter`` sweeps from the uniform vector and ``k - 1`` normal
        rows (``eigen.subspace_iteration``, the same rows every batch);
        ``method="lanczos"`` takes all ``k`` from one Krylov build of
        ``lanczos_m`` steps (default ``max(4k, 16)``) from the uniform
        vector plus a ``1e-2``-long normal perturbation drawn per batch
        from the trainer's generator (``eigen.lanczos_spectrum``).
        ``starts``, one entry per batch, replaces the random draws: the
        ``(k, n)`` start block in ``tree_ravel`` order (subspace) or the
        perturbation tree before scaling (lanczos)."""
        if loader is None:
            loader = _as_loader((x, y), self.batch_size)
        if method not in ("subspace", "lanczos"):
            raise ValueError(f"spectrum_test method {method!r}")
        m_lz = int(lanczos_m) or max(4 * k, 16)
        rows = []
        for j, data in enumerate(loader):
            _, hvp_fn = self._linearize(self._loss_fn(self.model_state, self._dropout_key()),
                                        self.params, self.put_batch(data))
            u = tree_uniform_like(self.params)
            start = None if starts is None else starts[j]
            if method == "lanczos":
                # a single-vector Krylov build cannot resolve multiplicity,
                # and the uniform start can span an invariant subspace:
                # perturb it slightly (the JAX trainer's protocol)
                if start is None:
                    shapes = self._sharding.shapes if self._sharding else {}
                    start = {name: torch.randn(shapes.get(name, t.shape),
                                               generator=self.generator,
                                               dtype=t.dtype).to(t.device)
                             for name, t in self.params.items()}
                if self._sharding is not None:
                    start = self._sharding.local(start)
                v0 = tree_axpy(1e-2 / tree_norm(start), start, u)
                res = eigen.lanczos_spectrum(hvp_fn, v0, k=k, m=m_lz)
            else:
                res = eigen.subspace_iteration(hvp_fn, u, k=k, eps=eps,
                                               max_iter=max_iter, start=start)
            rows.append(res.eigenvalues.tolist() + res.resid.tolist() + [res.iters])
        arr = np.asarray(rows, dtype=float)
        if self._writer:
            os.makedirs(self.log_dir, exist_ok=True)
            np.savetxt(os.path.join(self.log_dir, self.header2 + "_spectrum_test.csv"),
                       arr, delimiter=",")
        return arr

    # ------------------------------------------------------------------
    # checkpoints (opt.py:765-769, 1041-1071)
    # ------------------------------------------------------------------
    def save(self, tail: str = CKPT):
        """The parameters, BN statistics, eigenvector and epoch; under a
        mesh rank 0 writes them, gathered under a sharding."""
        params, v = self._full(self.params), self._full(self.v)
        if not self._writer:
            return
        checkpoints.save_checkpoint(
            os.path.join(self.model_dir, self.header2 + tail),
            {"params": params, "model_state": self.model_state,
             "v": v, "epoch": self.i})

    def save_full(self, tail: str = CKPT_FULL):
        """Everything an exact resume needs: ``save``'s payload plus the
        optimizer state, the best-model tracking, the CoV window, the
        LOBPCG preconditioner with its refit counter and the dropout keys
        drawn (the JAX package's checkpoint leaves the first two out).
        Under a mesh rank 0 writes it, gathered under a sharding."""
        full = [self._full(t) for t in (self.params, self.opt_state, self.v)]
        if not self._writer:
            return
        checkpoints.save_checkpoint(
            os.path.join(self.model_dir, self.header2 + tail),
            {"params": full[0], "model_state": self.model_state,
             "opt_state": full[1], "v": full[2], "epoch": self.i,
             "best": [self.best_val_acc, self.best_h, self.best_rho,
                      float(self.best_iter)],
             "h_hist": list(self._h_hist),
             "precond_state": self._precond_state, "kfac_iter": self._kfac_iter,
             "dropout_draws": self._dropout_draws})

    def resume(self, fname: Optional[str] = None):
        """Restore a ``save_full`` checkpoint; the next ``train()``
        continues from the epoch after it.  Under a mesh rank 0 reads it
        and every rank takes its payload (its slices under a sharding)."""
        self.init_state()
        if fname is None:
            fname = os.path.join(self.model_dir, self.header2 + CKPT_FULL)
        payload = self._load_state(
            self._broadcast(checkpoints.load_checkpoint(fname) if self._writer else None))
        self.opt_state = checkpoints.restore_like(self.opt_state, payload["opt_state"])
        self.i = int(payload["epoch"])
        b = payload["best"]
        self.best_val_acc, self.best_h = float(b[0]), float(b[1])
        self.best_rho, self.best_iter = float(b[2]), int(b[3])
        self._h_hist = [float(h) for h in payload["h_hist"]]
        # (a checkpoint written before LOBPCG was ported has neither)
        self._precond_state = checkpoints.to_device(payload.get("precond_state"), self.device)
        self._kfac_iter = int(payload.get("kfac_iter", self.kfac_batch))
        self._dropout_draws = int(payload.get("dropout_draws", 0))
        self._resume_epoch = self.i + 1

    def model_load(self, fname: Optional[str] = None):
        """Load a checkpoint's parameters, BN statistics and eigenvector;
        by default the best model, else the last epoch's.  Under a mesh rank
        0 reads it and every rank takes its payload."""
        self.init_state()
        payload = None
        if self._writer:
            if fname is None:
                fname = os.path.join(self.model_dir, self.header2 + CKPT_BEST)
                if not os.path.exists(fname):
                    fname = os.path.join(self.model_dir, self.header2 + CKPT)
            payload = checkpoints.load_checkpoint(fname)
        self._load_state(self._broadcast(payload))

    def _load_state(self, payload):
        """Take a checkpoint's params, BN statistics and eigenvector (this
        rank's slices under a sharding); returns the payload so cut."""
        if self._sharding is not None:
            payload = self._sharding.local(payload)
        self.params = checkpoints.restore_like(self.params, payload["params"])
        self.model_state = checkpoints.restore_like(self.model_state,
                                                    payload["model_state"])
        self.v = checkpoints.restore_like(self.v, payload["v"])
        return payload

    # ------------------------------------------------------------------
    # log summary (reference parse(), opt.py:1244-1257)
    # ------------------------------------------------------------------
    def parse(self) -> Dict[str, str]:
        """The log's last lines as a summary; under a mesh rank 0's."""
        out: Dict[str, str] = {}
        if self._writer:
            with open(self.log_file) as fh:
                lines = fh.readlines()[-10:]
            for ln in lines:
                if ":" in ln:
                    k, _, val = ln.partition(":")
                    out[k.strip().replace(" ", "_")] = val.strip()
            self._write(os.path.join(self.log_dir, self.header2 + "_summary.tsv"),
                        "\t".join(out.keys()) + "\n" + "\t".join(out.values()) + "\n", "w")
        return self._broadcast(out)
