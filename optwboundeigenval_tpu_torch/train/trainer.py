"""SpectralTrainer — one spectral-regularized training step on the card
(counterpart of ``optwboundeigenval_tpu/train/trainer.py``; the epoch
loop, logging, evaluation and checkpoints are not ported yet).

A step (``_step_body``, reference ``iter()`` body, opt.py:580-763):

1. gradient of the task loss and an HVP map (micro-batched when
   ``hvp_micro > 1``, through the CUDA accumulate kernel);
2. damped power iteration for ``rho``, warm-started from the carried
   eigenvector;
3. the penalty ``g`` and, when ``g > 0``, ``grad g`` from the vGHv pass;
4. ``p = grad f + mu * grad g`` and the optimizer step;
5. the BatchNorm running statistics, updated on the full batch at the
   PRE-step parameters (the reference advances them in comp_rho's
   forward, before the step mutates the weights).

State ``(params, model_state, opt_state, v)`` is carried explicitly.
Entry points run on the card: ``device=None`` means ``cuda``, and a
machine without one raises; pass ``device="cpu"`` to run on the CPU.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Union

import numpy as np
import torch

from optwboundeigenval_tpu_torch.ops import curvature, eigen, spectral
from optwboundeigenval_tpu_torch.optim.api import Optimizer
from optwboundeigenval_tpu_torch.train.task import Task
from optwboundeigenval_tpu_torch.utils.tree import tree_norm, tree_uniform_like


def resolve_device(device=None) -> torch.device:
    """``None`` means the card; raise rather than run silently on the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: optwboundeigenval_tpu_torch runs on the GPU "
                "unless device='cpu' is passed")
        device = "cuda"
    return torch.device(device)


# options of the JAX trainer that this port does not implement yet, with
# the value under which they are inert
_UNPORTED = {
    "lobpcg": False, "precond_builder": None, "scan_steps": 1, "mesh": None,
    "remat": False, "donate": False, "mem_track": False, "profile_dir": None,
    "rand_init": False,
}


class SpectralTrainer:
    """Constructor subset of the JAX trainer (reference opt.py:239-316).
    ``mu`` is a scalar or a callable of the epoch index;
    ``pow_iter_alpha`` a scalar or a callable of the power-iteration
    index.  The options of ``_UNPORTED`` raise ``NotImplementedError``
    when set to anything but their inert value."""

    def __init__(
        self,
        task: Task,
        optimizer: Optimizer,
        scheduler=None,
        *,
        mu: Union[float, Callable[[int], float]] = 0.0,
        K: float = 0.0,
        Kmin: float = 0.0,
        pow_iter_eps: float = 1e-3,
        max_pow_iter: int = 1000,
        pow_iter: bool = True,
        ignore_bad_vals: bool = True,
        rand_init: bool = False,
        pow_iter_alpha: Union[float, Callable] = 1.0,
        pow_iter_momentum: Optional[float] = None,
        eigensolver: str = "power",
        gradg_clip: Optional[float] = None,
        lobpcg: bool = False,
        precond_builder: Optional[Callable] = None,
        mesh=None,
        seed: int = 1226,
        mem_track: bool = False,
        remat: bool = False,
        hvp_micro: int = 0,
        scan_steps: int = 1,
        donate: bool = False,
        profile_dir: Optional[str] = None,
        device=None,
    ):
        given = dict(lobpcg=lobpcg, precond_builder=precond_builder,
                     scan_steps=scan_steps, mesh=mesh, remat=remat,
                     donate=donate, mem_track=mem_track,
                     profile_dir=profile_dir, rand_init=rand_init)
        for name, inert in _UNPORTED.items():
            if given[name] != inert:
                raise NotImplementedError(
                    f"SpectralTrainer({name}={given[name]!r}) is not ported")
        if eigensolver != "power":
            raise NotImplementedError(
                f"SpectralTrainer(eigensolver={eigensolver!r}) is not ported")
        self.device = resolve_device(device)
        self.task = task
        self.optimizer = optimizer
        self.scheduler = scheduler
        self.mu = mu
        self.K = float(K)
        self.Kmin = float(Kmin)
        self.pow_iter_eps = pow_iter_eps
        self.max_pow_iter = max_pow_iter
        self.pow_iter = pow_iter
        self.ignore_bad_vals = ignore_bad_vals
        self.pow_iter_alpha = pow_iter_alpha
        self.pow_iter_momentum = pow_iter_momentum
        self.gradg_clip = gradg_clip
        self.hvp_micro = int(hvp_micro)
        self.generator = torch.Generator().manual_seed(seed)

        self.params = None
        self.model_state = None
        self.opt_state = None
        self.v = None
        self.i = 0  # epoch counter
        self.rho = 0.0
        self.norm = 0.0
        self.g = 0.0

    def init_state(self) -> None:
        """Draw fresh parameters from the trainer's seed; set up the
        optimizer state and the uniform start vector."""
        if self.params is not None:
            return
        self.params, self.model_state = self.task.init(self.generator, self.device)
        self.opt_state = self.optimizer.init(self.params)
        self.v = tree_uniform_like(self.params)

    @property
    def ndim(self) -> int:
        return sum(p.numel() for p in self.params.values())

    def put_batch(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """Batch (numpy arrays or tensors) to tensors on the trainer's device."""
        return {k: torch.as_tensor(v, device=self.device) for k, v in batch.items()}

    def _step_body(self, params, model_state, opt_state, v, batch, mu):
        """Pure per-batch step: returns ``(params, model_state, opt_state,
        v, metrics)`` with the metrics as device tensors."""
        loss_fn = self.task.loss_fn(model_state)
        if self.hvp_micro > 1:
            # memory-bounded path: O(B / micro) activations per pass
            grads_f = curvature.grad_microbatched(loss_fn, params, batch,
                                                  self.hvp_micro)
            hvp_fn = lambda u: curvature.hvp_microbatched(
                loss_fn, params, batch, u, self.hvp_micro)
        else:
            grads_f, hvp_fn = curvature.linearize_hvp(loss_fn, params, batch)

        gradf_norm = tree_norm(grads_f)
        if self.pow_iter:
            eig = eigen.estimate_dominant_eig(
                hvp_fn, v, eps=self.pow_iter_eps, max_iter=self.max_pow_iter,
                alpha=self.pow_iter_alpha, ignore_bad_vals=self.ignore_bad_vals,
                momentum=self.pow_iter_momentum,
            )
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

        new_params, new_opt_state = self.optimizer.step(direction, opt_state,
                                                        params)
        # BN running statistics at the PRE-step params (opt.py:180-186, 421)
        if self.task.has_batch_stats:
            _, new_model_state = self.task.train_loss(params, model_state, batch)
        else:
            new_model_state = model_state
        return new_params, new_model_state, new_opt_state, new_v, metrics

    def train_step(self, batch: Dict[str, Any],
                   mu: Optional[float] = None) -> Dict[str, Any]:
        """Run ONE spectral-regularized step on ``batch`` and commit the
        new ``(params, model_state, opt_state, v)``.

        Returns the metrics as host values plus ``step_ok``.  A step whose
        gradient norms are not finite is NOT committed (the caller
        decides on a rollback, opt.py:696-708)."""
        if self.params is None:
            self.init_state()
        if mu is None:
            mu = self.mu(self.i) if callable(self.mu) else self.mu
        out = self._step_body(self.params, self.model_state, self.opt_state,
                              self.v, self.put_batch(batch), float(mu))
        new_params, new_model_state, new_opt_state, new_v, metrics = out
        # one device-to-host transfer for all tensor metrics
        keys = [k for k, m in metrics.items() if isinstance(m, torch.Tensor)]
        values = torch.stack([metrics[k].to(torch.float64) for k in keys]).tolist()
        metrics.update(zip(keys, values))
        step_ok = bool(np.isfinite(metrics["gradf_norm"])
                       and np.isfinite(metrics["gradg_norm"]))
        if step_ok:
            self.params = new_params
            self.model_state = new_model_state
            self.opt_state = new_opt_state
            self.v = new_v
            self.rho = metrics["rho"]
            self.norm = metrics["norm"]
            self.g = metrics["g"]
        metrics["step_ok"] = step_ok
        return metrics
