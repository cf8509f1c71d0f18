"""K-FAC: Kronecker-factored curvature (counterpart of
``optwboundeigenval_tpu/ops/kfac.py``), for the K-FAC optimizer and for
the preconditioner of the LOBPCG eigensolver mode (reference
opt.py:384-430).

* ``capture``: one forward and one backward over the loss.  Forward
  hooks on every ``nn.Linear``/``nn.Conv2d``, registered for that one
  pass under ``functional_call``, record the layer's input and return
  ``out + tap[name]``, a zero tap per layer; one ``autograd.grad`` over
  the taps gives every grad-output.  A layer called twice (ForestNet's
  ``fc2``) keeps the input of its LAST call and the SUM of both calls'
  grad-outputs (the same tap is added to both outputs), as the JAX
  package's interceptor does (kfac.py:110, 125-126).
* ``cov_a``/``cov_g``: the activation and grad-output covariances
  (ComputeCovA/ComputeCovG, kfac.py:277-367), conv patches by
  ``F.unfold`` in torch's ``(in_c, kh, kw)`` order (the JAX package's
  are ``(kh, kw, in_c)``; ``utils/interop.py`` permutes between them),
  the bias column last, padded rows masked and the real example count as
  the normaliser.
* the running factors ``m = decay * m + (1 - decay) * cov`` from
  identity, their ``eigh`` with eigenvalues under ``1e-10`` set to 0, and
  the natural gradient ``Q_g (Q_g^T M Q_a / (d_g d_a^T + damping))
  Q_a^T`` per layer of a parameter dict.

Factors are ``{layer name: {"m_aa", "m_gg", "Q_a", "d_a", "Q_g",
"d_g"}}`` tensors on the parameters' device; products and ``eigh`` run
there (``torch.matmul``, ``torch.linalg.eigh``).  Sampled "true-Fisher"
targets (kfac.py:85-96) come from :func:`sample_fisher_targets`, drawn from an
explicit generator, so a caller can also hand ``capture`` targets drawn
elsewhere.

Under a data-parallel mesh (``parallel/mesh.py``) the covariances are
the global batch's: each rank's contraction over its rows, all-reduced
over the ``data`` group, with the global example count and weight;
sampled targets are drawn for the global outputs gathered over the
``data`` group, the same draw on every rank, and each rank keeps its
rows.  Under a sharding (``parallel/sharding.py``) the factors are whole
layers' as in one process: :func:`fit_factors` captures on the gathered
weights, and :func:`precond_apply` gathers the residual, applies the
inverse and returns this rank's slices.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from optwboundeigenval_tpu_torch.parallel import mesh as meshlib

Tree = Dict[str, torch.Tensor]
LayerFactors = Dict[str, torch.Tensor]
Factors = Dict[str, LayerFactors]
BCE_LOSSES = ("bce_with_logits", "weighted_bce_with_logits")


class LayerCapture(NamedTuple):
    a: torch.Tensor  # the layer's input
    g: torch.Tensor  # dL / d(layer output)
    conv: Optional[tuple]  # (kernel_size, stride, padding, dilation), None for dense
    w: Optional[torch.Tensor] = None  # per-example padding weights


def factored_layers(model: nn.Module) -> Dict[str, nn.Module]:
    """The layers K-FAC factors: every ``nn.Linear`` and ``nn.Conv2d``."""
    return {name: m for name, m in model.named_modules()
            if isinstance(m, (nn.Linear, nn.Conv2d))}


@torch.no_grad()
def sample_fisher_targets(task, params: Tree, model_state: Tree, batch,
                          generator: torch.Generator) -> torch.Tensor:
    """Targets drawn from the model's own predictive distribution (eval
    mode), the reference's ``comp_fisher`` (opt.py:348-360): Bernoulli of
    the sigmoid for the BCE losses on multi-label outputs, categorical of
    the softmax otherwise.  Drawn on the host from ``generator``."""
    out = task.predict(params, model_state, batch)
    mesh = meshlib.current()
    first, _ = meshlib.global_rows(len(out))
    rows = slice(first, first + len(out))
    if mesh is not None:
        out = meshlib.all_gather_rows(out, mesh, "data")
    if out.dim() > 1 and task.loss.__name__ in BCE_LOSSES:
        y = torch.bernoulli(torch.sigmoid(out).cpu(), generator=generator)
        return y[rows].to(out.device, torch.float32)
    probs = torch.softmax(out.double(), dim=-1).cpu()
    return torch.multinomial(probs, 1, generator=generator)[rows, 0].to(out.device)


def capture(task, params: Tree, model_state: Tree, batch,
            targets: Optional[torch.Tensor] = None, key: Optional[int] = None):
    """One train-mode forward and backward: ``(loss, {layer name:
    LayerCapture})``.  ``targets`` replaces ``batch["y"]`` in the loss
    (sampled targets); the BatchNorm running statistics do not move; a
    dropout task's masks come from ``key``, the capture's own (JAX
    kfac.py:131, 159)."""
    layers = factored_layers(task.model)
    acts: Tree = {}
    taps: Tree = {}

    def hook(name):
        def record(module, inputs, out):
            acts[name] = inputs[0].detach()
            if name not in taps:
                taps[name] = torch.zeros_like(out, requires_grad=True)
            return out + taps[name]
        return record

    handles = [m.register_forward_hook(hook(name)) for name, m in layers.items()]
    try:
        with torch.enable_grad():
            out = task._apply({k: p.detach() for k, p in params.items()},
                              model_state, batch["x"], True, key=key)
            y = batch["y"] if targets is None else targets
            loss = task.loss(out, y, batch.get("w"))
            names = list(taps)
            grads = torch.autograd.grad(loss, [taps[k] for k in names])
    finally:
        for h in handles:
            h.remove()
    caps = {}
    for name, g in zip(names, grads):
        m = layers[name]
        conv = ((m.kernel_size, m.stride, m.padding, m.dilation)
                if isinstance(m, nn.Conv2d) else None)
        caps[name] = LayerCapture(a=acts[name], g=g, conv=conv, w=batch.get("w"))
    return loss.detach(), caps


def _padding_stats(w, batch: int, dtype, device):
    """``(mask, n, sum_w)``: the real-row mask, the real example count and
    the total weight (kfac.py:231-246); without weights every row is
    real."""
    if w is None:
        b = meshlib.all_sum(torch.tensor(float(batch), dtype=dtype, device=device))
        return None, b, b
    mask = (w > 0).to(dtype)
    n = torch.clamp_min(meshlib.all_sum(mask.sum()), 1.0)
    return mask, n, torch.clamp_min(meshlib.all_sum(w.to(dtype).sum()), 1e-12)


def _with_bias(a: torch.Tensor) -> torch.Tensor:
    return torch.cat([a, torch.ones((a.shape[0], 1), dtype=a.dtype, device=a.device)], 1)


def cov_a(cap: LayerCapture, has_bias: bool) -> torch.Tensor:
    """Activation covariance (ComputeCovA, kfac.py:249-274): padded rows
    masked, divided by the real example count."""
    a = cap.a
    mask, n, _ = _padding_stats(cap.w, a.shape[0], a.dtype, a.device)
    if cap.conv is not None:
        ksize, stride, padding, dilation = cap.conv
        a = F.unfold(a, ksize, dilation=dilation, padding=padding, stride=stride)
        spatial = a.shape[2]
        a = a.transpose(1, 2).reshape(-1, a.shape[1])  # rows example-major
        if has_bias:
            a = _with_bias(a)
        if mask is not None:
            a = a * torch.repeat_interleave(mask, spatial)[:, None]
        a = a / spatial
        return meshlib.all_sum(a.T @ (a / n))
    a = a.reshape(a.shape[0], -1)
    if has_bias:
        a = _with_bias(a)
    if mask is not None:
        a = a * mask[:, None]
    return meshlib.all_sum(a.T @ (a / n))


def cov_g(cap: LayerCapture, batch_averaged: bool = True) -> torch.Tensor:
    """Grad-output covariance (ComputeCovG, kfac.py:277-302); the loss is
    a weighted mean, so ``batch_averaged`` rescales by ``sum(w)``."""
    g = cap.g
    mask, n, sum_w = _padding_stats(cap.w, g.shape[0], g.dtype, g.device)
    if cap.conv is not None:
        spatial = g.shape[2] * g.shape[3]
        g = g.permute(0, 2, 3, 1).reshape(-1, g.shape[1])
        if mask is not None:
            g = g * torch.repeat_interleave(mask, spatial)[:, None]
        if batch_averaged:
            g = g * sum_w
        g = g * spatial
        return meshlib.all_sum(g.T @ (g / (n * spatial)))
    g = g.reshape(g.shape[0], -1)
    if mask is not None:
        g = g * mask[:, None]
    if batch_averaged:
        g = g * sum_w
    return meshlib.all_sum(g.T @ (g / n))


def _has_bias(params: Tree, name: str) -> bool:
    return f"{name}.bias" in params


def init_factors(model: nn.Module, params: Tree) -> Factors:
    """Identity running factors for every factored layer (kfac.py:329-345),
    their sizes read off the weights: ``A`` is ``fan_in (+1 for the
    bias)``, ``G`` the output width."""
    out = {}
    for name in factored_layers(model):
        w = params[f"{name}.weight"]
        na = w[0].numel() + _has_bias(params, name)
        ng = w.shape[0]
        eye = lambda n: torch.eye(n, dtype=w.dtype, device=w.device)
        ones = lambda n: torch.ones(n, dtype=w.dtype, device=w.device)
        out[name] = {"m_aa": eye(na), "m_gg": eye(ng), "Q_a": eye(na),
                     "d_a": ones(na), "Q_g": eye(ng), "d_g": ones(ng)}
    return out


def update_factors(factors: Factors, caps: Dict[str, LayerCapture], params: Tree,
                   stat_decay: float = 0.95, batch_averaged: bool = True) -> Factors:
    """EMA update ``m = decay * m + (1 - decay) * cov`` (kfac.py:348-366)."""
    out = dict(factors)
    for name, cap in caps.items():
        f = factors[name]
        aa = cov_a(cap, _has_bias(params, name))
        gg = cov_g(cap, batch_averaged)
        out[name] = {**f, "m_aa": stat_decay * f["m_aa"] + (1 - stat_decay) * aa,
                     "m_gg": stat_decay * f["m_gg"] + (1 - stat_decay) * gg}
    return out


def compute_inverses(factors: Factors, eps: float = 1e-10) -> Factors:
    """``eigh`` of each factor, eigenvalues below ``eps`` set to 0
    (kfac.py:369-379)."""
    out = {}
    for name, f in factors.items():
        d_a, Q_a = torch.linalg.eigh(f["m_aa"])
        d_g, Q_g = torch.linalg.eigh(f["m_gg"])
        out[name] = {**f, "Q_a": Q_a, "d_a": d_a * (d_a > eps),
                     "Q_g": Q_g, "d_g": d_g * (d_g > eps)}
    return out


def natural_grad_matrix(f: LayerFactors, m: torch.Tensor, damping: float) -> torch.Tensor:
    """``Q_g (Q_g^T m Q_a / (d_g d_a^T + damping)) Q_a^T`` (kfac.py:413-418)."""
    v1 = f["Q_g"].T @ m @ f["Q_a"]
    v2 = v1 / (f["d_g"][:, None] * f["d_a"][None, :] + damping)
    return f["Q_g"] @ v2 @ f["Q_a"].T


def to_matrix(tree: Tree, name: str) -> torch.Tensor:
    """Layer ``name``'s weight (and bias) in matrix form ``(out, fan_in
    (+1))`` (kfac.py:387-397): torch's weights are already ``(out, ...)``."""
    w = tree[f"{name}.weight"]
    m = w.reshape(w.shape[0], -1)
    b = tree.get(f"{name}.bias")
    return m if b is None else torch.cat([m, b.reshape(-1, 1)], 1)


def apply_to_tree(factors: Factors, tree: Tree, damping: float = 0.0) -> Tree:
    """The factored inverse applied to every factored layer of a
    gradient-like dict; the other entries pass through (kfac.py:421-453,
    opt.py:399)."""
    out = dict(tree)
    for name, f in factors.items():
        key = f"{name}.weight"
        nat = natural_grad_matrix(f, to_matrix(tree, name), damping)
        has_bias = f"{name}.bias" in tree
        w = tree[key]
        out[key] = (nat[:, :-1] if has_bias else nat).reshape(w.shape)
        if has_bias:
            out[f"{name}.bias"] = nat[:, -1]
    return out


def fit_factors(task, params: Tree, model_state: Tree, batch,
                generator: Optional[torch.Generator] = None, *,
                prev: Optional[Factors] = None, stat_decay: float = 0.95,
                sample_targets: bool = True, targets=None,
                key: Optional[int] = None) -> Factors:
    """The LOBPCG refresh (init_kfac, opt.py:362-382; kfac.py:461-479):
    capture on this batch (a dropout task's masks from ``key``), with
    targets sampled from ``generator`` under ``sample_targets`` (or
    ``targets`` as given), EMA-update ``prev`` (or identity) and
    recompute the inverses."""
    sharding = meshlib.current_sharding()
    if sharding is not None:
        params = sharding.gather(params)
    if targets is None and sample_targets:
        targets = sample_fisher_targets(task, params, model_state, batch, generator)
    _, caps = capture(task, params, model_state, batch, targets, key)
    factors = init_factors(task.model, params) if prev is None else prev
    return compute_inverses(update_factors(factors, caps, params, stat_decay))


def precond_apply(factors: Factors, residual: Tree, damping: float = 0.0) -> Tree:
    """The ``precond`` the eigensolver gets: ``r -> F^{-1} r`` per
    factored layer (kfac.py:482-485); under a sharding on the gathered
    residual, returning this rank's slices."""
    sharding = meshlib.current_sharding()
    if sharding is None:
        return apply_to_tree(factors, residual, damping)
    full = sharding.gather(residual)
    return sharding.local(apply_to_tree(factors, full, damping))
