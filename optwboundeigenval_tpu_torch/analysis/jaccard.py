"""Jaccard saliency comparison, the model-vs-baseline interpretability
audit (counterpart of ``optwboundeigenval_tpu/analysis/jaccard.py``;
reference ``jaccard``, opt.py:1364-1714, and ``jaccard_comp``,
opt.py:1716-1855):

* per-class decision cutoffs that maximise F1 on the precision-recall
  curve (opt.py:1456-1471), in numpy: the port needs no sklearn;
* saliency maps per image (input gradients, guided backprop, or Grad-CAM
  on a feature layer, opt.py:1384-1386) thresholded at a fixed value or a
  per-image quantile (opt.py:1571-1578);
* the Jaccard overlap of the model's and the baseline's masks per image,
  the 2x2 mean-Jaccard matrix conditioned on (model correct, baseline
  correct), the counts and the values as CSVs (opt.py:1610-1660), and a
  histogram and low-Jaccard triptychs where matplotlib imports;
* a logistic-regression meta-classifier on the model's saliency maps
  (opt.py:1403-1450), float32 full-batch gradient descent on the card;
* ``jaccard_comp``: the pairwise mean Jaccard across models, optionally
  over the rows where both predict the same class.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np
import torch

from optwboundeigenval_tpu_torch.analysis.grad_cam import grad_cam
from optwboundeigenval_tpu_torch.analysis.guided_backprop import generate_gradients
from optwboundeigenval_tpu_torch.analysis.plots import pyplot
from optwboundeigenval_tpu_torch.analysis.saliency import batch_saliency
from optwboundeigenval_tpu_torch.utils.precision import host


def precision_recall_curve(y_true: np.ndarray, score: np.ndarray):
    """sklearn's ``precision_recall_curve(y_true, score)`` for 0/1 labels:
    ``(precision, recall, thresholds)`` over the distinct scores in
    increasing order, precision and recall ending with 1 and 0."""
    order = np.argsort(score, kind="mergesort")[::-1]
    score, y = score[order], y_true[order]
    idx = np.r_[np.where(np.diff(score))[0], y.size - 1]
    tps = np.cumsum(y, dtype=np.float64)[idx]
    fps = 1 + idx - tps
    ps = tps + fps
    precision = np.divide(tps, ps, out=np.zeros_like(tps), where=ps != 0)
    recall = np.ones_like(tps) if tps[-1] == 0 else tps / tps[-1]
    return (np.hstack((precision[::-1], 1)), np.hstack((recall[::-1], 0)),
            score[idx][::-1])


def f1_max_cutoffs(labels: np.ndarray, scores: np.ndarray) -> np.ndarray:
    """Per-class threshold maximising F1 on the PR curve (opt.py:1456-1471),
    NaN labels masked; 0.5 for a class with one label value."""
    cutoffs = np.full(scores.shape[1], 0.5)
    for i in range(scores.shape[1]):
        li, si = labels[:, i], scores[:, i]
        good = li == li
        li, si = li[good], si[good]
        if len(np.unique(li)) < 2:
            continue
        prec, rec, thr = precision_recall_curve(li, si)
        f1 = 2 * prec * rec / np.maximum(prec + rec, 1e-12)
        best = int(np.nanargmax(f1[:-1])) if len(thr) else 0
        cutoffs[i] = thr[min(best, len(thr) - 1)]
    return cutoffs


def saliency_map(task, params, model_state, x, target_class=None,
                 method: str = "saliency", layer_path: Optional[str] = None) -> np.ndarray:
    """One of the reference's map generators, as (B, H, W) numpy: plain input
    gradients or guided backprop (absolute, the channels' maximum), or
    Grad-CAM on ``layer_path``."""
    if method == "gradcam":
        if layer_path is None:
            raise ValueError("method='gradcam' needs layer_path")
        return grad_cam(task, params, model_state, x, layer_path, target_class)
    if method == "guided":
        g = generate_gradients(task, params, model_state, x, target_class)
    else:
        g = batch_saliency(task, params, model_state, x, target_class)
    g = np.abs(g.cpu().numpy())
    return g.max(axis=-1) if g.ndim == 4 else g


def threshold_mask(maps: np.ndarray, cutoff: Optional[float] = None,
                   quantile: Optional[float] = 0.9) -> np.ndarray:
    """Fixed or per-image-quantile thresholding (opt.py:1571-1578)."""
    if cutoff is not None:
        return maps > cutoff
    q = np.quantile(maps.reshape(maps.shape[0], -1), quantile, axis=1)
    return maps > q[:, None, None]


def jaccard_of_masks(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    inter = np.sum(a & b, axis=(1, 2))
    union = np.sum(a | b, axis=(1, 2))
    return inter / np.maximum(union, 1)


def _predict(trainer, x: np.ndarray) -> np.ndarray:
    out = trainer.task.predict(trainer.params, trainer.model_state, trainer.put_batch({"x": x}))
    return host(out)


def _sigmoid(s):
    return 1 / (1 + np.exp(-s))


def jaccard_audit(trainer, baseline, loader, *, method: str = "saliency",
                  layer_path: Optional[str] = None, quantile: float = 0.9,
                  cutoff: Optional[float] = None, max_img: int = 25,
                  train_meta: bool = False, log_dir: str = "./logs",
                  plot_dir: str = "./plots", tag: str = "jaccard"):
    """Compare ``trainer``'s saliency with ``baseline``'s over ``loader``.
    Writes ``<header2>_<tag>_{cond,counts,values}.csv`` into ``log_dir``, a
    histogram and the ``max_img`` lowest-Jaccard triptychs into
    ``plot_dir`` where matplotlib imports, and returns ``{"jaccard",
    "conditioned", "counts", "cutoffs_model", "cutoffs_baseline", "meta"}``;
    ``train_meta`` fits the meta-classifier on the model's maps."""
    os.makedirs(log_dir, exist_ok=True)
    scores_m, scores_b, labels, jacs, worst, meta_x = [], [], [], [], [], []
    for data in loader:
        nreal = int(np.sum(np.asarray(data["w"]) > 0))
        x = np.asarray(data["x"])[:nreal]
        labels.append(np.asarray(data["y"])[:nreal])
        scores_m.append(_predict(trainer, x))
        scores_b.append(_predict(baseline, x))
        sm = saliency_map(trainer.task, trainer.params, trainer.model_state, x,
                          method=method, layer_path=layer_path)
        sb = saliency_map(baseline.task, baseline.params, baseline.model_state, x,
                          method=method, layer_path=layer_path)
        jac = jaccard_of_masks(threshold_mask(sm, cutoff, quantile),
                               threshold_mask(sb, cutoff, quantile))
        jacs.append(jac)
        worst.extend((float(jac[i]), x[i], sm[i], sb[i]) for i in range(len(x)))
        if train_meta:
            meta_x.append(sm.reshape(len(sm), -1))

    scores_m, scores_b = np.concatenate(scores_m), np.concatenate(scores_b)
    labels, jac = np.concatenate(labels), np.concatenate(jacs)
    if labels.ndim > 1:  # multilabel
        cutoffs_m = f1_max_cutoffs(labels, _sigmoid(scores_m))
        cutoffs_b = f1_max_cutoffs(labels, _sigmoid(scores_b))
        correct = lambda s, c: np.all(((_sigmoid(s) > c) == (labels > 0.5))
                                      | np.isnan(labels), axis=1)
        correct_m, correct_b = correct(scores_m, cutoffs_m), correct(scores_b, cutoffs_b)
    else:
        cutoffs_m = cutoffs_b = None
        correct_m = np.argmax(scores_m, axis=1) == labels
        correct_b = np.argmax(scores_b, axis=1) == labels

    # the 2x2 conditioned mean-Jaccard matrix (opt.py:1610-1660)
    cond, counts = np.full((2, 2), np.nan), np.zeros((2, 2), int)
    for mi in (0, 1):
        for bi in (0, 1):
            sel = (correct_m == bool(mi)) & (correct_b == bool(bi))
            counts[1 - mi, 1 - bi] = int(np.sum(sel))
            if np.any(sel):
                cond[1 - mi, 1 - bi] = float(np.mean(jac[sel]))
    stem = os.path.join(log_dir, f"{trainer.header2}_{tag}")
    np.savetxt(stem + "_cond.csv", cond, delimiter=",")
    np.savetxt(stem + "_counts.csv", counts, delimiter=",", fmt="%d")
    np.savetxt(stem + "_values.csv", jac, delimiter=",")

    worst.sort(key=lambda t: t[0])
    _plot_audit(pyplot(f"jaccard audit {tag}"), jac, worst[:max_img],
                os.path.join(plot_dir, f"{trainer.header2}_{tag}"))

    meta = None
    if train_meta and meta_x:
        meta = fit_meta_classifier(np.concatenate(meta_x), labels, device=trainer.device)
    return {"jaccard": jac, "conditioned": cond, "counts": counts,
            "cutoffs_model": cutoffs_m, "cutoffs_baseline": cutoffs_b, "meta": meta}


def _plot_audit(plt, jac, worst, stem):
    """The Jaccard histogram and the low-Jaccard triptychs (image, model map,
    baseline map)."""
    if plt is None:
        return
    os.makedirs(os.path.dirname(stem) or ".", exist_ok=True)
    fig, ax = plt.subplots()
    ax.hist(jac, bins=20)
    ax.set_xlabel("jaccard")
    fig.savefig(stem + "_hist.png")
    plt.close(fig)
    for k, (jv, img, sm, sb) in enumerate(worst):
        fig, axes = plt.subplots(1, 3, figsize=(9, 3))
        im = img.squeeze()
        if im.ndim == 3 and im.shape[-1] == 3:
            axes[0].imshow((im - im.min()) / (im.max() - im.min() + 1e-8))
        else:
            axes[0].imshow(im if im.ndim == 2 else im[..., 0], cmap="gray")
        axes[1].imshow(sm, cmap="hot")
        axes[2].imshow(sb, cmap="hot")
        for ax_, title in zip(axes, ("image", "model", "baseline")):
            ax_.set_title(title)
            ax_.axis("off")
        fig.suptitle(f"jaccard={jv:.3f}")
        fig.savefig(f"{stem}_worst{k}.png")
        plt.close(fig)


def fit_meta_classifier(saliency_flat: np.ndarray, labels: np.ndarray,
                        steps: int = 200, lr: float = 0.1, device=None):
    """Logistic regression on flattened saliency maps (opt.py:1403-1450;
    model dcnn.py:332-341): float32 full-batch gradient descent from zero
    weights on ``device`` (default: the card) on the mean logistic loss
    ``max(l, 0) - l y + log1p(exp(-|l|))``.  Its gradient in the logits is
    ``(sigmoid(l) - y) / l.numel()``, and ``-y / l.numel()`` where ``l ==
    0``: the JAX package differentiates the loss as written, and JAX
    gives ``max`` the slope 1/2 and ``abs`` the slope 1 at 0, so its first
    step (every logit 0) moves by ``-y``, not ``1/2 - y``.  Labels: the
    multilabel matrix (NaN as 0), or ``label > 0`` for class labels.
    Returns ``{"w", "b"}`` as numpy."""
    from optwboundeigenval_tpu_torch.train.trainer import resolve_device

    device = resolve_device(device)
    y = labels if labels.ndim > 1 else (labels[:, None] > 0)
    y = torch.as_tensor(np.nan_to_num(np.asarray(y, np.float32), nan=0.0), device=device)
    x = torch.as_tensor(np.asarray(saliency_flat, np.float32), device=device)
    w = torch.zeros((x.shape[1], y.shape[1]), device=device)
    b = torch.zeros(y.shape[1], device=device)
    for _ in range(steps):
        logits = x @ w + b
        dl = torch.where(logits == 0, -y, torch.sigmoid(logits) - y) / y.numel()
        w, b = w - lr * (x.T @ dl), b - lr * dl.sum(dim=0)
    return {"w": w.cpu().numpy(), "b": b.cpu().numpy()}


def jaccard_comp(trainers: Sequence, loader, *, method: str = "saliency",
                 layer_path: Optional[str] = None, quantile: float = 0.9,
                 same_pred_only: bool = True, log_dir: str = "./logs") -> np.ndarray:
    """The (n, n) matrix of mean pairwise Jaccards across models, over the
    rows where both predict the same class when ``same_pred_only``
    (opt.py:1716-1855); written to ``<log_dir>/jaccard_comp.csv``."""
    os.makedirs(log_dir, exist_ok=True)
    n = len(trainers)
    sums, cnts = np.zeros((n, n)), np.zeros((n, n))
    for data in loader:
        nreal = int(np.sum(np.asarray(data["w"]) > 0))
        x = np.asarray(data["x"])[:nreal]
        preds, masks = [], []
        for tr in trainers:
            preds.append(np.argmax(_predict(tr, x), axis=1))
            sm = saliency_map(tr.task, tr.params, tr.model_state, x, method=method,
                              layer_path=layer_path)
            masks.append(threshold_mask(sm, None, quantile))
        for a in range(n):
            for b in range(a + 1, n):
                jac = jaccard_of_masks(masks[a], masks[b])
                sel = preds[a] == preds[b] if same_pred_only else np.ones(len(jac), bool)
                sums[a, b] += float(np.sum(jac[sel]))
                cnts[a, b] += int(np.sum(sel))
    mat = np.full((n, n), np.nan)
    for a in range(n):
        mat[a, a] = 1.0
        for b in range(a + 1, n):
            if cnts[a, b] > 0:
                mat[a, b] = mat[b, a] = sums[a, b] / cnts[a, b]
    np.savetxt(os.path.join(log_dir, "jaccard_comp.csv"), mat, delimiter=",")
    return mat
