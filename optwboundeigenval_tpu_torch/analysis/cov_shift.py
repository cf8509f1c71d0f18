"""Covariate-shift robustness evaluation (counterpart of
``optwboundeigenval_tpu/analysis/cov_shift.py``), the reference's
importance-weighted testing:

* :func:`get_prob`: per-feature (skew-)normal log densities summed over
  the features, rows with an infinite skew-normal log density patched to
  the normal one (opt.py:1858-1880);
* :func:`test_model_cov`: importance weights ``exp(log p_test(x) - log
  p_train(x))`` over the shifted features, the weighted accuracy and
  micro-F1, and the reference's min/max weight: the extremes of the
  per-batch MEAN weight, seeded at 1 (opt.py:1095-1174);
* :func:`cov_shift_tester`: ``iters`` random shifts ``mult * N(0, 1)`` of
  the non-excluded features' mean/sd/skew, every model's best checkpoint
  evaluated under each, and the acc/F1/indices CSVs (opt.py:1890-1936);
* :func:`cov_shift_plots` (where matplotlib imports) and
  :func:`slope_comparison`: the replacements of cov_shift_plots.R and
  cov_shift_acc_comp.R.

A model's outputs do not depend on the shift, only the weights do: each
model is evaluated once per call on the card (:func:`model_outputs`) and
every draw reweights those outputs on the host.  Micro-F1 with sample
weights is numpy (the port needs no sklearn): for class labels it is
the weighted share of correct rows, as sklearn computes it.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence

import numpy as np
from scipy.stats import norm, skewnorm

from optwboundeigenval_tpu_torch.analysis.plots import pyplot
from optwboundeigenval_tpu_torch.data.loaders import ArrayLoader
from optwboundeigenval_tpu_torch.utils.precision import host


def _broadcast(m, sd, skew):
    m, sd, skew = list(m), list(sd), list(skew)
    n = max(len(m), len(sd), len(skew))
    m, sd, skew = (v * n if len(v) == 1 else v for v in (m, sd, skew))
    return np.asarray(m, float), np.asarray(sd, float), np.asarray(skew, float)


def _per_feature(v, feats: int) -> list:
    return list(v) * (feats if len(v) == 1 else 1)


def get_prob(inputs: np.ndarray, m=(0,), sd=(1,), skew=(0,)) -> np.ndarray:
    """Row-wise log density under independent per-feature (skew-)normal
    marginals (opt.py:1858-1880)."""
    inputs = np.asarray(inputs, float)
    m, sd, skew = _broadcast(m, sd, skew)
    if not np.any(skew):
        w = norm.logpdf(inputs, m, sd)
    else:
        w = skewnorm.logpdf(inputs, skew, m, sd)
        bad = np.where(np.isinf(w))[0]
        if len(bad) > 0:
            w[bad] = norm.logpdf(inputs[bad, :], m, sd)
    return np.sum(w, axis=1)


def f1_micro_weighted(y_true: np.ndarray, y_pred: np.ndarray, weights: np.ndarray) -> float:
    """sklearn's ``f1_score(y_true, y_pred, average="micro",
    sample_weight=weights)`` for class labels: ``2 tp / (|true| + |pred|)``
    with every count weighted, 0 when the weights sum to 0."""
    tp = float(np.sum(weights[y_true == y_pred]))
    total = float(np.sum(weights))
    return 2 * tp / (2 * total) if total else 0.0


def model_outputs(trainer, x: np.ndarray, y: np.ndarray) -> List[tuple]:
    """One eval-mode pass of ``trainer``'s current weights over ``(x, y)`` at
    its batch size: per batch ``(loss, predicted, target, inputs)``, the
    last three over the real rows."""
    out = []
    for data in ArrayLoader(x, y, trainer.batch_size):
        loss, ops = trainer.task.eval_loss(trainer.params, trainer.model_state,
                                           trainer.put_batch(data))
        nreal = int(np.sum(np.asarray(data["w"]) > 0))
        out.append((float(loss), np.argmax(host(ops)[:nreal], axis=1),
                    np.asarray(data["y"])[:nreal], np.asarray(data["x"])[:nreal]))
    return out


def weighted_metrics(outputs: List[tuple], feats: int, test_mean=(0,), test_sd=(1,),
                     test_skew=(0,), train_mean=(0,), train_sd=(1,), train_skew=(0,)):
    """``(loss, acc, f1, min_weight, max_weight)`` of :func:`model_outputs`
    under the shift from the train to the test marginals (opt.py:1095-1174)."""
    tm, tsd, tsk = _broadcast(*(_per_feature(v, feats) for v in (test_mean, test_sd, test_skew)))
    rm, rsd, rsk = _broadcast(*(_per_feature(v, feats)
                                for v in (train_mean, train_sd, train_skew)))
    modes = np.where(np.logical_or.reduce([tm - rm != 0, tsd - rsd != 0, tsk - rsk != 0]))[0]
    f_list, acc_list, f1_list, sizes, wm_list = [], [], [], [], []
    min_weight, max_weight = 1.0, 1.0
    for loss, predicted, target, inputs in outputs:
        nreal = len(target)
        if len(modes) > 0:
            w = np.exp(get_prob(inputs[:, modes], tm[modes], tsd[modes], tsk[modes])
                       - get_prob(inputs[:, modes], rm[modes], rsd[modes], rsk[modes]))
        else:
            w = np.ones(nreal)
        wm = float(np.mean(w))
        wm_list.append(wm)
        # the reference's quirk (opt.py:1152-1153): the extremes of the
        # per-batch MEAN weight, seeded at 1
        min_weight, max_weight = min(min_weight, wm), max(max_weight, wm)
        weights = w / (wm * nreal)
        f_list.append(loss)
        acc_list.append(float(np.sum(weights * (predicted == target))) * 100)
        f1_list.append(f1_micro_weighted(target, predicted, weights))
        sizes.append(nreal)
    acc_w = np.asarray(sizes, float) * np.asarray(wm_list)
    acc_w = acc_w / np.sum(acc_w)
    return (float(np.average(f_list, weights=sizes)),
            float(np.average(acc_list, weights=acc_w)),
            float(np.average(f1_list, weights=acc_w)), min_weight, max_weight)


def test_model_cov(trainer, x: np.ndarray, y: np.ndarray, **shift):
    """Importance-weighted ``(loss, acc, f1, min_weight, max_weight)`` of
    ``trainer``'s current weights on ``(x, y)``; ``shift`` holds
    ``test_mean``, ``test_sd``, ``test_skew``, ``train_mean``,
    ``train_sd``, ``train_skew`` (one value or one per feature)."""
    return weighted_metrics(model_outputs(trainer, x, y), x.shape[1], **shift)


def test_model_best_cov(trainer, x, y, **shift):
    """Load the best checkpoint, then :func:`test_model_cov` (opt.py:1176-1183)."""
    trainer.model_load()
    return test_model_cov(trainer, x, y, **shift)


def _append_file(fn: str, arr: np.ndarray) -> None:
    with open(fn, "ab") as f:
        f.write(b"\n")
        np.savetxt(f, arr, delimiter=",")


def cov_shift_tester(models: Sequence, x: np.ndarray, y: np.ndarray, iters: int = 1000,
                     bad_modes: Sequence[int] = (), header: str = "", mult: float = 0.1,
                     mean_diff: float = 0.0, sd_diff: float = 0.0, skew_diff: float = 0.0,
                     test_mean=(0,), test_sd=(1,), test_skew=(0,), train_mean=(0,),
                     train_sd=(1,), train_skew=(0,), indices: Optional[str] = None,
                     append: bool = False, log_dir: str = "./logs",
                     seed: Optional[int] = None):
    """Random-shift sweep across models (opt.py:1890-1936): ``indices ~
    mult * N(0, 1)`` (``seed``) on the features not in ``bad_modes``, or
    read from the CSV ``indices``; shift ``i`` moves the test mean, sd and
    skew by ``indices[:, i]`` times ``mean_diff``, ``sd_diff``,
    ``skew_diff``.  Every model's best checkpoint is evaluated once and
    reweighted per shift.  Writes ``<header>_cov_shift_{acc,f1,indices}.csv``
    (or appends acc and f1) and returns ``(acc, f1, indices)``, acc and f1
    (models, iters)."""
    os.makedirs(log_dir, exist_ok=True)
    feats = x.shape[1]
    good_modes = np.setdiff1d(np.arange(feats), np.asarray(bad_modes, int))
    test_mean, test_sd, test_skew = (_per_feature(v, feats)
                                     for v in (test_mean, test_sd, test_skew))
    if indices is None:
        rng = np.random.default_rng(seed)
        idx = np.zeros((feats, iters))
        idx[good_modes, :] = mult * rng.normal(size=(len(good_modes), iters))
    else:
        idx = np.genfromtxt(indices, delimiter=",")

    acc, f1 = np.zeros((len(models), iters)), np.zeros((len(models), iters))
    for j, model in enumerate(models):
        model.model_load()
        outputs = model_outputs(model, x, y)
        for i in range(iters):
            _, acc[j, i], f1[j, i], _, _ = weighted_metrics(
                outputs, feats,
                test_mean=np.asarray(test_mean) + idx[:, i] * mean_diff,
                test_sd=np.asarray(test_sd) + idx[:, i] * sd_diff,
                test_skew=np.asarray(test_skew) + idx[:, i] * skew_diff,
                train_mean=train_mean, train_sd=train_sd, train_skew=train_skew)

    stem = os.path.join(log_dir, header)
    if append:
        _append_file(stem + "_cov_shift_acc.csv", acc)
        _append_file(stem + "_cov_shift_f1.csv", f1)
    else:
        np.savetxt(stem + "_cov_shift_acc.csv", acc, delimiter=",")
        np.savetxt(stem + "_cov_shift_f1.csv", f1, delimiter=",")
        np.savetxt(stem + "_cov_shift_indices.csv", idx, delimiter=",")
    return acc, f1, idx


def cov_shift_plots(acc: np.ndarray, indices: np.ndarray, labels: Sequence[str],
                    baselines: Optional[Sequence[float]] = None,
                    out_path: str = "./plots/cov_shift_acc.png") -> Optional[str]:
    """cov_shift_plots.R: per-model accuracy against the L1 norm of the shift
    with linear trend lines and zero-shift baselines (cov_shift_plots.R:13-41),
    where matplotlib imports; returns the path, or None."""
    plt = pyplot("covariate shift")
    if plt is None:
        return None
    shift_norm = np.sum(np.abs(indices), axis=0)
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    fig, ax = plt.subplots(figsize=(8, 5))
    for j, label in enumerate(labels):
        col = f"C{j}"
        ax.scatter(shift_norm, acc[j], s=6, alpha=0.4, color=col, label=label)
        coef = np.polyfit(shift_norm, acc[j], 1)
        xs = np.linspace(shift_norm.min(), shift_norm.max(), 50)
        ax.plot(xs, np.polyval(coef, xs), color=col)
        if baselines is not None:
            ax.axhline(baselines[j], color=col, linestyle=":", alpha=0.7)
    ax.set_xlabel("L1 norm of covariate shift")
    ax.set_ylabel("importance-weighted accuracy (%)")
    ax.legend(fontsize=7)
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


def slope_comparison(acc: np.ndarray, indices: np.ndarray, labels: Sequence[str]):
    """cov_shift_acc_comp.R: each model's regression slope of accuracy on the
    shift's L1 norm with its standard error, and pairwise z-tests of the
    slopes' differences (cov_shift_acc_comp.R:23-28)."""
    from scipy import stats

    shift_norm = np.sum(np.abs(indices), axis=0)
    rows = []
    for j, label in enumerate(labels):
        res = stats.linregress(shift_norm, acc[j])
        rows.append({"model": label, "slope": res.slope, "stderr": res.stderr,
                     "pvalue": res.pvalue})
    comps = []
    for a in range(len(rows)):
        for b in range(a + 1, len(rows)):
            dz = (rows[a]["slope"] - rows[b]["slope"]) / np.sqrt(
                rows[a]["stderr"] ** 2 + rows[b]["stderr"] ** 2)
            comps.append({"a": rows[a]["model"], "b": rows[b]["model"], "z": dz,
                          "p": 2 * (1 - stats.norm.cdf(abs(dz)))})
    return rows, comps
