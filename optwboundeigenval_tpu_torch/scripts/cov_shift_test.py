"""Covariate-shift robustness of the Forest models (counterpart of
``scripts/cov_shift_test.py``; reference ``cov_shift_test.py``):

    python -m optwboundeigenval_tpu_torch.scripts.cov_shift_test [iters] [mult]
        [--device cpu] [--models_dir ./models] [--log_dir ./logs]
        [--plot_dir ./plots] [--seed S] [--data_root ./data]

Loads the best checkpoint (``<header2>_trained_model_best.pt``, written by
``main forest_*``) of each Forest variant of the reference grid
(cov_shift_test.py:36-141) that has one, sweeps ``iters`` random shifts
(1,000 by default) of the means of the ten continuous features
(``mult * N(0, 1)``; the binary soil and wilderness columns stay
unshifted) with ``analysis/cov_shift.cov_shift_tester``, writes
``Forest_cov_shift_{acc,f1,indices}.csv``, the scatter plot where
matplotlib imports, and prints the slope comparison.
"""

from __future__ import annotations

import argparse
import os

# the reference's model grid (cov_shift_test.py:36-141): spectral
# regularization at several mu/K and the unregularized control
VARIANTS = (dict(mu=0.01, K=1.0), dict(mu=0.01, K=0.0), dict(mu=0.001, K=5.0),
            dict(mu=0.001, K=0.0), dict(mu=0.005, K=1.0), dict(mu=0.0028, K=1.0),
            dict(mu=0.0, K=0.0))


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("iters", nargs="?", type=int, default=1000)
    p.add_argument("mult", nargs="?", type=float, default=0.1)
    p.add_argument("--device", default=None, help="cpu, or the card by default")
    p.add_argument("--models_dir", default="./models")
    p.add_argument("--log_dir", default="./logs")
    p.add_argument("--plot_dir", default="./plots")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--data_root", default="./data")
    return p.parse_args(argv)


def load_models(args):
    """The trainers of the variants whose best checkpoint exists, with their
    labels."""
    from optwboundeigenval_tpu_torch.models.mlp_forest import ForestNet
    from optwboundeigenval_tpu_torch.optim.api import sgd
    from optwboundeigenval_tpu_torch.train.task import Task
    from optwboundeigenval_tpu_torch.train.trainer import CKPT_BEST, SpectralTrainer

    models, labels = [], []
    for kw in VARIANTS:
        tr = SpectralTrainer(Task(model=ForestNet()), sgd(0.5), header="Forest",
                             batch_size=128, model_dir=args.models_dir,
                             log_dir=args.log_dir, device=args.device, **kw)
        if os.path.exists(os.path.join(args.models_dir, tr.header2 + CKPT_BEST)):
            models.append(tr)
            labels.append(f"mu={kw['mu']} K={kw['K']}")
    return models, labels


def main(argv=None):
    from optwboundeigenval_tpu_torch.analysis import cov_shift
    from optwboundeigenval_tpu_torch.data import forest

    args = parse_args(argv)
    data = forest.get_data(args.data_root)
    x, y = data["inputs_test"], data["target_test"]
    models, labels = load_models(args)
    if not models:
        print(f"No trained Forest checkpoints found under {args.models_dir}: "
              "train forest_* configs first.")
        return None
    acc, f1, idx = cov_shift.cov_shift_tester(
        models, x, y, iters=args.iters, mult=args.mult, mean_diff=1.0,
        bad_modes=list(range(10, x.shape[1])), header="Forest", log_dir=args.log_dir,
        seed=args.seed)
    cov_shift.cov_shift_plots(acc, idx, labels, baselines=[float(a.mean()) for a in acc],
                              out_path=os.path.join(args.plot_dir, "cov_shift_acc.png"))
    rows, comps = cov_shift.slope_comparison(acc, idx, labels)
    for r in rows:
        print(f"{r['model']}: slope={r['slope']:.4f} +- {r['stderr']:.4f}")
    for c in comps:
        print(f"{c['a']} vs {c['b']}: z={c['z']:.2f} p={c['p']:.4f}")
    return acc, f1, idx


if __name__ == "__main__":
    main()
