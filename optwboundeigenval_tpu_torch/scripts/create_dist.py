"""Constructed-distance USPS test set (counterpart of
``scripts/create_dist.py``; reference create_dist.py:65-118):

    python -m optwboundeigenval_tpu_torch.scripts.create_dist [--dist euclid|cosine]
        [--name N] [--zeroes K] [--minmax] [--seed S] [--device cpu]
        [--data_dir ./data] [--plot_dir ./plots]

Bins the two augmented USPS test sets by their distance to the plain test
set, leaves ``--zeroes`` random bins empty, fills each other bin from one
of the two (at random, or alternating the one with fewer and more rows
under ``--minmax``) and saves ``<data_dir>/<name>.npz``, which
``get_gan_loader`` and the ``distance`` script read.
"""

from __future__ import annotations

import argparse

import numpy as np

from optwboundeigenval_tpu_torch.scripts.distance import BATCH, live_rows


def main(argv=None):
    from optwboundeigenval_tpu_torch.analysis.distance import create_dist_dataset
    from optwboundeigenval_tpu_torch.data import usps

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--dist", default="cosine", choices=("euclid", "cosine"))
    p.add_argument("--name", default="constructed")
    p.add_argument("--zeroes", type=int, default=5)
    p.add_argument("--minmax", action="store_true")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--device", default=None, help="cpu, or the card by default")
    p.add_argument("--data_dir", default="./data")
    p.add_argument("--plot_dir", default="./plots")
    args = p.parse_args(argv)

    ref_x, _ = live_rows(usps.get_test_loader(batch_size=BATCH, root=args.data_dir))
    aug1, aug2 = usps.get_test_loader(batch_size=BATCH, augment=True, root=args.data_dir)
    out = create_dist_dataset(ref_x, live_rows(aug1), live_rows(aug2), dist=args.dist,
                              zeroes=args.zeroes, minmax=args.minmax, name=args.name,
                              data_dir=args.data_dir, plot_dir=args.plot_dir,
                              seed=args.seed, device=args.device)
    with np.load(out) as z:
        print(f"saved {out}: x{z['x'].shape} y{z['y'].shape}")
    return out


if __name__ == "__main__":
    main()
