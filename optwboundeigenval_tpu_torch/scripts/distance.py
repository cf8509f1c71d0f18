"""Nearest-distance histogram of a shifted USPS set (counterpart of
``scripts/distance.py``; reference ``distance.py``):

    python -m optwboundeigenval_tpu_torch.scripts.distance [euclid|cosine]
        [Aug1|Aug2|MNIST|GAN|GAN2|<name containing "constructed">]
        [--device cpu] [--data_dir ./data] [--plot_dir ./plots]

Compares the USPS test set with the shifted set (the two augmented test
sets, MNIST at 16x16, the MLP or DC GAN's ``gan_usps.npz`` /
``cgan_usps.npz``, or a constructed ``<name>.npz``) by least Euclidean
distance or largest cosine similarity, prints the mean and draws the
histogram where matplotlib imports.
"""

from __future__ import annotations

import argparse

import numpy as np

BATCH = 4096  # the reference loads each set as one batch; the rows are the same


def live_rows(loader):
    """``(x, y)`` of a loader's real rows."""
    xs, ys = [], []
    for b in loader:
        keep = np.asarray(b["w"]) > 0
        xs.append(np.asarray(b["x"])[keep])
        ys.append(np.asarray(b["y"])[keep])
    return np.concatenate(xs), np.concatenate(ys)


def shifted_loader(data: str, data_dir: str):
    from optwboundeigenval_tpu_torch.data import usps

    if data in ("Aug1", "Aug2"):
        return usps.get_test_loader(batch_size=BATCH, augment=True,
                                    root=data_dir)[0 if data == "Aug1" else 1]
    if data == "MNIST":
        return usps.get_mnist_loader(batch_size=BATCH, root=data_dir)
    if data in ("GAN", "GAN2"):
        return usps.get_gan_loader(batch_size=BATCH, root=data_dir,
                                   file="gan_usps.npz" if data == "GAN" else "cgan_usps.npz")
    if "constructed" in data:
        return usps.get_gan_loader(batch_size=BATCH, file=data + ".npz", root=data_dir)
    raise ValueError("Data not supported.")


def main(argv=None):
    from optwboundeigenval_tpu_torch.analysis.distance import distance_histogram
    from optwboundeigenval_tpu_torch.data import usps

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("dist", nargs="?", default="euclid", choices=("euclid", "cosine"))
    p.add_argument("data", nargs="?", default="Aug2")
    p.add_argument("--device", default=None, help="cpu, or the card by default")
    p.add_argument("--data_dir", default="./data")
    p.add_argument("--plot_dir", default="./plots")
    args = p.parse_args(argv)

    ref_x, _ = live_rows(usps.get_test_loader(batch_size=BATCH, root=args.data_dir))
    shifted_x, _ = live_rows(shifted_loader(args.data, args.data_dir))
    dmm = distance_histogram(ref_x, shifted_x, args.dist, tag=args.data,
                             plot_dir=args.plot_dir, device=args.device)
    what = "similarity" if args.dist == "cosine" else "distance"
    print(f"{args.data}/{args.dist}: mean nearest {what} = {dmm.mean():.4f}")
    return dmm


if __name__ == "__main__":
    main()
