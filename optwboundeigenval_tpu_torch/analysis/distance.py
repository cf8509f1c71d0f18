"""Distribution distances and constructed-distance test sets (counterpart
of ``optwboundeigenval_tpu/analysis/distance.py``; reference scripts
``distance.py`` and ``create_dist.py``):

* :func:`nearest_distances`: per shifted sample, the least Euclidean
  distance (or the largest cosine similarity) to any reference sample;
  the pairwise matrix is one float32 product on the device, in the JAX
  package's expanded form ``a^2 + b^2 - 2ab`` clamped at 0, so that the
  two agree;
* :func:`distance_histogram`: those distances with the reference's bins
  (``range(19)`` for Euclid, ``linspace(0.5, 1, 21)`` for cosine), drawn
  where matplotlib imports;
* :func:`create_dist_dataset`: bins two candidate pools by their distance
  to the reference set, drops ``zeroes`` random bins and fills each other
  bin from one pool, chosen at random or alternating the pool with fewer
  and more rows (``minmax``); saves ``<name>.npz``.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch

from optwboundeigenval_tpu_torch.analysis.plots import pyplot


def _pairwise_sq_euclid(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(n, d) x (m, d) -> (n, m) squared distances, expanded form."""
    a2 = (a * a).sum(dim=1, keepdim=True)
    b2 = (b * b).sum(dim=1, keepdim=True)
    return torch.clamp_min(a2 + b2.T - 2.0 * (a @ b.T), 0.0)


def _pairwise_cosine(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    an = a / torch.clamp_min(torch.linalg.norm(a, dim=1, keepdim=True), 1e-12)
    bn = b / torch.clamp_min(torch.linalg.norm(b, dim=1, keepdim=True), 1e-12)
    return an @ bn.T


def nearest_distances(ref: np.ndarray, samples: np.ndarray, dist: str = "euclid",
                      device=None) -> np.ndarray:
    """Per sample, the least Euclidean distance (``"euclid"``) or the largest
    cosine similarity (``"cosine"``) to ``ref`` (distance.py:42-49), in
    float32 on ``device`` (default: the card)."""
    from optwboundeigenval_tpu_torch.train.trainer import resolve_device

    if dist not in ("euclid", "cosine"):
        raise ValueError("Distance not supported.")
    device = resolve_device(device)
    a = torch.as_tensor(np.asarray(ref, np.float32).reshape(len(ref), -1), device=device)
    b = torch.as_tensor(np.asarray(samples, np.float32).reshape(len(samples), -1),
                        device=device)
    if dist == "euclid":
        return torch.sqrt(_pairwise_sq_euclid(a, b)).amin(dim=0).cpu().numpy()
    return _pairwise_cosine(a, b).amax(dim=0).cpu().numpy()


def distance_histogram(ref: np.ndarray, samples: np.ndarray, dist: str = "euclid",
                       tag: str = "set", plot_dir: str = "./plots",
                       device=None) -> np.ndarray:
    """:func:`nearest_distances`, and their histogram as
    ``<plot_dir>/distance_<dist>_<tag>_test.png`` where matplotlib imports."""
    dmm = nearest_distances(ref, samples, dist, device)
    plt = pyplot("distance histogram")
    if plt is None:
        return dmm
    os.makedirs(plot_dir, exist_ok=True)
    if dist == "euclid":
        plt.hist(dmm, bins=range(19), density=True)
        plt.xlabel("Distance")
        plt.ylim(0, 0.3)
    else:
        plt.hist(dmm, bins=np.linspace(0.5, 1, 21), density=True)
        plt.xlabel("Cosine Similarity")
        plt.ylim(0, 15)
    plt.ylabel("Frequency")
    plt.savefig(os.path.join(plot_dir, f"distance_{dist}_{tag}_test.png"))
    plt.clf()
    return dmm


def create_dist_dataset(ref_x: np.ndarray, pool1: Tuple[np.ndarray, np.ndarray],
                        pool2: Tuple[np.ndarray, np.ndarray], *, dist: str = "euclid",
                        zeroes: int = 4, minmax: bool = False, name: str = "constructed",
                        data_dir: str = "./data", plot_dir: str = "./plots",
                        seed: Optional[int] = None, device=None) -> str:
    """create_dist.py: bins of width 1 (Euclid, from 0) or 0.025 (cosine,
    from 0.5) over both pools' distances to ``ref_x``; ``zeroes`` bins,
    drawn from ``seed``, stay empty and each other takes the rows of one
    pool that fall in it.  Saves ``<data_dir>/<name>.npz`` (``x`` (N, s, s,
    1) float32, ``y``) and the histogram of its distances; returns the
    path."""
    rng = np.random.default_rng(seed)
    (x1, y1), (x2, y2) = pool1, pool2
    d1 = nearest_distances(ref_x, x1, dist, device)
    d2 = nearest_distances(ref_x, x2, dist, device)
    step = 0.025 if dist == "cosine" else 1.0
    if dist == "cosine":
        bins = np.arange(0.5, 1.0, step)
    else:
        bins = np.arange(0.0, max(d1.max(), d2.max()) + step, step)
    nz_bins = rng.choice(bins, max(len(bins) - zeroes, 1), replace=False)
    nz_bins.sort()

    new_x, new_y = [], []
    for k, lo in enumerate(nz_bins):
        rows1 = np.where((lo <= d1) & (d1 < lo + step))[0]
        rows2 = np.where((lo <= d2) & (d2 < lo + step))[0]
        if minmax:
            use1 = (len(rows1) < len(rows2)) if k % 2 == 0 else (len(rows1) > len(rows2))
        else:
            use1 = rng.integers(2) == 0
        rows, x, y = (rows1, x1, y1) if use1 else (rows2, x2, y2)
        if len(rows) > 0:
            new_x.append(x[rows].reshape(len(rows), -1))
            new_y.append(y[rows])
    if not new_x:
        raise ValueError("no samples fell into the selected bins")
    nx, ny = np.concatenate(new_x), np.concatenate(new_y)
    side = int(np.sqrt(nx.shape[1]))
    nx_img = nx.reshape(-1, side, side, 1)
    os.makedirs(data_dir, exist_ok=True)
    out = os.path.join(data_dir, name + ".npz")
    np.savez(out, x=nx_img.astype(np.float32), y=ny)
    distance_histogram(ref_x, nx_img, dist, tag=name, plot_dir=plot_dir, device=device)
    return out
