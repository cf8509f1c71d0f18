"""Forest CoverType (UCI covtype), 54 features, 7 classes (counterpart of
``optwboundeigenval_tpu/data/forest.py``).

Reference surface (forest_data.py:30-71): a 1/5 test split, then a 1/5
valid split of the rest, both with ``random_state=1226``, and a
``StandardScaler`` fit on the train part.  Reads ``covtype.csv`` or
``covtype.data`` from ``root`` when present, else the synthetic stand-in
of 20,000 rows.  Without sklearn or pandas: the splits reproduce
``sklearn.model_selection.train_test_split`` (``ShuffleSplit``: test rows
are the first ``ceil(n / 5)`` of ``RandomState(1226).permutation(n)``,
train rows the rest in permutation order) and the scaler reproduces
``StandardScaler`` (population variance by the corrected two-pass sum,
scale 1 where the standard deviation is 0).
"""

from __future__ import annotations

import math
import os

import numpy as np

from optwboundeigenval_tpu_torch.data.synthetic import make_classification

SEED = 1226


def load_covtype(root: str = "./data"):
    for name in ("covtype.csv", "covtype.data"):
        path = os.path.join(root, name)
        if os.path.exists(path):
            data = np.loadtxt(path, delimiter=",", dtype=np.float64)
            return data[:, :-1], (data[:, -1] - 1).astype(np.int64)  # 1..7 -> 0..6
    x, y = make_classification(20000, 54, 7, seed=SEED, noise=2.5)
    return x.astype(np.float64), y.astype(np.int64)


def train_test_split(x, y, test_size: float = 1 / 5, random_state: int = SEED):
    """``(x_train, x_test, y_train, y_test)`` as sklearn's
    ``train_test_split(x, y, test_size=..., random_state=...)`` returns
    them."""
    n = len(x)
    n_test = math.ceil(test_size * n)
    perm = np.random.RandomState(random_state).permutation(n)
    test, train = perm[:n_test], perm[n_test:]
    return x[train], x[test], y[train], y[test]


def fit_scaler(x: np.ndarray):
    """``(mean, scale)`` of sklearn's ``StandardScaler().fit(x)``."""
    n = x.shape[0]
    total = np.sum(x, axis=0)
    mean = total / n
    centred = x - mean
    correction = np.sum(centred, axis=0)
    var = (np.sum(centred ** 2, axis=0) - correction ** 2 / n) / n
    scale = np.sqrt(var)
    scale[scale == 0.0] = 1.0
    return mean, scale


def get_data(root: str = "./data"):
    """Split and scale as forest_data.py:48-60."""
    X, y = load_covtype(root)
    X, X_test, y, y_test = train_test_split(X, y)
    X, X_valid, y, y_valid = train_test_split(X, y)
    mean, scale = fit_scaler(X)
    scaled = lambda a: ((a - mean) / scale).astype(np.float32)
    return {
        "inputs": scaled(X),
        "target": y.astype(np.int32),
        "inputs_valid": scaled(X_valid),
        "target_valid": y_valid.astype(np.int32),
        "inputs_test": scaled(X_test),
        "target_test": y_test.astype(np.int32),
        "scaler_mean": mean.astype(np.float32),
        "scaler_scale": scale.astype(np.float32),
    }
