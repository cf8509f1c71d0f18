"""The port's Forest and USPS data against the JAX package: the same arrays
and batches, bit for bit.  The port reproduces sklearn's
``train_test_split`` and ``StandardScaler`` without sklearn (the GPU
machine has none), so those are held to sklearn itself."""

import bz2

import numpy as np
import pytest
from sklearn.model_selection import train_test_split as sk_split
from sklearn.preprocessing import StandardScaler

from optwboundeigenval_tpu.data import forest as jforest
from optwboundeigenval_tpu.data import usps as jusps
from optwboundeigenval_tpu.data.synthetic import make_classification as jmake
from optwboundeigenval_tpu_torch.data import forest, usps
from optwboundeigenval_tpu_torch.data.synthetic import make_classification


def _batches_equal(a, b, epochs=2):
    assert len(a) == len(b)
    for _ in range(epochs):  # a shuffling loader draws a new order per epoch
        for ba, bb in zip(a, b, strict=True):
            assert sorted(ba) == sorted(bb)
            for k in ba:
                np.testing.assert_array_equal(ba[k], bb[k], err_msg=k)


def test_make_classification_matches_jax():
    for args in ((100, 54, 7), (37, 5, 3)):
        for a, b in zip(make_classification(*args, seed=3, noise=2.5),
                        jmake(*args, seed=3, noise=2.5)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_forest_get_data_matches_jax(tmp_path):
    a, b = forest.get_data(str(tmp_path)), jforest.get_data(str(tmp_path))
    assert sorted(a) == sorted(b)
    assert len(a["inputs"]) == 12800 and len(a["inputs_test"]) == 4000
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_forest_reads_covtype_csv(tmp_path):
    rng = np.random.default_rng(0)
    rows = np.concatenate([rng.integers(0, 50, size=(60, 54)),
                           rng.integers(1, 8, size=(60, 1))], axis=1)
    np.savetxt(tmp_path / "covtype.data", rows, fmt="%d", delimiter=",")
    x, y = forest.load_covtype(str(tmp_path))
    np.testing.assert_array_equal(x, rows[:, :-1])
    np.testing.assert_array_equal(y, rows[:, -1] - 1)


@pytest.mark.parametrize("n", [5, 20, 999, 20000])
def test_split_and_scaler_match_sklearn(n):
    rng = np.random.default_rng(n)
    x = rng.normal(size=(n, 4)) * [1.0, 3.0, 1e-3, 0.0] + [0.0, 5.0, 1.0, 2.0]
    y = rng.integers(0, 3, size=n)
    for a, b in zip(forest.train_test_split(x, y),
                    sk_split(x, y, test_size=1 / 5, random_state=1226)):
        np.testing.assert_array_equal(a, b)
    mean, scale = forest.fit_scaler(x)
    sk = StandardScaler().fit(x)
    np.testing.assert_array_equal(mean, sk.mean_)
    np.testing.assert_array_equal(scale, sk.scale_)


def test_usps_loaders_match_jax(tmp_path):
    root = str(tmp_path)
    tr, va = usps.get_train_valid_loader(batch_size=128, root=root)
    jtr, jva = jusps.get_train_valid_loader(batch_size=128, root=root)
    assert (tr.num_examples, va.num_examples) == (6250, 1041)
    _batches_equal(tr, jtr)
    _batches_equal(va, jva)
    _batches_equal(usps.get_train_loader_na(root=root), jusps.get_train_loader_na(root=root))
    te, jte = usps.get_test_loader(root=root), jusps.get_test_loader(root=root)
    assert te.num_examples == 2007
    _batches_equal(te, jte)


def test_usps_reads_libsvm(tmp_path):
    rng = np.random.default_rng(1)
    with bz2.open(tmp_path / "usps.t.bz2", "wt") as fh:
        for i in range(5):
            vals = rng.uniform(-1, 1, size=256)
            fh.write(f"{i % 10 + 1} " + " ".join(
                f"{j + 1}:{v:.6f}" for j, v in enumerate(vals) if j % 3) + "\n")
    a = usps.load_usps(str(tmp_path), train=False)
    b = jusps.load_usps(str(tmp_path), train=False)
    for u, w in zip(a, b):
        np.testing.assert_array_equal(u, w)
    assert a[0].shape == (5, 16, 16, 1)
