"""The chest x-ray data and evaluation of the port against the JAX package
on the CPU: ``make_multilabel``, ``ten_crop`` and the stand-in loaders
bit-equal; the ``csv`` record readers and the NIH split against the JAX
readers (pandas) on a root of PNGs and CSVs written here; the numpy AUC
and per-class F1 against sklearn; ``test_model`` for ``'accauc
sigmoid'`` with class subsetting and TenCrop; ``ReduceLROnPlateau``;
``intersect_classes``; and ``comp_test``'s log through ``driver.run``
against the JAX driver on a small DenseNet trunk with ``TransitHead``.

Batches, class maps and the overlap line are exact; metrics agree to
rtol 1e-12 (same float64 numpy); the trained run's log to rtol 1e-8, as
the other ``driver.run`` comparisons.
"""

import os

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch
from sklearn.metrics import f1_score, roc_auc_score

from optwboundeigenval_tpu.analysis import comp as jcomp
from optwboundeigenval_tpu.configs import chestxray_mu0_01_K0 as jcxr_cfg
from optwboundeigenval_tpu.data import chestxray as jcxr
from optwboundeigenval_tpu.data.loaders import ArrayLoader as JaxLoader
from optwboundeigenval_tpu.data.synthetic import make_multilabel as jax_make_multilabel
from optwboundeigenval_tpu.models import backbones as jbb
from optwboundeigenval_tpu.models.cxr import TransitHead as JaxTransitHead
from optwboundeigenval_tpu.optim import adam as jax_adam
from optwboundeigenval_tpu.optim import schedules as jsched
from optwboundeigenval_tpu.train import SpectralTrainer as JaxTrainer
from optwboundeigenval_tpu.train import driver as jdriver
from optwboundeigenval_tpu.train.task import Task as JaxTask
from optwboundeigenval_tpu.train.task import losses as jax_losses
from optwboundeigenval_tpu_torch.analysis import comp
from optwboundeigenval_tpu_torch.configs import chestxray_mu0_01_K0
from optwboundeigenval_tpu_torch.data import chestxray as tcxr
from optwboundeigenval_tpu_torch.data.loaders import ArrayLoader
from optwboundeigenval_tpu_torch.data.synthetic import make_multilabel
from optwboundeigenval_tpu_torch.models import backbones as tbb
from optwboundeigenval_tpu_torch.models.cxr import CXRModel, TransitHead
from optwboundeigenval_tpu_torch.optim import schedules
from optwboundeigenval_tpu_torch.optim.api import adam
from optwboundeigenval_tpu_torch.train import driver
from optwboundeigenval_tpu_torch.train.task import Task, losses
from optwboundeigenval_tpu_torch.train.trainer import SpectralTrainer, f1_micro, roc_auc
from optwboundeigenval_tpu_torch.utils import interop

torch.set_num_threads(1)


def _same_batches(a, b, epochs=2):
    for _ in range(epochs):
        ba, bb = list(a), list(b)
        assert len(ba) == len(bb)
        for x, y in zip(ba, bb):
            assert sorted(x) == sorted(y)
            for k in x:
                np.testing.assert_array_equal(x[k], y[k], err_msg=k)  # NaN == NaN here


# ---- synthetic data ----------------------------------------------------------


@pytest.mark.parametrize("nan_frac,seed", [(0.0, 11), (0.1, 22), (0.3, 5)])
def test_make_multilabel_is_bit_equal(nan_frac, seed):
    got = make_multilabel(9, shape=(8, 8, 3), n_classes=13, seed=seed, nan_frac=nan_frac)
    want = jax_make_multilabel(9, shape=(8, 8, 3), n_classes=13, seed=seed, nan_frac=nan_frac)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert np.isnan(got[1]).any() == (nan_frac > 0)


def test_ten_crop_is_bit_equal():
    x = np.random.default_rng(0).random((9, 11, 3)).astype(np.float32)
    np.testing.assert_array_equal(tcxr.ten_crop(x, 6), jcxr.ten_crop(x, 6))


@pytest.mark.parametrize("getter,use", [
    ("get_nih_loader", "train"), ("get_nih_loader", "validation"), ("get_nih_loader", "test"),
    ("get_chexpert_loader", "validation"), ("get_chexpert_loader", "train"),
    ("get_mimic_loader", "validation"), ("get_mimic_loader", "train")])
def test_stand_in_loaders_are_bit_equal(getter, use):
    kw = dict(batch_size=4, size=224, synthetic_n=10)
    t, j = getattr(tcxr, getter)(use, **kw), getattr(jcxr, getter)(use, **kw)
    assert (t.class_to_idx, t.name, len(t)) == (j.class_to_idx, j.name, len(j))
    _same_batches(t, j)


def test_class_maps_are_the_jax_package_s():
    for name in ("NIH_CLASSES", "CHEXPERT_CLASSES", "MIMIC_CLASSES"):
        assert list(getattr(tcxr, name).items()) == list(getattr(jcxr, name).items())


# ---- the record readers on a root written here --------------------------------


def _png(path, rng, shape=(20, 24)):
    from PIL import Image

    os.makedirs(os.path.dirname(path), exist_ok=True)
    Image.fromarray(rng.integers(0, 256, size=shape + (3,), dtype=np.uint8)).save(path)


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    """An NIH root (13 images, Data_Entry_2017.csv with empty and unknown
    findings, the two lists) and CheXpert and MIMIC roots (CSVs with 1,
    0, -1 and empty labels, a column the class map lacks, one class column
    missing)."""
    tmp = tmp_path_factory.mktemp("cxr")
    rng = np.random.default_rng(0)
    nih = tmp / "nih"
    names = [f"{i:08d}_000.png" for i in range(13)]
    findings = ["Atelectasis|Effusion", "No Finding", "", "Hernia", "Mass | Nodule",
                "Pleural_Thickening|Edema|Fibrosis", "Unknown", "Pneumonia", "Cardiomegaly",
                "Infiltration|Mass", "Emphysema", "Consolidation|Pneumothorax", "Effusion"]
    for n in names:
        _png(str(nih / "images" / n), rng)
    pd.DataFrame({"Image Index": names, "Finding Labels": findings,
                  "Follow-up #": range(13)}).to_csv(nih / "Data_Entry_2017.csv", index=False)
    (nih / "test_list.txt").write_text("\n".join(names[:4]) + "\n")
    (nih / "train_val_list.txt").write_text("\n".join(names[4:]) + "\n")
    out = {"nih": str(nih)}
    for name, classes, img_root in (("chexpert", tcxr.CHEXPERT_CLASSES, tmp),
                                    ("mimic", tcxr.MIMIC_CLASSES, tmp / "mimic")):
        root = tmp / name
        root.mkdir()
        cols = [c for c in classes if c != "Fracture"]
        for split, n in (("train", 5), ("valid", 3)):
            paths = [f"{name}/{split}/p{i}/view1.png" for i in range(n)]
            for p in paths:
                _png(str(img_root / p), rng)
            table = {"Path": paths, "Sex": ["F"] * n}
            for c in cols:
                table[c] = rng.choice(["1.0", "0.0", "-1.0", ""], size=n)
            with open(root / f"{split}.csv", "w") as fh:
                fh.write(",".join(table) + "\n")
                for i in range(n):
                    fh.write(",".join(table[c][i] for c in table) + "\n")
        out[name] = str(root)
    return out


def _same_records(got, want):
    assert len(got) == len(want)
    for (gp, gl), (wp, wl) in zip(got, want):
        assert gp == wp
        np.testing.assert_array_equal(gl, wl)


@pytest.mark.parametrize("use", ["train", "validation", "test"])
def test_nih_records_match_the_pandas_readers(roots, use):
    _same_records(tcxr._nih_records(roots["nih"], use), jcxr._nih_records(roots["nih"], use))


@pytest.mark.parametrize("name,csv_name", [("chexpert", "train.csv"), ("chexpert", "valid.csv"),
                                           ("mimic", "train.csv"), ("mimic", "valid.csv")])
def test_csv_records_match_the_pandas_readers(roots, name, csv_name):
    classes = {"chexpert": tcxr.CHEXPERT_CLASSES, "mimic": tcxr.MIMIC_CLASSES}[name]
    img_root = os.path.dirname(roots[name]) if name == "chexpert" else roots[name]
    got = tcxr._csv_records(roots[name], csv_name, classes, img_root)
    _same_records(got, jcxr._csv_records(roots[name], csv_name, classes, img_root))
    assert any(np.isnan(lab).any() for _, lab in got)


@pytest.mark.parametrize("n", [1, 8, 37])
def test_nih_split_is_pandas_sample(n):
    names = [f"img{i}" for i in range(n)]
    shuffled = list(pd.Series(names).sample(frac=1, random_state=0))
    cut = int(n * 0.875)
    assert tcxr.nih_split(names) == (shuffled[:cut], shuffled[cut:])


@pytest.mark.parametrize("getter,root,use,crops", [
    ("get_nih_loader", "nih", "train", False), ("get_nih_loader", "nih", "test", True),
    ("get_chexpert_loader", "chexpert", "validation", False),
    ("get_mimic_loader", "mimic", "train", True)])
def test_image_loaders_are_bit_equal(roots, getter, root, use, crops):
    kw = dict(batch_size=2, root=roots[root], size=16, crops=crops)
    t, j = getattr(tcxr, getter)(use, **kw), getattr(jcxr, getter)(use, **kw)
    assert isinstance(t, tcxr.CXRImageLoader)
    assert (t.class_to_idx, t.name, len(t)) == (j.class_to_idx, j.name, len(j))
    _same_batches(t, j)


def test_image_loader_without_pil_raises(roots, monkeypatch):
    import importlib.util

    real = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec",
                        lambda name, *a: None if name == "PIL" else real(name, *a))
    with pytest.raises(ImportError, match="PIL"):
        tcxr.get_nih_loader("train", root=roots["nih"])


# ---- AUC, F1, the scheduler, the class intersection ---------------------------


@pytest.mark.parametrize("seed", range(4))
def test_roc_auc_and_f1_match_sklearn(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(5, 40))
    y = (rng.random(n) < 0.4).astype(np.float32)
    y[:2] = [0, 1]
    score = np.round(rng.random(n), 1)  # ties
    np.testing.assert_allclose(roc_auc(y, score), roc_auc_score(y, score), rtol=1e-12)
    pred = (score > 0.5).astype(np.float32)
    np.testing.assert_allclose(f1_micro(y, pred), f1_score(y, pred, average="micro"),
                               rtol=1e-12)
    # one label value: sklearn raises (older) or warns and gives NaN (1.9)
    try:
        with pytest.warns(UserWarning):
            one = roc_auc_score(np.zeros(n), score)
    except ValueError:
        one = float("nan")
    assert np.isnan(one)
    assert np.isnan(roc_auc(np.zeros(n), score)) and np.isnan(roc_auc(np.ones(n), score))


def test_reduce_lr_on_plateau_sequence_matches_jax():
    metrics = [1.0, 0.9, 0.95, 0.95, 0.9, 0.91, 0.899, 0.8999, 0.95, 0.96, 0.97, None,
               0.98, 0.99, 0.5, 0.6, 0.7]
    for kw in (dict(patience=2), dict(patience=0, factor=0.5, min_lr=2e-6),
               dict(patience=1, mode="max", threshold=0.01)):
        t, j = schedules.ReduceLROnPlateau(1e-5, **kw), jsched.ReduceLROnPlateau(1e-5, **kw)
        assert t.lr == j.lr
        assert [t.step(m) for m in metrics] == [j.step(m) for m in metrics]


def test_intersect_classes_matches_jax():
    dicts = [tcxr.NIH_CLASSES, tcxr.CHEXPERT_CLASSES, tcxr.MIMIC_CLASSES]
    assert comp.intersect_classes(dicts) == jcomp.intersect_classes(dicts)
    assert comp.intersect_classes(dicts[1:]) == jcomp.intersect_classes(dicts[1:])
    assert comp.intersect_classes(dicts[:1]) == jcomp.intersect_classes(dicts[:1])


# ---- test_model against the JAX trainer ---------------------------------------


class JaxFlat(fnn.Module):
    outnum: int = 6

    @fnn.compact
    def __call__(self, x, train=False):
        return fnn.Dense(self.outnum, dtype=jnp.float64, param_dtype=jnp.float64)(
            x.reshape(x.shape[0], -1))


class Flat(torch.nn.Module):
    def __init__(self, n_in, outnum=6):
        super().__init__()
        self.fc = torch.nn.Linear(n_in, outnum)

    def reset_parameters(self, generator=None):
        tbb.lecun_init(self, generator)

    def forward(self, x, train=False, stats_out=None):
        return self.fc(x.reshape(len(x), -1).to(self.fc.weight.dtype))


@pytest.fixture(scope="module")
def evaluators():
    """A JAX and a port trainer with ``test_func='accauc sigmoid'`` at the
    same float64 dense weights, and a 5-D TenCrop-shaped loader of 10 rows
    (3 crops of 4 x 4 x 3) whose labels hold NaNs and one class that is
    all 0."""
    rng = np.random.default_rng(7)
    x = rng.normal(size=(10, 3, 4, 4, 3)).astype(np.float32)
    y = (rng.random((10, 6)) < 0.5).astype(np.float32)
    y[:, 4] = 0
    y[rng.random((10, 6)) < 0.15] = np.nan
    kernel = rng.normal(size=(48, 6))
    bias = rng.normal(size=6)
    loss = "weighted_bce_with_logits"
    common = dict(test_func="accauc sigmoid", batch_size=4)
    jtr = JaxTrainer(JaxTask(model=JaxFlat(), loss=jax_losses[loss]), jax_adam(1e-3), **common)
    jtr.init_state({"x": x[:4, 0], "y": y[:4], "w": np.ones(4, np.float32)})
    jtr.params = {"Dense_0": {"kernel": jnp.asarray(kernel), "bias": jnp.asarray(bias)}}
    ttr = SpectralTrainer(Task(model=Flat(48).double(), loss=losses[loss]), adam(1e-3),
                          device="cpu", **common)
    ttr.init_state()
    ttr.params = {"fc.weight": torch.from_numpy(kernel.T.copy()),
                  "fc.bias": torch.from_numpy(bias)}
    return jtr, ttr, (x, y)


@pytest.mark.parametrize("kw", [
    dict(crops=True),
    dict(crops=True, classes=[0, 2, 3, 4], model_classes=[1, 2, 4, 5]),
    dict(crops=True, classes=[0, 1, 4], other_classes=[0, 1]),
    dict(crops=True, classes=[2, 3, 5], model_classes=[0, 1, 2], other_classes=1),
    dict(crops=False, classes=[0, 1, 3])], ids=lambda kw: ",".join(sorted(kw)))
def test_test_model_auc_matches_jax(evaluators, kw):
    jtr, ttr, (x, y) = evaluators
    if not kw["crops"]:
        x = x[:, 0]
    got = ttr.test_model(loader=ArrayLoader(x, y, 4), **kw)
    want = jtr.test_model(loader=JaxLoader(x, y, 4), **kw)
    np.testing.assert_allclose(got, want, rtol=1e-12)
    assert np.isfinite(got[1])


# ---- comp_test through driver.run --------------------------------------------


class JaxSmallCXR(fnn.Module):
    def setup(self):
        self.features = jbb.DenseNetFeatures(block_config=(2, 2), growth_rate=8,
                                             num_init_features=16, dtype=jnp.float64)
        self.head = JaxTransitHead(14, jnp.float64)

    def __call__(self, x, train=False):
        return self.head(self.features(x, train), train)


class SmallCXR(torch.nn.Module):
    forward = CXRModel.forward

    def __init__(self):
        super().__init__()
        self.features = tbb.DenseNetFeatures(block_config=(2, 2), growth_rate=8,
                                             num_init_features=16)
        self.head = TransitHead(self.features.out_channels, 14)

    def reset_parameters(self, generator=None):
        tbb.lecun_init(self, generator)


def _small_loaders(loader):
    """8 NIH train rows, 4 valid, 4 per test set (NIH, CheXpert, MIMIC) at
    32 px from ``make_multilabel``, batch 4, with their class maps."""
    def make(classes, n, data_seed, nan_frac, name, **kw):
        x, y = make_multilabel(n, shape=(32, 32, 3), n_classes=len(classes),
                               seed=data_seed, nan_frac=nan_frac)
        ld = loader(x, y, 4, **kw)
        ld.class_to_idx, ld.name = classes, name
        return ld
    return dict(
        train_loader=make(tcxr.NIH_CLASSES, 8, 11, 0.0, "NIH", shuffle=True, seed=11),
        valid_loader=make(tcxr.NIH_CLASSES, 4, 12, 0.0, "NIH"),
        test_loader=[make(tcxr.NIH_CLASSES, 4, 13, 0.0, "NIH"),
                     make(tcxr.CHEXPERT_CLASSES, 4, 22, 0.1, "CheXpert"),
                     make(tcxr.MIMIC_CLASSES, 4, 32, 0.1, "MIMIC")])


def test_comp_test_log_matches_jax_through_driver_run(tmp_path, monkeypatch):
    """``chestxray_mu0_01_K0`` as published (remat, defer_metrics, W-BCE,
    Adam under ReduceLROnPlateau, ``test=False``, ``comp_test=True``) on
    the small model for one epoch: the log, the overlap line and the
    three ``Comp Test`` blocks equal the JAX driver's."""
    jm = JaxSmallCXR()
    v0 = jax.jit(lambda x: jm.init(jax.random.PRNGKey(0), x, train=False))(
        jnp.zeros((1, 32, 32, 3)))
    p0 = jax.tree.map(lambda a: np.asarray(a, np.float64), v0["params"])
    s0 = jax.tree.map(lambda a: np.asarray(a, np.float64), v0["batch_stats"])
    monkeypatch.setattr(JaxTask, "init", lambda self, rng, x: (
        jax.tree.map(jnp.asarray, p0), {"batch_stats": jax.tree.map(jnp.asarray, s0)}))
    monkeypatch.setattr(Task, "init", lambda self, g, dev: interop.from_jax(SmallCXR(), p0, s0))
    runs = {}
    for side, opts, loader, run, model in (
            ("jax", jcxr_cfg.options(), JaxLoader, jdriver.run, jm),
            ("port", chestxray_mu0_01_K0.options(device="cpu"), ArrayLoader, driver.run,
             SmallCXR())):
        assert opts["comp_test"] and not opts["test"] and opts["remat"]
        opts.update(_small_loaders(loader), model=model, max_iter=1,
                    log_dir=str(tmp_path / side / "logs"), model_dir=str(tmp_path / side / "models"))
        runs[side] = run(opts)
    jtr, ttr = runs["jax"], runs["port"]
    with open(jtr.log_file) as fh:
        jlog = [ln for ln in fh if not ln.startswith("Time elapsed")]
    with open(ttr.log_file) as fh:
        tlog = [ln for ln in fh if not ln.startswith("Time elapsed")]
    assert len(tlog) == len(jlog)
    overlap = "['Atelectasis', 'Cardiomegaly', 'Pneumonia', 'Pneumothorax', 'Consolidation', " \
              "'Edema']\n"
    assert overlap in tlog and tlog.index(overlap) == jlog.index(overlap)
    labels = [ln.split(":")[0] for ln in tlog if ln.startswith("Comp Test")]
    assert labels == [f"Comp Test {n} {m}" for n in ("NIH", "CheXpert", "MIMIC")
                      for m in ("Loss", "Accuracy", "F1")]
    for t, j in zip(tlog, jlog):
        tt, jt = t.replace(":", " ").split(), j.replace(":", " ").split()
        assert len(tt) == len(jt)
        for a, b in zip(tt, jt):
            try:
                np.testing.assert_allclose(float(a), float(b), rtol=1e-8, atol=1e-12)
            except ValueError:
                assert a == b
