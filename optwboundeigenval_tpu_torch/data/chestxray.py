"""Chest x-ray datasets: NIH ChestX-ray14, CheXpert, MIMIC-CXR (counterpart
of ``optwboundeigenval_tpu/data/chestxray.py``).

The reference's datasets (dcnn.py:23-200) are CSV-driven, with per-class
index dicts, NaN for the uncertain (-1) CheXpert and MIMIC findings, the
NIH official test list and a 87.5/12.5 train/validation split of the
rest drawn with pandas' ``sample(frac=1, random_state=0)``
(dcnn.py:46-47).  Here the record readers use the ``csv`` module (no
pandas), and the split draws the same permutation pandas does,
``np.random.RandomState(0).choice(n, n, replace=False)``.

A loader reads real images only when its root holds the dataset's CSV
(the configs pass ``NIH_CXR_ROOT``, ``CHEXPERT_ROOT``, ``MIMIC_CXR_ROOT``);
images are decoded with PIL batch by batch, and a loader over real data
raises at construction when PIL is not installed.  Without a root, a
deterministic synthetic stand-in with the same label space (and 10% NaN
labels for CheXpert and MIMIC) takes its place, at 64 x 64 px whatever
``size`` says, as in the JAX package.  Both kinds yield the
padded, weighted batch dicts of ``data/loaders.py`` and carry
``class_to_idx`` and ``name``, which ``analysis/comp.py`` reads.
"""

from __future__ import annotations

import csv
import importlib.util
import math
import os
from typing import Dict, List, Optional

import numpy as np

from optwboundeigenval_tpu_torch.data.loaders import ArrayLoader
from optwboundeigenval_tpu_torch.data.synthetic import make_multilabel

NIH_CLASSES: Dict[str, int] = {
    "Atelectasis": 0, "Cardiomegaly": 1, "Effusion": 2, "Infiltration": 3,
    "Mass": 4, "Nodule": 5, "Pneumonia": 6, "Pneumothorax": 7,
    "Consolidation": 8, "Edema": 9, "Emphysema": 10, "Fibrosis": 11,
    "Pleural_Thickening": 12, "Hernia": 13,
}
CHEXPERT_CLASSES: Dict[str, int] = {
    "Enlarged Cardiomediastinum": 0, "Cardiomegaly": 1, "Lung Opacity": 2,
    "Lung Lesion": 3, "Edema": 4, "Consolidation": 5, "Pneumonia": 6,
    "Atelectasis": 7, "Pneumothorax": 8, "Pleural Effusion": 9,
    "Pleural Other": 10, "Fracture": 11, "Support Devices": 12,
}
MIMIC_CLASSES: Dict[str, int] = {
    "Enlarged Cardiomediastinum": 0, "Cardiomegaly": 1, "Airspace Opacity": 2,
    "Lung Lesion": 3, "Edema": 4, "Consolidation": 5, "Pneumonia": 6,
    "Atelectasis": 7, "Pneumothorax": 8, "Pleural Effusion": 9,
    "Pleural Other": 10, "Fracture": 11, "Support Devices": 12,
}

IMAGENET_MEAN = np.asarray([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.asarray([0.229, 0.224, 0.225], np.float32)


def ten_crop(x: np.ndarray, crop: int) -> np.ndarray:
    """torchvision's TenCrop: the 4 corners and the center, then their
    horizontal flips.  ``(H, W, C) -> (10, crop, crop, C)``."""
    h, w, _ = x.shape
    i, j = (h - crop) // 2, (w - crop) // 2
    crops = np.stack([x[:crop, :crop], x[:crop, -crop:], x[-crop:, :crop],
                      x[-crop:, -crop:], x[i:i + crop, j:j + crop]])
    return np.concatenate([crops, crops[:, :, ::-1, :]], axis=0)


class CXRImageLoader:
    """Batches of images decoded on the fly from ``records``, a list of
    ``(image path, label vector)``: resized to ``size`` (or to 256 and
    ten-cropped to ``size`` under ``crops``), ImageNet-normalised, the
    last batch padded with zero-weight rows."""

    def __init__(self, records: List, class_to_idx: Dict[str, int], batch_size: int = 16,
                 *, size: int = 224, crops: bool = False, shuffle: bool = False,
                 seed: int = 0, name: str = ""):
        if importlib.util.find_spec("PIL") is None:
            raise ImportError(f"the {name or 'chest x-ray'} images need PIL to decode, "
                              "and PIL is not installed")
        self.records = records
        self.class_to_idx = class_to_idx
        self.batch_size = batch_size
        self.size = size
        self.crops = crops
        self.shuffle = shuffle
        self.name = name
        self._rng = np.random.default_rng(seed)

    def __len__(self):
        return (len(self.records) + self.batch_size - 1) // self.batch_size

    @property
    def num_examples(self):
        return len(self.records)

    def _decode(self, path: str) -> np.ndarray:
        from PIL import Image

        img = Image.open(path).convert("RGB")
        if self.crops:
            x = np.asarray(img.resize((256, 256)), np.float32) / 255.0
            return (ten_crop(x, self.size) - IMAGENET_MEAN) / IMAGENET_STD
        x = np.asarray(img.resize((self.size, self.size)), np.float32) / 255.0
        return (x - IMAGENET_MEAN) / IMAGENET_STD

    def __iter__(self):
        order = np.arange(len(self.records))
        if self.shuffle:
            self._rng.shuffle(order)
        bs = self.batch_size
        for start in range(0, len(order), bs):
            take = order[start:start + bs]
            xs = np.stack([self._decode(self.records[i][0]) for i in take])
            ys = np.stack([self.records[i][1] for i in take])
            w = np.ones(len(take), np.float32)
            padn = bs - len(take)
            if padn > 0:
                xs = np.concatenate([xs, np.zeros((padn,) + xs.shape[1:], xs.dtype)])
                ys = np.concatenate([ys, np.zeros((padn,) + ys.shape[1:], ys.dtype)])
                w = np.concatenate([w, np.zeros(padn, np.float32)])
            yield {"x": xs, "y": ys, "w": w}

    def random_batch(self, rng=None):
        return next(iter(self))


def _synthetic_loader(classes, n, batch_size, seed, nan_frac=0.0, size=64, name=""):
    x, y = make_multilabel(n, shape=(size, size, 3), n_classes=len(classes), seed=seed,
                           nan_frac=nan_frac)
    loader = ArrayLoader(x, y, batch_size, shuffle=True, seed=seed)
    loader.class_to_idx = classes
    loader.name = name
    return loader


def _rows(path: str) -> List[List[str]]:
    """The non-empty rows of a CSV file."""
    with open(path, newline="") as fh:
        return [row for row in csv.reader(fh) if row]


def nih_split(names: List[str]):
    """``(train, validation)`` of the NIH train/validation list: pandas'
    ``sample(frac=1, random_state=0)`` order, the first 87.5% train."""
    order = np.random.RandomState(0).choice(len(names), size=len(names), replace=False)
    shuffled = [names[i] for i in order]
    cut = int(len(names) * 0.875)
    return shuffled[:cut], shuffled[cut:]


def _nih_records(root: str, use: str):
    test = [r[0] for r in _rows(os.path.join(root, "test_list.txt"))]
    train, valid = nih_split([r[0] for r in _rows(os.path.join(root, "train_val_list.txt"))])
    keep = set({"train": train, "validation": valid, "test": test}[use])
    img_dir = os.path.join(root, "images")
    records = []
    for row in _rows(os.path.join(root, "Data_Entry_2017.csv"))[1:]:
        if row[0] not in keep:
            continue
        labels = np.zeros(len(NIH_CLASSES), np.float32)
        for finding in row[1].split("|"):
            finding = finding.strip()
            if finding in NIH_CLASSES:
                labels[NIH_CLASSES[finding]] = 1
        records.append((os.path.join(img_dir, row[0]), labels))
    return records


def _number(text: str) -> float:
    try:
        return float(text)
    except ValueError:
        return math.nan


def _csv_records(root: str, csv_name: str, classes, img_root: str):
    """Label vectors from the CheXpert/MIMIC CSV: 1 where the column says
    1, NaN where it says -1 (uncertain, dcnn.py:134-135), else 0."""
    header, *rows = _rows(os.path.join(root, csv_name))
    cols = {cls: header.index(cls) for cls in classes if cls in header}
    records = []
    for row in rows:
        labels = np.zeros(len(classes), np.float32)
        for cls, col in cols.items():
            v = _number(row[col])
            if v == 1:
                labels[classes[cls]] = 1
            elif v == -1:
                labels[classes[cls]] = np.nan
        records.append((os.path.join(img_root, row[0]), labels))
    return records


def get_nih_loader(use: str = "train", batch_size: int = 16, root: Optional[str] = None,
                   size: int = 224, crops: bool = False, synthetic_n: int = 256):
    """NIH ChestX-ray14 (ChestXray_Dataset, dcnn.py:23-89)."""
    if root is not None and os.path.exists(os.path.join(root, "Data_Entry_2017.csv")):
        return CXRImageLoader(_nih_records(root, use), NIH_CLASSES, batch_size, size=size,
                              crops=crops, shuffle=(use == "train"), name="NIH")
    seed = {"train": 11, "validation": 12, "test": 13}.get(use, 14)
    return _synthetic_loader(NIH_CLASSES, synthetic_n, batch_size, seed, name="NIH")


def get_chexpert_loader(use: str = "train", batch_size: int = 16,
                        root: Optional[str] = None, size: int = 224, crops: bool = False,
                        synthetic_n: int = 256):
    """CheXpert (CheXpert_Dataset, dcnn.py:92-145); image paths are
    relative to the root's parent."""
    if root is not None and os.path.exists(os.path.join(root, "train.csv")):
        csv_name = {"train": "train.csv", "validation": "valid.csv"}[use]
        records = _csv_records(root, csv_name, CHEXPERT_CLASSES, os.path.dirname(root))
        return CXRImageLoader(records, CHEXPERT_CLASSES, batch_size, size=size, crops=crops,
                              shuffle=(use == "train"), name="CheXpert")
    seed = {"train": 21, "validation": 22}.get(use, 23)
    return _synthetic_loader(CHEXPERT_CLASSES, synthetic_n, batch_size, seed, nan_frac=0.1,
                             name="CheXpert")


def get_mimic_loader(use: str = "train", batch_size: int = 16, root: Optional[str] = None,
                     size: int = 224, crops: bool = False, synthetic_n: int = 256):
    """MIMIC-CXR (MIMICCXR_Dataset, dcnn.py:148-200)."""
    if root is not None and os.path.exists(os.path.join(root, "train.csv")):
        csv_name = {"train": "train.csv", "validation": "valid.csv"}[use]
        records = _csv_records(root, csv_name, MIMIC_CLASSES, root)
        return CXRImageLoader(records, MIMIC_CLASSES, batch_size, size=size, crops=crops,
                              shuffle=(use == "train"), name="MIMIC")
    seed = {"train": 31, "validation": 32}.get(use, 33)
    return _synthetic_loader(MIMIC_CLASSES, synthetic_n, batch_size, seed, nan_frac=0.1,
                             name="MIMIC")
