"""Cross-dataset comparison (counterpart of
``optwboundeigenval_tpu/analysis/comp.py``; reference ``comp_test``,
opt.py:1198-1242): test sets with different label spaces (NIH against
CheXpert against MIMIC) are evaluated on the classes they share, with
the model's output columns remapped to them."""

from __future__ import annotations

import os
from typing import Dict, List, Sequence


def intersect_classes(class_dicts: Sequence[Dict[str, int]]) -> List[Dict[str, int]]:
    """Per-dataset ``{class name: index}`` dicts -> per-dataset dicts over
    the classes all share, in the FIRST dict's order (the reference walks
    ``classes[0]``, opt.py:1200-1204)."""
    common = set(class_dicts[0]).intersection(*class_dicts[1:])
    names = [x for x in class_dicts[0] if x in common]
    return [{name: d[name] for name in names} for d in class_dicts]


def comp_test(trainer, test_loaders, options) -> None:
    """The best model over each test loader.  Where every loader carries a
    ``class_to_idx`` and the options a ``model_class_to_idx``, the shared
    classes go to the log first, then each loader's ``Comp Test <name>``
    lines over those classes; otherwise each loader's ``Comp Test <i>``
    lines over all."""
    dicts = [getattr(tl, "class_to_idx", None) for tl in test_loaders]
    model_dict = options.get("model_class_to_idx")
    crops = options.get("crops", False)
    if model_dict is None or any(d is None for d in dicts):
        for i, tl in enumerate(test_loaders):
            trainer.test_set(loader=tl, label=f"Comp Test {i}", crops=crops)
        return
    model_remap, *data_remaps = intersect_classes([model_dict] + dicts)
    model_classes = list(model_remap.values())
    os.makedirs(trainer.log_dir, exist_ok=True)
    with open(trainer.log_file, "a") as fh:
        fh.write(f"{list(model_remap)}\n")
    for tl, remap in zip(test_loaders, data_remaps):
        trainer.test_set(loader=tl, classes=list(remap.values()), model_classes=model_classes,
                         label=f"Comp Test {getattr(tl, 'name', '')}", crops=crops)
